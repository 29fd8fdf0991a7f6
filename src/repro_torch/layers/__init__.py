"""Transformer layers of the RAG LM: norms, rotary embeddings, SwiGLU and
GQA attention (prefill and one-token decode)."""
