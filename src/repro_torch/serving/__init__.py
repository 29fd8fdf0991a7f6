"""Serving: the RAG engine, the continuous-batching scheduler with
per-tenant admission, cross-request retrieval micro-batching and the
version-invalidated hot-result cache."""
