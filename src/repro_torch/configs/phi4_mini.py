"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA kv=8.  [arXiv:2412.08905; hf]

The RAG engine's generator at its published width: 32 layers, d_model
3072, 24 query / 8 KV heads (head_dim 128), d_ff 8192, vocab 200,064,
tied embeddings, full rotary (theta 1e4), bf16."""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="phi4-mini-3.8b",
    source="arXiv:2412.08905; hf",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    tie_embeddings=True,
    rope_theta=10_000.0,
    sharding_overrides={"heads": None, "kv_heads": None, "seq_attn": "model"},
)

SHAPES = lm_shapes(long_ok=False)
