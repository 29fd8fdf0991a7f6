"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA kv=8.  [arXiv:2412.08905; hf]

The RAG engine's generator at its published width: 32 layers, d_model
3072, 24 query / 8 KV heads (head_dim 128), d_ff 8192, vocab 200,064,
tied embeddings, full rotary (theta 1e4), bf16."""
from repro_torch.configs.base import LMConfig, ShapeSpec

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

# the reference's LM shape set (long_500k is a documented skip for a pure
# full-attention arch)
SHAPES = [
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode", {"seq_len": 524288, "global_batch": 1},
              skip=True, skip_reason="pure full-attention arch: no "
              "sub-quadratic path at 500k"),
]
