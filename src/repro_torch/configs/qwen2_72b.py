"""qwen2-72b [dense] — GQA kv=8, QKV bias.  [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="qwen2-72b",
    source="arXiv:2407.10671; hf",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SHAPES = lm_shapes(long_ok=False)
