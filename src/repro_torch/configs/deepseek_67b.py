"""deepseek-67b [dense] — llama-arch, GQA kv=8.  [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="deepseek-67b",
    source="arXiv:2401.02954; hf",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10_000.0,
)

SHAPES = lm_shapes(long_ok=False)
