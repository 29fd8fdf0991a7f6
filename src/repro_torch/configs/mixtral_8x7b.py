"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="mixtral-8x7b",
    source="arXiv:2401.04088; hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=True,
    n_experts=8,
    top_k=2,
)

# SWA (W=4096): decode touches a bounded window through a rolling cache
SHAPES = lm_shapes(long_ok=True)
