"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 64 routed top-6 + 2 shared.

[arXiv:2405.04434; hf]. 27 layers, d_model 2048, 16 heads (q/k width
128 + 64 roped, v 128), a latent KV cache of 512 + 64 per token and
layer, 64 routed experts (top 6, d_ff 1408) plus 2 shared, and a first
dense layer of d_ff 10,944: 15.7 B parameters, 31.4 GB in bf16, which
fits one 80 GB card at full width and depth.
"""
from repro_torch.configs.base import LMConfig
from repro_torch.configs.lm_shapes import lm_shapes

CONFIG = LMConfig(
    arch_id="deepseek-v2-lite-16b",
    source="arXiv:2405.04434; hf",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,           # per-expert hidden
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    dense_d_ff=10944,
)

# the MLA latent cache keeps the 500k decode cell's memory tractable
SHAPES = lm_shapes(long_ok=True, long_note="MLA compressed KV cache")
