"""equiformer-v2 [gnn] — SO(2)-eSCN equivariant graph attention.  [arXiv:2306.12059]

The reference's config: 12 layers, C 128, l_max 6, m_max 2, 8 heads,
fp32."""
from repro_torch.configs.base import GNNConfig
from repro_torch.configs.gnn_shapes import gnn_shapes

CONFIG = GNNConfig(
    arch_id="equiformer-v2",
    source="arXiv:2306.12059; unverified",
    model="equiformer_v2",
    n_layers=12,
    d_hidden=128,
    l_max=6,
    m_max=2,
    n_heads=8,
)

SHAPES = gnn_shapes()
