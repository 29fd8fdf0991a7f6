"""egnn [gnn] — E(n)-equivariant message passing (scalar distances).  [arXiv:2102.09844]

The reference's published config: 4 layers, d_hidden 64, fp32."""
from repro_torch.configs.base import GNNConfig
from repro_torch.configs.gnn_shapes import gnn_shapes

CONFIG = GNNConfig(
    arch_id="egnn",
    source="arXiv:2102.09844; paper",
    model="egnn",
    n_layers=4,
    d_hidden=64,
)

SHAPES = gnn_shapes()
