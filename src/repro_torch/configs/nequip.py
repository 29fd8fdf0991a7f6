"""nequip [gnn] — E(3)-equivariant tensor-product interatomic potential.  [arXiv:2101.03164]

The reference's published config: 5 layers, C 32, l_max 2, 8 radial
basis functions, cutoff 5, fp32."""
from repro_torch.configs.base import GNNConfig
from repro_torch.configs.gnn_shapes import gnn_shapes

CONFIG = GNNConfig(
    arch_id="nequip",
    source="arXiv:2101.03164; paper",
    model="nequip",
    n_layers=5,
    d_hidden=32,
    l_max=2,
    n_rbf=8,
    cutoff=5.0,
)

SHAPES = gnn_shapes()
