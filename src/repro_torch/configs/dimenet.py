"""dimenet [gnn] — directional message passing, triplet angular basis.  [arXiv:2003.03123]

The reference's config: 6 interaction blocks, d 128, 8 bilinear, 7
spherical, 6 radial basis functions, fp32."""
from repro_torch.configs.base import GNNConfig
from repro_torch.configs.gnn_shapes import gnn_shapes

CONFIG = GNNConfig(
    arch_id="dimenet",
    source="arXiv:2003.03123; unverified",
    model="dimenet",
    n_layers=6,            # n_blocks
    d_hidden=128,
    n_bilinear=8,
    n_spherical=7,
    n_radial=6,
)

SHAPES = gnn_shapes()
