"""HMGI default system config (the paper's own architecture, §3)."""
from repro_torch.configs.base import HMGIConfig, ShapeSpec

CONFIG = HMGIConfig(
    arch_id="hmgi",
    source="this paper",
    dim=384,
    modalities=("text", "image", "audio", "video"),
    modality_dims={"text": 384, "image": 512, "video": 768, "audio": 1280},
    n_partitions=64,
    n_probe=8,
    top_k=10,
    quant_bits=8,
    nsw_degree=16,
    nsw_ef=64,
    delta_capacity=4096,
    w_vector=0.6,
    w_graph=0.4,
    max_hops=2,
)

# serving shapes for the index itself
SHAPES = [
    ShapeSpec("serve_1m", "index_search", {"n_vectors": 1_048_576, "batch": 256, "dim": 384}),
    ShapeSpec("serve_16m", "index_search", {"n_vectors": 16_777_216, "batch": 1024, "dim": 384}),
]
