"""xdeepfm [recsys] — CIN + MLP over sparse embedding fields.  [arXiv:1803.05170]

The reference's published config: 39 fields of 100,000 ids, embeddings of
width 10, a CIN of 3 x 200 maps and an MLP of 2 x 400, fp32."""
from repro_torch.configs.base import RecsysConfig, ShapeSpec

CONFIG = RecsysConfig(
    arch_id="xdeepfm",
    source="arXiv:1803.05170; paper",
    n_sparse=39,
    embed_dim=10,
    vocab_per_field=100_000,   # Criteo-like scale per field (assignment leaves it open)
    cin_layers=(200, 200, 200),
    mlp_layers=(400, 400),
)

SHAPES = [
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
]
