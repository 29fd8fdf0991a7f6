"""The reference's shared GNN shape set (``repro.configs.gnn_shapes``)."""
from repro_torch.configs.base import ShapeSpec


def gnn_shapes() -> list[ShapeSpec]:
    return [
        ShapeSpec("full_graph_sm", "full_graph",
                  {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
        ShapeSpec("minibatch_lg", "minibatch",
                  {"n_nodes": 232_965, "n_edges": 114_615_892,
                   "batch_nodes": 1024, "fanout0": 15, "fanout1": 10}),
        ShapeSpec("ogb_products", "full_graph",
                  {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
        ShapeSpec("molecule", "molecule",
                  {"n_nodes": 30, "n_edges": 64, "batch": 128}),
    ]
