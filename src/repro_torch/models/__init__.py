"""Models of the port: the transformer LM (serving and training), the
GNNs (``gnn/``: EGNN, NequIP, DimeNet, Equiformer-v2) and the recommender
(``recsys/``: xDeepFM over EmbeddingBag)."""
