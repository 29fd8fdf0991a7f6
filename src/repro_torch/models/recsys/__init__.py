"""Recommender models of the port: xDeepFM (``xdeepfm.py``) over the
EmbeddingBag primitives (``embedding_bag.py``)."""
