"""Synthetic corpora (numpy-seeded, identical to the reference) and the
host data pipeline (``pipeline``: the training streams and ``Prefetcher``)."""
