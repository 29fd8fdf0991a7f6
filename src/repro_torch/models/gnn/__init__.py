"""GNN models of the port: EGNN full-graph and molecule inference over the
single-device ``LocalExec`` engine (``common.py``, ``driver.py``)."""
