"""Models of the port: the RAG engine's transformer LM (serving half) and
the EGNN node classifier (``gnn/``, inference)."""
