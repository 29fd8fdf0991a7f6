"""The index core: quantization, partitioning, IVF, delta, graph, fusion, facade."""
