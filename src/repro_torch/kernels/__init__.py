"""Hand-written CUDA kernels of the port (sm_90a).

Each kernel package has csrc/<name>.cu (the kernel, plain C entry points),
ops.py (the wrapper: plain version on CPU tensors, kernel on CUDA tensors,
a launch counter) and ref.py (the plain PyTorch version). ``_build.py``
compiles a source with nvcc on first use and loads it with ctypes.

  ivf_topk         — fused int8 scan + per-chunk max/argmax on the tensor
                     cores (the query split into int8 limbs):
                     ``probe_scan`` (the IVF probe, each probed partition of
                     the flat slab read once for every query that probes
                     it) and ``shared_scan`` (every query against one slab:
                     the delta store).
  decode_attention — GQA one-token flash-decode (split-K over the cache,
                     then a combine): the attention of every layer of every
                     decode tick of the RAG engine.
"""
