"""PyTorch/CUDA port of the Hybrid Multimodal Graph Index.

Laid out module for module like the JAX package ``repro`` (the reference it
is tested against), but it imports neither JAX nor anything of ``repro``.
Entry points run on a CUDA device unless the caller passes
``device="cpu"``; the Pallas kernels of the main path are hand-written CUDA
C++ for sm_90a under ``kernels/`` (built with nvcc at first use).
"""
