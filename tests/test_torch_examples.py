"""The port's RAG example (``examples/torch_multimodal_rag.py``) runs to
its end on the CPU: its LM is the reference's smoke phi4-mini (head dim
16), one the decode kernel has an instance of, so the same script runs on
the card (``test_torch_kernels_gpu.py``).
"""
import pytest

pytest.importorskip("torch")

import importlib.util
import os

from repro_torch.configs import smoke_config
from repro_torch.kernels.decode_attention import ops as dops


def test_multimodal_rag_example_on_the_cpu(capsys):
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch_multimodal_rag.py")
    spec = importlib.util.spec_from_file_location("torch_rag_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main("cpu")
    assert "served 12/12 requests" in capsys.readouterr().out
    hd = smoke_config("phi4-mini-3.8b").head_dim
    assert hd == 16 and hd in dops._HEAD_DIMS
