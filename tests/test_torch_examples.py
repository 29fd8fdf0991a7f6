"""The port's RAG example (``examples/torch_multimodal_rag.py``) runs to
its end on the CPU: its LM takes the serving launcher's head dim
(``launch.serve.SMOKE_HEAD_DIM``), one the decode kernel has an instance
of, so the same script runs on the card (``test_torch_kernels_gpu.py``).
"""
import importlib.util
import os

from repro_torch.launch.serve import SMOKE_HEAD_DIM


def test_multimodal_rag_example_on_the_cpu(capsys):
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "torch_multimodal_rag.py")
    spec = importlib.util.spec_from_file_location("torch_rag_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main("cpu")
    assert "served 12/12 requests" in capsys.readouterr().out
    assert SMOKE_HEAD_DIM in (64, 128)
