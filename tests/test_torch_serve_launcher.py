"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU:
a durable run, a ``--recover`` run on its directory and a ``--rag`` run,
each printing the reference launcher's lines, and the reference launcher
at the same arguments beside it."""
import pytest

pytest.importorskip("torch")

import re
import sys


from repro.launch import serve as j_serve
from repro_torch.launch import serve

_ARGS = ["--n-nodes", "600", "--queries", "16", "--ingest-steps", "2"]
# the first word(s) of each line the reference prints, in its order
_LINES = ("ingest+build:", "vector search:", "hybrid search (2 hops):",
          "ingest-while-search:", "snapshot:")


def _heads(out: str):
    return [ln.split(" ")[0] for ln in out.splitlines() if ln.strip()]


def test_serve_durable_recover_and_rag(tmp_path, capsys, monkeypatch):
    d = str(tmp_path / "data")
    first = serve.main(_ARGS + ["--device", "cpu", "--data-dir", d])
    out = capsys.readouterr().out
    assert [ln for ln in _LINES if ln in out] == list(_LINES)
    assert first["device"] == "cpu" and first["recall"] >= 0.5
    assert first["last_seq"] > 0 and first["ingest_build_s"] > 0

    again = serve.main(_ARGS + ["--device", "cpu", "--data-dir", d,
                                "--recover"])
    out = capsys.readouterr().out
    assert out.startswith("recover:") and "ingest+build" not in out
    assert re.search(r"recovered from snapshot step \d+", again["recovery"])
    assert again["last_seq"] > first["last_seq"]

    rag = serve.main(_ARGS + ["--device", "cpu", "--rag", "--metrics-out",
                              str(tmp_path / "m.json")])
    out = capsys.readouterr().out
    assert rag["rag_generated"] == {i: 8 for i in range(4)}
    assert "RAG generated:" in out and "metrics ->" in out
    assert "snapshot:" not in out

    # the reference launcher at the same arguments: the same lines, and
    # recall within 0.1 (its k-means seeds differ from the port's)
    monkeypatch.setattr(sys, "argv", ["serve"] + _ARGS)
    j_serve.main()
    ref = capsys.readouterr().out
    assert _heads(ref) == _heads(out)[:len(_heads(ref))]
    ref_recall = float(re.search(r"recall@10=(\S+)", ref).group(1))
    assert abs(ref_recall - rag["recall"]) <= 0.1


def test_serve_refuses_recover_without_data_dir():
    with pytest.raises(SystemExit):
        serve.main(["--recover", "--device", "cpu"])
