"""The port's static concurrency contract (``tools/staticcheck_torch.py``):
HMG201-HMG204 over ``src/repro_torch`` with the port's own table, and the
lock coverage that keeps the table in step with the code.

- the port's tree is clean (the four patterns the JAX package carries a
  reasoned pragma for carry the same pragma in the port);
- every lock the port builds is named by the table or exempted with a
  reason, and every ``*_locked`` method is registered: dropping any one
  entry makes the check fail;
- a seeded violation of each rule is found through the port's table
  (files laid out under a ``src/repro_torch`` tree in a temporary
  directory, so the table's paths apply);
- importing the tools, or ``chip_smoke.py``, pulls in neither ``jax`` nor
  the JAX package.
"""
import ast
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools import staticcheck_torch as sc  # noqa: E402
from tools.staticcheck.concurrency import check_hmg201  # noqa: E402


@functools.lru_cache(maxsize=None)
def _tree_files():
    files = sc.iter_py_files(sc.DEFAULT_PATHS)
    return tuple((sc._rel(f), ast.parse(f.read_text())) for f in files)


def _write(root: Path, rel: str, src: str) -> Path:
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


def test_port_tree_is_clean(capsys):
    assert sc.main([]) == 0
    assert capsys.readouterr().out.startswith("clean: ")
    assert len(_tree_files()) > 100


def test_cli_reports_findings(tmp_path, capsys):
    bad = _write(tmp_path, "src/repro_torch/serving/cache.py", """
        class HotResultCache:
            def size(self):
                return len(self._entries)
    """)
    assert sc.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "HMG201" in out and "1 finding(s)" in out


def test_the_four_reference_pragmas_are_carried():
    """The patterns the JAX package suppresses with a reason are the
    port's only suppressions, each with the same rule."""
    want = {("src/repro_torch/checkpoint/checkpoint.py", "HMG202"),
            ("src/repro_torch/core/index.py", "HMG201"),
            ("src/repro_torch/serving/retrieval.py", "HMG202")}
    got = set()
    n = 0
    for f in sc.iter_py_files(sc.DEFAULT_PATHS):
        for line in f.read_text().splitlines():
            if "staticcheck: disable=HMG2" in line:
                rule = line.split("disable=")[1][:6]
                got.add((sc._rel(f), rule))
                n += 1
                assert "(" in line and ")" in line, "a pragma needs a reason"
    assert got == want and n == 4


def test_every_lock_is_covered():
    files = _tree_files()
    sites = [key for rel, tree in files
             for key, _, _ in sc.lock_sites(rel, tree)]
    assert len(sites) >= 14
    assert sc.check_lock_coverage(files) == []


def _entries():
    """Every table entry that names a lock site: (kind, key)."""
    out = [("guard", s.cls) for s in sc.GUARDED_BY
           if s.cls not in sc.LOCK_OWNERS]
    out += [("wrap", w[1]) for w in sc.EXTRA_LOCK_WRAPS]
    out += [("condition", c) for c in sc.CONDITIONS]
    out += [("exempt", e) for e in sc.LOCK_EXEMPT]
    return out


@pytest.mark.parametrize("kind,key", _entries())
def test_dropping_a_table_entry_fails_coverage(kind, key):
    """A lock whose entry is removed is reported at its construction."""
    guards, wraps = list(sc.GUARDED_BY), list(sc.EXTRA_LOCK_WRAPS)
    conds, exempt = dict(sc.CONDITIONS), dict(sc.LOCK_EXEMPT)
    if kind == "guard":
        guards = [g for g in guards if g.cls != key]
    elif kind == "wrap":
        wraps = [w for w in wraps if w[1] != key]
    elif kind == "condition":
        conds.pop(key)
    else:
        exempt.pop(key)
    covered = sc.covered_sites(guards, wraps, conds, exempt)
    vs = sc.check_lock_coverage(_tree_files(), covered)
    assert vs and all(v.rule == "HMG201" for v in vs)
    assert any("neither the port's guarded-by table" in v.message
               for v in vs)


@pytest.mark.parametrize("name", sorted(sc.GUARDED_METHODS))
def test_dropping_a_locked_method_fails(name):
    """An unregistered ``*_locked`` method is reported where it is
    defined (HMG201), and a registered one that is gone as stale."""
    methods = {k: v for k, v in sc.GUARDED_METHODS.items() if k != name}
    vs = [v for rel, tree in _tree_files()
          for v in check_hmg201(rel, tree, guards=sc.GUARDED_BY,
                                methods=methods)]
    assert any(name.split(".")[1] in v.message
               and "GUARDED_METHODS" in v.message for v in vs)
    stale = dict(sc.GUARDED_METHODS, **{name + "_gone": "X._lock"})
    vs = sc.check_lock_coverage(_tree_files(), methods=stale)
    assert [v.message for v in vs] == [
        f"stale GUARDED_METHODS entry: {name}_gone is not defined"]


def test_a_new_lock_without_an_entry_fails(tmp_path):
    f = _write(tmp_path, "src/repro_torch/serving/new.py", """
        import threading
        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
        _global = threading.RLock()
        def make():
            return threading.Condition()
    """)
    rel = sc._rel(f)
    sites = sc.lock_sites(rel, ast.parse(f.read_text()))
    assert sorted(k.split(":", 1)[1] for k, _, _ in sites) == \
        ["Pool._lock", "_global", "make()"]
    vs = sc.check_files([f], full_tree=False)
    assert len(vs) == 3 and {v.rule for v in vs} == {"HMG201"}


def test_stale_entry_is_reported():
    guards = list(sc.GUARDED_BY) + [dataclasses.replace(
        sc.GUARDED_BY[0], cls="Gone", module="repro_torch.obs.metrics")]
    covered = sc.covered_sites(guards)
    vs = sc.check_lock_coverage(_tree_files(), covered)
    assert [v.message for v in vs if "stale" in v.message]


# ------------------------------------------- a seeded violation of each rule
def test_hmg201_seeded(tmp_path):
    f = _write(tmp_path, "src/repro_torch/serving/cache.py", """
        import threading
        class HotResultCache:
            def __init__(self):
                self._lock = threading.Lock()
                self._entries = {}
            def peek(self, key):
                return self._entries.get(key)
            def ok(self, key):
                with self._lock:
                    return self._entries.get(key)
    """)
    vs = sc.check_files([f], full_tree=False)
    assert [(v.rule, v.line) for v in vs] == [("HMG201", 8)]


def test_hmg201_pragma_needs_reason(tmp_path):
    f = _write(tmp_path, "src/repro_torch/serving/cache.py", """
        class HotResultCache:
            def peek(self, key):
                # staticcheck: disable=HMG201 (published dict is never mutated)
                a = self._entries
                # staticcheck: disable=HMG201
                return self._entries
    """)
    vs = sc.check_files([f], full_tree=False)
    assert sorted(v.rule for v in vs) == ["HMG000", "HMG201"]


def test_hmg202_seeded_host_sync(tmp_path):
    """A CUDA synchronise or a host read of a device tensor under a
    fine-grained lock is blocking in the port's table."""
    f = _write(tmp_path, "src/repro_torch/core/index.py", """
        import torch
        class HMGIIndex:
            def rows(self, m):
                with self._cache_lock:
                    torch.cuda.synchronize()
                    n = m.ids.max().item()
                with self._write_lock:
                    torch.cuda.synchronize()      # the coarse lock: exempt
                return n
    """)
    vs = sc.check_files([f], full_tree=False)
    assert [(v.rule, v.line) for v in vs] == [("HMG202", 6), ("HMG202", 7)]


def test_hmg203_seeded_cycle(tmp_path):
    a = _write(tmp_path, "src/repro_torch/x/a.py", """
        class HMGIIndex:
            def f(self):
                with self._cache_lock:
                    self.stats.record(1)
    """)
    b = _write(tmp_path, "src/repro_torch/x/b.py", """
        class WorkloadStats:
            def g(self, index):
                with self._lock:
                    index._ensure_sharded("a", 1)
    """)
    vs = sc.check_files([a, b], full_tree=False)
    assert [v.rule for v in vs] == ["HMG203"]
    assert "WorkloadStats._lock" in vs[0].message


def test_hmg204_seeded_publication(tmp_path):
    f = _write(tmp_path, "src/repro_torch/data/pipeline.py", """
        import threading
        class Prefetcher:
            def __init__(self):
                self._lock = threading.Lock()
                t = threading.Thread(target=self.work)
                t.start()
                self.extra = 0
            def bump(self):
                self.count = 1
    """)
    vs = sc.check_files([f], full_tree=False)
    assert [(v.rule, v.line) for v in vs] == [("HMG204", 8), ("HMG204", 10)]


# ----------------------------------------------------------------- imports
@pytest.mark.parametrize("mod", ["tools.staticcheck_torch",
                                 "tools.racecheck_torch", "chip_smoke"])
def test_import_pulls_neither_jax_nor_repro(mod):
    code = (f"import sys; import {mod}; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": "src"})
    assert r.returncode == 0, r.stdout + r.stderr
