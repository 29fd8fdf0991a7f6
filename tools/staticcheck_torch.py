"""The PyTorch port's concurrency contract: HMG201-HMG204 over
``src/repro_torch`` (the static half; ``tools/racecheck_torch.py`` is the
dynamic half).

The JAX package's contract lives in ``tools/staticcheck/registry.py`` and
names ``repro.*`` classes only. The port copied its locks, so it carries
its own table here, fitted to the port's code, and runs the same rule
functions over it (``tools.staticcheck.concurrency.check_hmg201`` ..
``check_hmg204`` through their ``guards=`` / ``methods=`` /
``acquiring=`` parameters) with the same reasoned-pragma discipline
(``# staticcheck: disable=RULE (reason)``, ``tools.staticcheck.pragmas``).

One check is the port's own: **lock coverage**. Every
``threading.Lock`` / ``RLock`` / ``Condition`` that ``src/repro_torch``
builds must be named by the table (a ``GuardSpec``'s lock, a lock the
dynamic harness wraps, a condition over a named lock) or by
``LOCK_EXEMPT`` with its reason, and every table entry must still name a
lock the code builds. A lock added without an entry fails the check, so
the table cannot fall behind the code.

    PYTHONPATH=src python -m tools.staticcheck_torch            # src/repro_torch
    PYTHONPATH=src python -m tools.staticcheck_torch --json
    PYTHONPATH=src python -m tools.staticcheck_torch path/to/file.py

Exit status 0 iff no finding survives pragma suppression. Nothing here
imports ``jax``, ``torch`` or either package: the checked files are only
parsed.
"""
from __future__ import annotations

import argparse
import ast
import functools
import json
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from tools.staticcheck import Violation, sort_violations  # noqa: E402
from tools.staticcheck.__main__ import iter_py_files  # noqa: E402
from tools.staticcheck.concurrency import (  # noqa: E402
    check_hmg201, check_hmg202, check_hmg203, check_hmg204)
from tools.staticcheck.pragmas import (  # noqa: E402
    filter_suppressed, scan_pragmas)
from tools.staticcheck.registry import GuardSpec  # noqa: E402

DEFAULT_PATHS = ("src/repro_torch",)
_SRC = "src/repro_torch/"

# --------------------------------------------------------------- the table
# The JAX package's table with repro. -> repro_torch., fitted to the port:
# DurableHMGIIndex guards its snapshot mark with the inherited write lock.
GUARDED_BY: Tuple[GuardSpec, ...] = (
    GuardSpec("Histogram", "repro_torch.obs.metrics", "_lock",
              ("bucket_counts", "count", "total", "vmax", "_window",
               "_wpos"),
              (_SRC + "obs/metrics.py",)),
    GuardSpec("MetricsRegistry", "repro_torch.obs.metrics", "_lock",
              ("_counters", "_gauges", "_histograms"),
              (_SRC + "obs/metrics.py",)),
    GuardSpec("CheckpointManager", "repro_torch.checkpoint.checkpoint",
              "_lock", ("_pending", "_error"),
              (_SRC + "checkpoint/checkpoint.py",)),
    GuardSpec("WorkloadStats", "repro_torch.core.partitioner", "_lock",
              ("hits",),
              (_SRC + "core/partitioner.py", _SRC + "core/index.py",
               _SRC + "query/executor.py")),
    GuardSpec("Prefetcher", "repro_torch.data.pipeline", "_lock",
              ("step", "q", "_stop", "_thread"),
              (_SRC + "data/pipeline.py",)),
    # the lazily built read caches of a modality are owned by the facade's
    # _cache_lock; they are reached as ``m.<attr>``
    GuardSpec("ModalityIndex", "repro_torch.core.index", "_cache_lock",
              ("ivf_sharded", "id_rows"),
              (_SRC + "core/index.py", _SRC + "query/executor.py"),
              receivers=("m",)),
    GuardSpec("HotResultCache", "repro_torch.serving.cache", "_lock",
              ("_entries", "_stores"),
              (_SRC + "serving/cache.py",)),
    GuardSpec("AdmissionController", "repro_torch.serving.scheduler",
              "_lock", ("_buckets",),
              (_SRC + "serving/scheduler.py",)),
    GuardSpec("MicroBatcher", "repro_torch.serving.retrieval", "_lock",
              ("_pending", "_leader"),
              (_SRC + "serving/retrieval.py",)),
    # whose turn it is on each device that spmd shards share
    GuardSpec("_Turns", "repro_torch.sharding.collectives", "_lock",
              ("_next", "_aborted"),
              (_SRC + "sharding/collectives.py",)),
    GuardSpec("DurableHMGIIndex", "repro_torch.persistence.durable",
              "_write_lock", ("_last_snapshot_seq",),
              (_SRC + "persistence/durable.py",)),
)

# ``*_locked`` methods -> the lock their callers hold. The port has no
# ``_state_tree_locked``: ``state_tree`` takes the write lock inline.
GUARDED_METHODS: Dict[str, str] = {
    "CheckpointManager._drain_pending_locked": "CheckpointManager._lock",
    "HMGIIndex._insert_locked": "HMGIIndex._write_lock",
    "HMGIIndex._maintain_locked": "HMGIIndex._write_lock",
    "HMGIIndex._ingest_locked": "HMGIIndex._write_lock",
    "HMGIIndex._compact_locked": "HMGIIndex._write_lock",
    "HMGIIndex._restore_state_locked": "HMGIIndex._write_lock",
    "MicroBatcher._take_batch_locked": "MicroBatcher._lock",
}

# HMG202: the JAX package's blocking calls, and the port's host syncs on
# device work (a CUDA synchronise, or a read of a device tensor's values
# on the host). The coarse write lock is exempt, as there.
BLOCKING_CALLS: Tuple[str, ...] = (
    "fsync", "fsync_file", "fsync_dir", "sleep", "block_until_ready",
    "join", "result", "wait", "device_get",
    "synchronize", "_sync", "item", "tolist", "cpu")
HMG202_LOCK_ATTRS: Tuple[str, ...] = ("_lock", "_cache_lock")

# HMG203: calls that take a known lock inside them.
LOCK_ACQUIRING_CALLS: Dict[str, str] = {
    "counter": "MetricsRegistry._lock",
    "gauge": "MetricsRegistry._lock",
    "histogram": "MetricsRegistry._lock",
    "observe": "Histogram._lock",
    "observe_ms": "Histogram._lock",
    "inc": "Counter._lock",
    "record": "WorkloadStats._lock",
    "hits_snapshot": "WorkloadStats._lock",
    "load_hits": "WorkloadStats._lock",
    "_ensure_sharded": "HMGIIndex._cache_lock",
    "_modality_id_rows": "HMGIIndex._cache_lock",
    "_drop_sharded": "HMGIIndex._cache_lock",
    "try_admit": "AdmissionController._lock",
}

# Guarded classes whose lock another class builds: the facade owns the
# modality caches' lock, and the durable index inherits its write lock.
LOCK_OWNERS: Dict[str, Tuple[str, str]] = {
    "ModalityIndex": ("repro_torch.core.index", "HMGIIndex"),
    "DurableHMGIIndex": ("repro_torch.core.index", "HMGIIndex"),
}

# Locks the dynamic harness wraps beyond the GuardSpecs' own:
# (module, class, lock attributes). HMGIIndex owns the facade's two locks
# (DurableHMGIIndex inherits them); a Counter serialises inc().
EXTRA_LOCK_WRAPS: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    ("repro_torch.core.index", "HMGIIndex", ("_write_lock", "_cache_lock")),
    ("repro_torch.obs.metrics", "Counter", ("_lock",)),
)

# Condition variables over a lock of the table: "Class.attr" -> the lock
# attribute it waits on.
CONDITIONS: Dict[str, str] = {
    "MicroBatcher._cv": "_lock",
    "_Turns._cv": "_lock",
}

# Locks outside the contract, each with its reason. Keys are
# "path:Class.attr", "path:name" (module level) or "path:function()" (a
# lock built inside a function).
LOCK_EXEMPT: Dict[str, str] = {
    _SRC + "kernels/_build.py:_locks_lock": (
        "module-level leaf lock around one dict lookup; no shared object "
        "state, and nothing else is taken under it"),
    _SRC + "kernels/segment_reduce/ops.py:_COUNT_LOCK": (
        "module-level leaf lock around the two launch counts' increments, "
        "which threads launching at once (spmd shards, autograd's device "
        "threads) would otherwise lose; nothing else is taken under it"),
    _SRC + "sharding/collectives.py:_STAGGER_LOCK": (
        "module-level leaf lock around the two ``STAGGER`` tallies' "
        "increments, which shards of different shared devices make at "
        "once; nothing else is taken under it"),
    _SRC + "kernels/_build.py:load()": (
        "one lock per kernel source, held across that source's nvcc build "
        "so two threads never compile it twice; no object state is "
        "guarded, and no other lock is taken under it"),
}

_LOCK_CTORS = ("Lock", "RLock", "Condition")


# ----------------------------------------------------------- lock coverage
def _is_lock_ctor(node: ast.AST) -> Optional[str]:
    """'Lock' / 'RLock' / 'Condition' for ``threading.X(...)`` or ``X(...)``."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "threading" and f.attr in _LOCK_CTORS:
        return f.attr
    if isinstance(f, ast.Name) and f.id in _LOCK_CTORS:
        return f.id
    return None


def lock_sites(rel: str, tree: ast.Module) -> List[Tuple[str, str, int]]:
    """(site key, constructor, line) for every lock one file builds. The
    key is "path:Class.attr" for ``self.attr = threading.X()`` in a
    class's method, "path:name" for a module-level name, and
    "path:function()" for any other lock built in a function."""
    out: List[Tuple[str, str, int]] = []

    def visit(node: ast.AST, cls: Optional[str], fn: Optional[str]) -> None:
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                visit(sub, node.name, None)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in node.body:
                visit(sub, cls, node.name if fn is None else fn)
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                _is_lock_ctor(node.value):
            kind = _is_lock_ctor(node.value)
            tgts = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in tgts:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self" and cls:
                    out.append((f"{rel}:{cls}.{t.attr}", kind, node.lineno))
                elif isinstance(t, ast.Name) and fn is None:
                    out.append((f"{rel}:{t.id}", kind, node.lineno))
                else:
                    out.append((f"{rel}:{fn or '<module>'}()", kind,
                                node.lineno))
            return
        kind = _is_lock_ctor(node)
        if kind:
            out.append((f"{rel}:{fn or '<module>'}()", kind, node.lineno))
        for sub in ast.iter_child_nodes(node):
            visit(sub, cls, fn)

    for top in tree.body:
        visit(top, None, None)
    return out


def _site_path(rel: str) -> str:
    """A checked file's path from its ``src/repro_torch/`` on, so a tree
    laid out elsewhere (a test's) meets the table's keys."""
    _, sep, tail = rel.rpartition(_SRC)
    return sep + tail if sep else rel


def _module_path(module: str) -> str:
    return "src/" + module.replace(".", "/") + ".py"


def covered_sites(guards: Iterable[GuardSpec] = GUARDED_BY,
                  wraps=EXTRA_LOCK_WRAPS,
                  conditions: Optional[Dict[str, str]] = None,
                  exempt: Optional[Dict[str, str]] = None
                  ) -> Dict[str, str]:
    """Site key -> what in the table names it."""
    conditions = CONDITIONS if conditions is None else conditions
    exempt = LOCK_EXEMPT if exempt is None else exempt
    out: Dict[str, str] = {}
    for s in guards:
        if s.cls not in LOCK_OWNERS:       # the owner's wrap names those
            out[f"{_module_path(s.module)}:{s.cls}.{s.lock}"] = \
                f"GUARDED_BY {s.cls}"
    for module, cls, locks in wraps:
        for la in locks:
            out[f"{_module_path(module)}:{cls}.{la}"] = \
                f"EXTRA_LOCK_WRAPS {cls}"
    mod_of = {s.cls: s.module for s in guards}
    for name, lock in conditions.items():
        cls = name.split(".", 1)[0]
        if cls in mod_of:
            out[f"{_module_path(mod_of[cls])}:{name}"] = \
                f"CONDITIONS over {cls}.{lock}"
    for key, reason in exempt.items():
        out[key] = f"LOCK_EXEMPT ({reason})"
    return out


@functools.lru_cache(maxsize=None)
def _summary(rel: str, tree: ast.Module):
    """The lock sites of one parsed file, and its classes' methods as
    "Class.method"."""
    methods = [f"{n.name}.{fn.name}"
               for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
               for fn in n.body
               if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))]
    return lock_sites(_site_path(rel), tree), methods


def check_lock_coverage(files: Sequence[Tuple[str, ast.Module]],
                        covered: Optional[Dict[str, str]] = None,
                        methods: Optional[Dict[str, str]] = None,
                        full_tree: bool = True) -> List[Violation]:
    """Locks built but not in the table and, over the whole tree only,
    table entries that name no lock or method the code has (an
    unregistered ``*_locked`` method is HMG201's own finding)."""
    covered = covered_sites() if covered is None else covered
    methods = GUARDED_METHODS if methods is None else methods
    out: List[Violation] = []
    built: Dict[str, Tuple[str, int]] = {}
    defined: set = set()
    for rel, tree in files:
        sites, methods_of = _summary(rel, tree)
        for key, kind, line in sites:
            built[key] = (rel, line)
            if key not in covered:
                out.append(Violation(
                    "HMG201", rel, line,
                    f"threading.{kind} built here ({key.split(':', 1)[1]}) "
                    "is in neither the port's guarded-by table nor its "
                    "exempt list (tools/staticcheck_torch.py) — declare "
                    "what it guards, or exempt it with the reason"))
        defined.update(methods_of)
    if full_tree:
        for cls, (module, owner) in sorted(LOCK_OWNERS.items()):
            lock = next((g.lock for g in GUARDED_BY if g.cls == cls), None)
            key = f"{_module_path(module)}:{owner}.{lock}"
            if lock is not None and key not in covered:
                out.append(Violation(
                    "HMG201", _module_path(module), 0,
                    f"GUARDED_BY {cls} is guarded by {owner}.{lock}, which "
                    "the table does not wrap (EXTRA_LOCK_WRAPS)"))
        for key, what in sorted(covered.items()):
            if key not in built:
                out.append(Violation(
                    "HMG201", key.split(":", 1)[0], 0,
                    f"stale table entry: {what} names {key}, which the "
                    "code no longer builds"))
        for name in sorted(methods):
            if name not in defined:
                out.append(Violation(
                    "HMG201", "tools/staticcheck_torch.py", 0,
                    f"stale GUARDED_METHODS entry: {name} is not defined"))
    return out


# --------------------------------------------------------------------- CLI
def _rel(f: Path) -> str:
    f = f.resolve()
    return f.relative_to(REPO_ROOT).as_posix() \
        if f.is_relative_to(REPO_ROOT) else f.as_posix()


def check_files(files: Sequence[Path], full_tree: bool = True,
                guards: Sequence[GuardSpec] = GUARDED_BY,
                methods: Optional[Dict[str, str]] = None,
                covered: Optional[Dict[str, str]] = None
                ) -> List[Violation]:
    """HMG201/202/204 per file, HMG203 over all of them, and the lock
    coverage; a reasoned pragma suppresses a finding on its line."""
    methods = GUARDED_METHODS if methods is None else methods
    out: List[Violation] = []
    trees: List[Tuple[str, ast.Module]] = []
    pragmas = {}
    for f in files:
        rel = _rel(f)
        source = f.read_text()
        tree = ast.parse(source, filename=rel)
        idx = scan_pragmas(rel, source)
        pragmas[rel] = idx
        vs = (check_hmg201(rel, tree, guards=guards, methods=methods)
              + check_hmg202(rel, tree, blocking=BLOCKING_CALLS,
                             lock_attrs=HMG202_LOCK_ATTRS, methods=methods)
              + check_hmg204(rel, tree, guards=guards))
        out.extend(filter_suppressed(vs, idx) + idx.violations)
        trees.append((rel, tree))
    for v in check_hmg203(trees, guards=guards,
                          acquiring=LOCK_ACQUIRING_CALLS, methods=methods):
        if v.path not in pragmas or \
                not pragmas[v.path].is_disabled(v.rule, v.line):
            out.append(v)
    for v in check_lock_coverage(trees, covered, methods, full_tree):
        if v.path not in pragmas or \
                not pragmas[v.path].is_disabled(v.rule, v.line):
            out.append(v)
    return sort_violations(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tools.staticcheck_torch",
        description="HMG201-HMG204 and lock coverage over the PyTorch port.")
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/dirs to check (default: src/repro_torch); "
                         "stale table entries are reported only over the "
                         "default tree")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the findings as a JSON array")
    args = ap.parse_args(argv)
    full = list(args.paths) == list(DEFAULT_PATHS)
    vs = check_files(iter_py_files(args.paths), full_tree=full)
    if args.as_json:
        print(json.dumps([v.__dict__ for v in vs], indent=2))
    else:
        for v in vs:
            print(v.format())
        n = len(iter_py_files(args.paths))
        print(f"{len(vs)} finding(s) over {n} file(s)" if vs else
              f"clean: {n} file(s), {len(GUARDED_BY)} guarded classes, "
              f"{len(GUARDED_METHODS)} *_locked methods")
    return 1 if vs else 0


if __name__ == "__main__":
    sys.exit(main())
