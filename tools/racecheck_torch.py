"""The PyTorch port's dynamic concurrency check: Eraser locksets,
deterministic interleavings and a copy-on-write check, over
``src/repro_torch`` (the runtime half; ``tools/staticcheck_torch.py`` is
the static half).

The generic machinery is the JAX package's (``tools/racecheck.py``):
``TrackedLock``, ``LocksetChecker``, the seeded ``Interleaver`` and its
schedule strings, and ``_wrap_class``. What is the port's own:

- ``instrument()`` patches the classes of the port's table
  (``tools/staticcheck_torch.py``), not the JAX package's;
- the canonical workload runs on a device the caller names: N searcher
  threads on modality "a" (search through the shared hot-result cache
  and the admission controller, plus ``_modality_id_rows`` and
  ``_ensure_sharded`` so the lazy caches race cold) against one writer
  confined to modality "b" (insert, delete, ``maintain``,
  ``state_tree``). Every searcher result and every writer snapshot of
  modality "a" must be bitwise the single-threaded oracle's;
- **the version check.** Torch tensors are mutable and JAX arrays are
  not: the port keeps lock-free searchers safe only by copy-on-write
  (a write builds new tensors and publishes them by assignment). At the
  start of each searcher op the harness records ``Tensor._version`` of
  every tensor of the index's published read state (every modality's
  ivf and delta fields, master vectors and ids, NSW graph, id-row and
  sharded caches, and the graph and attribute store: a search may read
  any modality through cross-modal rescoring); an in-place write to one
  of them before the op ends is reported as a version change;
- two fixtures the harness must catch: ``RacyHotResultCache`` (the
  port's cache with its lock elided) and ``inplace_delete_writer`` (a
  writer that sets the delta's tombstones in place instead of cloning);
- ``free_running``: real threads with no scheduler (searchers and the
  writer, then ``RetrievalService`` micro-batching under client threads
  against each request retrieved alone), as users run them.

    PYTHONPATH=src python -m tools.racecheck_torch --sweep --device cpu
    PYTHONPATH=src python -m tools.racecheck_torch --seed 7 --device cpu
    PYTHONPATH=src python -m tools.racecheck_torch --schedule "7:0.2.1..."

Without ``--device`` it runs on the card. Importing this module imports
neither ``jax`` nor the JAX package; the port is imported when a run
starts.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

REPO_ROOT = Path(__file__).resolve().parents[1]
for _p in (REPO_ROOT, REPO_ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import tools.racecheck as _rc  # noqa: E402
from tools.racecheck import (  # noqa: E402
    Interleaver, LocksetChecker, _wrap_class, parse_schedule)
from tools.staticcheck_torch import (  # noqa: E402
    EXTRA_LOCK_WRAPS, GUARDED_BY)


# ---------------------------------------------------------------------------
# instrumentation: the port's table
# ---------------------------------------------------------------------------

class _StepClock:
    """The spans' clock under instrumentation: each read advances it by
    one microsecond. Span times feed the histograms, whose branches
    (a new maximum) are scheduling points; a clock that depends only on
    the order of reads makes a recorded schedule replay exactly."""

    def __init__(self):
        self._mu = threading.Lock()
        self._t = 0.0

    def perf_counter(self) -> float:
        with self._mu:
            self._t += 1e-6
            return self._t

    def __getattr__(self, name):
        return getattr(time, name)


@contextmanager
def instrument(checker: Optional[LocksetChecker] = None,
               extra: Sequence[Tuple[type, Tuple[str, ...],
                                     Tuple[str, ...]]] = ()):
    """Patch every class of the port's table (and ``extra`` (cls,
    tracked_attrs, lock_attrs) triples) for the duration of the context:
    its locks become ``TrackedLock`` at construction, and guarded
    attribute accesses feed the lockset checker and the interleaver. The
    port's global obs registry is swapped for a fresh one built under the
    patches, so scheduled threads never block on a plain lock, and the
    spans' clock for a ``_StepClock``."""
    if _rc._RC is not None:
        raise RuntimeError("instrument() does not nest")
    plan: Dict[type, Tuple[set, set]] = {}

    def add(cls, tracked=(), lock_attrs=()):
        tr, lk = plan.setdefault(cls, (set(), set()))
        tr.update(tracked)
        lk.update(lock_attrs)

    for spec in GUARDED_BY:
        add(getattr(importlib.import_module(spec.module), spec.cls),
            spec.attrs, (spec.lock,))
    for module, cls, lock_attrs in EXTRA_LOCK_WRAPS:
        add(getattr(importlib.import_module(module), cls), (), lock_attrs)
    for cls, tracked, lock_attrs in extra:
        add(cls, tuple(tracked), tuple(lock_attrs))

    import repro_torch.obs.metrics as metrics_mod
    import repro_torch.obs.spans as spans_mod
    patches: list = [(spans_mod, "time", spans_mod.time)]
    spans_mod.time = _StepClock()
    for cls, (tracked, lock_attrs) in plan.items():
        _wrap_class(cls, tuple(sorted(tracked)), tuple(sorted(lock_attrs)),
                    patches)
    old_registry = metrics_mod._REGISTRY
    metrics_mod._REGISTRY = metrics_mod.MetricsRegistry()
    _rc._RC = _rc._RCState(checker)
    try:
        yield
    finally:
        _rc._RC = None
        metrics_mod._REGISTRY = old_registry
        for cls, name, orig in reversed(patches):
            setattr(cls, name, orig)


# ---------------------------------------------------------------------------
# the version check: copy-on-write of the published read state
# ---------------------------------------------------------------------------

def published_tensors(index) -> List[Tuple[str, object]]:
    """(name, tensor) for every tensor of the index's published read
    state. The modality's lazy caches are read through its ``__dict__``,
    so the check itself adds no scheduling point."""
    out: List[Tuple[str, object]] = []

    def leaves(prefix, obj, fields):
        for f in fields:
            out.append((f"{prefix}/{f}", getattr(obj, f)))

    ivf_fields = ("centroids", "data", "vmin", "scale", "ids", "counts")
    for mod, m in list(index.modalities.items()):
        p = f"m/{mod}"
        leaves(f"{p}/ivf", m.ivf, ivf_fields)
        leaves(f"{p}/delta", m.delta, type(m.delta)._fields)
        out.append((f"{p}/vectors", m.vectors))
        out.append((f"{p}/ids", m.ids))
        if m.nsw is not None:
            leaves(f"{p}/nsw", m.nsw, type(m.nsw)._fields)
        caches = vars(m)
        if caches.get("id_rows") is not None:
            out.append((f"{p}/id_rows", caches["id_rows"]))
        for s, sh in enumerate(caches.get("ivf_sharded") or ()):
            leaves(f"{p}/ivf_sharded/{s}", sh, ivf_fields)
    if index.graph is not None:
        leaves("graph", index.graph, type(index.graph)._fields)
    if index.attributes is not None:
        out.append(("attributes/values", index.attributes.values))
    if index.boosted_weights is not None:
        out.append(("boosted_weights", index.boosted_weights))
    return out


def version_mark(index) -> List[Tuple[str, object, int]]:
    return [(name, t, t._version) for name, t in published_tensors(index)]


def version_changes(mark) -> List[str]:
    """The tensors of ``mark`` written in place since it was taken."""
    return [name for name, t, v in mark if t._version != v]


# ---------------------------------------------------------------------------
# fixtures the harness must catch
# ---------------------------------------------------------------------------

def _racy_cache_class():
    from repro_torch.serving.cache import HotResultCache, query_signature
    import numpy as np

    class RacyHotResultCache(HotResultCache):
        """The port's hot-result cache with its lock elided: unguarded
        get-then-store on the entry dict and a bare store counter."""

        def lookup(self, plan, q, version):
            q = np.ascontiguousarray(q, np.float32)
            entry = self._entries.get((plan, query_signature(q)))
            if entry is None or entry[1] != version \
                    or entry[0] != q.tobytes():
                return None
            return entry[2], entry[3]

        def store(self, plan, q, version, scores, ids):
            q = np.ascontiguousarray(q, np.float32)
            self._entries[(plan, query_signature(q))] = (
                q.tobytes(), int(version), np.asarray(scores),
                np.asarray(ids))
            self._stores += 1

    return RacyHotResultCache


class _CacheFixture:
    """N threads race one lookup-or-store on one key of a cache."""

    def __init__(self, cache):
        import numpy as np
        self.cache = cache
        self.q = np.ones((1, 4), np.float32)
        self.scores = np.zeros((1, 2), np.float32)
        self.ids = np.arange(2, dtype=np.int32)[None]

    def get(self):
        hit = self.cache.lookup("plan", self.q, 0)
        if hit is None:
            self.cache.store("plan", self.q, 0, self.scores, self.ids)
            hit = self.cache.lookup("plan", self.q, 0)
        return hit


def run_cache_fixture(racy: bool, seed: int = 0, n_threads: int = 3) -> dict:
    """One seeded race over the racy cache or the port's own. Returns
    {stores, warnings, schedule}."""
    from repro_torch.serving.cache import HotResultCache
    checker = LocksetChecker()
    with instrument(checker):
        cls = _racy_cache_class() if racy else HotResultCache
        fx = _CacheFixture(cls(capacity=4))
        sched = Interleaver(seed)
        for i in range(n_threads):
            sched.spawn(fx.get, name=f"fix-{i}")
        schedule = sched.run()
        stores = vars(fx.cache)["_stores"]
    return {"stores": stores, "warnings": list(checker.warnings),
            "schedule": schedule}


def inplace_delete_writer(index, step: int, writes, snaps: list) -> None:
    """The canonical writer with one fault: its delete sets the delta's
    tombstones in place instead of building a new delta, so a searcher
    holding the published delta sees the write mid-op."""
    import torch
    upd_ids, upd, del_ids = writes
    index.insert("b", upd_ids[step], upd[step])
    with index._write_lock:
        m = index.modalities["b"]
        ids = index._tensor(del_ids[step], torch.int64)
        m.delta.tombstones[ids] = True
        m.has_dead = True
        index._bump_version()
    index.maintain("b")
    tree, _meta = index.state_tree()
    snaps.append(_a_keys(tree))


# ---------------------------------------------------------------------------
# the canonical concurrent workload
# ---------------------------------------------------------------------------

# modality "a"'s stores: the writer never touches them; "a"'s probe heat
# varies with the interleaving, so it is left out by construction
_A_KEY_PREFIXES = ("m/a/ivf/", "m/a/delta/", "m/a/vectors", "m/a/ids")

# the writer's steps, each an insert of BATCH updated rows and a delete of
# N_DEL ids; N_QUERIES query batches of Q_ROWS rows for the searchers
STEPS, BATCH, N_DEL, N_QUERIES, Q_ROWS = 3, 8, 3, 3, 2


def _a_keys(tree: dict) -> dict:
    import numpy as np
    import torch
    out = {}
    for k, v in tree.items():
        if any(k.startswith(p) for p in _A_KEY_PREFIXES):
            out[k] = (v.detach().cpu().numpy().copy()
                      if isinstance(v, torch.Tensor) else np.array(v))
    return out


def small_config():
    from repro_torch.configs.base import HMGIConfig
    return HMGIConfig(n_partitions=6, kmeans_iters=4, n_probe=4, top_k=5,
                      delta_capacity=256, maint_auto=True,
                      maint_budget_rows=96, maint_chunk=32,
                      use_nsw_refine=False, obs_sync_spans=False)


class Workload:
    """The published starting state (built once, restored into a fresh
    index for every run, so each run starts from the same bytes), the
    searchers' queries and the writer's batches. Modality "a" holds
    updated rows in its delta, so the searchers' delta scan has live rows
    to find."""

    def __init__(self, device, cfg=None, n: int = 240, d: int = 16):
        """n rows of width d (default: the JAX package's canonical size)
        under ``cfg`` (default: ``small_config()``)."""
        import numpy as np
        import torch
        from repro_torch.core.index import HMGIIndex
        self.device = torch.device(device)
        self.cfg = small_config() if cfg is None else cfg
        rng = np.random.default_rng(0)
        half = n // 2
        ids_a = np.arange(0, half, dtype=np.int32)
        ids_b = np.arange(half, n, dtype=np.int32)
        vec = rng.normal(size=(n, d)).astype(np.float32)
        index = HMGIIndex(self.cfg, seed=0, device=self.device)
        index.ingest({"a": (ids_a, vec[:half]), "b": (ids_b, vec[half:])},
                     n_nodes=n)
        index.insert("a", ids_a[:BATCH],
                     rng.normal(size=(BATCH, d)).astype(np.float32))
        tree, self.meta = index.state_tree()
        self.tree = {k: (v.detach().cpu().clone()
                         if isinstance(v, torch.Tensor) else v)
                     for k, v in tree.items()}
        self.k = int(self.cfg.top_k)
        self.queries = rng.normal(size=(N_QUERIES, Q_ROWS, d)).astype(
            np.float32)
        self.writes = (
            np.stack([rng.choice(ids_b, size=BATCH, replace=False)
                      for _ in range(STEPS)]),
            rng.normal(size=(STEPS, BATCH, d)).astype(np.float32),
            np.stack([rng.choice(ids_b, size=N_DEL, replace=False)
                      for _ in range(STEPS)]))
        self.steps = STEPS

    def fresh(self):
        from repro_torch.core.index import HMGIIndex
        index = HMGIIndex(self.cfg, seed=0, device=self.device)
        index.restore_state(self.tree, self.meta)
        return index


def serving_state():
    """One hot-result cache and one admission controller with a tenant
    always admitted ("hot") and one always rejected ("zero"): outcomes
    that cannot depend on the interleaving."""
    from repro_torch.serving.cache import HotResultCache
    from repro_torch.serving.scheduler import (AdmissionController,
                                               TenantQuota)
    return (HotResultCache(capacity=8),
            AdmissionController({"hot": TenantQuota(rate=0.0, burst=1e9),
                                 "zero": TenantQuota(rate=0.0, burst=0.0)}))


def searcher_op(index, q, k: int, cache=None, admission=None):
    """One searcher round on modality "a": admission, the search through
    the shared cache (lookup-or-store, stamped with ``index.version``),
    and both lazy caches. Returns (scores, ids, id_rows, version
    changes)."""
    mark = version_mark(index)
    if admission is not None:
        assert admission.try_admit("hot", now=0.0), "hot tenant starved"
        assert not admission.try_admit("zero", now=0.0), \
            "zero-quota tenant admitted"
    if cache is not None:
        version = index.version
        hit = cache.lookup(("a", k), q, version)
        if hit is None:
            sv, si = index.search(q, "a", k=k)
            sv, si = sv.cpu().numpy(), si.cpu().numpy()
            cache.store(("a", k), q, version, sv, si)
        else:
            sv, si = hit
    else:
        sv, si = index.search(q, "a", k=k)
        sv, si = sv.cpu().numpy(), si.cpu().numpy()
    rows = index._modality_id_rows("a").cpu().numpy()
    index._ensure_sharded("a", 1)
    return sv, si, rows, version_changes(mark)


def writer_op(index, step: int, writes, snaps: list) -> None:
    upd_ids, upd, del_ids = writes
    index.insert("b", upd_ids[step], upd[step])
    index.delete("b", del_ids[step])
    index.maintain("b")
    tree, _meta = index.state_tree()
    snaps.append(_a_keys(tree))


def _oracle(wl: Workload, n_searchers: int, writer=writer_op):
    """Single-threaded: every searcher round, then the whole writer."""
    import numpy as np
    index = wl.fresh()
    cache, admission = serving_state()
    expected = [searcher_op(index, wl.queries[i % len(wl.queries)], wl.k,
                            cache, admission)[:3]
                for i in range(n_searchers)]
    snaps: List[dict] = []
    for step in range(wl.steps):
        writer(index, step, wl.writes, snaps)
    for s in snaps[1:]:
        for k0, v in snaps[0].items():
            assert np.array_equal(s[k0], v), \
                f"oracle modality-a state drifted at {k0} (workload bug: " \
                "the writer must be confined to modality b)"
    return expected, snaps[0]


def _compare(expected, oracle_snap, results, snaps) -> List[str]:
    import numpy as np
    out: List[str] = []
    for i, rounds in results.items():
        esv, esi, erows = expected[i]
        for r, (sv, si, rows, _chg) in enumerate(rounds):
            for what, got, want in (("scores", sv, esv), ("ids", si, esi),
                                    ("id_rows", rows, erows)):
                if not np.array_equal(got, want):
                    out.append(f"searcher-{i} round {r}: {what} diverge")
    for step, snap in enumerate(snaps):
        for k0, v in oracle_snap.items():
            if not np.array_equal(snap[k0], v):
                out.append(f"writer snapshot step {step}: modality-a key "
                           f"{k0} diverges")
    return out


def _changes(results) -> List[str]:
    return [f"searcher-{i} round {r}: {name} written in place"
            for i, rounds in results.items()
            for r, res in enumerate(rounds) for name in res[3]]


def canonical_workload(seed: int = 0, schedule: Optional[str] = None, *,
                       workload: Optional[Workload] = None,
                       device="cpu", n_searchers: int = 3, rounds: int = 2,
                       timeout_s: float = 120.0,
                       writer=writer_op) -> dict:
    """One seeded (or replayed) run of the canonical workload: the oracle
    single-threaded, then a fresh index from the same state with
    ``n_searchers`` searcher threads x ``rounds`` racing one writer under
    the interleaver. Returns seed, schedule, points (scheduling choices),
    ops, warnings, mismatches, version_changes and ok."""
    if schedule is not None:
        seed, replay = parse_schedule(schedule)
    else:
        replay = None
    checker = LocksetChecker()
    with instrument(checker):
        wl = Workload(device) if workload is None else workload
        expected, oracle_snap = _oracle(wl, n_searchers, writer)
        index = wl.fresh()
        cache, admission = serving_state()
        sched = Interleaver(seed, replay=replay, timeout_s=timeout_s)
        results: Dict[int, list] = {i: [] for i in range(n_searchers)}
        snaps: List[dict] = []

        def searcher(i: int) -> None:
            for _ in range(rounds):
                results[i].append(searcher_op(
                    index, wl.queries[i % len(wl.queries)], wl.k, cache,
                    admission))

        def write() -> None:
            for step in range(wl.steps):
                writer(index, step, wl.writes, snaps)

        for i in range(n_searchers):
            sched.spawn(searcher, i, name=f"searcher-{i}")
        sched.spawn(write, name="writer")
        sched_str = sched.run()
    mismatches = _compare(expected, oracle_snap, results, snaps)
    changes = _changes(results)
    warnings = list(checker.warnings)
    return {"seed": seed, "schedule": sched_str,
            "points": len(sched.choices),
            "ops": n_searchers * rounds + wl.steps,
            "warnings": warnings, "mismatches": mismatches,
            "version_changes": changes,
            "ok": not warnings and not mismatches and not changes}


def free_running(workload: Workload, n_searchers: int = 8,
                 rounds: int = 4) -> dict:
    """Real threads, no scheduler: ``n_searchers`` searchers and the
    writer start together on one barrier. Results are held to the oracle
    bitwise and every searcher op to the version check."""
    expected, oracle_snap = _oracle(workload, n_searchers)
    index = workload.fresh()
    cache, admission = serving_state()
    results: Dict[int, list] = {i: [] for i in range(n_searchers)}
    snaps: List[dict] = []
    errors: List[BaseException] = []
    gate = threading.Barrier(n_searchers + 1)

    def run(fn):
        try:
            gate.wait()
            fn()
        except BaseException as e:          # surfaced below
            errors.append(e)

    def searcher(i):
        for _ in range(rounds):
            results[i].append(searcher_op(
                index, workload.queries[i % len(workload.queries)],
                workload.k, cache, admission))

    def write():
        for step in range(workload.steps):
            writer_op(index, step, workload.writes, snaps)

    threads = [threading.Thread(target=run, args=(lambda i=i: searcher(i),))
               for i in range(n_searchers)]
    threads.append(threading.Thread(target=run, args=(write,)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    mismatches = _compare(expected, oracle_snap, results, snaps)
    changes = _changes(results)
    return {"ops": n_searchers * rounds + workload.steps,
            "mismatches": mismatches, "version_changes": changes,
            "ok": not mismatches and not changes}


def service_clients(index, queries, n_clients: int = 16, per_client: int = 4,
                    k: int = 10, window_s: float = 0.001) -> dict:
    """``RetrievalService`` with micro-batching, a hot-result cache and
    admission, under ``n_clients`` client threads, each sending
    ``per_client`` of ``queries`` (clients overlap, so batches mix, dedup
    and hit the cache). Every response must be bitwise the request
    retrieved alone (``run_plan`` over that one row)."""
    import numpy as np
    from repro_torch.serving.cache import HotResultCache
    from repro_torch.serving.retrieval import (RetrievalPlan,
                                               RetrievalService, run_plan)
    from repro_torch.serving.scheduler import AdmissionController
    plan = RetrievalPlan(modality="a", k=k)
    solo = [run_plan(index, plan, queries[i:i + 1])
            for i in range(queries.shape[0])]
    svc = RetrievalService(index, batching=True, window_s=window_s,
                           cache=HotResultCache(capacity=64),
                           admission=AdmissionController())
    got: Dict[Tuple[int, int], tuple] = {}
    errors: List[BaseException] = []
    gate = threading.Barrier(n_clients)

    def client(c):
        try:
            gate.wait()
            for j in range(per_client):
                i = (c * 3 + j * 5) % queries.shape[0]
                got[(c, j)] = (i, svc.search(plan, queries[i], tenant="t"))
        except BaseException as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    bad = [f"client {c} request {j} (query {i}) differs from alone"
           for (c, j), (i, res) in sorted(got.items())
           if res is None or not (np.array_equal(res[0], solo[i][0])
                                  and np.array_equal(res[1], solo[i][1]))]
    return {"requests": len(got), "mismatches": bad, "ok": not bad}


def cache_selftest(seeds: Sequence[int]) -> Tuple[int, int]:
    """Across ``seeds``: the racy cache must draw a lockset warning (or
    store twice) under at least one schedule, and the port's cache must
    never draw a warning. Returns (racy catches, guarded failures)."""
    catches = failures = 0
    for s in seeds:
        r = run_cache_fixture(True, seed=s)
        catches += bool(r["warnings"] or r["stores"] > 1)
        g = run_cache_fixture(False, seed=s)
        failures += bool(g["warnings"])
    return catches, failures


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tools.racecheck_torch",
        description="The port's dynamic race check: Eraser locksets, "
                    "deterministic interleavings and the copy-on-write "
                    "version check over the canonical workload.")
    ap.add_argument("--sweep", action="store_true",
                    help="the fixture selftests, then the canonical "
                         "workload under --seeds seeded schedules")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=None,
                    help="run the canonical workload under one seed")
    ap.add_argument("--schedule", type=str, default=None,
                    help="replay a recorded schedule ('<seed>:<i>.<i>...')")
    ap.add_argument("--searchers", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-thread stall timeout (seconds)")
    ap.add_argument("--device", default="cuda",
                    help="where the index lives (default: the card)")
    args = ap.parse_args(argv)

    def report(r) -> bool:
        for w in r["warnings"]:
            print(f"  warning: {w}", file=sys.stderr)
        for m0 in r["mismatches"] + r["version_changes"]:
            print(f"  mismatch: {m0}", file=sys.stderr)
        if not r["ok"]:
            print(f"  repro: python -m tools.racecheck_torch --device "
                  f"{args.device} --schedule '{r['schedule']}'",
                  file=sys.stderr)
        return r["ok"]

    kw = dict(device=args.device, n_searchers=args.searchers,
              rounds=args.rounds, timeout_s=args.timeout)
    failed = False
    if args.sweep:
        t0 = time.perf_counter()
        n_fix = 8
        catches, bad = cache_selftest(range(n_fix))
        print(f"fixture selftest: racy cache caught under {catches} of "
              f"{n_fix} seeds; the port's cache clean ({bad} failures)")
        failed |= catches == 0 or bad > 0
        r = canonical_workload(0, writer=inplace_delete_writer, **kw)
        print(f"in-place delta writer: {len(r['version_changes'])} version "
              "changes (must be > 0)")
        failed |= not r["version_changes"]
        wl = Workload(args.device)
        for s in range(args.seeds):
            r = canonical_workload(s, workload=wl, **kw)
            print(f"seed {s:3d}: {'ok' if r['ok'] else 'FAIL'}  "
                  f"({r['points']} scheduling points)")
            failed |= not report(r)
        print("sweep: " + ("FAILED" if failed else
                           f"clean across {args.seeds} seeds (zero lockset "
                           "warnings, zero version changes, bitwise "
                           f"results) in {time.perf_counter() - t0:.1f} s"))
    elif args.schedule is not None or args.seed is not None:
        r = canonical_workload(args.seed or 0, schedule=args.schedule, **kw)
        if report(r):
            s = r["schedule"]
            print(f"ok (schedule '{s[:60]}{'...' if len(s) > 60 else ''}')")
        else:
            failed = True
    else:
        ap.print_help()
        return 2
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
