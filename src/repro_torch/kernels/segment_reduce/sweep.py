"""Sweep of the segment-sum kernels' plans and build settings on the card.

    python -m repro_torch.kernels.segment_reduce.sweep [--mode acc|sum]
        [--out FILE] [--baseline DIR] [--shapes NAME,...]

Builds ``csrc/segment_reduce.cu`` once per build setting, all at once,
into ``build/repro_torch_kernels/sweep/``, and reports ptxas' registers and
spills of every instance of each build (keyed
"team|rows/<dtype>/v<V>[/nc<NC>]/<perm>/<add|sum>"). Then, at the main
paths' shapes, it holds every plan against the plain version bit for bit
and times it (CUDA events, L2 flushed, median of 10) beside a bound that
counts each entry, index and row once, and beside one ``index_add_``.

``--mode acc`` (the default), the in-place kernel: the settings of
``SEG_ACC_UNROLL`` (entries' rows in flight), ``SEG_ACC_PREFETCH`` (output
rows loaded ahead), ``SEG_ACC_MIN_BLOCKS`` (blocks an SM the registers must
allow) and ``SEG_ACC_STAGES`` (gathered one-element fp32 rows staged
through a shared-memory ring of that many entries by ``cp.async``; 0: in
registers), at ``shapes``: EGNN's 67 fp32 block of the ogbn-products graph
(``LocalExec`` over ``make_flat_graph(2,449,029, 61,859,140)``, block 0's
1,048,576 edges), NequIP's 291 on that graph's first 524,288 edges,
Equiformer-v2's 6,275 fp32 on a 65,536-edge block of its minibatch union
(distinct sources; destinations in trees of 1 + 15 + 150 nodes, the root
taking 15 edges, each first-hop node 10, the leaves none) and on its
molecule cell's one block (the engine over 128 molecules of 30 nodes and
64 edges, ``driver.make_molecule_batch``), DimeNet's 128, phi4-mini's
4,096 tokens of 3,072 bf16, xDeepFM's 39 fields of 65,536 rows at widths
10 and 1, each side as the transposes run it: distinct rows with a perm,
or a range from ``seg_lo``. The bound counts each touched row read and
written once; ``index_add_`` adds into the same buffer in place. Plans:
``ops.acc_plan``'s, and its neighbours (the wide route at each other slice
count the instances allow and twice the plan's, the team route at 1, 2,
4, 8 and 16 segments a team); the plan under each build setting, and
EGNN's at other group sizes.

``--mode sum``, the summing kernel: the settings of ``SEG_SUM_UNROLL``,
``SEG_SUM_MIN_BLOCKS`` and ``SEG_SUM_STAGES`` (the entries of the ring
that gathered rows of 4-byte or wider vectors and streamed rows of
16-byte vectors come through; 0: in registers), at ``sum_shapes``: one
EGNN layer (all
61,859,140 edges of that graph × 68 fp32, no perm), NequIP's push chunk
(that graph's first 36,709 rows × 289), Equiformer-v2's ``push_attn``
chunk (42,790 tree-shaped edges × 6,272), DimeNet's triplets into edges
(41,008 × 128 into 10,556 rows, perm), xDeepFM's EmbeddingBag (65,536 bags
of 1-40 rows × 10, sorted bag ids: a near-identity perm), k-means'
``run_sums`` at serve_1m (1,048,576 × 384 in runs of 256 over 64 clusters,
perm; then the runs into the clusters) and the hop operator's
out-degrees (131,072 nodes of 0-16 edges × 1). Each row is written once
into a NaN-filled buffer; ``index_add_`` adds into a zeroed one. Plans:
``ops.sum_plan``'s, its neighbours (the wide route at other slice
counts, other groups on every route, narrower loads), each under every
setting.

``--baseline DIR`` also builds ``DIR``'s ``segment_reduce.cu`` (a
checkout such as the parent commit unpacked under ``build/``) and times
its kernel at each shape in turns with the plan (baseline, plan, plan,
baseline): in acc mode its in-place entry, which takes the same plan; in
sum mode its summing entry, where it is the first, one-warp-a-segment
kernel, ``(msg, rowptr, perm, out, n_seg, d, is_bf16, vec, stream)``.
Prints one JSON line per shape (and writes them all to ``--out`` if
given). Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce import ops
from repro_torch.kernels.segment_reduce.ref import (
    csr_from_ids, segment_sum_csr_accumulate_ref, segment_sum_csr_ref)
from repro_torch.sparse.segment import csr_by_row

# (unroll, prefetch, min blocks, stages); the first is the source's default
SETTINGS = ((4, 4, 4, 4), (4, 4, 4, 0), (2, 4, 4, 4), (8, 4, 3, 4),
            (8, 8, 2, 4), (4, 4, 4, 8))
# the summing mode's (unroll, min blocks, stages); the first is the
# source's default
SUM_SETTINGS = ((4, 4, 8), (4, 4, 4), (4, 4, 0), (8, 4, 8), (4, 5, 8))
EGNN_GROUPS = {"source": (4, 8, 16, 31), "destination": (1, 2, 4)}
N_NODES, N_EDGES = 2_449_029, 61_859_140
_INSTANCE = re.compile(r"segment_(sum|accumulate)_kernel(_team)?I"
                       r"(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?Lb([01])E")
_BASELINE_SUM_ARGTYPES = [ops._P] * 4 + [ops._I] * 4 + [ops._P]


def _ptxas(stderr: str) -> dict:
    """{"team|rows/<dtype>/v<V>[/nc<NC>]/<perm>/<add|sum>": (registers,
    spill store bytes, spill load bytes)} of every instance."""
    out, lines = {}, stderr.splitlines()
    for i, text in enumerate(lines):
        hit = _INSTANCE.search(text)
        if not (hit and "Compiling entry" in text):
            continue
        info = " ".join(lines[i + 1:i + 6])
        r = re.search(r"Used (\d+) registers", info)
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      info)
        mode, team, dt, v, nc, perm = hit.groups()
        key = "/".join(["team" if team else "rows",
                        "f32" if dt == "f" else "bf16", f"v{v}"]
                       + ([] if team else [f"nc{nc}"])
                       + ["perm" if perm == "1" else "noperm",
                          "add" if mode == "accumulate" else "sum"])
        out[key] = (int(r.group(1)) if r else None,
                    int(s.group(1)) if s else None,
                    int(s.group(2)) if s else None)
    return out


def _build_lib(src: Path, tag: str, defines=()):
    out = _build.BUILD_DIR / "sweep" / f"libsegment_reduce_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *defines,
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stderr, time.perf_counter() - t0


def _entry(lib, mode: str, argtypes=None):
    fn = (lib.segment_sum_csr_accumulate if mode == "acc"
          else lib.segment_sum_csr)
    fn.argtypes = argtypes or (ops._ACC_ARGTYPES if mode == "acc"
                               else ops._ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def build(setting, mode: str):
    """(tag, the mode's C entry, ptxas' report, nvcc seconds)."""
    if mode == "acc":
        u, p, m, st = setting
        tag = f"u{u}p{p}m{m}" + (f"s{st}" if st else "")
        defines = (f"-DSEG_ACC_UNROLL={u}", f"-DSEG_ACC_PREFETCH={p}",
                   f"-DSEG_ACC_MIN_BLOCKS={m}", f"-DSEG_ACC_STAGES={st}")
    else:
        u, m, r = setting
        tag = f"sum_u{u}m{m}r{r}"
        defines = (f"-DSEG_SUM_UNROLL={u}", f"-DSEG_SUM_MIN_BLOCKS={m}",
                   f"-DSEG_SUM_STAGES={r}")
    lib, log, secs = _build_lib(ops._SRC, tag, defines)
    return tag, _entry(lib, mode), _ptxas(log), secs


def build_baseline(root: str, mode: str):
    src = (Path(root) / "src" / "repro_torch" / "kernels" / "segment_reduce"
           / "csrc" / "segment_reduce.cu")
    lib, _, secs = _build_lib(src, f"baseline_{mode}")
    return _entry(lib, mode, None if mode == "acc"
                  else _BASELINE_SUM_ARGTYPES), secs


def _source(idx):
    """A gather's transpose over its distinct rows: (rowptr, perm, rows,
    seg_lo, idx)."""
    rp, perm, rows = csr_by_row(idx)
    return rp, perm, rows, 0, idx.long()


def _destination(dst):
    """Edges sorted by destination, added over their range of rows."""
    lo, hi = int(dst[0]), int(dst[-1]) + 1
    rp = torch.searchsorted(dst, torch.arange(
        lo, hi + 1, dtype=dst.dtype, device=dst.device)).to(torch.int32)
    return rp, None, None, lo, dst.long()


def _tree_destinations(e):
    """The destination side of ``e`` edges of a minibatch union: trees of
    1 + 15 + 150 nodes, the root taking 15 edges and each first-hop node
    10, from the first tree's root on."""
    per = torch.tensor([15] + [10] * 15 + [0] * 150, device="cuda")
    deg = per.repeat(-(-e // 165))
    dst = torch.repeat_interleave(torch.arange(deg.numel(), device="cuda",
                                               dtype=torch.int32), deg)
    return _destination(dst[:e].contiguous())


def _flat_exec():
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import LocalExec
    return LocalExec(gd.make_flat_graph(N_NODES, N_EDGES, 1, seed=0))


def shapes(gen):
    """name -> (d, dtype, rows of the buffer, a thunk of the CSR)."""
    from repro_torch.configs import get_config
    from repro_torch.models.gnn import driver as gd
    ex = _flat_exec()
    e, en = ex.block, 524_288
    mol = gd.engine(get_config("equiformer-v2"), gd.disjoint_union(
        gd.make_molecule_batch(128, 30, 64, seed=0)[0]))
    em = min(mol.block, mol.n_edges)

    def rnd(hi, n):
        return torch.randint(0, hi, (n,), device="cuda", generator=gen,
                             dtype=torch.int32)

    eq = 65_536
    fields = (torch.arange(39, device="cuda", dtype=torch.int32) * 100_000
              + rnd(100_000, 65_536 * 39).view(65_536, 39)).reshape(-1)
    return {
        "egnn_67.source": (67, torch.float32, N_NODES,
                           lambda: _source(ex.src[:e])),
        "egnn_67.destination": (67, torch.float32, N_NODES,
                                lambda: _destination(ex.dst[:e])),
        "nequip_291.source": (291, torch.float32, N_NODES,
                              lambda: _source(ex.src[:en])),
        "nequip_291.destination": (291, torch.float32, N_NODES,
                                   lambda: _destination(ex.dst[:en])),
        "equiformer_6275.source": (6275, torch.float32, 170_000, lambda:
                                   _source(torch.randperm(
                                       170_000, device="cuda", generator=gen)
                                       [:eq].int())),
        "equiformer_6275.destination": (6275, torch.float32, 170_000,
                                        lambda: _tree_destinations(eq)),
        "equiformer_6275_molecule.source": (6275, torch.float32, mol.n,
                                            lambda: _source(mol.src[:em])),
        "equiformer_6275_molecule.destination": (
            6275, torch.float32, mol.n, lambda: _destination(mol.dst[:em])),
        "dimenet_128": (128, torch.float32, 10_556,
                        lambda: _source(rnd(10_556, 41_008))),
        "token_3072_bf16": (3072, torch.bfloat16, 200_064,
                            lambda: _source(rnd(200_064, 4_096))),
        "xdeepfm_10": (10, torch.float32, 3_900_000,
                       lambda: _source(fields)),
        "xdeepfm_1": (1, torch.float32, 3_900_000, lambda: _source(fields)),
    }


def sum_shapes(gen):
    """name -> (d, a thunk of (messages, rowptr, perm)), fp32."""
    ex = _flat_exec()

    def msgs(e, d):
        return torch.randn((e, d), device="cuda", generator=gen)

    def egnn():
        return msgs(ex.n_edges, 68), ex.rowptr, None

    def nequip():
        rp = ex.rowptr[:36_710].contiguous()
        return msgs(int(rp[-1]), 289), rp, None

    def equiformer():
        rp = _tree_destinations(42_790)[0]
        return msgs(42_790, 6272), rp, None

    def dimenet():
        ids = torch.randint(0, 10_556, (41_008,), device="cuda",
                            generator=gen, dtype=torch.int32)
        return (msgs(41_008, 128), *csr_from_ids(ids, 10_556))

    def bag():
        sizes = torch.randint(1, 41, (65_536,), device="cuda", generator=gen)
        bags = torch.repeat_interleave(torch.arange(65_536, device="cuda"),
                                       sizes).to(torch.int32)
        return (msgs(bags.numel(), 10), *csr_from_ids(bags, 65_536))

    def kmeans(side):
        from repro_torch.core.partitioner import run_csr
        x = msgs(1 << 20, 384)
        x /= x.norm(dim=1, keepdim=True)
        a = torch.randint(0, 64, (1 << 20,), device="cuda", generator=gen)
        starts, perm, run_ptr = run_csr(a, 64)
        if side == "runs":
            return x, starts, perm
        return msgs(int(run_ptr[-1]), 384), run_ptr, None

    def degrees():
        deg = torch.randint(0, 17, (131_072,), device="cuda", generator=gen)
        rp = torch.zeros(131_073, dtype=torch.int32, device="cuda")
        rp[1:] = deg.cumsum(0)
        return msgs(int(rp[-1]), 1), rp, None

    return {"egnn_68": (68, egnn), "nequip_289": (289, nequip),
            "equiformer_6272": (6272, equiformer),
            "dimenet_128": (128, dimenet), "xdeepfm_bag_10": (10, bag),
            "kmeans_384.runs": (384, lambda: kmeans("runs")),
            "kmeans_384.clusters": (384, lambda: kmeans("clusters")),
            "degrees_1": (1, degrees)}


def regrid(plan: ops.AccPlan, n_seg: int, **kw) -> ops.AccPlan:
    """``plan`` with the fields ``kw`` changed and its warps and grid
    counted again."""
    plan = plan._replace(**kw)
    warps = -(-n_seg // plan.group) * plan.slices
    return plan._replace(warps=warps, grid=min(-(-warps // 8),
                                               ops._ACC_BLOCKS_CAP))


def _slicings(plan: ops.AccPlan, d: int, es: int) -> list:
    """(slices, width) of every other balanced slice count the instances
    allow (at most 4 registers a lane), and twice the plan's."""
    n_vec = d // plan.vec
    lane_vecs = ops.ACC_LANE_REGS // max(1, plan.vec * es // 4)
    out = {-(-n_vec // (32 * nc)) for nc in range(1, lane_vecs + 1)}
    out.add(min(n_vec, 2 * plan.slices))
    cuts = []
    for s in sorted(out - {plan.slices}):
        per = -(-n_vec // s)
        cuts.append((-(-n_vec // per), per * plan.vec))
    return cuts


def neighbours(plan: ops.AccPlan, d: int, es: int, n_seg: int) -> list:
    """Other in-place plans of the same route: the wide route's other
    slicings; 1, 2, 4, 8 and 16 segments a team (team)."""
    if plan.route == "team":
        teams = 32 // (d // plan.vec)
        groups = sorted({m * teams for m in (1, 2, 4, 8, 16)} - {plan.group})
        return [regrid(plan, n_seg, group=g) for g in groups]
    if plan.route == "medium":
        return []
    return [regrid(plan, n_seg, slices=s, width=w)
            for s, w in _slicings(plan, d, es)]


def sum_neighbours(plan: ops.AccPlan, d: int, es: int, n_seg: int) -> list:
    """Other summing plans: 1, 2, 4 and 8 segments a team (team); 1, 2, 4,
    8, 16 and 31 segments a warp (medium, wide); the wide route's other
    slicings at the plan's group; the row kernel's routes at 8- and 4-byte
    loads."""
    if plan.route == "team":
        teams = 32 // (d // plan.vec)
        groups = {m * teams for m in (1, 2, 4, 8)}
    else:
        groups = {1, 2, 4, 8, 16, 31}
    out = [regrid(plan, n_seg, group=g) for g in sorted(groups - {plan.group})]
    if plan.route == "wide":
        out += [regrid(plan, n_seg, slices=s, width=w)
                for s, w in _slicings(plan, d, es)]
    if plan.route != "team":                    # narrower loads' routes
        for nbytes in (8, 4):
            route, s, w, v = ops._route(d, es, (nbytes,))
            if v < plan.vec and route != "team":
                out.append(regrid(plan, n_seg, route=route, slices=s,
                                  width=w, vec=v))
    return out


def _timer():
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def timed(fn):
        fn()
        times = []
        for _ in range(10):
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))
    return timed


def run_acc(args, built, base_fn, result) -> None:
    gen = torch.Generator(device="cuda").manual_seed(31)
    stream = torch.cuda.current_stream().cuda_stream
    default_fn = built[0][1]
    timed = _timer()
    table = shapes(gen)
    names = args.shapes.split(",") if args.shapes else list(table)
    for name in names:
        d, dtype, n_rows, make = table[name]
        rp, perm, rows, lo, idx = make()
        r = rp.numel() - 1
        e = idx.numel()
        cot = torch.randn((e, d), device="cuda", generator=gen).to(dtype)
        base = torch.randn((n_rows, d), device="cuda", generator=gen).to(dtype)
        want = segment_sum_csr_accumulate_ref(cot, rp, perm, out=base.clone(),
                                              rows=rows, seg_lo=lo)
        es = cot.element_size()
        nbytes = (e * d * es + (0 if perm is None else e * 4) + (r + 1) * 4
                  + (0 if rows is None else r * 4) + 2 * r * d * es)
        out = base.clone()
        lib = base.clone()
        ptrs = (cot.data_ptr(), out.data_ptr(), rp.data_ptr(),
                None if perm is None else perm.data_ptr(),
                None if rows is None else rows.data_ptr())

        def call(fn, plan, dst):
            err = fn(cot.data_ptr(), ptrs[2], ptrs[3], ptrs[4],
                     dst.data_ptr(), r, d, lo, int(dtype == torch.bfloat16),
                     int(plan.route != "team"), plan.vec, plan.group,
                     plan.slices, plan.grid, stream)
            if err:
                raise RuntimeError(f"sweep: {name} {plan}: CUDA error {err}")

        def held(fn, plan):
            fresh = base.clone()
            call(fn, plan, fresh)
            if not torch.equal(fresh, want):
                raise SystemExit(f"sweep: {name} {plan} differs from the "
                                 f"plain version")
            ms = timed(lambda: call(fn, plan, out))
            return dict(plan=plan._asdict(), ms=ms,
                        tb_s=nbytes / (ms * 1e-3) / 1e12)

        plan = ops.accumulate_plan(cot, rp, perm, out)
        row = {"shape": dict(E=e, d=d, rows=r, n=n_rows,
                             dtype=str(dtype).removeprefix("torch."),
                             perm=perm is not None),
               "bound_ms": nbytes / 3.35e12 * 1e3, "gbytes": nbytes / 1e9,
               "index_add_in_place_ms": timed(
                   lambda: lib.index_add_(0, idx, cot))}
        if base_fn is not None:
            turns = [held(base_fn, plan)["ms"], held(default_fn, plan)["ms"],
                     held(default_fn, plan)["ms"], held(base_fn, plan)["ms"]]
            row["baseline_vs_plan_ms"] = dict(turns=turns)
        row["plan"] = held(default_fn, plan)
        row["neighbours"] = [held(default_fn, p)
                             for p in neighbours(plan, d, es, r)]
        row["settings"] = {tag: held(fn, plan)["ms"] for tag, fn, _, _ in built}
        if name.startswith("egnn_67"):
            side = name.split(".")[1]
            row["groups"] = {g: held(default_fn, regrid(plan, r, group=g))
                             ["ms"] for g in EGNN_GROUPS[side]}
        result[name] = row
        print(json.dumps({name: row}), flush=True)
        del cot, base, want, out, lib
        torch.cuda.empty_cache()


def run_sum(args, built, base_fn, result) -> None:
    gen = torch.Generator(device="cuda").manual_seed(37)
    stream = torch.cuda.current_stream().cuda_stream
    default_fn = built[0][1]
    timed = _timer()
    table = sum_shapes(gen)
    names = args.shapes.split(",") if args.shapes else list(table)
    for name in names:
        d, make = table[name]
        msg, rp, perm = make()
        e, n = msg.shape[0], rp.numel() - 1
        want = segment_sum_csr_ref(msg, rp, perm)
        nbytes = (int(rp[-1] - rp[0]) * d * 4 + n * d * 4 + (n + 1) * 4
                  + (0 if perm is None else int(rp[-1] - rp[0]) * 4))
        out = torch.empty((n, d), device="cuda")
        pm = None if perm is None else perm.data_ptr()

        def call(fn, plan, dst):
            err = fn(msg.data_ptr(), rp.data_ptr(), pm, dst.data_ptr(), n, d,
                     0, int(plan.route != "team"), plan.vec, plan.group,
                     plan.slices, plan.grid, stream)
            if err:
                raise RuntimeError(f"sweep: {name} {plan}: CUDA error {err}")

        def old(dst):
            vec = ops._vector_width(d, 4, msg.data_ptr(), dst.data_ptr())
            err = base_fn(msg.data_ptr(), rp.data_ptr(), pm, dst.data_ptr(),
                          n, d, 0, vec, stream)
            if err:
                raise RuntimeError(f"sweep: baseline {name}: CUDA error {err}")

        def held(fn, label):
            fresh = torch.full_like(out, float("nan"))
            fn(fresh)
            if not torch.equal(fresh, want):
                raise SystemExit(f"sweep: {name} {label} differs from the "
                                 f"plain version")
            return timed(lambda: fn(out))

        def plan_ms(fn, plan):
            ms = held(lambda dst: call(fn, plan, dst), plan)
            return dict(plan=plan._asdict(), ms=ms,
                        tb_s=nbytes / (ms * 1e-3) / 1e12)

        deg = (rp[1:] - rp[:-1]).long()
        pos = torch.repeat_interleave(torch.arange(n, device="cuda"), deg)
        ids = torch.full((e,), n, dtype=torch.int64, device="cuda")
        if perm is None:
            ids[int(rp[0]):int(rp[0]) + pos.numel()] = pos
        else:
            ids[perm[int(rp[0]):int(rp[-1])].long()] = pos
        lib = torch.zeros((n + 1, d), device="cuda")
        plan = ops.summing_plan(msg, rp, perm, out)
        row = {"shape": dict(E=int(rp[-1] - rp[0]), d=d, n=n, dtype="float32",
                             perm=perm is not None),
               "bound_ms": nbytes / 3.35e12 * 1e3, "gbytes": nbytes / 1e9,
               "index_add_ms": timed(lambda: lib.index_add_(0, ids, msg))}
        del lib, ids, pos
        if base_fn is not None:
            turns = [held(old, "baseline"), plan_ms(default_fn, plan)["ms"],
                     plan_ms(default_fn, plan)["ms"], held(old, "baseline")]
            row["baseline_vs_plan_ms"] = dict(turns=turns)
        row["plan"] = plan_ms(default_fn, plan)
        row["neighbours"] = [plan_ms(default_fn, p)
                             for p in sum_neighbours(plan, d, 4, n)]
        row["settings"] = {tag: plan_ms(fn, plan)["ms"]
                           for tag, fn, _, _ in built}
        row["grid"] = [dict(plan=p._asdict(), ms={
            tag: plan_ms(fn, p)["ms"] for tag, fn, _, _ in built[1:]})
            for p in sum_neighbours(plan, d, 4, n)]
        result[name] = row
        print(json.dumps({name: row}), flush=True)
        del msg, want, out
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("acc", "sum"), default="acc",
                    help="the in-place kernel (acc) or the summing one (sum)")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    ap.add_argument("--baseline", default=None,
                    help="a checkout whose kernel is timed beside")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated names of the shapes to run (all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep: needs a CUDA device")
    jobs = [lambda s=s: build(s, args.mode)
            for s in (SETTINGS if args.mode == "acc" else SUM_SETTINGS)]
    if args.baseline:
        jobs.append(lambda: build_baseline(args.baseline, args.mode))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = [f.result() for f in [pool.submit(j) for j in jobs]]
    base_fn = None
    result = {}
    if args.baseline:
        base_fn, result["baseline_nvcc_s"] = built.pop()
    result.update(card=torch.cuda.get_device_name(0), mode=args.mode,
                  builds={tag: {"nvcc_s": secs, "ptxas": regs}
                          for tag, _, regs, secs in built})
    print(json.dumps({"builds": result["builds"]}), flush=True)
    (run_acc if args.mode == "acc" else run_sum)(args, built, base_fn, result)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
