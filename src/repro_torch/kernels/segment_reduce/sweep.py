"""Sweep of the in-place segment-sum kernel's plans and build settings on
the card.

    python -m repro_torch.kernels.segment_reduce.sweep [--out FILE]
        [--baseline DIR] [--shapes NAME,...]

Builds ``csrc/segment_reduce.cu`` once per setting of ``SEG_ACC_UNROLL``
(entries' rows in flight), ``SEG_ACC_PREFETCH`` (output rows loaded ahead),
``SEG_ACC_MIN_BLOCKS`` (blocks an SM the registers must allow) and
``SEG_ACC_STAGES`` (one-element fp32 rows staged through a shared-memory
ring of that many entries by ``cp.async``; 0: in registers), all at
once, into ``build/repro_torch_kernels/sweep/``, and reports ptxas'
registers and spills of every in-place instance of each build. Then, at
the main paths' shapes (``SHAPES``: EGNN's 67 fp32 block of the
ogbn-products graph (``LocalExec`` over ``make_flat_graph(2,449,029,
61,859,140)``, block 0's 1,048,576 edges), NequIP's 291 on that graph's
first 524,288 edges, Equiformer-v2's 6,275 fp32 on a 65,536-edge block
of its minibatch union (distinct sources; destinations in trees of 1 +
15 + 150 nodes, the root taking 15 edges, each first-hop node 10, the
leaves none) and on its molecule cell's one block (the engine over 128
molecules of 30 nodes and 64 edges, ``driver.make_molecule_batch``),
DimeNet's 128, phi4-mini's 4,096 tokens of 3,072 bf16, xDeepFM's 39
fields of 65,536 rows at widths 10 and 1, each side as the transposes
run it: distinct rows with a perm, or a range from ``seg_lo``), it holds
every plan against the plain version bit for bit and times it (CUDA
events, L2 flushed, median of 10) beside a bound that counts each entry,
index and row once and each touched row read and written once, and
``index_add_`` into the same buffer in place:

- ``ops.acc_plan``'s plan, and its neighbours: the wide route at each
  other slice count the instances allow (and twice the plan's), the
  team route at 1, 2, 4, 8 and 16 segments a team;
- the plan under each build setting, and EGNN's at other group sizes.

``--baseline DIR`` also builds ``DIR``'s ``segment_reduce.cu``, a checkout
whose in-place entry is the kernel before the routes (one warp a group of
segments, the row in 256-column tiles walked in series; ``(msg, rowptr,
perm, rows, out, n_seg, d, seg_lo, group, is_bf16, stream)``), and times
it at each shape at its ``group_size``, in turns with the plan (baseline,
plan, plan, baseline). Prints one JSON line per shape (and writes them
all to ``--out`` if given). Needs a CUDA device and nvcc.
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
    segment_sum_csr_accumulate_ref)
from repro_torch.sparse.segment import csr_by_row

# (unroll, prefetch, min blocks, stages); the first is the source's default
SETTINGS = ((4, 4, 4, 4), (4, 4, 4, 0), (2, 4, 4, 4), (8, 4, 3, 4),
            (8, 8, 2, 4), (4, 4, 4, 8))
EGNN_GROUPS = {"source": (4, 8, 16, 31), "destination": (1, 2, 4)}
N_NODES, N_EDGES = 2_449_029, 61_859_140
_INSTANCE = re.compile(r"segment_accumulate_kernel(_team)?I(f|13__nv_bfloat16)"
                       r"Li(\d+)E(?:Li(\d+)E)?Lb([01])E")
_BASELINE_ARGTYPES = [ops._P] * 5 + [ops._I] * 5 + [ops._P]


def _ptxas(stderr: str) -> dict:
    """{"team|rows/<dtype>/v<V>[/nc<NC>]/<perm>": (registers, spill store
    bytes, spill load bytes)} of every in-place instance."""
    out, lines = {}, stderr.splitlines()
    for i, text in enumerate(lines):
        hit = _INSTANCE.search(text)
        if not (hit and "Compiling entry" in text):
            continue
        info = " ".join(lines[i + 1:i + 6])
        r = re.search(r"Used (\d+) registers", info)
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      info)
        team, dt, v, nc, perm = hit.groups()
        key = "/".join(["team" if team else "rows",
                        "f32" if dt == "f" else "bf16", f"v{v}"]
                       + ([] if team else [f"nc{nc}"])
                       + ["perm" if perm == "1" else "noperm"])
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


def build(setting):
    """(tag, the in-place C entry, ptxas' report, nvcc seconds)."""
    u, p, m, st = setting
    tag = f"u{u}p{p}m{m}" + (f"s{st}" if st else "")
    lib, log, secs = _build_lib(ops._SRC, tag, (
        f"-DSEG_ACC_UNROLL={u}", f"-DSEG_ACC_PREFETCH={p}",
        f"-DSEG_ACC_MIN_BLOCKS={m}", f"-DSEG_ACC_STAGES={st}"))
    fn = lib.segment_sum_csr_accumulate
    fn.argtypes = ops._ACC_ARGTYPES
    fn.restype = ctypes.c_int
    return tag, fn, _ptxas(log), secs


def build_baseline(root: str):
    src = (Path(root) / "src" / "repro_torch" / "kernels" / "segment_reduce"
           / "csrc" / "segment_reduce.cu")
    lib, _, secs = _build_lib(src, "baseline")
    fn = lib.segment_sum_csr_accumulate
    fn.argtypes = _BASELINE_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, secs


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


def shapes(gen):
    """name -> (d, dtype, rows of the buffer, a thunk of the CSR)."""
    from repro_torch.configs import get_config
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import LocalExec
    ex = LocalExec(gd.make_flat_graph(N_NODES, N_EDGES, 1, seed=0))
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


def regrid(plan: ops.AccPlan, n_seg: int, **kw) -> ops.AccPlan:
    """``plan`` with the fields ``kw`` changed and its warps and grid
    counted again."""
    plan = plan._replace(**kw)
    warps = -(-n_seg // plan.group) * plan.slices
    return plan._replace(warps=warps, grid=min(-(-warps // 8),
                                               ops._ACC_BLOCKS_CAP))


def neighbours(plan: ops.AccPlan, d: int, es: int, n_seg: int) -> list:
    """Other plans of the same route: every slice count the instances
    allow (at most 4 registers a lane) and twice the plan's (wide); 1, 2,
    4, 8 and 16 segments a team (team)."""
    if plan.route == "team":
        teams = 32 // (d // plan.vec)
        groups = sorted({m * teams for m in (1, 2, 4, 8, 16)} - {plan.group})
        return [regrid(plan, n_seg, group=g) for g in groups]
    if plan.route == "medium":
        return []
    n_vec = d // plan.vec
    lane_vecs = ops.ACC_LANE_REGS // max(1, plan.vec * es // 4)
    out = set()
    for nc in range(1, lane_vecs + 1):
        out.add(-(-n_vec // (32 * nc)))
    out.add(min(n_vec, 2 * plan.slices))
    plans = []
    for s in sorted(out - {plan.slices}):
        per = -(-n_vec // s)
        s = -(-n_vec // per)
        plans.append(regrid(plan, n_seg, slices=s, width=per * plan.vec))
    return plans


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    ap.add_argument("--baseline", default=None,
                    help="a checkout whose in-place kernel is timed beside")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated names of SHAPES to run (all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep: needs a CUDA device")
    jobs = [lambda s=s: build(s) for s in SETTINGS]
    if args.baseline:
        jobs.append(lambda: build_baseline(args.baseline))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = [f.result() for f in [pool.submit(j) for j in jobs]]
    base_fn = None
    if args.baseline:
        base_fn, base_secs = built.pop()
    result = {"card": torch.cuda.get_device_name(0),
              "builds": {tag: {"nvcc_s": secs, "ptxas": regs}
                         for tag, _, regs, secs in built}}
    if args.baseline:
        result["baseline_nvcc_s"] = base_secs
    print(json.dumps({"builds": result["builds"]}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(31)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    default_fn = built[0][1]

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
            group = ops.group_size(r, e)

            def old(dst):
                err = base_fn(cot.data_ptr(), ptrs[2], ptrs[3], ptrs[4],
                              dst.data_ptr(), r, d, lo, group,
                              int(dtype == torch.bfloat16), stream)
                if err:
                    raise RuntimeError(f"sweep: baseline {name}: {err}")

            fresh = base.clone()
            old(fresh)
            same = torch.equal(fresh, want)
            turns = [timed(lambda: old(out)), held(default_fn, plan)["ms"],
                     held(default_fn, plan)["ms"], timed(lambda: old(out))]
            row["baseline_vs_plan_ms"] = dict(turns=turns, group=group,
                                              baseline_bitwise=same)
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
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
