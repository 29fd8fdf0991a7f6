"""Sweep of the in-place segment-sum kernel's build settings on the card.

    python -m repro_torch.kernels.segment_reduce.sweep [--out FILE]

Builds ``csrc/segment_reduce.cu`` once per setting of ``SEG_ACC_UNROLL``
(entries' rows in flight), ``SEG_ACC_PREFETCH`` (output rows loaded ahead)
and ``SEG_ACC_MIN_BLOCKS`` (blocks an SM the registers must allow), all at
once, into ``build/repro_torch_kernels/sweep/``, with ptxas' registers and
spills of the fp32 three-column instances. Then, at one message block of
EGNN training at the ogbn-products shape (block 0 of ``LocalExec`` over
``make_flat_graph(2,449,029, 61,859,140)``: 1,048,576 cotangent rows of d
= 67 fp32), it holds every setting and group size against the plain
version bit for bit on the source side (the block's distinct sources) and
the destination side (its range of destinations), and times each (CUDA
events, L2 flushed, median of 10) beside ``index_add_`` into the same
buffer in place and a gather of as many random rows. Prints one JSON line
per side (and writes both to ``--out`` if given). Needs a CUDA device and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce import ops
from repro_torch.kernels.segment_reduce.ref import (
    segment_sum_csr_accumulate_ref)

# (unroll, prefetch, min blocks); the first is the source's default
SETTINGS = ((4, 4, 4), (8, 4, 1), (8, 8, 1), (16, 8, 1), (8, 4, 4),
            (4, 4, 5), (2, 4, 5), (4, 2, 6), (2, 2, 8))
GROUPS = {"source": (4, 8, 16, 26, 31), "destination": (1, 2, 4)}
N_NODES, N_EDGES, D = 2_449_029, 61_859_140, 67


def build(setting):
    """(tag, the C entry, {"perm"|"noperm": (registers, spill bytes)})."""
    u, p, m = setting
    tag = f"u{u}p{p}m{m}"
    out = _build.BUILD_DIR / "sweep" / f"libsegment_reduce_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DSEG_ACC_UNROLL={u}",
         f"-DSEG_ACC_PREFETCH={p}", f"-DSEG_ACC_MIN_BLOCKS={m}", "-o",
         str(out), str(ops._SRC)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    regs, lines = {}, proc.stderr.splitlines()
    for i, text in enumerate(lines):
        hit = re.search(r"segment_accumulate_kernelIfLi3ELb([01])", text)
        if hit and "Compiling entry" in text:
            info = " ".join(lines[i + 1:i + 6])
            r = re.search(r"Used (\d+) registers", info)
            s = re.search(r"(\d+) bytes spill stores", info)
            regs["perm" if hit.group(1) == "1" else "noperm"] = (
                int(r.group(1)) if r else None, int(s.group(1)) if s else None)
    fn = ctypes.CDLL(str(out)).segment_sum_csr_accumulate
    fn.argtypes = ops._ACC_ARGTYPES
    fn.restype = ctypes.c_int
    return tag, fn, regs


def main(argv=None) -> None:
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import LocalExec
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep: needs a CUDA device")
    with ThreadPoolExecutor(len(SETTINGS)) as pool:
        built = list(pool.map(build, SETTINGS))
    ex = LocalExec(gd.make_flat_graph(N_NODES, N_EDGES, 1, seed=0))
    gen = torch.Generator(device="cuda").manual_seed(31)
    cot = torch.randn((ex.block, D), device="cuda", generator=gen)
    base = torch.randn((N_NODES, D), device="cuda", generator=gen)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    e = ex.block
    stream = torch.cuda.current_stream().cuda_stream
    src_rp, src_perm, src_rows = ex._src_csr(0)
    dst_rp, dst_lo = ex._dst_csr(0)
    sides = {"source": (src_rp, src_perm, src_rows, 0, ex.src[:e].long()),
             "destination": (dst_rp, None, None, dst_lo, ex.dst[:e].long())}

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

    result = {"card": torch.cuda.get_device_name(0)}
    for side, (rp, perm, rows, lo, idx) in sides.items():
        r = rp.numel() - 1
        want = segment_sum_csr_accumulate_ref(cot, rp, perm, out=base.clone(),
                                              rows=rows, seg_lo=lo)
        lib = base.clone()
        gather_idx = torch.randint(0, e, (e,), device="cuda", generator=gen)
        nbytes = (e * D * 4 + (0 if perm is None else e * 4) + (r + 1) * 4
                  + (0 if rows is None else r * 4) + 2 * r * D * 4)
        row = {"rows": r, "bound_ms": nbytes / 3.35e12 * 1e3,
               "index_add_in_place_ms": timed(
                   lambda: lib.index_add_(0, idx, cot)),
               "random_row_gather_ms": timed(
                   lambda: cot.index_select(0, gather_idx)),
               "settings": {}}
        for tag, fn, regs in built:
            out = base.clone()

            def call(group, dst):
                err = fn(cot.data_ptr(), rp.data_ptr(),
                         None if perm is None else perm.data_ptr(),
                         None if rows is None else rows.data_ptr(),
                         dst.data_ptr(), r, D, lo, group, 0, stream)
                if err:
                    raise RuntimeError(f"{tag}: CUDA error {err}")

            ms = {}
            for group in GROUPS[side]:
                fresh = base.clone()
                call(group, fresh)
                if not torch.equal(fresh, want):
                    raise SystemExit(f"sweep: {tag} {side} group {group} "
                                     f"differs from the plain version")
                ms[group] = timed(lambda: call(group, out))
            row["settings"][tag] = {"regs_spills": regs, "ms": ms}
        result[side] = row
        print(json.dumps({side: row}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
