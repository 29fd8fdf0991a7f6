"""Counts the kernels ``torch.profiler`` misses in a host-paced window
under the host load of a whole ``chip_smoke.py`` run, with and without a
lead on the host inside the window before the first launch.

    PYTHONPATH=src python tools/profile_drops_torch.py [--seconds S]
        [--every T] [--load] [--lead-ms M]

Each round profiles one window shaped like a RAG decode tick (host-bound:
32 "layers", each a ``record_function`` scope that launches one
``torch.cuda._sleep`` kernel, then 2 ms on the host; no kernel of the
repository) and prints one JSON line: the process's age, the kernels
launched and seen, and the first seen kernel's start after the trace's
(µs). With ``--lead-ms M`` each round also profiles a window that waits M
ms on the host inside the profiler before the first launch (its own line,
``"lead_ms": M``), as ``chip_smoke.profile_once`` does. With ``--load``
the dryrun child (``chip_smoke.py --dryrun-child``, its meta traces on the
CPU) and the crash harness sweep (on the card) run beside the rounds,
each restarted when it ends. The last line counts the short windows of
each kind. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LAYERS = 32


def window(lead_ms: float) -> dict:
    """One profiled host-paced window: launched and seen kernels, and the
    first seen kernel's start after the trace's."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead_ms:
            time.sleep(lead_ms / 1e3)
        for i in range(LAYERS):
            with record_function(f"layer_{i}"):
                torch.cuda._sleep(20_000)
            time.sleep(0.002)
        torch.cuda.synchronize()
    res = prof.profiler.kineto_results
    kern = sorted(e.start_ns() for e in res.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA
                  and "spin" in e.name())
    return dict(launched=LAYERS, seen=len(kern),
                first_kernel_after_start_us=(kern[0] - res.trace_start_ns())
                / 1e3 if kern else None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--every", type=float, default=5.0)
    ap.add_argument("--load", action="store_true")
    ap.add_argument("--lead-ms", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_drops_torch: needs a CUDA device")
    t_start = time.perf_counter()
    torch.zeros(1, device="cuda")
    import chip_smoke as cs
    child = sweep = None
    try:
        short = {0.0: 0, args.lead_ms: 0}
        rounds = 0
        while time.perf_counter() - t_start < args.seconds:
            if args.load:
                if child is None or child["proc"].poll() is not None:
                    if child is not None:
                        cs.stop_dryrun_child(child)
                    child = cs.start_dryrun_child()
                if sweep is None or sweep.poll() is not None:
                    if sweep is not None:
                        sweep.communicate()
                    sweep = cs.start_harness_sweep()
            leads = (0.0, args.lead_ms) if args.lead_ms else (0.0,)
            for lead in leads:
                r = window(lead)
                short[lead] += r["seen"] < r["launched"]
                print(json.dumps(dict(age_s=time.perf_counter() - t_start,
                                      lead_ms=lead, **r)), flush=True)
            rounds += 1
            time.sleep(args.every)
        print(json.dumps({"rounds": rounds, "short_windows": short,
                          "load": args.load}), flush=True)
    finally:
        if child is not None:
            cs.stop_dryrun_child(child)
        if sweep is not None and sweep.poll() is None:
            cs.stop_harness_sweep(sweep)


if __name__ == "__main__":
    main()
