"""Three-term roofline over the H100 dry run's records (the port of
``repro.roofline.analysis``):

    compute    = sum over dtype classes of FLOPs / that class's peak  [s]
    memory     = bytes / HBM bandwidth                                 [s]
    collective = collective bytes / NVLink bandwidth                   [s]

The counts are per device (``launch/dryrun.py``: one card holds the whole
cell on the ``h100`` mesh). The constants are NVIDIA's H100 SXM data
sheet's, the figures ``chip_smoke.py`` and ``PERF.md`` use: dense bf16
and int8 on the tensor cores, fp32 outside them (the port keeps TF32
off), HBM3, and NVLink within a host of eight cards (450 GB/s each way).
The reference holds one bf16 peak; here each class runs at its own.

A record whose terms were not counted (the grid meshes, which count only
each device's parameter and optimizer bytes) has no row.
"""
from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
HBM_BW = 3.35e12             # bytes/s / card
LINK_BW = 450e9              # bytes/s / card, NVLink, each way
HBM_BYTES = 80e9             # device memory / card

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_h100")


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    counted_flops_total: float
    useful_ratio: float       # model FLOPs / counted FLOPs
    peak_gib: float
    devices: int = 1
    note: str = ""

    @property
    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the bound term that is *useful* model compute (at
        the bf16 peak), over the record's own devices."""
        if self.bound_time <= 0:
            return 0.0
        ideal = self.model_flops / (self.devices * PEAK_FLOPS["bf16"])
        return min(ideal / self.bound_time, 1.0)


def compute_seconds(flops: Dict[str, float]) -> float:
    """Each dtype class's FLOPs over its peak, summed."""
    return sum(float(v) / PEAK_FLOPS[k] for k, v in flops.items())


def terms(flops: Dict[str, float], nbytes: float, coll: float) -> dict:
    """The three terms, the dominant one and the bound in ms."""
    t = {"compute_s": compute_seconds(flops), "memory_s": nbytes / HBM_BW,
         "collective_s": coll / LINK_BW}
    dom = max(("compute", t["compute_s"]), ("memory", t["memory_s"]),
              ("collective", t["collective_s"]), key=lambda kv: kv[1])[0]
    return dict(t, dominant=dom,
                bound_ms=1e3 * max(t["compute_s"], t["memory_s"],
                                   t["collective_s"]))


def analyse_record(rec: Dict) -> Optional[RooflineRow]:
    if rec.get("status") != "ok" or not isinstance(rec.get("flops"), dict):
        return None
    flops = rec["flops"]
    coll = rec.get("collective_bytes_per_device", {}).get("total", 0.0)
    t = terms(flops, rec["bytes"], coll)
    total = float(sum(flops.values()))
    model_flops = rec.get("meta", {}).get("model_flops", 0.0)
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=t["compute_s"], memory_s=t["memory_s"],
        collective_s=t["collective_s"], dominant=t["dominant"],
        model_flops=model_flops, counted_flops_total=total,
        useful_ratio=(model_flops / total) if total else 0.0,
        peak_gib=rec.get("peak_bytes", 0) / 2 ** 30,
        devices=int(rec.get("devices", 1)), note=rec.get("method", ""))


def load_all(results_dir: str = RESULTS_DIR,
             mesh: str = "h100") -> List[RooflineRow]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, mesh, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        row = analyse_record(rec)
        if row:
            rows.append(row)
    return rows


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':22s} {'shape':14s} {'compute(s)':>11s} "
           f"{'memory(s)':>11s} {'collect(s)':>11s} {'bound':>10s} "
           f"{'useful':>7s} {'roofl%':>7s} {'peak GiB':>9s}  note")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:14s} {r.compute_s:11.4e} "
            f"{r.memory_s:11.4e} {r.collective_s:11.4e} {r.dominant:>10s} "
            f"{r.useful_ratio:7.3f} {100 * r.roofline_fraction:6.1f}% "
            f"{r.peak_gib:9.2f}  {r.note}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS_DIR)
    ap.add_argument("--mesh", default="h100")
    args = ap.parse_args(argv)
    print(format_table(load_all(args.results, args.mesh)))


if __name__ == "__main__":
    main()
