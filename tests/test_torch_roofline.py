"""The port's roofline (``repro_torch.roofline``): the dispatch-trace
counter (``trace.py``, the counterpart of the reference's ``hlo_parse.py``),
the kernels' meta routes and counter regions, and ``analysis.py`` against
the reference's ``repro.roofline.analysis`` (which imports no JAX).

- The counter: a view or alias counts no bytes, a storage counts once
  across its views, an ``out=`` argument is written and not read, the
  peak follows the storages' lifetimes, the matrix products count FLOPs
  by dtype class.
- Each kernel wrapper's meta route runs the CUDA route's checks (a shape
  the card refuses raises the kernel's own message), allocates its
  outputs at their shapes and dtypes, and is counted by the same formula
  as its CPU route.
- A smoke LM train step and a smoke xDeepFM train step traced on meta
  count what the same steps count on the CPU: with every id of a
  micro-batch distinct, the same FLOPs, bytes and peak; with
  repeated ids, the meta trace's worst case lies above the CPU's by at
  most what the rows the ids did not take account for, computed here.
- ``analyse_record`` on a hand-made record gives the reference's three
  terms scaled by the ratio of the peaks.
"""
import pytest

pytest.importorskip("torch")

import json

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.ivf_topk import ops as iops
from repro_torch.kernels.segment_reduce import ops as sops
from repro_torch.roofline import analysis
from repro_torch.roofline.trace import Counter

META = torch.device("meta")


def test_views_count_no_bytes_and_storages_count_once():
    a = torch.randn(64, 32)
    with Counter() as c:
        c.track(a)
        v = a.t()                         # a view
        w = a.view(32, 64)                # another view of a's storage
        assert c.bytes == 0
        assert c.live == a.numel() * 4
        x = v.contiguous()                # a copy: read and written
        assert c.bytes == 2 * a.numel() * 4
        assert c.live == 2 * a.numel() * 4
        del x, w
        assert c.live == a.numel() * 4
    assert c.peak == 2 * a.numel() * 4
    assert c.ops["t"] == 1 and c.ops["view"] == 1


def test_out_arguments_are_written_not_read_and_peaks_follow_lifetimes():
    a, b = torch.randn(16, 8), torch.randn(8, 4)
    out = torch.empty(16, 4)
    with Counter() as c:
        c.track(out)
        torch.mm(a, b, out=out)
        assert c.bytes_read == (a.numel() + b.numel()) * 4
        assert c.bytes_written == out.numel() * 4
        assert c.flops == {"bf16": 0.0, "fp32": 2.0 * 16 * 8 * 4,
                           "int8": 0.0}
        for _ in range(3):
            t = torch.ones(1000)          # 4 KB made and freed each time
            del t
    assert c.peak == 4000 + out.numel() * 4 and c.live == out.numel() * 4


def test_flops_by_dtype_class_and_the_vector_products():
    a = torch.randn(8, 16, dtype=torch.bfloat16)
    b = torch.randn(16, 4, dtype=torch.bfloat16)
    m, v = torch.randn(32, 16), torch.randn(16)
    with Counter() as c:
        a @ b
        m @ v
        v @ v
    assert c.flops["bf16"] == 2 * 8 * 16 * 4
    assert c.flops["fp32"] == 2 * 32 * 16 + 2 * 16


def _seg_case(device, perm=True):
    g = torch.Generator().manual_seed(0)
    e, d, n = 40, 6, 9
    msgs = torch.randn(e, d, generator=g)
    ids = torch.randint(0, n, (e,), generator=g)
    rowptr, order = sops.csr_from_ids(ids, n)
    if device == "meta":
        msgs, rowptr, order = (t.to(META) for t in (msgs, rowptr, order))
    return msgs, rowptr, (order if perm else None), n


def test_segment_meta_routes_allocate_and_count_as_the_cpu_route():
    """The summing and in-place entries on meta tensors: the CUDA route's
    outputs, and the kernel counted by its formula (every listed entry on
    meta, each the CPU's here since no id is dropped)."""
    got = {}
    for dev in ("cpu", "meta"):
        msgs, rowptr, perm, n = _seg_case(dev)
        with Counter() as c:
            out = sops.segment_sum_csr(msgs, rowptr, perm)
            acc = torch.zeros(n + 3, msgs.shape[1], device=msgs.device)
            rows = torch.arange(2, n + 2, dtype=torch.int32,
                                device=msgs.device)
            sops.segment_sum_csr_accumulate(msgs, rowptr, perm, out=acc,
                                            rows=rows)
        assert out.shape == (n, msgs.shape[1]) and out.dtype == msgs.dtype
        assert out.device.type == dev
        got[dev] = c.summary()
    for k in ("segment_sum", "segment_sum_csr_accumulate"):
        assert got["meta"]["kernels"][k] == got["cpu"]["kernels"][k]
        assert got["cpu"]["kernels"][k]["launches"] == 1
    assert got["meta"]["flops"] == got["cpu"]["flops"]
    assert got["meta"]["bytes"] == got["cpu"]["bytes"]
    # the plain version's operators are not counted: only the set-up's
    assert got["cpu"]["ops"] == got["meta"]["ops"]


def test_segment_meta_route_runs_the_cuda_checks():
    msgs, rowptr, perm, n = _seg_case("meta")
    with pytest.raises(ValueError, match="the kernel takes"):
        sops.segment_sum_csr(msgs.to(torch.float64), rowptr, perm)
    with pytest.raises(ValueError, match="contiguous int32"):
        sops.segment_sum_csr(msgs, rowptr.to(torch.int64), perm)


def _decode_case(device, hd=128, b=2, s=48, hkv=2, g=3):
    q = torch.randn(b, hkv * g, hd)
    k = torch.randn(b, s, hkv, hd)
    v = torch.randn(b, s, hkv, hd)
    valid = torch.ones(b, s, dtype=torch.bool)
    return tuple(t.to(device) for t in (q, k, v, valid))


def test_decode_meta_route_allocates_the_cuda_routes_workspace():
    """The meta route's output is q's shape, its split workspace the one
    ``plan`` gives an H100's 132 SMs, held at once (the counter's peak);
    every position valid, so the CPU route counts the same."""
    got = {}
    for dev in ("cpu", "meta"):
        q, k, v, valid = _decode_case(dev)
        with Counter() as c:
            c.track(q, k, v, valid)
            base = c.live
            out = dops.decode_attention(q, k, v, valid)
        assert out.shape == q.shape and out.dtype == q.dtype
        got[dev] = (c.summary(), c.peak - base)
    b, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    tiles, splits = dops.plan(b, hkv, s, dops.H100_SMS)
    ws = b * hkv * splits * (h // hkv) * (hd + 2) * 4
    assert got["meta"][1] == ws + q.numel() * 4
    assert got["meta"][0]["kernels"] == got["cpu"][0]["kernels"]
    assert got["meta"][0]["kernels"]["decode_attention"]["flops"] == (
        4.0 * b * s * h * hd)


def test_decode_meta_route_refuses_what_the_card_refuses():
    q, k, v, valid = _decode_case("meta", hd=96)
    with pytest.raises(ValueError, match="the kernel takes hd in"):
        dops.decode_attention(q, k, v, valid)


def test_scan_meta_routes_allocate_the_chunk_outputs():
    nq, d, k_parts, cap, n_probe, chunk = 4, 32, 6, 20, 2, 8
    q = torch.randn(nq, d, device=META)
    slab = torch.empty(k_parts * cap, d, dtype=torch.int8, device=META)
    f = torch.empty(k_parts * cap, device=META)
    probes = torch.empty(nq, n_probe, dtype=torch.int32, device=META)
    with Counter() as c:
        cmax, carg = iops.probe_scan(q, q.sum(1), slab, f, f, f, probes, cap,
                                     chunk)
        smax, sarg = iops.shared_scan(q, q.sum(1), slab, f, f, f, chunk)
    assert cmax.shape == carg.shape == (nq, n_probe * -(-cap // chunk))
    assert carg.dtype == torch.int32 and cmax.dtype == torch.float32
    assert smax.shape == (nq, -(-k_parts * cap // chunk))
    k = c.summary()["kernels"]
    assert k["ivf_probe_scan"]["flops"] == 2.0 * iops.N_LIMBS * nq * n_probe \
        * cap * d
    assert c.flops["int8"] == k["ivf_probe_scan"]["flops"] + \
        k["ivf_shared_scan"]["flops"]
    with pytest.raises(ValueError, match="unsupported d"):
        iops.shared_scan(torch.randn(nq, 2000, device=META),
                         torch.randn(nq, device=META),
                         torch.empty(8, 2000, dtype=torch.int8, device=META),
                         *(torch.empty(8, device=META),) * 3, 4)


# ---------------------------------------------------------------------------
# meta against CPU
# ---------------------------------------------------------------------------

def _lm_step_counts(cfg, params, batch, accum):
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    opt = init_adamw(params)
    step = lm.make_train_step(cfg, None, lm.ExecOpts(q_block=16, remat=True),
                              AdamWConfig(), grad_accum=accum)
    with Counter() as c:
        c.track(params, opt, batch)
        step(params, opt, batch)
    return c


def _lm_tokens(cfg, accum, micro, seq, distinct, seed=0):
    rng = np.random.default_rng(seed)
    if distinct:
        tok = np.stack([rng.permutation(cfg.vocab_size)[:micro * seq]
                        for _ in range(accum)]).reshape(accum, micro, seq)
    else:
        tok = rng.integers(0, 8, (accum, micro, seq))
    return torch.from_numpy(tok.astype(np.int32))


def _worst_case_excess(tokens, d, es):
    """What the meta trace's worst case (every id of a micro-batch
    distinct) adds over these tokens: per micro-batch, each missing row's
    FLOPs in the in-place kernel (one add a column) and an upper bound of
    its bytes (the kernel's row read and write, its row index and offset,
    and the CSR set-up's row entries: unique's rows and counts, the
    offsets' zero fill, cumulative sum and casts)."""
    flops, nbytes = 0, 0
    for mb in tokens.reshape(tokens.shape[0], -1):
        missing = mb.numel() - int(torch.unique(mb).numel())
        flops += missing * d
        nbytes += missing * (2 * d * es + 4 + 4 + 8 * 6 + 4 * 6)
    return flops, nbytes


@pytest.mark.parametrize("distinct", [True, False])
def test_lm_meta_trace_counts_the_cpu_step(distinct):
    from repro_torch.models import lm
    cfg = smoke_config("phi4-mini-3.8b")
    accum, micro, seq = 2, 2, 32
    cpu_params = lm.init_lm(cfg, 0, device="cpu")
    tok = _lm_tokens(cfg, accum, micro, seq, distinct)
    cpu = _lm_step_counts(cfg, cpu_params, {"tokens": tok, "labels": tok},
                          accum)
    meta_params = lm.init_lm(cfg, 0, device="meta")
    mt = tok.to(META)
    meta = _lm_step_counts(cfg, meta_params, {"tokens": mt, "labels": mt},
                           accum)
    ex_flops, ex_bytes = _worst_case_excess(tok, cfg.d_model, 2)
    assert meta.flops["bf16"] == cpu.flops["bf16"] > 0
    assert meta.flops["fp32"] - cpu.flops["fp32"] == ex_flops
    assert 0 <= meta.bytes - cpu.bytes <= ex_bytes
    assert 0 <= meta.peak - cpu.peak <= ex_bytes
    if distinct:
        assert meta.bytes == cpu.bytes and meta.peak == cpu.peak
    assert meta.kernels["segment_sum_csr_accumulate"]["launches"] == accum


@pytest.mark.parametrize("distinct", [True, False])
def test_recsys_meta_trace_counts_the_cpu_step(distinct):
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.train.optimizer import init_adamw
    cfg = smoke_config("xdeepfm")
    rows = 48
    rng = np.random.default_rng(1)
    if distinct:
        ids = np.stack([rng.permutation(cfg.vocab_per_field)[:rows]
                        for _ in range(cfg.n_sparse)], 1)
    else:
        ids = rng.integers(0, 5, (rows, cfg.n_sparse))
    ids = torch.from_numpy(ids.astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, 2, rows).astype(np.int32))
    counts = {}
    for dev in ("cpu", "meta"):
        params = xdeepfm.init(cfg, 0, device=dev)
        batch = {"ids": ids.to(dev), "labels": labels.to(dev)}
        opt = init_adamw(params)
        with Counter() as c:
            c.track(params, opt, batch)
            xdeepfm.make_train_step(cfg)(params, opt, batch)
        counts[dev] = c
    cpu, meta = counts["cpu"], counts["meta"]
    # the two transposes (tables at D, linear_w at 1) over one CSR of the
    # flat (field, id) rows
    flat = ids + torch.arange(cfg.n_sparse) * cfg.vocab_per_field
    ex_flops, ex_bytes = 0, 0
    for d in (cfg.embed_dim, 1):
        f, b = _worst_case_excess(flat[None], d, 4)
        ex_flops, ex_bytes = ex_flops + f, ex_bytes + b
    assert meta.flops["fp32"] - cpu.flops["fp32"] == ex_flops
    assert 0 <= meta.bytes - cpu.bytes <= ex_bytes
    assert 0 <= meta.peak - cpu.peak <= ex_bytes
    if distinct:
        assert meta.bytes == cpu.bytes and meta.peak == cpu.peak
    assert meta.kernels["segment_sum_csr_accumulate"]["launches"] == 2


# ---------------------------------------------------------------------------
# analysis against the reference's
# ---------------------------------------------------------------------------

def test_analyse_record_scales_the_reference_terms():
    from repro.roofline import analysis as ref
    flops, nbytes, coll, model = 1.1e15, 7.3e12, 2.9e10, 5e14
    ref_row = ref.analyse_record({
        "status": "ok", "arch": "a", "shape": "s", "mesh": "singlepod",
        "flops_per_device": flops, "bytes_per_device": nbytes,
        "collective_bytes_per_device": {"total": coll},
        "meta": {"model_flops": model}, "memory": {"temp_bytes": 2 ** 30}})
    rec = {"status": "ok", "arch": "a", "shape": "s", "mesh": "h100",
           "flops": {"bf16": flops, "fp32": 0.0, "int8": 0.0},
           "bytes": nbytes, "collective_bytes_per_device": {"total": coll},
           "meta": {"model_flops": model}, "peak_bytes": 2 ** 30}
    row = analysis.analyse_record(rec)
    assert row.compute_s == pytest.approx(
        ref_row.compute_s * ref.PEAK_FLOPS / analysis.PEAK_FLOPS["bf16"])
    assert row.memory_s == pytest.approx(
        ref_row.memory_s * ref.HBM_BW / analysis.HBM_BW)
    assert row.collective_s == pytest.approx(
        ref_row.collective_s * ref.LINK_BW / analysis.LINK_BW)
    assert row.dominant == "memory" and row.peak_gib == 1.0
    # each class at its own peak, summed
    rec["flops"] = {"bf16": 1e12, "fp32": 2e12, "int8": 4e12}
    assert analysis.analyse_record(rec).compute_s == pytest.approx(
        1e12 / 989e12 + 2e12 / 67e12 + 4e12 / 1979e12)
    # one device: the useful share is the record's own
    assert row.roofline_fraction == pytest.approx(
        min(1.0, model / 989e12 / row.bound_time))


def test_load_all_and_format_table(tmp_path):
    (tmp_path / "h100").mkdir()
    rec = {"status": "ok", "arch": "xdeepfm", "shape": "serve_p99",
           "mesh": "h100", "flops": {"bf16": 0.0, "fp32": 6.7e10,
                                     "int8": 0.0},
           "bytes": 3.35e9, "meta": {"model_flops": 3e10},
           "peak_bytes": 0, "method": "traced on meta"}
    (tmp_path / "h100" / "xdeepfm__serve_p99.json").write_text(
        json.dumps(rec))
    grid = dict(rec, mesh="singlepod", status="ok", flops="not counted")
    (tmp_path / "h100" / "xdeepfm__grid.json").write_text(json.dumps(grid))
    rows = analysis.load_all(str(tmp_path), "h100")
    assert len(rows) == 1
    assert rows[0].compute_s == pytest.approx(1e-3)
    assert rows[0].memory_s == pytest.approx(1e-3)
    assert "xdeepfm" in analysis.format_table(rows)
