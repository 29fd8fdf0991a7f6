"""Card-only tests of the port: each CUDA kernel against its plain version
(the IVF scans, the flash-decode kernel and the segment sum), the facade
(search, hybrid search, a maintenance drain, the NSW refine lane) and the
EGNN forward on the card against the same on the CPU, ``search_bucketed``'s
bytes batched against alone (with and without the NSW lane), the
progressive rounds' probe-kernel launches, and durability on the card:
``recover`` byte-equal to the live index and to the harness's golden
prefix, ``partitioner.fit`` and the hop operator repeated bitwise (their
sums run the segment-sum kernel), a bf16 checkpoint leaf round trip, and
EGNN training on the card: the segment sum's backward and the gather
transpose against the CPU and ``index_add_``, the in-place kernel of the
transposes against its plain version bit for bit, one train step against
the CPU's, its launches, and the no-grad forward's launches; and
the row-sharded search: scores equal to the single layout's, one probe
launch per shard, each shard's probe kernel at its ``cap_l`` against the
plain version, the replica rebuilt after a maintain pass; the decode
kernel at mixtral's G = 4 window shape, the MoE dispatch's bytes twice on
the card, and a full-width DeepSeek-V2-Lite decode tick's capacity drops
against the same tick on the CPU.

Every test carries the ``gpu`` marker and skips itself when
``torch.cuda.is_available()`` is false (decided inside the test, so every
pytest-xdist worker collects the same tests). This file imports neither
JAX nor the reference package, so it runs on a card host without them:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance of the scans against their fp32 plain versions: 1e-4 absolute on
scores of O(1) (the int8 limb split of the query is within ~3e-6 at
d = 384, and fp32 sums run in another order); the argmax may move only
between rows whose scores tie to rounding, so at least 99% of chunk
argmaxes agree. Against the plain emulation of their limb arithmetic
(``ref.*_scan_limbs``) the scans agree bitwise. The segment sum and its
plain version make the same fp32 adds in the same order and round once, so
they must agree bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ivf_topk import ops, ref


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _case(g, d, n_rows):
    slab = torch.randint(-128, 128, (n_rows, d), dtype=torch.int8,
                         device="cuda", generator=g)
    scale = torch.rand(n_rows, device="cuda", generator=g) / 100
    vmin = -torch.rand(n_rows, device="cuda", generator=g)
    live = torch.rand(n_rows, device="cuda", generator=g) > 0.2
    bias = torch.where(live, 0.0, ref.NEG).float()
    return slab, 128 * scale + vmin, scale, bias


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [1, 16, 100])
@pytest.mark.parametrize("d", [24, 32, 33, 384])
def test_cuda_kernels_match_plain_versions(d, chunk):
    """Widths that take the 16-byte path (32, 384) and the bytewise path
    (24, 33), ragged tails (cap 37), masked rows, and a misaligned slab
    view (rows from offset 1) for the shared scan."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(d * 1000 + chunk)
    nq, k_parts, cap, n_probe = 5, 6, 37, 3
    slab, aff, scale, bias = _case(g, d, k_parts * cap)
    q = torch.randn(nq, d, device="cuda", generator=g)
    qs = q.sum(1)
    probes = torch.argsort(torch.rand(nq, k_parts, device="cuda", generator=g),
                           1)[:, :n_probe].int().contiguous()
    args = (q, qs, slab, aff, scale, bias, probes, cap, chunk)
    before = ops.probe_scan.launches
    km, ka = ops.probe_scan(*args)
    assert ops.probe_scan.launches == before + 1
    pm, pa = ref.probe_scan(*args)
    torch.cuda.synchronize()
    assert (km - pm).abs().max().item() <= 1e-4
    assert (ka == pa).float().mean().item() >= 0.99
    data = slab[1:]
    n = data.shape[0]
    sargs = (q, qs, data, aff[:n].contiguous(), scale[:n].contiguous(),
             bias[:n].contiguous(), chunk)
    km, ka = ops.shared_scan(*sargs)
    pm, pa = ref.shared_scan(*sargs)
    torch.cuda.synchronize()
    assert (km - pm).abs().max().item() <= 1e-4
    assert (ka == pa).float().mean().item() >= 0.99


def _probe_args(g, nq, d, k_parts, cap, n_probe, chunk, probes=None):
    slab, aff, scale, bias = _case(g, d, k_parts * cap)
    q = torch.randn(nq, d, device="cuda", generator=g)
    if probes is None:
        probes = torch.argsort(torch.rand(nq, k_parts, device="cuda",
                                          generator=g), 1)[:, :n_probe]
    return (q, q.sum(1), slab, aff, scale, bias,
            probes.int().contiguous(), cap, chunk)


def _assert_match(kern, plain):
    (km, ka), (pm, pa) = kern, plain
    torch.cuda.synchronize()
    assert km.shape == pm.shape
    assert (km - pm).abs().max().item() <= 1e-4
    assert (ka == pa).float().mean().item() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("d,chunk", [(384, 16), (384, 1), (33, 16),
                                     (1280, 16)])
def test_cuda_kernels_equal_the_limb_emulation_bitwise(d, chunk):
    """The kernels compute exactly the limb arithmetic of
    ``ref.*_scan_limbs`` (exact int32 sums, the same fp32 combination and
    affine steps), so their outputs have the same bits; d = 1280 is the
    widest modality of configs/hmgi.py."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(d + chunk)
    args = _probe_args(g, 12, d, 6, 300, 3, chunk)
    q, qs, slab, aff, scale, bias, probes, cap, _ = args
    limbs, s = ops.query_limbs(q)
    km, ka = ops.probe_scan(*args)
    em, ea = ref.probe_scan_limbs(limbs, s, qs, slab, aff, scale, bias, probes,
                                  cap, chunk)
    torch.cuda.synchronize()
    assert torch.equal(km, em) and torch.equal(ka, ea)
    _assert_match((km, ka), ref.probe_scan(*args))
    km, ka = ops.shared_scan(q, qs, slab, aff, scale, bias, chunk)
    em, ea = ref.shared_scan_limbs(limbs, s, qs, slab, aff, scale, bias, chunk)
    torch.cuda.synchronize()
    assert torch.equal(km, em) and torch.equal(ka, ea)
    _assert_match((km, ka), ref.shared_scan(q, qs, slab, aff, scale, bias,
                                            chunk))


@pytest.mark.gpu
def test_cuda_scans_are_batch_independent_bitwise():
    """8 queries give the same bits alone as inside a batch of 256 (their
    pairs then share partitions, groups and tiles with other queries)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(256)
    args = _probe_args(g, 256, 384, 16, 1000, 4, 16)
    q, qs, slab, aff, scale, bias, probes, cap, chunk = args
    sel = torch.arange(40, 48, device="cuda")
    big = ops.probe_scan(*args)
    small = ops.probe_scan(q[sel].contiguous(), qs[sel].contiguous(), slab,
                           aff, scale, bias, probes[sel].contiguous(), cap,
                           chunk)
    torch.cuda.synchronize()
    assert torch.equal(big[0][sel], small[0])
    assert torch.equal(big[1][sel], small[1])
    big = ops.shared_scan(q, qs, slab, aff, scale, bias, 1)
    small = ops.shared_scan(q[sel].contiguous(), qs[sel].contiguous(), slab,
                            aff, scale, bias, 1)
    torch.cuda.synchronize()
    assert torch.equal(big[0][sel], small[0])
    assert torch.equal(big[1][sel], small[1])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["one_each", "all_one", "repeated"])
def test_cuda_probe_scan_skewed_probes(layout):
    """Skewed probe lists: every query probes one partition (some probed by
    nobody); every query probes partition 3 only; a partition repeated in
    a query's probe row."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(5)
    nq, k_parts = 64, 16
    if layout == "one_each":
        probes = (torch.arange(nq, device="cuda") % 5 * 3)[:, None]
    elif layout == "all_one":
        probes = torch.full((nq, 2), 3, device="cuda")
    else:
        probes = torch.tensor([[1, 4, 1]] * nq, device="cuda")
    args = _probe_args(g, nq, 96, k_parts, 129, 0, 16, probes=probes)
    _assert_match(ops.probe_scan(*args), ref.probe_scan(*args))


@pytest.mark.gpu
def test_cuda_scans_zero_query_row():
    """A zero query row: step 0, all limbs 0, scores qsum·aff + bias = 0 +
    bias for that row, as in the plain versions."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(9)
    args = list(_probe_args(g, 6, 64, 4, 50, 2, 16))
    args[0][2] = 0.0
    args[1] = args[0].sum(1)
    _assert_match(ops.probe_scan(*args), ref.probe_scan(*args))
    q, qs, slab, aff, scale, bias = args[:6]
    _assert_match(ops.shared_scan(q, qs, slab, aff, scale, bias, 16),
                  ref.shared_scan(q, qs, slab, aff, scale, bias, 16))


@pytest.mark.gpu
def test_cuda_probe_topk_row_in_last_partial_chunk():
    """cap % chunk != 0 and every query's best row in its probe's last,
    partial chunk: scan_topk_probe on the card returns it first, and the
    same top-k as on the CPU."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(4)
    nq, d, k_parts, cap, n_probe = 15, 64, 8, 47, 3     # 47 = 2·16 + 15
    q = torch.randn(nq, d, device="cuda", generator=g)
    q /= q.norm(dim=1, keepdim=True)
    slab = torch.randint(-128, 128, (k_parts * cap, d), dtype=torch.int8,
                         device="cuda", generator=g)
    scale = torch.full((k_parts * cap,), 1e-3, device="cuda")
    vmin = -0.128 * torch.ones(k_parts * cap, device="cuda")
    probes = torch.argsort(torch.rand(nq, k_parts, device="cuda", generator=g),
                           1)[:, :n_probe].int().contiguous()
    want = []
    for i in range(nq):
        j = i % n_probe
        r = int(probes[i, j]) * cap + 32 + i        # one row per query
        slab[r] = (q[i] * 127 / q[i].abs().max()).round().to(torch.int8)
        scale[r], vmin[r] = 0.05, -128 * 0.05       # dequantizes to code·0.05
        want.append(j * cap + 32 + i)
    bias = torch.zeros(k_parts * cap, device="cuda")
    gv, gr = ops.scan_topk_probe(q, slab, vmin, scale, bias, probes, cap, k=10)
    cv, cr = ops.scan_topk_probe(*(t.cpu() for t in (q, slab, vmin, scale,
                                                     bias, probes)), cap, k=10)
    torch.cuda.synchronize()
    assert gr[:, 0].tolist() == want
    assert (gv.cpu() - cv).abs().max().item() <= 1e-4
    assert (gr.cpu() == cr).float().mean().item() >= 0.98


@pytest.mark.gpu
def test_wrappers_check_their_inputs_on_the_card():
    _need_card()
    q = torch.zeros((2, 16), device="cuda")
    data = torch.zeros((4, 16), dtype=torch.int8, device="cuda")
    f = torch.zeros(4, device="cuda")
    with pytest.raises(TypeError):               # fp32 data is refused
        ops.shared_scan(q, q.sum(1), data.float(), f, f, f, 1)
    with pytest.raises(ValueError):              # a CPU operand is refused
        ops.shared_scan(q, q.sum(1), data.cpu(), f, f, f, 1)


@pytest.mark.gpu
def test_facade_on_the_card_matches_the_cpu():
    """ingest → search / hybrid_search on the card, against the same index
    restored on the CPU (plain versions)."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.core.index import HMGIIndex
    from repro_torch.data.synthetic import make_corpus
    n = 2000
    c = make_corpus(n_nodes=n, modality_dims={"text": 64}, intra_p=96 / n,
                    inter_p=2 / n, seed=0)
    cfg = get_config("hmgi").replace(n_partitions=16, n_probe=4,
                                     delta_capacity=256, maint_auto=False)
    attrs = {"a": np.random.default_rng(0).integers(0, 10, n)}
    gpu = HMGIIndex(cfg)
    gpu.ingest({"text": (c.node_ids["text"], c.vectors["text"])}, n,
               edges=(c.src, c.dst, c.edge_type), node_attrs=attrs)
    tree, meta = gpu.state_tree()
    cpu = HMGIIndex(cfg, device="cpu")
    cpu.restore_state(tree, meta)
    q = c.vectors["text"][:32]
    for call in (lambda i: i.search(q, "text"),
                 lambda i: i.search(q, "text", where=("a", "<", 3)),
                 lambda i: i.hybrid_search(q, "text", n_hops=2)):
        gv, gi = call(gpu)
        cv, ci = call(cpu)
        np.testing.assert_allclose(gv.cpu().numpy(), cv.numpy(), rtol=0,
                                   atol=1e-4)
        # ids equal except where neighbouring scores tie to rounding
        same = gi.cpu().numpy() == ci.numpy()
        assert same.mean() >= 0.98


def _small_card_index(maint_auto=True):
    from repro_torch.configs import get_config
    from repro_torch.core.index import HMGIIndex
    from repro_torch.data.synthetic import make_corpus
    n = 2000
    c = make_corpus(n_nodes=n, modality_dims={"text": 64}, intra_p=96 / n,
                    inter_p=2 / n, seed=0)
    cfg = get_config("hmgi").replace(n_partitions=16, n_probe=4,
                                     delta_capacity=256,
                                     maint_auto=maint_auto)
    gpu = HMGIIndex(cfg)
    gpu.ingest({"text": (c.node_ids["text"], c.vectors["text"])}, n,
               edges=(c.src, c.dst, c.edge_type))
    return gpu, c


@pytest.mark.gpu
@pytest.mark.parametrize("n_hops", [0, 1, 2])
def test_search_bucketed_bytes_do_not_depend_on_the_batch(n_hops):
    """8 queries batched give the bytes each gives alone (bucket 8 vs
    bucket 2): every per-row reduction on the path sums in an order fixed
    by the row's length, not by the batch."""
    _need_card()
    from repro_torch.query.executor import search_bucketed
    gpu, c = _small_card_index()
    rng = np.random.default_rng(1)
    q = (c.vectors["text"][:8]
         + 0.05 * rng.normal(size=(8, 64))).astype(np.float32)
    bv, bi = search_bucketed(gpu, q, "text", k=6, n_hops=n_hops)
    for i in range(8):
        sv, si = search_bucketed(gpu, q[i:i + 1], "text", k=6,
                                 n_hops=n_hops)
        assert sv[0].tobytes() == bv[i].tobytes(), i
        assert si[0].tobytes() == bi[i].tobytes(), i


@pytest.mark.gpu
def test_drain_then_search_on_the_card_matches_the_cpu():
    """Writes under maint_auto and one forced drain on the card, the same
    writes and drain on a CPU copy: the same slab bytes, and searches that
    agree."""
    _need_card()
    from repro_torch.core.index import HMGIIndex
    gpu, c = _small_card_index()
    tree, meta = gpu.state_tree()
    cpu = HMGIIndex(gpu.cfg, device="cpu")
    cpu.restore_state(tree, meta)
    rng = np.random.default_rng(2)
    ids = rng.choice(2000, 100, replace=False).astype(np.int32)
    vecs = rng.normal(size=(100, 64)).astype(np.float32)
    for idx in (gpu, cpu):
        idx.insert("text", ids, vecs)
        idx.delete("text", ids[:5])
    # the writes were quantized on each device: carry the card's delta to
    # the CPU so the drain moves the same bytes
    tree, meta = gpu.state_tree()
    cpu = HMGIIndex(gpu.cfg, device="cpu")
    cpu.restore_state(tree, meta)
    reports = [idx.maintain("text", budget=4096, need_rows=100)
               for idx in (gpu, cpu)]
    assert reports[0].describe() == reports[1].describe()
    assert "compact_chunk" in reports[0].describe()
    gm, cm = gpu.modalities["text"], cpu.modalities["text"]
    for f in ("data", "vmin", "scale", "ids", "counts"):
        assert torch.equal(getattr(gm.ivf, f).cpu(), getattr(cm.ivf, f)), f
    for call in (lambda i: i.search(vecs, "text", n_probe=16),
                 lambda i: i.search(c.vectors["text"][:32], "text")):
        gv, gi = call(gpu)
        cv, ci = call(cpu)
        np.testing.assert_allclose(gv.cpu().numpy(), cv.numpy(), rtol=0,
                                   atol=1e-4)
        assert (gi.cpu().numpy() == ci.numpy()).mean() >= 0.98
    got = gpu.search(vecs[5:], "text", k=1, n_probe=16)[1].cpu().numpy()
    np.testing.assert_array_equal(got[:, 0], ids[5:])



def _nsw_card_index():
    """The small card index with the NSW refine lane (n_probe 2 of 16, so
    the lane adds rows the probed partitions miss)."""
    from repro_torch.configs import get_config
    from repro_torch.core.index import HMGIIndex
    from repro_torch.data.synthetic import make_corpus
    n = 2000
    c = make_corpus(n_nodes=n, modality_dims={"text": 64}, intra_p=96 / n,
                    inter_p=2 / n, seed=0)
    cfg = get_config("hmgi").replace(n_partitions=16, n_probe=2,
                                     delta_capacity=256, use_nsw_refine=True,
                                     nsw_degree=8, nsw_ef=32)
    gpu = HMGIIndex(cfg)
    gpu.ingest({"text": (c.node_ids["text"], c.vectors["text"])}, n,
               edges=(c.src, c.dst, c.edge_type))
    q = (c.vectors["text"][:32] + 0.1 * np.random.default_rng(3).normal(
        size=(32, 64))).astype(np.float32)
    return gpu, q


@pytest.mark.gpu
def test_nsw_lane_bytes_do_not_depend_on_the_batch():
    """8 queries through the NSW refine lane give the bytes each gives
    alone, as a search and as a hybrid search."""
    _need_card()
    from repro_torch.query.executor import search_bucketed
    gpu, q = _nsw_card_index()
    for hops in (0, 1):
        bv, bi = search_bucketed(gpu, q[:8], "text", k=6, n_hops=hops)
        for i in range(8):
            sv, si = search_bucketed(gpu, q[i:i + 1], "text", k=6,
                                     n_hops=hops)
            assert sv[0].tobytes() == bv[i].tobytes(), (hops, i)
            assert si[0].tobytes() == bi[i].tobytes(), (hops, i)


@pytest.mark.gpu
def test_nsw_lane_with_the_kernels_matches_the_plain_versions():
    """The NSW lane on the card (the scan kernels, the graph's beam search
    on the device) against the same index restored on the CPU (plain
    versions), the graph carried across: scores within 1e-4, ids equal
    except where scores tie to rounding. A CPU rebuild of the graph over
    the card's rows gives the same neighbours up to ties."""
    _need_card()
    from repro_torch.core import nsw as nsw_mod
    from repro_torch.core.index import HMGIIndex
    gpu, q = _nsw_card_index()
    tree, meta = gpu.state_tree()
    cpu = HMGIIndex(gpu.cfg, device="cpu")
    cpu.restore_state(tree, meta)
    launches = ops.probe_scan.launches
    for call in (lambda i: i.search(q, "text"),
                 lambda i: i.hybrid_search(q, "text", n_hops=1)):
        gv, gi = call(gpu)
        cv, ci = call(cpu)
        np.testing.assert_allclose(gv.cpu().numpy(), cv.numpy(), rtol=0,
                                   atol=1e-4)
        assert (gi.cpu().numpy() == ci.numpy()).mean() >= 0.98
    assert ops.probe_scan.launches > launches
    g = gpu.modalities["text"].nsw
    gs, gi = nsw_mod.search(g, torch.as_tensor(q, device="cuda"), ef=32, k=10)
    cs, ci = nsw_mod.search(cpu.modalities["text"].nsw, torch.as_tensor(q),
                            ef=32, k=10)
    np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=0,
                               atol=1e-5)
    assert (gi.cpu().numpy() == ci.numpy()).mean() >= 0.98


@pytest.mark.gpu
def test_progressive_rounds_launch_the_probe_kernel():
    """Each round of progressive_search over an int8 index runs the probe
    kernel once, and the last round at full probe equals a one-shot
    search at that probe up to ties."""
    _need_card()
    from repro_torch.core import ivf as ivf_mod
    from repro_torch.core.progressive import progressive_search
    gpu, q = _nsw_card_index()
    ix = gpu.modalities["text"].ivf
    before = ops.probe_scan.launches
    rounds = list(progressive_search(ix, q, k=10,
                                     probe_schedule=(1, 2, 4, 8, 16)))
    assert len(rounds) == 5
    assert ops.probe_scan.launches - before == 5
    one = ivf_mod.search(ix, torch.as_tensor(q, device="cuda"), n_probe=16,
                         k=10)
    np.testing.assert_allclose(rounds[-1].scores.cpu().numpy(),
                               one[0].cpu().numpy(), rtol=0, atol=1e-6)
    assert (rounds[-1].ids.cpu().numpy() == one[1].cpu().numpy()).mean() \
        >= 0.98

# ---------------------------------------------------------------- decode
def _decode_case(g, b, s, hkv, grp, hd, dtype, lengths):
    """q (b, hkv·grp, hd), k/v (b, s, hkv, hd) in dtype; row i valid on a
    ragged, shuffled set of lengths[i] positions."""
    q = torch.randn((b, hkv * grp, hd), device="cuda", generator=g).to(dtype)
    k = torch.randn((b, s, hkv, hd), device="cuda", generator=g).to(dtype)
    v = torch.randn((b, s, hkv, hd), device="cuda", generator=g).to(dtype)
    valid = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    for i, n in enumerate(lengths):
        perm = torch.randperm(s, device="cuda", generator=g)[:n]
        valid[i, perm] = True
    return q, k, v, valid


def _decode_masks(g, b, s):
    """(name, (b, s) bool mask) layouts for one decode case on the card."""
    dev = "cuda"
    pos = torch.arange(s, device=dev)
    out = []
    lengths = torch.randint(1, s + 1, (b,), device=dev, generator=g)
    out.append(("prefix", pos[None, :] < lengths[:, None]))
    # shuffled sets of 0 (→ 0 out), 1, 37, 640 and S positions, then random
    shuffled = torch.zeros((b, s), dtype=torch.bool, device=dev)
    for i in range(b):
        n = min(s, (0, 1, 37, 640, s)[i]) if i < 5 else int(lengths[i])
        shuffled[i, torch.randperm(s, device=dev, generator=g)[:n]] = True
    out.append(("shuffled", shuffled))
    last = torch.zeros((b, s), dtype=torch.bool, device=dev)
    last[:, s - 1] = True                               # one valid, last slot
    out.append(("last_slot", last))
    # a rolling window of w positions ending at p, wrapping past the end
    w = max(1, s // 3)
    p = torch.randint(0, s, (b,), device=dev, generator=g)
    out.append(("window_wrap", ((p[:, None] - pos[None, :]) % s) < w))
    if s > 4 * 64:
        # whole tiles and splits empty between two islands
        holes = torch.zeros((b, s), dtype=torch.bool, device=dev)
        holes[:, :64] = True
        holes[:, s - 100:s - 40] = True
        holes[b // 2:, 64 * 2:64 * 3] = True
        out.append(("empty_tiles", holes))
    return out


# (B, S) of the decode cases: S of 1, one short of a tile, one tile, one
# past it, one past 8 tiles (a split of the longest kind), and the serving
# cache; B of 1 and 64
_DECODE_SHAPES = [(3, 1), (2, 63), (2, 64), (3, 65), (1, 513), (5, 1000),
                  (2, 2048), (64, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("grp", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_matches_plain_version(dtype, hd, grp):
    """Every (B, S) of ``_DECODE_SHAPES`` under prefix, shuffled (row 0
    all-invalid → 0, then 1, 37, 640 and S valid positions), last-slot-only,
    wrapping-window and empty-tile masks.
    fp32: 1e-5 absolute (the same fp32 sums in another order); bf16: both
    round one fp32 result to bf16, so 1 bf16 ulp of outputs |out| < 4
    (2^-6)."""
    _need_card()
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    g = torch.Generator(device="cuda").manual_seed(hd * 10 + grp)
    hkv = 2
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    for b, s in _DECODE_SHAPES:
        q, k, v, _ = _decode_case(g, b, s, hkv, grp, hd, dtype, [0] * b)
        for name, valid in _decode_masks(g, b, s):
            before = dops.decode_attention.launches
            out = dops.decode_attention(q, k, v, valid)
            assert dops.decode_attention.launches == before + 1
            ref = decode_attention_ref(q.reshape(b, hkv, grp, hd), k, v,
                                       valid).reshape(b, hkv * grp, hd)
            torch.cuda.synchronize()
            assert out.dtype == dtype and out.shape == q.shape
            empty = ~valid.any(dim=1)
            assert bool((out[empty] == 0).all()), (b, s, name)
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= tol, (b, s, name, err)


@pytest.mark.gpu
def test_decode_kernel_gives_the_same_bits_twice():
    """Two calls on the same inputs: the same bits (the last block merges
    the splits in split order, whichever block arrives last)."""
    _need_card()
    from repro_torch.kernels.decode_attention import ops as dops
    g = torch.Generator(device="cuda").manual_seed(11)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, valid = _decode_case(g, 8, 2048, 8, 3, 128, dtype,
                                      [1448, 1402, 1336, 1388, 234, 1323,
                                       1515, 516])
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        first = dops.decode_attention(q, k, v, valid)
        again = [dops.decode_attention(q, k, v, valid) for _ in range(5)]
        torch.cuda.synchronize()
        for out in again:
            assert torch.equal(out.view(bits), first.view(bits))


@pytest.mark.gpu
def test_decode_kernel_is_one_launch():
    """One call runs one kernel on the device (the split merge is folded
    into the kernel's last block), as the profiler sees it."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.decode_attention import ops as dops
    g = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, valid = _decode_case(g, 8, 2048, 8, 3, 128, torch.bfloat16,
                                  [2048, 1, 700, 0, 64, 65, 1000, 2000])
    dops.decode_attention(q, k, v, valid)              # builds, allocates
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dops.decode_attention(q, k, v, valid)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 1, [(e.key, e.count)
                                                for e in kernels]
    assert "decode_kernel" in kernels[0].key


@pytest.mark.gpu
def test_decode_kernel_at_the_serving_shape():
    """phi4-mini's tick: B 8, S 2048, Hkv 8, G 3, hd 128, bf16, ragged."""
    _need_card()
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    g = torch.Generator(device="cuda").manual_seed(7)
    lengths = [129, 300, 700, 1024, 1500, 1600, 2000, 2048]
    q, k, v, valid = _decode_case(g, 8, 2048, 8, 3, 128, torch.bfloat16,
                                  lengths)
    out = dops.decode_attention(q, k, v, valid)
    ref = decode_attention_ref(q.reshape(8, 8, 3, 128), k, v,
                               valid).reshape(8, 24, 128)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2 ** -6


@pytest.mark.gpu
def test_decode_kernel_at_the_mixtral_window_shape():
    """mixtral-8x7b's decode over its 4,096-slot rolling window: B 1 and 8,
    S 4096, Hkv 8, G 4, hd 128, bf16, the window full and wrapped (every
    slot valid) and part-filled."""
    _need_card()
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    g = torch.Generator(device="cuda").manual_seed(17)
    for b, lengths in ((1, [4096]), (8, [4096, 4096, 100, 2000, 4095, 1,
                                         3000, 4096])):
        q, k, v, valid = _decode_case(g, b, 4096, 8, 4, 128, torch.bfloat16,
                                      lengths)
        before = dops.decode_attention.launches
        out = dops.decode_attention(q, k, v, valid)
        assert dops.decode_attention.launches == before + 1
        ref = decode_attention_ref(q.reshape(b, 8, 4, 128), k, v,
                                   valid).reshape(b, 32, 128)
        torch.cuda.synchronize()
        assert (out.float() - ref.float()).abs().max().item() <= 2 ** -6


def _dsv2_moe_layer(dtype):
    """One full-width DeepSeek-V2-Lite MoE layer's weights (64 experts of
    2048 x 1408, the fp32 router) and its config."""
    from repro_torch.common.params import Init
    from repro_torch.configs import get_config
    from repro_torch.layers.moe import init_moe
    cfg = get_config("deepseek-v2-lite-16b")
    return cfg, init_moe(cfg, Init(0, torch.device("cuda"), dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [8, 1536])
def test_moe_dispatch_gives_the_same_bytes_twice(t):
    """The dispatch's index_copy_ sends every dropped (token, choice) to
    one discarded row, in no fixed order; the kept slots are unique, so
    the layer's output is the same bits on every call (bf16, a decode
    tick's 8 tokens with cap 1 and a 1,536-token prefill)."""
    _need_card()
    from repro_torch.layers import moe
    cfg, p = _dsv2_moe_layer(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(t)
    x = (torch.randn((1, t, cfg.d_model), device="cuda", generator=g)
         + torch.randn((cfg.d_model,), device="cuda", generator=g)
         ).to(torch.bfloat16)
    routings = []
    first, _ = moe.moe_ffn(cfg, p, x, routings=routings)
    again = [moe.moe_ffn(cfg, p, x)[0] for _ in range(3)]
    torch.cuda.synchronize()
    assert int((~routings[0].keep).sum()) > 0         # drops are exercised
    for out in again:
        assert torch.equal(out.view(torch.int16), first.view(torch.int16))


@pytest.mark.gpu
def test_dsv2_decode_tick_drop_share_equals_the_cpu():
    """A full-width DeepSeek-V2-Lite cut to 2 layers (the dense first
    layer and one MoE layer), fp32: 8 ragged prompts prefilled, then one
    decode tick of the 8 slots on the card and on the CPU, the same
    weights. The tick routes 8 tokens x 6 choices into 64 experts of
    capacity 1: its drops equal the CPU's (unless a router near-tie under
    1e-6, which another summation order may flip, is present), and the
    logits agree to 1e-3 (fp32 on both, TF32 off)."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.layers import moe
    from repro_torch.models import lm
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("deepseek-v2-lite-16b").replace(n_layers=2,
                                                     dtype="float32")
    pc = lm.init_lm(cfg, seed=5)
    pcpu = {"embed": pc["embed"].cpu(), "head": pc["head"].cpu(),
            "final_ln": pc["final_ln"].cpu(),
            "layers": [{k: ({n: t.cpu() for n, t in v.items()}
                            if isinstance(v, dict) else v.cpu())
                        for k, v in lp.items()} for lp in pc["layers"]]}
    rng = np.random.default_rng(6)
    lens = rng.integers(8, 40, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)) for n in lens]
    toks = rng.integers(0, cfg.vocab_size, 8)
    out = {}
    for dev, params in (("cuda", pc), ("cpu", pcpu)):
        cache = lm.init_cache(cfg, 8, 48, device=dev)
        for i, prompt in enumerate(prompts):
            _, c1 = lm.prefill(cfg, params,
                               torch.as_tensor(prompt, device=dev)[None],
                               margin=48 - len(prompt))
            for shared, one in zip(cache, c1):
                shared[:, i].copy_(one[:, 0])
        routings = []
        logits, _ = lm.decode_step(cfg, params, cache,
                                   torch.as_tensor(toks, device=dev),
                                   torch.as_tensor(lens, device=dev),
                                   moe_routings=routings)
        (r,) = routings
        out[dev] = (r.keep.cpu(), r.idx.cpu(), float(moe.near_tie_gap(r)),
                    logits.cpu())
    (kc, ic, gap_c, lc), (kp, ip, gap_p, lp) = out["cuda"], out["cpu"]
    assert kc.shape == (48,)
    if min(gap_c, gap_p) >= 1e-6:
        assert torch.equal(ic, ip)
        assert torch.equal(kc, kp), (int((~kc).sum()), int((~kp).sum()))
        assert (lc - lp).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_decode_wrapper_checks_its_inputs_on_the_card():
    _need_card()
    from repro_torch.kernels.decode_attention import ops as dops
    q = torch.zeros((2, 6, 128), device="cuda", dtype=torch.bfloat16)
    k = torch.zeros((2, 16, 2, 128), device="cuda", dtype=torch.bfloat16)
    valid = torch.ones((2, 16), dtype=torch.bool, device="cuda")
    nc = torch.zeros((2, 2, 16, 128), device="cuda",
                     dtype=torch.bfloat16).transpose(1, 2)
    bad = [
        (q.float(), k, k, valid),                       # mixed dtypes
        (q.half(), k.half(), k.half(), valid),           # fp16 not taken
        (q, k, k, valid.to(torch.uint8)),                # mask not bool
        (q, k, k, valid.cpu()),                          # a CPU operand
        (q[:, :, :96].contiguous(), k[..., :96].contiguous(),
         k[..., :96].contiguous(), valid),               # hd 96
        (torch.zeros((2, 18, 128), device="cuda", dtype=torch.bfloat16),
         k, k, valid),                                   # G = 9
        (q, nc, nc, valid),                              # not contiguous
        (q, k[:, :8], k, valid),                         # shapes disagree
    ]
    for args in bad:
        with pytest.raises(ValueError):
            dops.decode_attention(*args)


# ---------------------------------------------------------------- segment sum
def _seg_case(g, e, n, d, dtype):
    msg = torch.randn((e, d), device="cuda", generator=g).to(dtype)
    ids = torch.randint(-1, n + 2, (e,), device="cuda", generator=g,
                        dtype=torch.int32)
    return msg, ids


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 16, 64, 68, 128, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_kernel_matches_plain_version(d, dtype):
    """Unsorted ids with dropped ones (-1, >= n) and empty segments, through
    ``segment_sum`` (perm) and ``segment_sum_csr`` on the grouped copy (no
    perm, into rows [seg_lo, seg_lo + n) of a larger output), and a
    misaligned message view (rows from an odd element offset)."""
    _need_card()
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import (
        csr_from_ids, segment_sum_csr_ref, segment_sum_ref)
    g = torch.Generator(device="cuda").manual_seed(d)
    e, n = 5000, 700
    msg, ids = _seg_case(g, e, n, d, dtype)
    before = sops.segment_sum_csr.launches
    got = sops.segment_sum(msg, ids, n)
    assert sops.segment_sum_csr.launches == before + 1
    want = segment_sum_ref(msg, ids, n)
    assert got.dtype == dtype and torch.equal(got, want)
    rowptr, perm = csr_from_ids(ids, n)
    grouped = msg[perm[:int(rowptr[-1])].long()].contiguous()
    out = torch.full((n + 9, d), float("nan"), device="cuda", dtype=dtype)
    sops.segment_sum_csr(grouped, rowptr, out=out, seg_lo=5)
    assert torch.equal(out[5:5 + n], want)
    assert bool(out[:5].isnan().all()) and bool(out[5 + n:].isnan().all())
    flat = torch.randn(e * d + 1, device="cuda", generator=g).to(dtype)
    odd = flat[1:].view(e, d)                     # 4 or 2 bytes off
    assert torch.equal(sops.segment_sum_csr(odd, rowptr, perm),
                       segment_sum_csr_ref(odd, rowptr, perm))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_kernel_edge_cases(dtype):
    """All ids dropped, N = 1, E = 0, one 100,000-edge hub beside small
    segments; two calls give the same bits."""
    _need_card()
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_ref
    g = torch.Generator(device="cuda").manual_seed(11)
    msg = torch.randn((3000, 68), device="cuda", generator=g).to(dtype)
    dropped = torch.full((3000,), -1, device="cuda", dtype=torch.int32)
    dropped[::2] = 40
    assert bool((sops.segment_sum(msg, dropped, 40) == 0).all())
    one = torch.zeros(3000, device="cuda", dtype=torch.int32)
    assert torch.equal(sops.segment_sum(msg, one, 1),
                       segment_sum_ref(msg, one, 1))
    empty = sops.segment_sum(msg[:0], one[:0], 7)
    assert empty.shape == (7, 68) and bool((empty == 0).all())
    hub_msg = torch.randn((100_000 + 3000, 68), device="cuda",
                          generator=g).to(dtype)
    hub_ids = torch.randint(0, 500, (103_000,), device="cuda", generator=g,
                            dtype=torch.int32)
    hub_ids[torch.randperm(103_000, device="cuda", generator=g)[:100_000]] = 7
    a = sops.segment_sum(hub_msg, hub_ids, 500)
    b = sops.segment_sum(hub_msg, hub_ids, 500)
    assert torch.equal(a, b)
    assert torch.equal(a, segment_sum_ref(hub_msg, hub_ids, 500))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_segment_wrapper_refuses_what_the_kernel_cannot_take():
    """ValueError, no launch, and never the plain version's answer."""
    _need_card()
    from repro_torch.kernels.segment_reduce import ops as sops
    msg = torch.ones((8, 4), device="cuda")
    ids = torch.zeros(8, device="cuda", dtype=torch.int32)
    rowptr = torch.tensor([0, 8], device="cuda", dtype=torch.int32)
    huge = torch.zeros((1, 1), device="cuda").expand(2 ** 31, 1)
    bad = [
        lambda: sops.segment_sum(msg.half(), ids, 1),            # fp16
        lambda: sops.segment_sum(msg.double(), ids, 1),          # fp64
        lambda: sops.segment_sum_csr(torch.ones((4, 8), device="cuda").T,
                                     rowptr),                    # strided
        lambda: sops.segment_sum(huge, ids[:1].expand(2 ** 31),
                                 1),                             # E >= 2^31
        lambda: sops.segment_sum_csr(huge, rowptr),
        lambda: sops.segment_sum_csr(msg, rowptr.long()),        # int64
        lambda: sops.segment_sum_csr(msg, rowptr.cpu()),         # CPU rowptr
        lambda: sops.segment_sum_csr(msg, rowptr,
                                     out=torch.empty((1, 5), device="cuda")),
    ]
    before = sops.segment_sum_csr.launches
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert sops.segment_sum_csr.launches == before


@pytest.mark.gpu
def test_egnn_forward_on_the_card_matches_the_cpu():
    """Full-width EGNN on a 3,000-node graph: card (kernel in every layer,
    one launch per chunk) against the same weights on the CPU, and
    bitwise equal across chunk budgets on the card."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import LocalExec
    cfg = get_config("egnn")
    g = gd.make_flat_graph(3000, 75_000, 100, seed=1)
    params = gd.init_model(cfg, 0, 100)
    ex = LocalExec(g, 20_000)
    before = sops.segment_sum_csr.launches
    got = gd.node_logits_local(cfg, params, g, ex=ex)
    assert sops.segment_sum_csr.launches == before + cfg.n_layers * len(ex.chunks)
    assert torch.equal(got, gd.node_logits_local(cfg, params, g,
                                                 ex=LocalExec(g, 10_000)))
    cpu_g = type(g)(*(t.cpu() for t in g))
    cpu_p = {k: ([{m: {n: t.cpu() for n, t in mp.items()}
                   for m, mp in lp.items()} for lp in v]
                 if k == "layers" else v.cpu()) for k, v in params.items()}
    want = gd.node_logits_local(cfg, cpu_p, cpu_g)
    assert (got.cpu() - want).abs().max().item() <= 1e-3 * max(
        1.0, want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_backward_on_the_card_equals_the_cpu(dtype):
    """The gradient flows through the kernel's launch on the card (Queue 3
    item 8) and equals the CPU version's: ids < 0 and >= n give 0."""
    _need_card()
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.sparse import segment as seg
    g = torch.Generator(device="cuda").manual_seed(21)
    msg, ids = _seg_case(g, 20_000, 3_000, 68, dtype)
    cot = torch.randn((3_000, 68), device="cuda", generator=g).to(dtype)
    x = msg.clone().requires_grad_(True)
    before = sops.segment_sum_csr.launches
    out = seg.segment_sum(x, ids, 3_000)
    assert sops.segment_sum_csr.launches == before + 1
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, x, cot)
    xc = msg.cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(seg.segment_sum(xc, ids.cpu(), 3_000), xc,
                                  cot.cpu())
    assert torch.equal(got.cpu(), want)
    dropped = (ids < 0) | (ids >= 3_000)
    assert not bool(got[dropped].any())
    # segment_mean differentiates through it
    xm = msg.float().clone().requires_grad_(True)
    (gm,) = torch.autograd.grad(seg.segment_mean(xm, ids, 3_000).sum(), xm)
    xmc = msg.float().cpu().requires_grad_(True)
    (gmc,) = torch.autograd.grad(
        seg.segment_mean(xmc, ids.cpu(), 3_000).sum(), xmc)
    assert torch.equal(gm.cpu(), gmc)


@pytest.mark.gpu
def test_gather_transpose_on_the_card_equals_index_add():
    """``LocalExec``'s gather transpose (the in-place kernel over the
    compacted CSR of the rows read, into its sink's buffer) against
    ``index_add_`` (atomics) within fp32 tolerance, and the same bits
    twice; one launch per backward."""
    _need_card()
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.models.gnn import common as gc
    g = torch.Generator(device="cuda").manual_seed(22)
    n, e, d = 50_000, 1 << 20, 67
    table = torch.randn((n, d), device="cuda", generator=g)
    idx = torch.randint(0, n, (e,), device="cuda", generator=g,
                        dtype=torch.int32)
    cot = torch.randn((e, d), device="cuda", generator=g)

    def grad():
        t = table.clone().requires_grad_(True)
        buf = gc._GradBuffer(t)
        token = gc._GradSink.apply(t, buf)
        rows = gc._GatherRows.apply(
            token, idx, lambda c: buf.add(c, *gc.csr_by_row(idx)))
        return torch.autograd.grad(rows, t, cot)[0]

    before = sops.segment_sum_csr_accumulate.launches
    a, b = grad(), grad()
    assert sops.segment_sum_csr_accumulate.launches == before + 2
    assert torch.equal(a, b)
    want = torch.zeros_like(table).index_add_(0, idx.long(), cot)
    torch.testing.assert_close(a, want, rtol=0, atol=1e-4)


def _acc_case(g, n_rows, n_seg, d, dtype, with_perm, mean_deg):
    """A CSR of n_seg segments of 0..2·mean_deg entries (a perm over the
    messages, or the messages in order), distinct rows of an (n_rows, d)
    output, and that output's random start."""
    deg = torch.randint(0, 2 * mean_deg + 1, (n_seg,), device="cuda",
                        generator=g)
    rowptr = torch.zeros(n_seg + 1, dtype=torch.int32, device="cuda")
    rowptr[1:] = deg.cumsum(0)
    e = int(rowptr[-1]) + 5
    msg = torch.randn((e, d), device="cuda", generator=g).to(dtype)
    perm = (torch.randperm(e, device="cuda", generator=g)[:e - 5].int()
            if with_perm else None)
    rows = torch.randperm(n_rows, device="cuda", generator=g)[:n_seg].int()
    out0 = torch.randn((n_rows, d), device="cuda", generator=g).to(dtype)
    return msg, rowptr, perm, rows, out0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 5, 33, 67, 68, 129, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accumulate_kernel_matches_plain_version(d, dtype, monkeypatch):
    """The in-place kernel against its plain version bit for bit: the
    compacted-source form (perm, listed rows, ~1.2 entries a segment) and
    the destination-range form (no perm, ``seg_lo``, ~25 entries, empty
    segments); every group size gives the same bits; rows not listed keep
    theirs; one launch a call."""
    _need_card()
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import (
        segment_sum_csr_accumulate_ref)
    g = torch.Generator(device="cuda").manual_seed(40 + d)
    msg, rowptr, perm, rows, out0 = _acc_case(g, 9_000, 4_000, d, dtype,
                                              True, 1)
    want = segment_sum_csr_accumulate_ref(msg, rowptr, perm,
                                          out=out0.clone(), rows=rows)
    auto = sops.group_size
    for group in (None, 1, 7, 31):
        monkeypatch.setattr(sops, "group_size", auto if group is None
                            else lambda n, e, group=group: group)
        before = sops.segment_sum_csr_accumulate.launches
        got = sops.segment_sum_csr_accumulate(msg, rowptr, perm,
                                              out=out0.clone(), rows=rows)
        assert sops.segment_sum_csr_accumulate.launches == before + 1
        assert torch.equal(got, want), group
    keep = torch.ones(9_000, dtype=torch.bool, device="cuda")
    keep[rows.long()] = False
    assert torch.equal(want[keep], out0[keep])
    msg, rowptr, _, _, out0 = _acc_case(g, 3_000, 1_500, d, dtype, False, 25)
    rowptr[100:201] = rowptr[100]                  # 100 empty segments
    want = segment_sum_csr_accumulate_ref(msg, rowptr, out=out0.clone(),
                                          seg_lo=700)
    for group in (None, 2, 31):
        monkeypatch.setattr(sops, "group_size", auto if group is None
                            else lambda n, e, group=group: group)
        got = sops.segment_sum_csr_accumulate(msg, rowptr, out=out0.clone(),
                                              seg_lo=700)
        assert torch.equal(got, want), group
    assert torch.equal(want[:700], out0[:700])
    assert torch.equal(want[2_200:], out0[2_200:])
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_accumulate_kernel_refuses_what_it_cannot_take():
    """ValueError and no launch: fp16, a CPU output, a width that differs,
    int64 rows, rows beside ``seg_lo``, a range past the output, messages
    that need a gradient."""
    _need_card()
    from repro_torch.kernels.segment_reduce import ops as sops
    msg = torch.ones((8, 4), device="cuda")
    rowptr = torch.tensor([0, 3, 8], device="cuda", dtype=torch.int32)
    rows = torch.tensor([5, 1], device="cuda", dtype=torch.int32)
    out = torch.zeros((6, 4), device="cuda")
    acc = sops.segment_sum_csr_accumulate
    bad = [
        lambda: acc(msg.half(), rowptr, out=out.half()),
        lambda: acc(msg, rowptr, out=out.cpu()),
        lambda: acc(msg, rowptr, out=torch.zeros((6, 5), device="cuda")),
        lambda: acc(msg, rowptr, out=out, rows=rows.long()),
        lambda: acc(msg, rowptr, out=out, rows=rows, seg_lo=1),
        lambda: acc(msg, rowptr, out=out, seg_lo=5),
        lambda: acc(msg.clone().requires_grad_(True), rowptr, out=out),
    ]
    before = acc.launches
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert acc.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [67, 68])
def test_forward_kernel_bits_unchanged_beside_accumulate(d):
    """The summing kernel (the forward's, the index path's) still equals
    its plain version bit for bit at EGNN's widths, and the in-place kernel
    into zeros equals it (0 + s = s)."""
    _need_card()
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_csr_ref
    g = torch.Generator(device="cuda").manual_seed(60 + d)
    msg, rowptr, perm, _, _ = _acc_case(g, 1, 20_000, d, torch.float32, True,
                                        25)
    fwd = sops.segment_sum_csr(msg, rowptr, perm)
    assert torch.equal(fwd, segment_sum_csr_ref(msg, rowptr, perm))
    zeros = torch.zeros((20_000, d), device="cuda")
    assert torch.equal(sops.segment_sum_csr_accumulate(msg, rowptr, perm,
                                                       out=zeros), fwd)


def _egnn_train_case(n=3000, e=75_000):
    from repro_torch.configs import get_config
    from repro_torch.models.gnn import driver as gd
    cfg = get_config("egnn")
    g = gd.make_flat_graph(n, e, 100, seed=1)
    params = gd.init_model(cfg, 0, 100)
    return cfg, g, params


@pytest.mark.gpu
def test_egnn_train_step_on_the_card_matches_the_cpu(monkeypatch):
    """A full-width EGNN step on a 3,000-node graph in message blocks of
    16,384 edges: the card's new params and gradients against the same
    step on the CPU (1e-3 relative to max(1, |want|)), the same bits twice
    and for another chunk budget, ``layers × chunks`` launches of the
    summing kernel (the forward's chunks) and ``layers × 2 × blocks`` of the
    in-place one (each block's two gather transposes)."""
    _need_card()
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.models.gnn import common as gc
    from repro_torch.models.gnn import driver as gd
    from repro_torch.train.optimizer import init_adamw
    monkeypatch.setattr(gc, "MSG_BLOCK_EDGES", 1 << 14)
    cfg, g, params = _egnn_train_case()
    step = gd.make_train_step(cfg, "full_graph")
    ex = gc.LocalExec(g, 20_000)
    blocks = -(-ex.n_edges // ex.block)
    assert blocks > 1 and len(ex.chunks) > 1

    def grads(p, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss, _ = gd.train_loss(cfg, "full_graph", live, batch)
        return torch.autograd.grad(loss, leaves(live))

    before = sops.segment_sum_csr.launches
    before_acc = sops.segment_sum_csr_accumulate.launches
    new, _, m = step(params, init_adamw(params), {"graph": g, "exec": ex})
    assert sops.segment_sum_csr.launches - before == cfg.n_layers * len(
        ex.chunks)
    assert sops.segment_sum_csr_accumulate.launches - before_acc == (
        cfg.n_layers * 2 * blocks)
    again, _, _ = step(params, init_adamw(params), {"graph": g, "exec": ex})
    half, _, _ = step(params, init_adamw(params),
                      {"graph": g, "exec": gc.LocalExec(g, 9_000)})
    for a, b, c in zip(leaves(new), leaves(again), leaves(half)):
        assert torch.equal(a, b) and torch.equal(a, c)
    cpu = lambda t: t.cpu()                                 # noqa: E731
    cg, cp = type(g)(*(t.cpu() for t in g)), tree_map(cpu, params)
    want, _, wm = step(cp, init_adamw(cp), {"graph": cg})
    for a, b in zip(leaves(new), leaves(want)):
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * max(
            1.0, b.abs().max().item())
    for a, b in zip(grads(params, {"graph": g, "exec": ex}),
                    grads(cp, {"graph": cg})):
        assert (a.cpu() - b).abs().max().item() <= 1e-3 * max(
            1.0, b.abs().max().item())
    assert abs(float(m["loss"]) - float(wm["loss"])) <= 1e-3 * max(
        1.0, abs(float(wm["loss"])))


@pytest.mark.gpu
def test_no_grad_forward_still_launches_layers_x_chunks():
    """Serving's forward under ``no_grad``: one launch per chunk and layer,
    the bits of the forward taken under grad."""
    _need_card()
    from repro_torch.common.tree import tree_map
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import LocalExec
    cfg, g, params = _egnn_train_case()
    ex = LocalExec(g, 20_000)
    before = sops.segment_sum_csr.launches
    with torch.no_grad():
        plain = gd.node_logits_local(cfg, params, g, ex=ex)
    assert sops.segment_sum_csr.launches - before == cfg.n_layers * len(
        ex.chunks)
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    assert torch.equal(gd.node_logits_local(cfg, live, g, ex=ex).detach(),
                       plain)


@pytest.mark.gpu
def test_recover_on_the_card_gives_the_live_bytes(tmp_path):
    """The crash harness's op script (two snapshots, NSW lane, a tail) on a
    ``DurableHMGIIndex`` on the card (no device given), then ``recover``
    (no device given): search and hybrid_search bytes equal the live index
    and the golden prefix replayed into a fresh index on the card."""
    _need_card()
    from repro_torch.persistence import DurableHMGIIndex, recover
    from repro_torch.persistence import crash_harness as ch
    cfg = ch.make_cfg()
    live = DurableHMGIIndex(cfg, str(tmp_path), seed=0)
    assert live.device.type == "cuda"
    d = ch.apply_ops(live, ch.scripted_ops())
    rec = recover(cfg, str(tmp_path), seed=0)
    assert rec.device.type == "cuda" and rec.last_seq == d
    assert "snapshot step" in rec.metrics()["recovery"]
    ch.assert_bit_identical(rec, live, "recovered vs live")
    ch.assert_bit_identical(rec, ch.golden_index(cfg, d), "recovered vs golden")
    live.close()
    rec.close()


@pytest.mark.gpu
def test_fit_and_hop_operator_repeat_bitwise_on_the_card():
    """The k-means cluster sums and the hop operator's out-weights run the
    fixed-order segment-sum kernel: three runs give the same bytes, and
    each launches the kernel. The card's cluster sums equal
    ``partitioner.run_sums``' plain version on the CPU bitwise."""
    _need_card()
    from repro_torch.core import partitioner, traversal
    from repro_torch.core.graph_store import from_edges
    from repro_torch.kernels.segment_reduce import ops as sops
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((200_000, 64), device="cuda", generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    init = torch.arange(0, 200_000, 3125)
    before = sops.segment_sum_csr.launches
    fits = [partitioner.fit(x, 64, 8, init_idx=init) for _ in range(3)]
    # two launches an iteration: the runs, then each cluster's runs
    assert sops.segment_sum_csr.launches == before + 3 * 8 * 2
    for f in fits[1:]:
        assert torch.equal(f.centroids, fits[0].centroids)
        assert torch.equal(f.counts, fits[0].counts)
    a = partitioner.assign(x, fits[0].centroids)
    assert torch.equal(partitioner.run_sums(x, a, 64).cpu(),
                       partitioner.run_sums(x.cpu(), a.cpu(), 64))
    rng = np.random.default_rng(1)
    n, e = 50_000, 400_000
    gs = from_edges(n, rng.integers(0, n, e), rng.integers(0, n, e),
                    rng.integers(0, 4, e), rng.random(e).astype(np.float32),
                    device="cuda")
    ops_ = [traversal._push_operator(gs, traversal._edge_weights(gs, None))
            for _ in range(3)]
    for a in ops_[1:]:
        assert torch.equal(a.indices(), ops_[0].indices())
        assert torch.equal(a.values(), ops_[0].values())


@pytest.mark.gpu
def test_bf16_checkpoint_leaf_round_trips_bitwise_on_the_card(tmp_path):
    _need_card()
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    g = torch.Generator(device="cuda").manual_seed(2)
    w = torch.randn((33, 7), device="cuda", generator=g).to(torch.bfloat16)
    w[0, 0] = float("nan")
    save_checkpoint(str(tmp_path), 1, {"w": w, "i": torch.arange(4)})
    got, _, _ = restore_checkpoint(str(tmp_path), {"w": w,
                                                   "i": torch.arange(4)})
    assert got["w"].device == w.device and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    flat, _, _ = restore_checkpoint(str(tmp_path), like=None)
    assert flat["w"].dtype == torch.bfloat16
    assert torch.equal(flat["w"].view(torch.int16), w.cpu().view(torch.int16))


def _sharded_pair(n_shards, **over):
    """The small card index and its state in a facade over a mesh of
    ``n_shards`` shards on the same card (layout forced to sharded)."""
    from repro_torch.core.index import HMGIIndex
    from repro_torch.sharding import Mesh
    gpu, c = _small_card_index(**over)
    dev = str(gpu.device)
    mesh = Mesh([dev] * n_shards, ("data",))
    sh = HMGIIndex(gpu.cfg.replace(shard_layout="sharded"), mesh=mesh)
    sh.restore_state(*gpu.state_tree())
    return gpu, sh, c


def _queries(c, n=32, seed=3):
    rng = np.random.default_rng(seed)
    v = c.vectors["text"]
    return (v[:n] + 0.05 * rng.normal(size=(n, v.shape[1]))).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_search_equals_single_on_the_card(n_shards):
    """On the kernel path the sharded search's scores equal the single
    layout's with torch.equal (ids up to exact ties), plain, filtered and
    at full probe; the probe kernel runs once per shard per search."""
    _need_card()
    gpu, sh, c = _sharded_pair(n_shards)
    q = _queries(c)
    assert sh.device_layout("text").n_shards == n_shards
    for kw in (dict(), dict(n_probe=16), dict(n_probe=8, impl="kernel")):
        want = gpu.search(q, "text", k=10, **kw)
        before = ops.probe_scan.launches
        got = sh.search(q, "text", k=10, **kw)
        assert ops.probe_scan.launches - before == n_shards
        assert torch.equal(got[0], want[0])
        # an id may differ only where its score repeats in the row
        for r, j in torch.nonzero(got[1] != want[1]).tolist():
            assert int((want[0][r] == want[0][r, j]).sum()) > 1


@pytest.mark.gpu
def test_each_shards_probe_kernel_equals_its_plain_version():
    """Each shard's probe kernel at its cap_l = ceil(cap / S), which is not
    a multiple of the 16-row chunk, against the plain version."""
    _need_card()
    from repro_torch.common.reduce import row_sum
    from repro_torch.core import ivf as ivf_mod
    from repro_torch.core.partitioner import assign_topk
    gpu, c = _small_card_index()
    m = gpu.modalities["text"]
    q = gpu._norm_queries(_queries(c))
    probes, _ = assign_topk(q, m.ivf.centroids, 4)
    probes = probes.to(torch.int32).contiguous()
    sh = ivf_mod.shard_index(m.ivf, 4)
    for s in range(4):
        loc = ivf_mod.IVFIndex(*(getattr(sh, f)[s] for f in (
            "centroids", "data", "vmin", "scale", "ids", "counts")), bits=8)
        data, vmin, scale, ids = loc.slab_view()
        bias = torch.where(ids >= 0, 0.0, ref.NEG).float()
        args = (q, row_sum(q), data, (128.0 * scale + vmin).contiguous(),
                scale, bias, probes, loc.capacity, 16)
        km, ka = ops.probe_scan(*args)
        pm, pa = ref.probe_scan(*args)
        torch.cuda.synchronize()
        _assert_match((km, ka), (pm, pa))


@pytest.mark.gpu
def test_replica_after_maintain_equals_a_fresh_shard_index():
    """A maintain pass that changes the slab drops the replica; the next
    sharded search builds one equal to a fresh shard_index, and answers as
    the single layout does."""
    _need_card()
    from repro_torch.core import ivf as ivf_mod
    gpu, sh, c = _sharded_pair(4, maint_auto=False)
    q = _queries(c, 16)
    for idx in (gpu, sh):           # the same probe heat on both
        idx.search(q, "text")
    m = sh.modalities["text"]
    assert m.ivf_sharded is not None
    rng = np.random.default_rng(5)
    ids = np.arange(40, dtype=np.int32)
    rows = rng.normal(size=(40, 64)).astype(np.float32)
    for idx in (gpu, sh):
        idx.insert("text", ids, rows)
        assert not idx.maintain("text", budget=4096, need_rows=40).is_noop
    assert m.ivf_sharded is None
    want = gpu.search(q, "text")
    got = sh.search(q, "text")
    assert torch.equal(got[0], want[0])
    fresh = ivf_mod.shard_index(m.ivf, 4)
    for s, loc in enumerate(m.ivf_sharded):
        for f in ("centroids", "data", "vmin", "scale", "ids", "counts"):
            assert torch.equal(getattr(loc, f), getattr(fresh, f)[s]), f


@pytest.mark.gpu
def test_sharded_search_across_cards():
    """With two cards or more, one shard per card: each shard's replica
    lies on its own card, every card runs the probe kernel once a search,
    and the merged scores equal the single layout's on the first card."""
    _need_card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    from repro_torch.core.index import HMGIIndex
    from repro_torch.sharding import Mesh
    gpu, c = _small_card_index()
    mesh = Mesh([f"cuda:{i}" for i in range(n)], ("data",))
    sh = HMGIIndex(gpu.cfg.replace(shard_layout="sharded"), mesh=mesh,
                   device="cuda:0")
    sh.restore_state(*gpu.state_tree())
    q = _queries(c)
    for kw in (dict(), dict(n_probe=16)):
        want = gpu.search(q, "text", k=10, **kw)
        before = ops.probe_scan.launches
        got = sh.search(q, "text", k=10, **kw)
        assert ops.probe_scan.launches - before == n
        assert got[0].device == want[0].device
        assert torch.equal(got[0], want[0])
        for r, j in torch.nonzero(got[1] != want[1]).tolist():
            assert int((want[0][r] == want[0][r, j]).sum()) > 1
    devs = [loc.data.device for loc in sh.modalities["text"].ivf_sharded]
    assert devs == [torch.device("cuda", i) for i in range(n)]
