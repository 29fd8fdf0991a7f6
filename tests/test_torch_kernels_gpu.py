"""Card-only tests of the port: each CUDA kernel against its plain version,
and the facade on the card against the same index on the CPU.

Every test carries the ``gpu`` marker and skips itself when
``torch.cuda.is_available()`` is false (decided inside the test, so every
pytest-xdist worker collects the same tests). This file imports neither
JAX nor the reference package, so it runs on a card host without them:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance: 1e-4 absolute on scores of O(1) (fp32 sums over d ≤ 384 in
another order); the argmax may move only between rows whose scores tie to
rounding, so at least 99% of chunk argmaxes agree.
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
