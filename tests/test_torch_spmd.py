"""The single-controller SPMD runner of the port
(``sharding/collectives.py``: ``spmd``, ``ShardCtx``, ``replicate_tree``),
on the CPU: a body runs once per shard in a thread of its own, its
collectives are rendezvous that compute the shard-list collectives, a
failing shard ends the call with its own exception, and replicated
parameters take the shards' gradients added in shard order.
"""
import pytest

pytest.importorskip("torch")

import threading
import time

import numpy as np
import torch

from repro_torch.roofline.trace import Counter
from repro_torch.sharding import Mesh
from repro_torch.sharding import collectives as col

LIMIT_S = 30.0


def grid(shape=(2, 2)):
    names = ("data",) if len(shape) == 1 else ("data", "model")
    return Mesh(np.array(["cpu"] * int(np.prod(shape))).reshape(shape),
                names)


def within_limit(fn):
    """``fn()`` in a helper thread, joined within ``LIMIT_S`` seconds: a
    hang fails the test instead of stalling the run. Returns (result,
    exception)."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:                     # noqa: BLE001
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT_S)
    assert not t.is_alive(), f"spmd did not return within {LIMIT_S} s"
    return box.get("out"), box.get("err")


def shard_tensors(mesh, seed=0, shape=(5, 3)):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g) for _ in col.shards(mesh)]


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_results_come_back_in_shard_order(shape):
    """Each shard's body sees its own shard and operands, in a thread of
    its own; the results come back in shard order whatever order the
    bodies end in."""
    mesh = grid(shape)
    main = threading.get_ident()
    delays = [0.03, 0.0, 0.02, 0.01]

    def body(ctx, x, delay):
        time.sleep(delay)
        return (ctx.index, dict(ctx.shard.coords), str(ctx.device), x,
                threading.get_ident() != main)

    got = col.spmd(mesh, body, list("abcd"), delays)
    assert [r[0] for r in got] == [0, 1, 2, 3]
    assert [r[1] for r in got] == [s.coords for s in col.shards(mesh)]
    assert [r[3] for r in got] == list("abcd")
    assert all(r[2] == "cpu" and r[4] for r in got)
    with pytest.raises(ValueError, match="per-shard operands"):
        col.spmd(mesh, body, list("abc"), delays)


def test_shards_of_one_device_take_turns():
    """Four shards of one device run one at a time between collectives:
    no two bodies compute at once, yet all meet at each rendezvous."""
    mesh = grid((4,))
    active, peak, lock = [0], [0], threading.Lock()

    def enter():
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])

    def leave():
        with lock:
            active[0] -= 1

    def body(ctx, x):
        for _ in range(3):
            enter()
            time.sleep(0.005)
            x = x + 1
            leave()
            x = ctx.psum(x, "data")
        return x

    out = col.spmd(mesh, body, shard_tensors(mesh))
    assert peak[0] == 1 and all(torch.equal(o, out[0]) for o in out)


def test_shards_of_one_device_number_their_nodes_in_turn_order():
    """Under grad, the autograd nodes the shards of one device make are
    numbered in the order they were made, across the shards' threads, as
    one thread would number them (the backward then runs them one shard's
    block at a time, highest number first)."""
    mesh = grid((4,))
    w = torch.ones(3, requires_grad=True)
    made, lock = [], threading.Lock()

    def body(ctx, x):
        for _ in range(3):
            for _ in range(ctx.index + 2):      # unequal node counts
                x = x * w
                with lock:
                    made.append(x.grad_fn._sequence_nr())
            x = ctx.psum(x, "data")
        return x

    col.spmd(mesh, body, [torch.ones(3) for _ in range(4)])
    assert len(made) == 3 * (2 + 3 + 4 + 5)
    assert all(a < b for a, b in zip(made, made[1:])), made


def test_shards_of_one_device_take_turns_in_shard_order():
    """Between two collectives the shards of one device run in shard
    order, whichever thread is ready first (shard 3's is ready at once,
    shard 0's last), as one program over the shards would."""
    mesh = grid((4,))
    order, lock = [], threading.Lock()

    def body(ctx, x):
        for phase in range(3):
            time.sleep(0.002 * (3 - ctx.index) if phase == 0 else 0)
            with lock:
                order.append((phase, ctx.index))
            x = ctx.psum(x, "data")
        return x

    _, err = within_limit(lambda: col.spmd(mesh, body, shard_tensors(mesh)))
    assert err is None
    assert order == [(p, i) for p in range(3) for i in range(4)]


def test_turn_numbering_is_counted_and_needs_its_torch_function(
        monkeypatch):
    """Under grad on a shared device the turns' throwaway autograd nodes
    and their seconds are counted in ``STAGGER``, and none without grad.
    A torch without the function that reads a thread's creation number
    is refused under grad, where shards share a device, and not
    without grad."""
    mesh = grid((4,))
    w = torch.ones(3, requires_grad=True)

    def body(ctx, x):
        for _ in range(ctx.index + 2):
            x = x * w
        return ctx.psum(x, "data")

    xs = [torch.ones(3) for _ in range(4)]
    col.STAGGER.update(nodes=0, seconds=0.0)
    with torch.no_grad():
        col.spmd(mesh, body, xs)
    assert col.STAGGER == {"nodes": 0, "seconds": 0.0}
    col.spmd(mesh, body, xs)
    assert col.STAGGER["nodes"] > 0 and col.STAGGER["seconds"] > 0
    monkeypatch.setattr(col, "_SEQUENCE_NR", None)
    with pytest.raises(RuntimeError, match="_get_sequence_nr"):
        col.spmd(mesh, body, xs)
    with torch.no_grad():
        col.spmd(mesh, body, xs)


@pytest.mark.parametrize("axes", ["data", "model", ("data", "model")])
def test_rendezvous_collectives_equal_the_shard_lists_bitwise(axes):
    """psum, rotate, ppermute and all_gather (tiled or stacked) through
    the rendezvous give each shard exactly what the shard-list
    collectives give it."""
    mesh = grid()
    xs = shard_tensors(mesh)
    n = col.size(mesh, axes)
    perm = [(i, (i + 1) % n) for i in range(n - 1)]   # the last gets zeros

    def body(ctx, x):
        return (ctx.psum(x, axes), ctx.rotate(x, axes),
                ctx.ppermute(x, axes, perm),
                ctx.all_gather(x, axes, dim=1),
                ctx.all_gather(x, axes, tiled=False))

    got = col.spmd(mesh, body, xs)
    want = list(zip(col.psum(xs, mesh, axes), col.rotate(xs, mesh, axes),
                    col.ppermute(xs, mesh, axes, perm),
                    col.all_gather(xs, mesh, axes, dim=1),
                    col.all_gather(xs, mesh, axes, tiled=False)))
    for g_shard, w_shard in zip(got, want):
        for a, b in zip(g_shard, w_shard):
            assert a.shape == b.shape and torch.equal(a, b)


def test_collectives_report_once_to_the_callers_counter():
    """A dry-run counter entered by the caller sees each rendezvous
    collective once; its bodies' operators and kernel calls are not its
    own (the counter is active where its dispatch mode is), while the
    caller's are."""
    from repro_torch.kernels.segment_reduce import ops
    mesh = grid((4,))
    xs = shard_tensors(mesh)
    rowptr = torch.tensor([0, 2, 5], dtype=torch.int32)

    def body(ctx, x):
        ops.segment_sum_csr(x, rowptr)
        return ctx.rotate(ctx.psum(x, "data"), "data")

    with Counter() as c:
        col.spmd(mesh, body, xs)
        assert "segment_sum" not in c.kernels
        ops.segment_sum_csr(xs[0], rowptr)
    assert c.kernels["segment_sum"]["launches"] == 1
    assert c.collective_ops["all-reduce"] == 1
    assert c.collective_ops["collective-permute"] == 1
    assert c.collective_total["collective-permute"] == 4 * xs[0].numel() * 4


def test_a_failing_shard_raises_in_the_caller():
    """Shard 2 raises while the others wait at a psum: the call ends within
    the time limit with shard 2's own exception, noted with its index, and
    no thread outlives it."""
    mesh = grid()
    before = threading.active_count()

    def body(ctx, x):
        if ctx.index == 2:
            raise ValueError("shard two cannot")
        return ctx.psum(x, "data")

    _, err = within_limit(lambda: col.spmd(mesh, body, shard_tensors(mesh)))
    assert isinstance(err, ValueError) and "shard two cannot" in str(err)
    assert any("shard 2 of 4" in note for note in err.__notes__)
    assert threading.active_count() == before


@pytest.mark.parametrize("case", ["other collective", "ends early"])
def test_mismatched_collectives_raise_instead_of_hanging(case):
    """Shards that meet at different collectives, or a shard that ends its
    body while the others wait at one, raise ``CollectiveError`` within
    the time limit."""
    mesh = grid((4,))
    before = threading.active_count()

    def body(ctx, x):
        if ctx.index == 1:
            return x if case == "ends early" else ctx.rotate(x, "data")
        return ctx.psum(x, "data")

    _, err = within_limit(lambda: col.spmd(mesh, body, shard_tensors(mesh)))
    assert isinstance(err, col.CollectiveError), err
    assert "different collectives" in str(err)
    assert threading.active_count() == before


def test_bodies_take_the_callers_grad_and_inference_modes():
    """Grad mode and inference mode are thread-local: each body runs under
    the caller's. A ``no_grad`` caller's bodies build no graph."""
    mesh = grid()
    w = torch.ones(3, requires_grad=True)

    def body(ctx, x):
        y = (x * w).sum()
        return (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
                y.requires_grad, y.grad_fn is None)

    xs = shard_tensors(mesh)
    with torch.no_grad():
        assert all(r == (False, False, False, True)
                   for r in col.spmd(mesh, body, xs))
    with torch.inference_mode():
        assert all(r[:3] == (False, True, False)
                   for r in col.spmd(mesh, body, xs))
    assert all(r == (True, False, True, False)
               for r in col.spmd(mesh, body, xs))


def _replicated_grads(mesh, seed):
    """The gradient of a replicated parameter tree through bodies of
    unequal work, and each shard's own gradient."""
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(6, 4, generator=g).requires_grad_(True),
              "b": torch.randn(4, generator=g).requires_grad_(True)}
    xs = [torch.randn(3 + 2 * i, 6, generator=g) for i in range(4)]

    def body(ctx, p, x):
        for _ in range(ctx.index + 1):          # unequal work per shard
            x = torch.tanh(x @ p["w"] + p["b"]) @ p["w"].T
        return ctx.psum((x * x).sum(), "data")

    per_shard = col.spmd(mesh, body, col.replicate_tree(params, mesh), xs)
    grads = torch.autograd.grad(per_shard[0], [params["w"], params["b"]])
    own = []
    for i, x in enumerate(xs):
        w = params["w"].detach().requires_grad_(True)
        b = params["b"].detach().requires_grad_(True)
        for _ in range(i + 1):
            x = torch.tanh(x @ w + b) @ w.T
        own.append(torch.autograd.grad((x * x).sum(), [w, b]))
    return grads, own


def test_replicated_gradients_are_the_shard_order_sum_and_repeat():
    """A replicated parameter's gradient is its shards' gradients added in
    shard order (bit for bit), and two runs give the same bits."""
    mesh = grid((4,))
    grads, own = _replicated_grads(mesh, 7)
    for k in range(2):
        total = own[0][k]
        for o in own[1:]:
            total = total + o[k]
        assert torch.equal(grads[k], total)
    again, _ = _replicated_grads(mesh, 7)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    reps = col.replicate_tree({"w": torch.ones(2)}, mesh)
    assert len(reps) == 4 and all(torch.equal(r["w"], torch.ones(2))
                                  for r in reps)
