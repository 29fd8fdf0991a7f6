"""Collectives over a ``Mesh`` on one controller: the port's counterparts
of ``lax.psum``, ``pmean``, ``all_gather``, ``ppermute`` and
``axis_index``.

The reference's mesh bodies run under ``shard_map``: one program per
shard, with collectives between them. The port runs them from one Python
process, as JAX's single controller does: a value that differs by shard
is a *shard list*, one tensor per shard of the mesh in its row-major
order (``shards(mesh)``), each on its shard's device. The functions here
are the only place that loops over shards:

- ``map_shards(fn, mesh, *lists)`` runs a body once per shard;
- ``blocks`` / ``split`` cut a global tensor into each shard's block (an
  operand's ``in_specs``) and ``unsplit`` joins blocks again (an
  ``out_specs=P(axes)`` result);
- ``psum`` / ``pmean`` add, in shard order, the tensors of each group of
  shards that differ only along the given axes, so a sum has the same
  bits on every run; ``all_gather`` joins a group's tensors along a
  dimension; ``ppermute`` moves each group's tensors by a permutation of
  their coordinates along the axes (a shard that receives nothing gets
  zeros, as in JAX); ``axis_index`` is a shard's coordinate along them.

A move between shards is ``.to(device)``, a no-op where the mesh repeats
one device (four shards on one card). Each collective reports its bytes
to the dry-run counter (``roofline.trace.collective``) as the reference's
HLO would carry them: per device, over the shards of the groups with more
than one member (a group of one moves nothing). Every collective is built of
differentiable tensor operations, so autograd runs through them: the
gradient of a replicated input is the sum of its shards' gradients, as
``shard_map`` gives it for a ``P()`` operand.

Two forms of a mesh body use them:

- **shard lists** (``map_shards``): one Python loop over the shards,
  each collective a call on every shard's tensor at once. ``moe_ffn``,
  ``lookup_sharded`` and ``retrieval_score`` run so: they cut their
  operands here (``split``, ``blocks``) and join their results onto the
  first shard's device (``unsplit``).
- **per-shard bodies** (``spmd``), what ``shard_map`` is on one
  controller: ``spmd(mesh, body, *per_shard)`` runs ``body(ctx, ...)``
  once per shard, each in a thread of its own with its shard's device
  current and the caller's grad and inference modes, and returns the
  results in shard order. Shards on one device take turns on it between
  collectives, in shard order (four shards of one card run one at a
  time, in the order the shard lists run them, and under grad their
  autograd nodes are numbered in that order, so a backward runs them as
  one thread's, alike on every run); shards on devices of their own run
  at once. The body sees its own blocks only; its
  collectives (``ShardCtx.psum``, ``rotate``, ``all_gather``, ...) are
  rendezvous: every shard hands in its tensor at a ``threading.Barrier``,
  the last to arrive runs the shard-list function above on all of them
  (one report to the caller's dry-run counter), and each takes its own
  result back. A shard that raises aborts the barrier, so every other
  shard's wait breaks; the caller joins every thread and re-raises the
  shard's own exception, noted with its index. Replicated operands
  (``P()``) go through ``replicate_tree``, whose backward adds the
  shards' gradients in shard order, so a step's bits do not depend on
  the threads' timing. The GNN ring (``models/gnn/common.py``) runs so:
  each shard holds its ``n_loc`` node rows on its device.

Thread-local state does not follow a body into its thread beyond the
grad and inference modes: a ``TorchDispatchMode`` (the dry run's
``Counter``) or autocast entered by the caller does not see the bodies'
operators. The layout is one controller's: a backend with one process
per rank (``torch.distributed``) would replace the threads.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, List, NamedTuple, Sequence, Tuple, Union

import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.common.tree import leaves, tree_map
from repro_torch.roofline import trace
from repro_torch.sharding.rules import Mesh, _axes_size, _present

Axes = Union[str, Sequence[str]]


class Shard(NamedTuple):
    """One shard of a mesh: its position in row-major order, its
    coordinate on each axis, and its device."""
    index: int
    coords: dict
    device: torch.device


def _axes(mesh: Mesh, axes: Axes) -> Tuple[str, ...]:
    """``axes`` as a tuple of the mesh's axis names (each must exist)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} is not in the mesh {mesh.shape}")
    return axes


def shards(mesh: Mesh) -> List[Shard]:
    """Every shard of the mesh in row-major order."""
    sizes = list(mesh.devices.shape)
    out = []
    for i, dev in enumerate(mesh.devices.reshape(-1)):
        coords, rest = {}, i
        for a, n in zip(reversed(mesh.axis_names), reversed(sizes)):
            coords[a] = rest % n
            rest //= n
        out.append(Shard(i, {a: coords[a] for a in mesh.axis_names}, dev))
    return out


def size(mesh: Mesh, axes: Axes) -> int:
    """The number of shards along ``axes`` (1 for none)."""
    return _axes_size(mesh, _axes(mesh, axes))


def axis_index(mesh: Mesh, axes: Axes, shard: Shard) -> int:
    """``shard``'s coordinate along ``axes``, row-major over them
    (``lax.axis_index``)."""
    i = 0
    for a in _axes(mesh, axes):
        i = i * mesh.shape[a] + shard.coords[a]
    return i


def groups(mesh: Mesh, axes: Axes) -> List[List[int]]:
    """The shards that differ only along ``axes``, one list per group, each
    in the order of its coordinate along them."""
    axes = _axes(mesh, axes)
    by_key = {}
    for s in shards(mesh):
        key = tuple(s.coords[a] for a in mesh.axis_names if a not in axes)
        by_key.setdefault(key, []).append(s)
    return [[s.index for s in sorted(g, key=lambda s: axis_index(mesh, axes,
                                                                  s))]
            for g in by_key.values()]


def _report(kind: str, xs, gs, result_bytes) -> None:
    """One collective over the groups ``gs`` to the dry-run counter: per
    device ``result_bytes(group, operand bytes)``, none for groups of one."""
    big = [g for g in gs if len(g) > 1]
    if big:
        g = big[0]
        trace.collective(kind, result_bytes(g, trace.tensor_bytes(xs[g[0]])),
                         sum(len(g) for g in big))


def map_shards(fn: Callable, mesh: Mesh, *lists) -> list:
    """``[fn(shard, *(l[i] for l in lists)) for each shard i]``: a body run
    once per shard, in shard order."""
    return [fn(s, *(l[s.index] for l in lists)) for s in shards(mesh)]


def replicate(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """A ``P()`` operand: ``x`` on every shard's device."""
    return [x.to(s.device) for s in shards(mesh)]


def blocks(x: torch.Tensor, mesh: Mesh, spec: Sequence) -> List[torch.Tensor]:
    """An operand with in_spec ``spec`` (one entry a dimension: None, an
    axis name or a tuple of them; axes the mesh lacks are dropped): each
    shard's block of ``x`` (a view where the device does not change),
    replicated over the axes the spec leaves out. Each split dimension
    must divide by its shards."""
    cuts = []
    for dim, ax in enumerate(spec):
        ax = _present(mesh, ax)
        n = size(mesh, ax)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide into {n} shards over {ax}")
        if n > 1:
            cuts.append((dim, ax, n))

    def block(s):
        b = x
        for dim, ax, n in cuts:
            b = torch.chunk(b, n, dim)[axis_index(mesh, ax, s)]
        return b.to(s.device)

    return [block(s) for s in shards(mesh)]


def split(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int = 0
          ) -> List[torch.Tensor]:
    """A ``P(axes)`` operand on ``dim`` (``blocks``)."""
    axes = _axes(mesh, axes)
    return blocks(x, mesh, (None,) * dim + (axes,))


def firsts(xs: Sequence, mesh: Mesh, axes: Axes) -> list:
    """The entries of the shards at coordinate 0 of every axis not in
    ``axes``, in their order along ``axes`` (shard 0's alone for none)."""
    axes = _axes(mesh, axes)
    first = [s for s in shards(mesh)
             if all(v == 0 for a, v in s.coords.items() if a not in axes)]
    first.sort(key=lambda s: axis_index(mesh, axes, s))
    return [xs[s.index] for s in first]


def unsplit(xs: Sequence[torch.Tensor], mesh: Mesh, axes: Axes,
            dim: int = 0) -> torch.Tensor:
    """An ``out_specs=P(axes)`` result: ``firsts``' blocks joined along
    ``dim`` on the first shard's device. No axes: shard 0's."""
    dev = shards(mesh)[0].device
    parts = [t.to(dev) for t in firsts(xs, mesh, axes)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def psum(xs: Sequence[torch.Tensor], mesh: Mesh, axes: Axes
         ) -> List[torch.Tensor]:
    """``lax.psum``: each shard gets the sum of its group's tensors, added
    left to right in the group's order on the first member's device."""
    out = list(xs)
    devs = [s.device for s in shards(mesh)]
    _report("all-reduce", xs, groups(mesh, axes), lambda g, t: t)
    for g in groups(mesh, axes):
        total = xs[g[0]]
        for i in g[1:]:
            total = total + xs[i].to(total.device)
        for i in g:
            out[i] = total.to(devs[i])
    return out


def pmean(xs: Sequence[torch.Tensor], mesh: Mesh, axes: Axes
          ) -> List[torch.Tensor]:
    """``lax.pmean``: ``psum`` divided by the group's size."""
    n = size(mesh, axes)
    return [t / n for t in psum(xs, mesh, axes)]


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh, axes: Axes,
               dim: int = 0, tiled: bool = True) -> List[torch.Tensor]:
    """``lax.all_gather``: each shard gets its group's tensors joined along
    ``dim`` (``tiled``) or stacked on a new ``dim``, in the group's
    order."""
    out = list(xs)
    devs = [s.device for s in shards(mesh)]
    _report("all-gather", xs, groups(mesh, axes), lambda g, t: len(g) * t)
    for g in groups(mesh, axes):
        dev = xs[g[0]].device
        parts = [xs[i].to(dev) for i in g]
        if tiled:
            joined = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
        else:
            joined = torch.stack(parts, dim)
        for i in g:
            out[i] = joined.to(devs[i])
    return out


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh, axes: Axes,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``lax.ppermute``: within each group, the tensor at coordinate
    ``src`` moves to coordinate ``dst`` for every ``(src, dst)`` of
    ``perm``; a shard that receives nothing gets zeros."""
    out = [None] * len(xs)
    devs = [s.device for s in shards(mesh)]
    moves = [(s, d) for s, d in perm if s != d]
    if moves:
        gs = groups(mesh, axes)
        trace.collective("collective-permute",
                         trace.tensor_bytes(xs[gs[0][moves[0][0]]]),
                         len(moves) * len(gs))
    for g in groups(mesh, axes):
        for src, dst in perm:
            out[g[dst]] = xs[g[src]].to(devs[g[dst]])
        for i in g:
            if out[i] is None:
                out[i] = torch.zeros_like(xs[i])
    return out


def rotate(xs: Sequence[torch.Tensor], mesh: Mesh, axes: Axes
           ) -> List[torch.Tensor]:
    """One step around the ring over ``axes``: coordinate i's tensor moves
    to i + 1 (mod the ring's size)."""
    n = size(mesh, axes)
    return ppermute(xs, mesh, axes, [(i, (i + 1) % n) for i in range(n)])


# ---------------------------------------------------------------------------
# per-shard bodies
# ---------------------------------------------------------------------------

class CollectiveError(RuntimeError):
    """The shards of an ``spmd`` call met at a rendezvous with different
    collectives (or one had finished its body), or the collective failed."""


class _Rendezvous:
    """Where the shards of one ``spmd`` call meet: a collective is one
    ``Barrier`` wait of every shard; the barrier's action (run by the last
    shard to arrive, while every other one waits) checks that all handed in
    the same collective and computes it over their tensors; each shard then
    takes its own result. ``abort`` breaks every wait, present and future.

    Shards that share a device take turns on it (``_Turns``), in shard
    order: a body holds its device's turn while it runs and passes it to
    the device's next shard while it waits at a rendezvous, so on one
    card the shards run one at a time between collectives, in the order
    one program over them would: one shard's temporaries live at a time,
    and the threads do not contend for the interpreter. Shards alone on
    their device run at once.

    Under grad the turns also keep the backward one program's. Autograd
    runs a device's ready nodes highest creation number first, and that
    number counts per thread, so four shards' threads would number their
    nodes alike and a backward would interleave them, holding every
    shard's recomputed (checkpointed) block at once. At each turn a shard
    first moves its thread's count past the device's highest
    (``_advance_to``): the device's nodes are then numbered in the order
    they were made, as in one thread, and since the turns go in shard
    order, every run numbers them alike. Without the function that reads
    the count, such a call is refused."""

    def __init__(self, shs: List[Shard], counter, grad: bool):
        n = len(shs)
        self._given = [None] * n
        self._keys = [None] * n
        self._fns = [None] * n
        self._out: list = [None] * n
        self._error = None
        self._counter = counter        # the caller's dry-run counter
        self._barrier = threading.Barrier(n, action=self._combine)
        self._devices = [s.device for s in shs]
        self._turns = _Turns(self._devices)
        shared = self._turns.shared
        if grad and shared and _SEQUENCE_NR is None:
            raise RuntimeError(
                "spmd under grad with shards that share a device needs "
                "torch._C._autograd._get_sequence_nr, which this torch "
                "lacks: without it a backward would run the shards' "
                "recomputed blocks at once")
        # each shared device's highest autograd creation number so far
        self._high = dict.fromkeys(shared, 0) if grad else {}

    def take_turn(self, i: int) -> None:
        if self._turns.after[i] is not None:
            self._turns.take(i)
            if self._high:
                _advance_to(self._high[self._devices[i]])

    def end_turn(self, i: int) -> None:
        if self._turns.after[i] is not None:
            if self._high:
                d = self._devices[i]
                self._high[d] = max(self._high[d], _SEQUENCE_NR())
            self._turns.give(i)

    def exchange(self, i: int, key: tuple, x, fn: Callable):
        self._given[i], self._keys[i], self._fns[i] = x, key, fn
        self.end_turn(i)
        try:
            self._barrier.wait()
        finally:
            self.take_turn(i)
        if self._error is not None:
            raise CollectiveError(self._error)
        return self._out[i]

    def _combine(self) -> None:
        self._error = None
        keys = self._keys
        if any(k != keys[0] for k in keys):
            self._error = ("the shards met at different collectives: "
                           + ", ".join(f"shard {i} {k}"
                                       for i, k in enumerate(keys)))
        else:
            try:
                # every shard waits here: the collective's nodes come after
                # every device's
                if self._high:
                    _advance_to(max(self._high.values()))
                # the collective is no shard's body: a dispatch mode the
                # running shard's body entered does not see it
                with _disable_current_modes(), \
                        trace.attached(self._counter):
                    self._out = list(self._fns[0](list(self._given)))
                if self._high:
                    self._high = dict.fromkeys(self._high, _SEQUENCE_NR())
            except Exception as e:                     # noqa: BLE001
                self._error = f"{keys[0]} failed: {type(e).__name__}: {e}"
        self._given = [None] * len(self._given)

    def abort(self) -> None:
        self._turns.abort()
        self._barrier.abort()


class _Turns:
    """The turns of the shards that share a device: each such device's
    shards run one at a time, in shard order, round and round (``after``:
    each shard's successor on its device, None for a shard alone on its
    device). ``abort`` ends every wait for a turn."""

    def __init__(self, devices: List[torch.device]):
        on: dict = {}
        for i, d in enumerate(devices):
            on.setdefault(d, []).append(i)
        self.after: List = [None] * len(devices)
        for idx in on.values():
            if len(idx) > 1:
                for a, b in zip(idx, idx[1:] + idx[:1]):
                    self.after[a] = b
        self.shared = {d for d, idx in on.items() if len(idx) > 1}
        self._device = list(devices)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._next = {d: on[d][0] for d in self.shared}
        self._aborted = False

    def take(self, i: int) -> None:
        """Waits until it is shard ``i``'s turn on its device (or the call
        is aborted)."""
        d = self._device[i]
        with self._lock:
            self._cv.wait_for(lambda: self._next[d] == i or self._aborted)

    def give(self, i: int) -> None:
        """Shard ``i`` passes its device's turn to the device's next
        shard."""
        with self._lock:
            self._next[self._device[i]] = self.after[i]
            self._cv.notify_all()

    def abort(self) -> None:
        with self._lock:
            self._aborted = True
            self._cv.notify_all()


# this thread's next autograd creation number (None: not in this torch)
_SEQUENCE_NR = getattr(torch._C._autograd, "_get_sequence_nr", None)

# what the turns' numbering has cost since the caller last zeroed it: the
# throwaway view nodes made, and the host seconds spent making them
STAGGER = {"nodes": 0, "seconds": 0.0}
_STAGGER_LOCK = threading.Lock()


def _advance_to(target: int) -> None:
    """Makes (and drops) one view node at a time until this thread's
    autograd creation number reaches ``target`` (counted in
    ``STAGGER``)."""
    t0 = time.perf_counter()
    n = target - _SEQUENCE_NR()
    if n > 0:
        with torch.enable_grad():
            leaf = torch.zeros((), requires_grad=True)
            for _ in range(n):
                leaf.view(())
    dt = time.perf_counter() - t0
    with _STAGGER_LOCK:
        STAGGER["nodes"] += max(n, 0)
        STAGGER["seconds"] += dt


class ShardCtx:
    """One shard's side of an ``spmd`` call: its ``Shard`` and mesh, and
    the collectives as a body inside ``shard_map`` calls them, each on this
    shard's own tensor (``lax.psum`` and so on). Every shard of the call
    must make the same collectives in the same order."""

    def __init__(self, shard: Shard, mesh: Mesh, rv: _Rendezvous):
        self.shard, self.mesh, self._rv = shard, mesh, rv

    @property
    def index(self) -> int:
        return self.shard.index

    @property
    def device(self) -> torch.device:
        return self.shard.device

    def axis_index(self, axes: Axes) -> int:
        return axis_index(self.mesh, axes, self.shard)

    def _meet(self, key: tuple, fn: Callable, x):
        return self._rv.exchange(self.shard.index, key, x, fn)

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        axes = _axes(self.mesh, axes)
        return self._meet(("psum", axes), lambda xs: psum(xs, self.mesh, axes),
                          x)

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        axes = _axes(self.mesh, axes)
        return self._meet(("all_gather", axes, dim, tiled),
                          lambda xs: all_gather(xs, self.mesh, axes, dim,
                                                tiled), x)

    def ppermute(self, x: torch.Tensor, axes: Axes,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        axes, perm = _axes(self.mesh, axes), tuple(map(tuple, perm))
        return self._meet(("ppermute", axes, perm),
                          lambda xs: ppermute(xs, self.mesh, axes, perm), x)

    def rotate(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        axes = _axes(self.mesh, axes)
        return self._meet(("rotate", axes),
                          lambda xs: rotate(xs, self.mesh, axes), x)


def _current(device: torch.device):
    """``device`` made current in this thread (CUDA), else nothing."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def spmd(mesh: Mesh, body: Callable, *per_shard: Sequence) -> list:
    """``[body(ctx_i, *(a[i] for a in per_shard)) for each shard i]``, each
    shard's body in a thread of its own (one program per device, in
    lockstep at the collectives; the module docstring): its shard's device
    current, the caller's grad and inference modes; shards that share a
    device take turns on it between collectives, in shard order. Under
    grad with shards that share a device it needs torch's per-thread
    autograd creation number (``_Rendezvous``), and raises without it.
    The results come back
    in shard order. A body that raises breaks the rendezvous; once every
    thread has ended, the lowest shard's own exception (one that is not the
    broken barrier's) is raised here with a note naming the shard."""
    shs = shards(mesh)
    n = len(shs)
    for a in per_shard:
        if len(a) != n:
            raise ValueError(f"spmd: {len(a)} per-shard operands for the "
                             f"{n} shards of {mesh.shape}")
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()
    rv = _Rendezvous(shs, trace.active(), grad and not inference)
    results: list = [None] * n
    errors: list = [None] * n

    def run(s: Shard) -> None:
        try:
            rv.take_turn(s.index)
            try:
                with _current(s.device), torch.inference_mode(inference), \
                        torch.set_grad_enabled(grad):
                    results[s.index] = body(ShardCtx(s, mesh, rv),
                                            *(a[s.index] for a in per_shard))
                # the end is a rendezvous too: a shard that ends while
                # another waits at a collective is a mismatch, not a hang
                rv.exchange(s.index, ("end",), None, lambda xs: xs)
            finally:
                rv.end_turn(s.index)
        except BaseException as e:                     # noqa: BLE001
            errors[s.index] = e
            rv.abort()

    threads = [threading.Thread(target=run, args=(s,),
                                name=f"spmd-shard-{s.index}") for s in shs]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    except BaseException:
        rv.abort()
        for t in threads:
            t.join()
        raise
    failed = [(i, e) for i, e in enumerate(errors) if e is not None]
    if failed:
        i, e = next(((i, e) for i, e in failed
                     if not isinstance(e, threading.BrokenBarrierError)),
                    failed[0])
        e.add_note(f"raised in shard {i} of {n} ({shs[i].device}) of an "
                   f"spmd call over the mesh {mesh.shape}")
        raise e
    return results


class _Replicate(torch.autograd.Function):
    """``x`` on every device of ``devices`` (a view where it does not
    move); the backward adds the copies' gradients in device-list order on
    ``x``'s device, whatever order autograd's threads produce them in."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.set_materialize_grads(False)
        ctx.home = x.device
        return tuple(x.view_as(x) if d == x.device else x.to(d)
                     for d in devices)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                g = g.to(ctx.home)
                total = g if total is None else total + g
        return total, None


def replicate_tree(tree, mesh: Mesh) -> list:
    """A ``P()`` operand of ``spmd``: the tree on every shard's device, one
    tree a shard. A leaf that takes a gradient (under grad) goes through
    ``_Replicate``, so its gradient is the shards' added in shard order, as
    ``shard_map`` gives a replicated input's."""
    devs = [s.device for s in shards(mesh)]
    grad = torch.is_grad_enabled()
    per_leaf = [list(_Replicate.apply(t, devs))
                if grad and isinstance(t, torch.Tensor) and t.requires_grad
                else [t.to(d) if isinstance(t, torch.Tensor) else t
                      for d in devs]
                for t in leaves(tree)]

    def one(i):
        it = iter(per_leaf)
        return tree_map(lambda _: next(it)[i], tree)

    return [one(i) for i in range(len(devs))]
