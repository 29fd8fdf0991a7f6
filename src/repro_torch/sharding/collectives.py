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

The callers hold global tensors: ``RingExec``, ``moe_ffn`` and
``lookup_sharded`` cut their operands here (``split``, ``blocks``) and
join their results onto the first shard's device (``unsplit``), and the
ring's node-level work between pushes (encoders, MLPs, the loss) runs
over every row on that device. The layout is one controller's: a backend
with one process per rank (``torch.distributed``) would change those
callers too, so that each rank holds only its own blocks.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple, Union

import torch

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


def ring_sources(mesh: Mesh, axes: Axes, steps: int) -> List[int]:
    """For each shard, the shard whose tensor it holds after ``steps``
    ``rotate``s over ``axes``."""
    out = [0] * len(shards(mesh))
    for g in groups(mesh, axes):
        for pos, i in enumerate(g):
            out[i] = g[(pos - steps) % len(g)]
    return out
