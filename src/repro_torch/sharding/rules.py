"""Logical-axis sharding rules (MaxText-style), and the device mesh they
resolve against.

``Mesh`` is a named grid of ``torch.device``s, the port's counterpart of
``jax.sharding.Mesh``: ``axis_names`` and a ``.shape`` mapping from axis
name to size. One Python process drives every device of the mesh, as
JAX's single-controller ``shard_map`` does. A mesh may repeat one device:
``Mesh(["cpu"] * 4, ("data",))`` runs four shards on the CPU, and
``Mesh(["cuda:0"] * 4, ("data",))`` four on one card.

Parameters and activations are annotated with tuples of *logical* axis
names. A rule table maps each logical name to a mesh axis (or a tuple of
mesh axes, or None). ``logical_to_spec`` resolves names to a spec — a
plain tuple with one entry per dimension: None, an axis name, or a tuple
of axis names — with two fallbacks that make one rule table serve every
mesh:

  * axes not present in the mesh are dropped ("pod" on a single-pod mesh);
  * if the mapped mesh-axis product does not divide the dimension, the
    longest divisible *prefix* of the tuple is used instead (GQA
    kv_heads=8 under a 16-way "model" axis falls back to replication;
    global_batch=256 under ("pod","data","model")=512 falls back to
    ("pod","data")=32).

The index's row-sharded stable scan reads ``db_axes`` / ``db_shards``
(``core/ivf.py:shard_index``); the mesh bodies split their batches and
nodes over ``data_axes``. ``shard_tree`` resolves a tree of logical
axes against a mesh into one ``NamedSharding`` a leaf, and
``with_sharding`` is the activation constraint: it resolves the spec (a
bad one raises) and returns its input, since under GSPMD a sharding
constraint never changes a value. The mesh bodies' collectives are
``sharding/collectives.py``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.common.params import resolve_device

MeshAxes = Union[None, str, Tuple[str, ...]]


class Mesh:
    """A named grid of devices.

    devices: a nested sequence (or numpy object array) of devices or
    device strings whose shape is the grid's, one dimension per name in
    ``axis_names``. A device may appear more than once."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.asarray(devices, dtype=object)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if given.ndim != len(self.axis_names) or given.size == 0:
            raise ValueError(f"Mesh: a {given.shape} device grid for axis "
                             f"names {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"Mesh: repeated axis name in {self.axis_names}")
        grid = np.empty(given.size, dtype=object)
        for i, d in enumerate(given.reshape(-1)):
            grid[i] = resolve_device(d, "Mesh")
        self.devices = grid.reshape(given.shape)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    def device_at(self, coords: Dict[str, int]) -> torch.device:
        """The device at the given axis coordinates; an axis left out is
        taken at coordinate 0."""
        return self.devices[tuple(int(coords.get(a, 0))
                                  for a in self.axis_names)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


# Logical axis vocabulary (the reference's table, docs/DESIGN.md §5):
DEFAULT_RULES: Dict[Optional[str], MeshAxes] = {
    # activations
    "batch": ("pod", "data"),            # prefix-fallback trims to what divides
    "seq": None,
    "seq_attn": None,                    # context parallelism opt-in (phi4)
    "cache_seq": "model",                # decode KV cache: flash-decode split
    "embed": None,
    "act_mlp": "model",
    "act_heads": "model",
    "vocab_act": "model",
    # params
    "embed_fsdp": "data",                # ZeRO-3 row shard of weight matrices
    "embed_model": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": None,                     # experts replicated; (D,F) carry the shards
    "vocab": "model",
    "kv_lora": None,
    # HMGI index
    "db": ("pod", "data"),
    "partitions": None,
    "dim": None,
    # recsys / gnn
    "table": "model",
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    "feat": None,
    "hidden": "model",
    None: None,
}


_ACTIVE_OVERRIDES: Dict[Optional[str], MeshAxes] = {}


class rule_overrides:
    """Context manager: per-arch logical->mesh overrides active inside it."""

    def __init__(self, overrides: Optional[Dict] = None):
        self.overrides = dict(overrides or {})

    def __enter__(self):
        global _ACTIVE_OVERRIDES
        self._saved = _ACTIVE_OVERRIDES
        _ACTIVE_OVERRIDES = {**self._saved, **self.overrides}
        return self

    def __exit__(self, *exc):
        global _ACTIVE_OVERRIDES
        _ACTIVE_OVERRIDES = self._saved
        return False


def _axes_size(mesh: Mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape.get(a, 1)
    return size


def _present(mesh: Mesh, axes: MeshAxes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if a in mesh.shape)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    mesh: Mesh,
    rules: Optional[Dict] = None,
    dims: Optional[Sequence[int]] = None,
) -> Tuple[MeshAxes, ...]:
    """Resolve logical axis names to a spec for ``mesh`` (see module doc)."""
    base = {**DEFAULT_RULES, **_ACTIVE_OVERRIDES}
    rules = base if rules is None else {**base, **rules}
    used: set = set()
    out = []
    for i, name in enumerate(logical_axes):
        cand = _present(mesh, rules.get(name))
        cand = tuple(a for a in cand if a not in used)
        # longest divisible prefix
        chosen: Tuple[str, ...] = ()
        if dims is not None and cand:
            size = 1
            for j, a in enumerate(cand):
                size *= mesh.shape[a]
                if dims[i] % size == 0:
                    chosen = cand[: j + 1]
                else:
                    break
        elif cand:
            chosen = cand
        used.update(chosen)
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(chosen)
    return tuple(out)


def batch_axes(mesh: Mesh, n: int) -> Tuple[str, ...]:
    """Mesh axes used for the batch/data dimension of size n (prefix rule)."""
    spec = logical_to_spec(["batch"], mesh, None, [n])[0]
    if spec is None:
        return ()
    return (spec,) if isinstance(spec, str) else tuple(spec)


def db_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes carrying the HMGI stable store's row shards (the "db"
    logical axis — ("pod","data"), trimmed to what the mesh has)."""
    return _present(mesh, DEFAULT_RULES["db"])


def db_shards(mesh: Optional[Mesh]) -> int:
    """Number of row shards the mesh supports for the stable store (1 when
    there is no mesh — the single-device layout)."""
    if mesh is None:
        return 1
    return _axes_size(mesh, db_axes(mesh))


def data_axes(mesh: Mesh, rows: Optional[int] = None) -> Tuple[str, ...]:
    """The data axes of a mesh body, ("pod", "data") trimmed to what the
    mesh has: a batch's rows, or a graph's nodes, split over them. With
    ``rows``: none when ``rows`` does not divide by their shards (a batch
    of 1 in decode stays replicated)."""
    axes = _present(mesh, ("pod", "data"))
    if rows is not None and rows % _axes_size(mesh, axes):
        return ()
    return axes


def require_mesh(mesh, what: str) -> Mesh:
    """``mesh`` if it is a ``Mesh``; anything else raises TypeError."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what}: mesh must be a repro_torch Mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


class NamedSharding(NamedTuple):
    """A leaf's placement over a mesh: the mesh and its resolved spec (one
    entry per dimension, as ``logical_to_spec`` gives it)."""
    mesh: Mesh
    spec: Tuple[MeshAxes, ...]


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def shard_tree(axes_tree, shapes_tree, mesh: Mesh, rules=None):
    """A tree of logical-axes tuples (and a tree of the same structure
    whose leaves have ``.shape``: tensors, or anything shaped) -> the same
    tree of ``NamedSharding``s."""
    def walk(axes, shaped: Any):
        if _is_axes_leaf(axes):
            dims = getattr(shaped, "shape", None)
            return NamedSharding(mesh, logical_to_spec(axes, mesh, rules,
                                                       dims))
        if isinstance(axes, dict):
            return {k: walk(v, shaped[k]) for k, v in axes.items()}
        if isinstance(axes, (list, tuple)):
            return type(axes)(walk(a, s) for a, s in zip(axes, shaped))
        raise TypeError(f"shard_tree: a leaf {axes!r} is not a tuple of "
                        "logical axis names")
    return walk(axes_tree, shapes_tree)


def with_sharding(x, logical_axes, mesh: Optional[Mesh] = None, rules=None):
    """Activation sharding constraint by logical names: the identity (no
    mesh, or any mesh: a constraint moves no value). With a mesh the spec
    is resolved first, so a spec longer than ``x``'s rank raises, as
    ``jax.lax.with_sharding_constraint`` does."""
    if mesh is None:
        return x
    require_mesh(mesh, "with_sharding")
    if len(logical_axes) > x.dim():
        raise ValueError(f"with_sharding: {len(logical_axes)} logical axes "
                         f"{tuple(logical_axes)} for a rank-{x.dim()} value")
    logical_to_spec(logical_axes, mesh, rules, dims=tuple(x.shape))
    return x
