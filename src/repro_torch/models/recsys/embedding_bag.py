"""EmbeddingBag and the per-field table lookup (the port of
``repro.models.recsys.embedding_bag``).

The tables are one stacked ``(F, V, D)`` tensor. ``lookup`` clamps each
id into its field's ``[0, V)`` (the reference's ``jnp.take(...,
mode="clip")``) and reads all fields with one gather over the ``(F·V,
D)`` view, the ids offset by ``f·V``: ``sparse.segment.gather_rows``, so
that under grad its transpose is one launch of the in-place kernel
(``segment_sum_csr_accumulate``) over the distinct rows read, a clipped
id's gradient landing on the clamped row. ``embedding_bag`` reduces
ragged multi-hot ids per bag: ``sum`` through the CUDA segment-sum kernel
(``sparse.segment.segment_sum``), ``mean`` through ``segment_mean`` and
``max`` through ``segment_max``; an id < 0 contributes a row of zeros, an
id >= V reads the last row, and an empty bag is 0 (-inf for ``max``), as
in the reference. ``lookup_sharded`` is the reference's row-sharded
lookup over a mesh (``sharding/collectives.py``): the tables' rows split
over "model", each shard takes its row range (an id outside it reads
zeros) and the partial rows are ``psum``med over "model"; the batch
splits over the data axes when it divides. An id < 0 or >= V therefore
reads zeros there, where ``lookup`` clips it (ROADMAP.md Queue 3).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.params import Init
from repro_torch.sharding import collectives as col
from repro_torch.sharding.rules import Mesh, data_axes, require_mesh
from repro_torch.sparse import segment as seg


def init_tables(init: Init, n_fields: int, vocab_per_field: int,
                dim: int) -> Dict[str, torch.Tensor]:
    """``{"tables": (F, V, D)}``: normal draws times ``0.1 / sqrt(D)``."""
    return {"tables": init.dense((n_fields, vocab_per_field, dim),
                                 fan_in=dim, scale=0.1)}


def flat_ids(ids: torch.Tensor, vocab_per_field: int) -> torch.Tensor:
    """ids (B, F) -> (B·F,) int64 rows of the ``(F·V, ...)`` view: each id
    clamped into ``[0, V)`` and offset by its field's ``f·V``."""
    f = ids.shape[-1]
    off = torch.arange(f, dtype=torch.int64, device=ids.device)
    off = off * vocab_per_field
    return (ids.to(torch.int64).clamp(0, vocab_per_field - 1)
            + off).reshape(-1)


def lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables (F, V, D); ids (B, F) -> (B, F, D)."""
    f, v, d = tables.shape
    rows = seg.gather_rows(tables.reshape(f * v, d), flat_ids(ids, v))
    return rows.reshape(ids.shape[0], f, d)


def table_shards(tables: torch.Tensor, mesh: Mesh):
    """(each shard's (F, V_loc, ...) block of the rows, V_loc): the rows
    split over "model" (all of them without a "model" axis)."""
    if "model" not in mesh.shape:
        return col.replicate(tables, mesh), tables.shape[1]
    return (col.split(tables, mesh, "model", dim=1),
            tables.shape[1] // mesh.shape["model"])


def local_rows(shard, t: torch.Tensor, ids: torch.Tensor,
               v_loc: int) -> torch.Tensor:
    """One shard's partial rows: ids in its range ``[m·V_loc, (m+1)·V_loc)``
    read its block, any other id reads zeros."""
    lo = shard.coords.get("model", 0) * v_loc
    rel = ids.to(torch.int64) - lo
    ok = (rel >= 0) & (rel < v_loc)
    return torch.where(ok[..., None], lookup(t, rel), 0.0)


def lookup_sharded(tables: torch.Tensor, ids: torch.Tensor,
                   mesh: Mesh) -> torch.Tensor:
    """tables (F, V, D); ids (B, F) -> (B, F, D) over ``mesh`` (the module
    docstring): one ``psum`` of the partial rows over "model"."""
    require_mesh(mesh, "lookup_sharded")
    tabs, v_loc = table_shards(tables, mesh)
    axes = data_axes(mesh, ids.shape[0])
    idl = (col.split(ids, mesh, axes) if axes
           else col.replicate(ids, mesh))
    rows = col.map_shards(
        lambda sh, t, i: local_rows(sh, t, i, v_loc), mesh, tabs, idl)
    if "model" in mesh.shape:
        rows = col.psum(rows, mesh, "model")
    return col.unsplit(rows, mesh, axes)


def embedding_bag(tables: torch.Tensor, flat: torch.Tensor,
                  bag_ids: torch.Tensor, n_bags: int, field: int = 0,
                  mode: str = "sum") -> torch.Tensor:
    """``torch.nn.EmbeddingBag``'s function over ``tables[field]``: flat
    (L,) ids, bag_ids (L,) in ``[0, n_bags)`` -> (n_bags, D)."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    table = tables[field]
    rows = seg.gather_rows(table, flat.to(torch.int64).clamp(
        0, table.shape[0] - 1))
    rows = torch.where((flat >= 0)[:, None], rows, 0.0)
    if mode == "sum":
        return seg.segment_sum(rows, bag_ids, n_bags)
    if mode == "mean":
        return seg.segment_mean(rows, bag_ids, n_bags)
    return seg.segment_max(rows, bag_ids, n_bags)
