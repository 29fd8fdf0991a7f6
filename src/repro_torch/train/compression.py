"""Gradient compression for slow inter-pod links (the port of
``repro.train.compression``, on torch tensors): top-k sparsification with
error feedback, and int8 quantized all-reduce emulation.

Error feedback (Karimireddy et al. '19): the residual of the compression is
carried into the next step, so compressed SGD/Adam converges at the dense
rate. ``compress -> (all-reduce compressed) -> decompress`` applies to the
inter-pod gradient sync only. The reference has no mesh body here either:
these are the per-tensor transforms and their error feedback, with the
reference's arithmetic: top-k takes
``common/topk.top_k``, which orders ties as ``jax.lax.top_k`` does (lower
position first), and int8 rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.common.topk import top_k
from repro_torch.common.tree import leaves, tree_map


class ErrorFeedbackState(NamedTuple):
    residual: object      # tree like grads (fp32)


def init_error_feedback(grads_like) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def topk_compress(g: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the largest-|g| fraction; returns (values (k,) fp32, flat
    indices (k,) int64)."""
    flat = g.reshape(-1).to(torch.float32)
    k = max(int(frac * flat.shape[0]), 1)
    _, idx = top_k(torch.abs(flat), k)
    return flat[idx], idx


def topk_decompress(values: torch.Tensor, idx: torch.Tensor,
                    shape) -> torch.Tensor:
    flat = torch.zeros((math.prod(shape),), dtype=torch.float32,
                       device=values.device)
    flat[idx] = values
    return flat.reshape(shape)


def _per_leaf(one, grads, ef: ErrorFeedbackState):
    """(compressed tree, new ef) of ``one(g, residual) -> (comp, resid)``
    over the leaves."""
    out = [one(g, r) for g, r in zip(leaves(grads), leaves(ef.residual))]

    def tree_of(i):
        it = iter(o[i] for o in out)
        return tree_map(lambda _: next(it), grads)

    return tree_of(0), ErrorFeedbackState(residual=tree_of(1))


def compress_grads_topk(grads, ef: ErrorFeedbackState, frac: float = 0.05):
    """Returns (compressed grads (dense tensors, sparsified), new ef). On
    a deployment the (values, indices) pairs are what travel over the pod
    link — the bytes saving is frac·(1 + idx_overhead)."""
    def one(g, r):
        acc = g.to(torch.float32) + r
        vals, idx = topk_compress(acc, frac)
        comp = topk_decompress(vals, idx, acc.shape)
        return comp.to(g.dtype), acc - comp

    return _per_leaf(one, grads, ef)


def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization (for quantized all-reduce)."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(torch.amax(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def compress_grads_int8(grads, ef: ErrorFeedbackState):
    """Int8 + error feedback (4x inter-pod gradient bytes reduction)."""
    def one(g, r):
        acc = g.to(torch.float32) + r
        q, s = int8_compress(acc)
        deq = int8_decompress(q, s)
        return deq.to(g.dtype), acc - deq

    return _per_leaf(one, grads, ef)
