"""The transformer LM of the port (``repro.models.lm``): init, the
training forward, ``xent_loss``, ``loss_fn`` and ``make_train_step``,
prefill with KV-cache production, one-token decode with per-slot
positions, and an inference ``forward``.

Every LM config of the reference: GQA or multi-head latent attention
(``layers/mla.py``), dense or mixture-of-experts FFN (``layers/moe.py``,
with shared experts and dense first layers), QKV bias, a sliding window,
tied or untied embeddings. The reference's ``lax.scan`` over stacked
layers is a Python loop over per-layer parameters here.

Training (``forward`` with ``opts``, ``loss_fn``, ``make_train_step``)
follows the reference's semantics: no KV cache is kept; with
``ExecOpts.remat`` the layers from ``cfg.first_dense_layers`` on (the
reference's scanned body) run under ``torch.utils.checkpoint`` and the
dense head layers do not; attention takes ``ExecOpts.q_block``; every
layer's output passes the bf16 cotangent barrier. The token lookup is a
gather whose transpose adds each distinct token's cotangent rows into the
embedding's gradient with the segment-sum kernel's in-place entry
(``ops.segment_sum_csr_accumulate``; no atomics, so its bits depend only
on its inputs): with tied embeddings in place into the (V, D) gradient
that the logits matmul produced, over the touched rows only. The train
step accumulates micro-batches into one fp32 gradient sum as the backward
produces each leaf's gradient, and updates the params and moments in
place (``train.optimizer.adamw_update_``): it consumes its inputs, as the
reference's donated buffers are consumed.

Parameters are a dict: ``embed`` (V, D), ``final_ln`` (D,), ``head``
(D, V) when embeddings are untied, and ``layers``, a list of per-layer
dicts ``{"attn": {...}, "ln1", "ln2", "ffn": {w1, w3, w2}}`` — a MoE
layer has ``"moe": {wr, w1, w3, w2}`` and, with shared experts,
``"shared": {w1, w3, w2}`` in place of ``"ffn"``. ``attn`` is
``{wq, wk, wv, wo[, bq, bk, bv]}`` (GQA) or ``{wq, w_dkv, w_krope, w_uk,
w_uv, wo}`` (MLA). The cache is a tuple of three tensors with a leading L
axis, laid out as in the reference: (L, B, clen, Hkv, hd) K and V (GQA)
or (L, B, clen, r) latents and (L, B, clen, dr) roped keys (MLA), then
an (L, B, clen) int32 tensor of the position held in each slot (-10^9
when empty).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.params import Init, dtype_of, resolve_device
from repro_torch.common.tree import leaves, tree_map
from repro_torch.kernels.segment_reduce import ops as seg_ops
from repro_torch.layers.attention import gqa_forward, init_gqa
from repro_torch.layers.mla import init_mla, mla_forward
from repro_torch.layers.mlp import init_swiglu, swiglu
from repro_torch.layers.moe import init_moe, moe_ffn
from repro_torch.layers.norms import rms_norm
from repro_torch.sharding.rules import require_mesh, with_sharding
from repro_torch.sparse.segment import csr_by_row
from repro_torch.train.optimizer import AdamWConfig, adamw_update_

Cache = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
EMPTY_SLOT = -(10 ** 9)


@dataclasses.dataclass(frozen=True)
class ExecOpts:
    """Execution knobs of the training path (the reference's fields).
    ``unroll_layers`` and ``unroll_attn_blocks`` set the reference's scan
    unrolling for its dry-run cost analysis; eager PyTorch runs a Python
    loop either way, so they are accepted and change nothing."""
    q_block: int = 1024
    unroll_layers: bool = False
    unroll_attn_blocks: bool = False
    remat: bool = True
    aux_loss_weight: float = 0.01
    bf16_grad_barrier: bool = True


class _BF16Barrier(torch.autograd.Function):
    """The identity forward; the backward casts the cotangent to bf16 (the
    reference's ``_bf16_barrier_bwd_strict``). It is applied to bf16
    activations only, whose cotangent is bf16 already: in value it is the
    identity, as in the reference (where it marks where the backward's
    collectives move half the bytes)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def barrier_apply(x: torch.Tensor, opts: ExecOpts) -> torch.Tensor:
    """The bf16 cotangent barrier, where ``opts`` asks for it and x is bf16."""
    if opts.bf16_grad_barrier and x.dtype == torch.bfloat16:
        return _BF16Barrier.apply(x)
    return x


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(cfg, init: Init, layer_idx: int) -> Dict[str, object]:
    lp: Dict[str, object] = {
        "attn": (init_mla if cfg.attention == "mla" else init_gqa)(cfg, init),
        "ln1": init.ones((cfg.d_model,)),
        "ln2": init.ones((cfg.d_model,))}
    if cfg.moe and layer_idx >= cfg.first_dense_layers:
        lp["moe"] = init_moe(cfg, init)
        if cfg.n_shared_experts:
            lp["shared"] = init_swiglu(
                cfg, init, d_ff=cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff))
    else:
        lp["ffn"] = init_swiglu(
            cfg, init, d_ff=(cfg.dense_d_ff or cfg.d_ff) if cfg.moe else cfg.d_ff)
    return lp


def init_lm(cfg, seed: int = 0, *, device=None) -> Dict[str, object]:
    """Seeded random parameters in ``cfg.dtype``, made on ``device`` (None =
    the CUDA device; raises without one). The draws differ from the
    reference's ``init_lm`` for the same seed."""
    device = resolve_device(device, "init_lm")
    init = Init(seed, device, dtype_of(cfg.dtype))
    params: Dict[str, object] = {
        "embed": init.dense((cfg.vocab_size, cfg.d_model), fan_in=cfg.d_model)}
    if not cfg.tie_embeddings:
        params["head"] = init.dense((cfg.d_model, cfg.vocab_size),
                                    fan_in=cfg.d_model)
    params["final_ln"] = init.ones((cfg.d_model,))
    params["layers"] = [_init_layer(cfg, init, i) for i in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_fwd(cfg, lp, x, positions, mode, cache_l, cache_pos, moe_routings,
               opts: Optional[ExecOpts] = None, mesh=None):
    """One block; returns (x, this layer's cache, MoE aux loss). With
    ``opts`` (training) attention takes ``opts.q_block``, no cache is
    returned and the output passes the bf16 barrier. ``mesh``: the MoE
    FFN's mesh body and the reference's sharding constraints."""
    attn = mla_forward if cfg.attention == "mla" else gqa_forward
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h, new_cache = attn(cfg, lp["attn"], h, positions, mode=mode,
                        cache=cache_l, cache_pos=cache_pos,
                        q_block=opts.q_block if opts is not None else 0,
                        mesh=mesh)
    if opts is not None:
        new_cache = None    # training keeps no KV (collect_cache=False)
    x = x + h
    hn = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        out, aux = moe_ffn(cfg, lp["moe"], hn, mesh,
                           capacity_factor=cfg.capacity_factor,
                           routings=moe_routings)
        if "shared" in lp:
            out = out + swiglu(lp["shared"], hn)
    else:
        out, aux = swiglu(lp["ffn"], hn), None
    x = x + out
    x = with_sharding(x, ("batch", "seq", None), mesh)
    if opts is not None:
        x = barrier_apply(x, opts)
    return x, new_cache, aux


def _logits(cfg, params, x: torch.Tensor,
            embed: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """``embed``: the table the lookup read (training's sink token), for
    tied embeddings."""
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        table = params["embed"] if embed is None else embed
        logits = x @ table.to(x.dtype).T
    else:
        logits = x @ params["head"].to(x.dtype)
    return with_sharding(logits, ("batch", "seq", "vocab_act"), mesh)


def _embed(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(dtype_of(cfg.dtype))


class _TokenGrad:
    """One lookup's tokens and, once its backward ran, the cotangent of
    its rows (B·S, D)."""

    def __init__(self, tokens: torch.Tensor):
        self.tokens = tokens.reshape(-1)
        self.cot = None

    def add_into(self, grad: torch.Tensor) -> None:
        """Adds each distinct token's cotangent rows into its row of
        ``grad``, in place, with the in-place segment-sum kernel (its plain
        version on CPU tensors)."""
        if self.cot is None:
            return
        rowptr, perm, rows = csr_by_row(self.tokens, grad.shape[0])
        seg_ops.segment_sum_csr_accumulate(self.cot.contiguous(), rowptr,
                                           perm, out=grad, rows=rows)
        self.cot = None


class _TableSink(torch.autograd.Function):
    """The identity on the embedding table: its output is the token that
    the lookup (and, tied, the logits matmul) read. Its backward runs after
    both; it takes the logits' (V, D) gradient (zeros when the embeddings
    are untied) and adds the lookup's rows into it in place."""

    @staticmethod
    def forward(ctx, table, holder):
        ctx.set_materialize_grads(False)
        ctx.holder = holder
        ctx.like = (table.shape, table.dtype, table.device)
        return table.view_as(table)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        shape, dtype, device = ctx.like
        if grad is None:
            grad = torch.zeros(shape, dtype=dtype, device=device)
        elif not grad.is_contiguous():
            grad = grad.contiguous()
        ctx.holder.add_into(grad)
        return grad, None


class _TokenRows(torch.autograd.Function):
    """``table.index_select(0, tokens)`` whose backward hands its
    cotangent to the ``_TokenGrad`` and returns no gradient for the table
    (a ``_TableSink`` token): the sink adds it."""

    @staticmethod
    def forward(ctx, table, tokens, holder):
        ctx.holder = holder
        return table.index_select(0, tokens)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        ctx.holder.cot = grad
        return None, None, None


def _lookup(cfg, params, tokens: torch.Tensor):
    """(x (B, S, D), the table the logits read). Under grad, with an
    embedding that takes a gradient, the lookup and the logits read the
    table through a ``_TableSink``."""
    table = params["embed"]
    if not (torch.is_grad_enabled() and table.requires_grad):
        return _embed(cfg, params, tokens), table
    holder = _TokenGrad(tokens.long())
    table = _TableSink.apply(table, holder)
    x = _TokenRows.apply(table, holder.tokens, holder)
    return x.reshape(*tokens.shape, -1).to(dtype_of(cfg.dtype)), table


def _remat_layer(cfg, lp, x, positions, moe_routings, opts, mesh=None):
    """One layer under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward. The recompute appends no second routing."""
    first = [True]

    def run(x):
        routings = moe_routings if first[0] else None
        first[0] = False
        y, _, a = _layer_fwd(cfg, lp, x, positions, "full", None, None,
                             routings, opts, mesh)
        return y, a

    return checkpoint(run, x, use_reentrant=False)


def forward(cfg, params, tokens: torch.Tensor, mesh=None,
            opts: Optional[ExecOpts] = None, *,
            moe_routings: Optional[list] = None):
    """tokens (B, S) -> (logits (B, S, V), aux), aux the MoE load-balance
    loss summed over the layers (fp32; 0 for a dense model). No cache is
    kept.

    ``opts`` None: the inference forward (one query block, no barrier,
    nothing rematerialised). With ``opts``: the training forward (the
    module docstring). ``moe_routings``: a list to which every MoE layer
    appends its ``moe.Routing``, once per forward (over a mesh, one per
    data shard). ``mesh``: each MoE FFN runs its mesh body
    (``moe.moe_ffn``); the rest of the forward is unchanged, as under
    GSPMD, where the reference's sharding constraints change no value."""
    x, table = _lookup(cfg, params, tokens)
    x = with_sharding(x, ("batch", "seq", None), mesh)
    positions = torch.arange(tokens.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = opts is not None and opts.remat and torch.is_grad_enabled()
    for i, lp in enumerate(params["layers"]):
        if remat and i >= cfg.first_dense_layers:
            x, a = _remat_layer(cfg, lp, x, positions, moe_routings, opts,
                                mesh)
        else:
            x, _, a = _layer_fwd(cfg, lp, x, positions, "full", None, None,
                                 moe_routings, opts, mesh)
        if a is not None:
            aux = aux + a
    return _logits(cfg, params, x, table, mesh), aux


def xent_loss(cfg, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over B·S, in fp32 (the reference's). The label
    logit is a gather: the reference's one-hot ``where`` + sum adds zeros
    to that one value, so it has the same bits, without another (B, S, V)
    fp32 tensor."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    label_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - label_logit)


def loss_fn(cfg, params, batch, mesh=None, opts: ExecOpts = ExecOpts()):
    """(loss + aux_loss_weight · aux, {"xent", "aux"}) of one batch
    ``{"tokens", "labels"}`` (B, S)."""
    logits, aux = forward(cfg, params, batch["tokens"], mesh, opts)
    loss = xent_loss(cfg, logits, batch["labels"])
    return loss + opts.aux_loss_weight * aux, {"xent": loss, "aux": aux}


def _backward_into(cfg, params, batch, opts, take,
                   mesh=None) -> Tuple[torch.Tensor, dict]:
    """Runs ``loss_fn`` of one batch and its backward; ``take(i, g)`` gets
    leaf i's gradient as soon as the backward has produced it (a hook after
    its accumulation), and the leaf lets it go, so the whole gradient tree
    never exists at once. Returns the detached (loss, parts)."""
    flat = leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]

    def hook(i):
        def fn(t):
            g, t.grad = t.grad, None
            take(i, g)
        return fn

    for i, t in enumerate(live):
        t.register_post_accumulate_grad_hook(hook(i))
    it = iter(live)
    with torch.enable_grad():
        loss, parts = loss_fn(cfg, tree_map(lambda _: next(it), params),
                              batch, mesh, opts)
        loss.backward()
    return loss.detach(), {k: v.detach() for k, v in parts.items()}


def make_train_step(cfg, mesh=None, opts: ExecOpts = ExecOpts(),
                    opt_cfg: AdamWConfig = AdamWConfig(), grad_accum: int = 1):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the gradient of ``loss_fn`` and ``train.optimizer.adamw_update_``.

    The step consumes its inputs, as the reference's donated buffers are:
    the params and the moments are updated in place (the returned trees
    are the given ones). Nothing is written before the update starts, so a
    step that fails before it leaves them as they were. ``grad_accum > 1``:
    the batch arrives shaped (accum, micro_batch, seq); the micro-batches
    run in order and the sum is divided by ``grad_accum``, the loss is the
    mean of the micro-batches' and the metrics carry no parts, as in the
    reference. Each leaf's gradient is added into an fp32 sum as the
    backward produces it (cast from the model dtype, as the reference
    accumulates). metrics: {"loss", ["xent", "aux",] "grad_norm", "lr"}.
    ``mesh``: the forward's (``forward``); the parameters are replicated
    and each gets the sum of its shards' gradients."""
    if mesh is not None:
        require_mesh(mesh, "make_train_step")

    def train_step(params, opt_state, batch):
        flat = leaves(params)
        # 0 + g is g exactly: with one batch the sum holds the model-dtype
        # gradient itself, as the reference's update receives it
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in flat]
        micro = ([batch] if grad_accum == 1 else
                 [{k: v[a] for k, v in batch.items()}
                  for a in range(grad_accum)])
        lsum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for mb in micro:
            loss, parts = _backward_into(cfg, params, mb, opts,
                                         lambda i, g: grads[i].add_(g), mesh)
            lsum = lsum + loss
        if grad_accum > 1:
            for g in grads:
                g.div_(grad_accum)
            loss, parts = lsum / grad_accum, {}
        it = iter(grads)
        _, _, om = adamw_update_(opt_cfg, tree_map(lambda _: next(it), params),
                                 opt_state, params)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_len_for(cfg, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def init_cache(cfg, batch: int, cache_len: int, *, device=None) -> Cache:
    """An empty cache (zeros, every slot position -10^9) with a leading L
    axis: K/V for GQA, (latent, roped k) for MLA. device: None = the CUDA
    device."""
    device = resolve_device(device, "init_cache")
    dt = dtype_of(cfg.dtype)
    L = cfg.n_layers
    if cfg.attention == "mla":
        shapes = [(L, batch, cache_len, cfg.kv_lora_rank),
                  (L, batch, cache_len, cfg.qk_rope_head_dim)]
    else:
        shapes = [(L, batch, cache_len, cfg.n_kv_heads,
                   cfg.resolved_head_dim)] * 2
    return (torch.zeros(shapes[0], dtype=dt, device=device),
            torch.zeros(shapes[1], dtype=dt, device=device),
            torch.full((L, batch, cache_len), EMPTY_SLOT, dtype=torch.int32,
                       device=device))


def prefill(cfg, params, tokens: torch.Tensor, margin: int = 0, *,
            mesh=None, moe_routings: Optional[list] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Processes prompts tokens (B, S); returns (last-token logits (B, V),
    cache).

    ``margin`` reserves headroom in the returned cache for the decode steps
    that follow (full attention); a sliding-window cache keeps the last
    ``window`` positions, rolled so that slot == pos % clen. ``moe_routings``:
    a list to which every MoE layer appends its ``moe.Routing``. ``mesh``:
    as for ``forward``."""
    bsz, s = tokens.shape
    x = with_sharding(_embed(cfg, params, tokens), ("batch", "seq", None),
                      mesh)
    positions = torch.arange(s, device=x.device)
    per_layer = []
    for lp in params["layers"]:
        x, layer_cache, _ = _layer_fwd(cfg, lp, x, positions, "full", None,
                                       None, moe_routings, mesh=mesh)
        per_layer.append(layer_cache)
    logits = _logits(cfg, params, x[:, -1:, :], mesh=mesh)

    clen = cache_len_for(cfg, s + margin)
    L = len(per_layer)
    n = min(s, clen)
    leaves = []
    for j, c0 in enumerate(per_layer[0]):       # (B, S, ...) per layer
        leaf = torch.zeros((L, bsz, clen) + tuple(c0.shape[2:]),
                           dtype=c0.dtype, device=c0.device)
        for i, layer_cache in enumerate(per_layer):
            c = layer_cache[j]
            if clen < s:   # window truncation: keep the last clen, slot order
                c = torch.roll(c[:, -clen:], shifts=s % clen, dims=1)
            leaf[i, :, :n] = c
        leaves.append(leaf)
    if clen < s:
        slot_vals = torch.roll(torch.arange(s - clen, s, dtype=torch.int32,
                                            device=x.device), s % clen)
    else:
        slot_vals = torch.cat([
            torch.arange(s, dtype=torch.int32, device=x.device),
            torch.full((clen - s,), EMPTY_SLOT, dtype=torch.int32,
                       device=x.device)])
    # per-row slot positions (L, B, clen): decode advances each row at its
    # own position (continuous batching over ragged prompts)
    slot_pos = slot_vals[None, None, :].expand(L, bsz, clen).contiguous()
    return logits[:, 0], (leaves[0], leaves[1], slot_pos)


def decode_step(cfg, params, cache: Cache, token: torch.Tensor, pos, *,
                mesh=None, moe_routings: Optional[list] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step. token (B,); pos a scalar (every row at the same
    position) or (B,) per-row positions — the continuous-batching case,
    where ragged prompts put each cache row at its own length. Each row
    writes its cache entry at its own slot, in place in ``cache``, and
    attends only to its own history. ``moe_routings`` and ``mesh`` as for
    ``prefill`` (over a mesh a GQA model still runs the decode kernel).

    Returns (logits (B, V), cache) — the cache tensors given, updated."""
    x = with_sharding(_embed(cfg, params, token[:, None]),
                      ("batch", "seq", None), mesh)
    pos_b = torch.as_tensor(pos, device=x.device).to(torch.int32).reshape(-1)
    pos_b = pos_b.expand(token.shape[0]).contiguous()          # (B,)
    positions = pos_b[:, None]                                  # (B, 1)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _layer_fwd(cfg, lp, x, positions, "decode",
                             tuple(c[i] for c in cache), pos_b, moe_routings,
                             mesh=mesh)
    return _logits(cfg, params, x, mesh=mesh)[:, 0], cache


def param_bytes(params) -> int:
    """Bytes of every parameter tensor."""
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            total += node.numel() * node.element_size()
        elif isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
    return total
