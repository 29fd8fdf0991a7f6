"""HMGI-RAG serving engine: batched retrieval-augmented generation (the port
of ``repro.serving.engine``).

The end-to-end serving pipeline the paper targets (§1: "advanced RAG"):
  1. HMGI hybrid search (vector + graph fusion) retrieves entity context
     for a batch of query vectors;
  2. retrieved entity ids become context tokens prepended to the prompt;
  3. the LM generates with continuous batching over a shared fixed-shape
     KV cache.

One prefill per admitted request is copied in place into that request's
row of the shared cache (every leaf, the slot-position row included), then
one batched decode step runs per engine tick. The decode step takes a
per-slot ``(n_slots,)`` position vector — with ragged prompts the slots sit
at different sequence lengths, and each row writes K/V at its own cache
index and attends only to its own history, so a batched tick produces the
tokens sequential per-request decoding would. The decode attention of
every layer of every tick runs the CUDA flash-decode kernel on the card.

With an index attached and ``maintenance_interval > 0``, a
``MaintenanceDriver`` runs one bounded ``HMGIIndex.maintain`` pass every
``maintenance_interval``-th tick, between admission and the decode step:
ingest-while-search pays a small constant tax per tick instead of rare
full-compaction stalls. The reference's ``jax.jit`` calls are eager calls
here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.common.params import resolve_device
from repro_torch.models import lm
from repro_torch.serving.cache import HotResultCache
from repro_torch.serving.retrieval import RetrievalPlan, RetrievalService
from repro_torch.serving.scheduler import (AdmissionController,
                                           ContinuousBatcher,
                                           MaintenanceDriver, Request)


@dataclasses.dataclass
class EngineConfig:
    n_slots: int = 8
    max_seq: int = 256
    retrieve_k: int = 4
    hops: int = 1
    # adaptive index maintenance between decode steps (0 = off): every
    # maintenance_interval-th tick runs index.maintain(budget=...) so
    # ingest-while-search pays bounded work per tick, never a full rebuild
    maintenance_interval: int = 4
    maintenance_budget_rows: int = 256
    # durability pacing (0 = off): every snapshot_interval-th tick writes a
    # versioned snapshot when the index is a DurableHMGIIndex, bounding
    # crash-recovery replay at ~one interval's worth of ops
    snapshot_interval: int = 0
    # retrieval path (RetrievalService): micro-batch retrievals through the
    # pow2-bucketed (Q, k) entry, with an optional version-invalidated
    # hot-result cache (0 = no cache)
    retrieval_batching: bool = True
    retrieval_window_s: float = 0.001
    retrieval_max_batch: int = 64
    retrieval_cache_capacity: int = 256


class RAGEngine:
    """lm_params: from ``lm.init_lm`` or ``convert.lm_params_from_jax``, on
    ``device`` (None = the CUDA device; raises without one). index: a port
    ``HMGIIndex`` or None (generation only)."""

    def __init__(self, lm_cfg, lm_params, index, cfg: EngineConfig = EngineConfig(),
                 admission: Optional[AdmissionController] = None, *,
                 device=None):
        lm.check_supported(lm_cfg)
        self.device = resolve_device(device, "RAGEngine")
        if lm_params["embed"].device != self.device:
            raise ValueError(f"RAGEngine: lm_params live on "
                             f"{lm_params['embed'].device}, the engine on "
                             f"{self.device}")
        self.lm_cfg = lm_cfg
        self.params = lm_params
        self.index = index
        self.cfg = cfg
        self.batcher = ContinuousBatcher(cfg.n_slots, admission=admission)
        self.retrieval = (RetrievalService(
            index, batching=cfg.retrieval_batching,
            window_s=cfg.retrieval_window_s,
            max_batch=cfg.retrieval_max_batch,
            cache=(HotResultCache(cfg.retrieval_cache_capacity)
                   if cfg.retrieval_cache_capacity > 0 else None),
            admission=admission) if index is not None else None)
        clen = lm.cache_len_for(lm_cfg, cfg.max_seq)
        self._cache = lm.init_cache(lm_cfg, cfg.n_slots, clen,
                                    device=self.device)
        self._tokens = np.zeros((cfg.n_slots,), np.int32)
        self.maintenance = (
            MaintenanceDriver(index, cfg.maintenance_budget_rows,
                              cfg.maintenance_interval,
                              snapshot_interval=cfg.snapshot_interval)
            if index is not None and cfg.maintenance_interval > 0 else None)
        self.stats = {"ticks": 0, "tokens": 0, "retrievals": 0,
                      "maintenance_runs": 0}

    # -- query embedding (mean-pooled token embeddings) -----------------------
    def embed_queries(self, token_batch: np.ndarray) -> np.ndarray:
        """(Q, T) tokens -> (Q, D) fp32 numpy: the mean of their embedding
        rows (no transformer forward), computed in the model dtype."""
        toks = torch.as_tensor(np.asarray(token_batch), device=self.device)
        emb = self.params["embed"][toks.long()]
        return emb.mean(dim=1).to(torch.float32).cpu().numpy()

    # -- retrieval ------------------------------------------------------------
    def retrieve(self, query_vecs: np.ndarray, modality: str = "text",
                 tenant: str = "default"):
        """Hybrid retrieval through the serving path: pow2-bucketed batch
        call + per-row hot-result cache (invalidated by the index version
        stamp). Returns ids (Q, retrieve_k), or None when there is no index
        or admission rejects the tenant."""
        if self.index is None:
            return None
        self.stats["retrievals"] += len(query_vecs)
        plan = RetrievalPlan(modality=modality, k=self.cfg.retrieve_k,
                             n_hops=self.cfg.hops)
        got = self.retrieval.search_many(plan, np.asarray(query_vecs),
                                         tenant=tenant)
        if got is None:
            return None
        _scores, ids = got
        return np.asarray(ids)

    # -- generation -----------------------------------------------------------
    def submit(self, rid: int, prompt: np.ndarray, retrieved_ids=None,
               max_new_tokens: int = 16):
        if retrieved_ids is not None:
            # entity ids map into reserved low vocab as context tokens; the
            # -1 padding of short candidate sets is dropped, not wrapped
            # into a real token by the modulo
            rids = np.asarray(retrieved_ids).reshape(-1)
            rids = rids[rids >= 0]
            ctx = (rids % max(self.lm_cfg.vocab_size // 4, 1)).astype(np.int32)
            prompt = np.concatenate([ctx, prompt])
        self.batcher.submit(Request(rid, np.asarray(prompt).astype(np.int32),
                                    max_new_tokens))

    def _prefill_slot(self, slot: int, prompt: np.ndarray):
        toks = torch.as_tensor(prompt, device=self.device)[None, :]
        with obs.span("serving.prefill") as sp:
            logits, cache = lm.prefill(
                self.lm_cfg, self.params, toks,
                margin=self._cache[0].shape[2] - len(prompt))
            sp.fence(logits)
        # copy this request's cache into its row of the shared cache, in
        # place — all leaves, including the (L, clen) slot-position row:
        # decode masks each slot's attention by its own positions
        for shared, one in zip(self._cache, cache):
            shared[:, slot].copy_(one[:, 0])
        # the prefill logits give this request's first generated token (fed
        # to the first decode step at pos = len(prompt))
        first = int(torch.argmax(logits[0]))
        self._tokens[slot] = first
        self.batcher.record_prefill_token(slot, first)

    def tick(self) -> List[int]:
        """One engine iteration: admit + prefill new, decode one token for all.

        Decode runs at a per-slot ``(n_slots,)`` position vector. Inactive
        slots decode garbage into their own rows only; admission
        re-prefills the row before reuse."""
        with obs.span("serving.tick"):
            admitted = self.batcher.admit()
            for slot in admitted:
                req = self.batcher.requests[self.batcher.slots[slot].rid]
                self._prefill_slot(slot, req.prompt)
            if self.maintenance is not None:
                # between decode steps: one bounded maintenance step keeps
                # ingest-while-search from ever paying a full compaction
                # stall
                if self.maintenance.tick() is not None:
                    self.stats["maintenance_runs"] += 1
            occupancy = int(np.sum(self.batcher.active_mask()))
            if occupancy == 0:
                return []
            obs.histogram("serving.batch_occupancy",
                          obs.COUNT_BUCKETS).observe(occupancy)
            pos = np.array([s.pos for s in self.batcher.slots], np.int32)
            with obs.span("serving.decode_step"):
                logits, self._cache = lm.decode_step(
                    self.lm_cfg, self.params, self._cache,
                    torch.as_tensor(self._tokens, device=self.device),
                    torch.as_tensor(pos, device=self.device))
                # the argmax's copy to the host waits for the step, so the
                # span holds the step's device time without sync-spans
                nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
            self.batcher.record_tokens(nxt)
            self._tokens = nxt
            self.stats["ticks"] += 1
            self.stats["tokens"] += int(np.sum(self.batcher.active_mask()))
            return list(nxt)

    def run_to_completion(self, max_ticks: int = 1000) -> Dict[int, List[int]]:
        t = 0
        while self.batcher.any_active and t < max_ticks:
            self.tick()
            t += 1
        return {rid: r.generated for rid, r in self.batcher.requests.items()}
