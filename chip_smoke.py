"""Chip smoke: builds the port's CUDA kernels and drives HMGI's main paths
on one NVIDIA GPU (written for an H100): hybrid retrieval, RAG serving
over the retrieval index with phi4-mini and with DeepSeek-V2-Lite at full
width and depth, EGNN full-graph inference at the ogbn-products shape,
EGNN training (full graph, minibatch, molecule), the mesh bodies on one
controller (the GNN ring at ogbn-products, DimeNet's line-graph ring,
xDeepFM's row-sharded tables, the MoE/LM mesh), NequIP, DimeNet and
Equiformer-v2 inference and training at their published configs,
phi4-mini training at full width and depth, xDeepFM training, serving
and retrieval at its published config, and the serving launcher.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device   — the card's name and power limit (nvidia-smi).
  2. build    — the three CUDA libraries built at once (one nvcc each),
                their nvcc times and ptxas' register/shared-memory/spill
                report.
  3. kernels  — each kernel against its plain PyTorch version at the main
                paths' shapes, then timed (CUDA events, L2 flushed between
                launches) beside its bound, the plain version and a
                library call. The two scans also run skewed probes (the
                probe scan), equal their limb emulation bitwise on 16
                queries, and give 8 queries the same bits alone as in the
                batch of 256. The decode kernel runs the tick's ragged
                histories, all 8 slots at the full 2,048 and short
                histories, each twice for the same bits, with its launch
                plan (tile, splits, blocks, shared memory), timed also
                after a flush that leaves L2 clean; then at the reference's
                smoke head dim 16 (bf16 and fp32, the tick's slots) and
                over a bf16 cache of 2.42e9 elements, past 2^31
                ([kernel.decode_attention.hd16_*], [...past_2_31]). The
                delta kernel is
                measured again after phase 4 at the delta size those
                searches scanned, when ingest overflow grew the delta.
                The probe kernel is also held against its plain version
                on each shard of the sharded phase's S = 4 layout. The
                segment sums run each route of their plans (team, medium,
                wide) at small shapes, bit for bit and uncounted: the
                summing kernel ([kernel.segment_sum.routes], with
                [kernel.segment_sum.small]'s unsorted ids) and the
                in-place one; every summing check is bitwise and every
                summing line prints its plan.
  4. vector   — ingest → search → filtered search → update → delete at the
                serve_1m shape (1,048,576 × 384, batch 256) under the
                default config (get_config("hmgi"): maint_auto on),
                recall@10 against an exact top-10 computed on the card,
                and 16 queries re-run on a CPU copy of the index. Then,
                uncounted, the summing kernel as k-means' cluster sums
                (run_sums' two launches of a Lloyd iteration) over this
                index's rows by their centroids, beside its bound and
                index_add_ ([kernel.segment_sum.kmeans_runs],
                [...kmeans_clusters]).
     maint    — adaptive maintenance on the same index: recluster, merge
                and split through maintain(), a merge by deletes, a split
                by maybe_repartition, drains past the delta's watermark;
                full-probe bytes unchanged by each move, the card against
                a CPU copy after each pass, every write found, no delete
                back, no write dropped; maintain() and insert-batch
                latency, one full compact() as the stop-the-world
                baseline.
     sharded  — the row-sharded stable scan on the same index, its state
                in a facade over a mesh of S shards on this card (no
                second ingest): device_layout sharded(x4) under
                shard_layout "auto" (the 805 MB slab is over the 256 MiB
                budget) and explain's layout; shard_index at S = 2, 4, 8
                (ms, GB/s, peak memory; the live rows and per-shard
                counts against the single layout); search_sharded equal
                to search (scores bitwise, ids up to exact ties) at S =
                2, 4, 8, n_probe 8 and 64, with a predicate and with
                precomputed probes; each shard's probe kernel at cap_l
                against its plain version and timed; the facade's
                search, filtered search and query equal to the single
                facade's, search_bucketed 8 batched equal to alone;
                insert batches on both facades until maintain changes the
                slab (the replica dropped, rebuilt and timed, searches
                equal again); search p50/p99 at S = 1, 2, 4, 8, the
                sharded.scan / sharded.merge span p50s, one profiled S =
                4 search with one probe launch per shard; with two cards
                or more, one check and one p50 across them.
     durable  — the durable lifecycle at the same size over the same
                corpus (get_config("hmgi"): wal_sync_every 1,
                snapshot_keep 2): a script of writes (ingest, 18 update
                batches of 256, 4 delete batches of 16, snapshot() after
                batch 12, a tail with maybe_repartition() and maintain())
                on a plain HMGIIndex, a DurableHMGIIndex and one at group
                commit 16 (the WAL's append and fsync, insert-batch
                latency and the WAL's overhead), snapshot() and recover()
                by stage; the recovered index equal to the live one byte
                for byte (every state leaf; search, filtered and
                full-probe bytes for 256 queries); two kill -9 children of
                this script (HMGI_FAULTPOINT at the 15th WAL append and in
                the snapshot's write) recovered and held to a golden
                replay of their durable prefix; the port's crash harness
                swept over its nine points on the card (in the background
                beside the dryrun phase's probes, its [durable.sweep]
                line there); partitioner.fit
                three times bitwise, its cluster sums against their plain
                version; the directory recovered again over a 4-shard
                mesh, its search bytes equal to the live index's. It
                needs 10 GB free under the temp dir.
  5. hybrid   — ingest with a graph, hybrid_search (plain, typed, filtered)
                at 131,072 nodes, checked against a CPU copy of the index;
                the summing kernel as the hop operator's out-degrees on
                its graph, uncounted ([kernel.segment_sum.hop_degrees]);
                then [sharded.hybrid]: the same index over 4 shards
                (layout forced: its 100 MB slab is under the budget),
                hybrid_search and one RAGEngine.retrieve batch equal to
                the single facade's, hybrid p50 beside it.
     facade   — the rest of the facade on the same index: the NSW graph
                built (seconds, peak memory; a 16,384-row twin on the CPU
                gives the same neighbours up to ties), nsw.search alone
                (recall@10, latency), search with the NSW refine lane
                (against plain search, a CPU copy, 8 queries batched vs
                alone), hybrid_search with the sparse-dense rerank (its
                span, the match tensor's size, a CPU copy), progressive
                rounds (recall must not fall, the last equals one-shot
                n_probe 16), label propagation (equal to the CPU), stage
                times from the facade's own spans (trace=True, sync
                spans), and the reference's MVCC sequence on the NSW lane
                (a delete, an update, compact() with its NSW rebuild). The
                probe and delta kernels' launches must grow. Then the
                index through a snapshot (write_snapshot, read_snapshot,
                restore_state): plain, typed and filtered hybrid_search
                byte-equal; the hop operator three times bitwise.
     racecheck — the port's concurrency contract on the card
                (tools/racecheck_torch.py) over a get_config("hmgi")
                index of 16,384 rows at d 384: (a) 4 seeded interleavings
                of 3 searchers (search through a shared hot-result cache
                and admission, the lazy id-row and sharded caches) against
                a writer confined to another modality (insert, delete,
                maintain, state_tree), each bitwise the card's
                single-threaded oracle, no Eraser lockset warning and no
                in-place write to a tensor of the published state during a
                searcher's op; (b) 8 free-running searchers beside the
                writer, the same checks, then RetrievalService with
                micro-batching under 16 client threads, every response
                bitwise the request alone. One [racecheck] line.
  6. rag      — RAGEngine over the phase-5 index with full-width
                phi4-mini (32 layers, bf16, seeded random weights) and its
                default maintenance pacing (a bounded maintain() every 4th
                tick): 32 retrievals, 32 ragged requests (prompts 128-1,536
                tokens, 32-64 new tokens) on 8 slots; prefill, decode-tick
                and maintenance-stall latency, tokens/s, one profiled tick
                (with the decode kernel's share of its device time); checks
                that 8 retrievals give the same bytes batched as alone,
                stage by stage too, that every
                decode tick ran the flash-decode kernel in each layer, a
                4-layer fp32 copy matches sequential decode token for
                token, and a 2-layer copy matches the same weights on the
                CPU.
     rag_dsv2 — the same engine, index and traffic with DeepSeek-V2-Lite
                (get_config("deepseek-v2-lite-16b"): 27 layers, MLA,
                64 routed experts top-6 + 2 shared, bf16, 31.4 GB of
                seeded random weights): prefill and decode-tick latency,
                tokens/s, parameter bytes and peak memory, one profiled
                tick (its top kernels and operators), each part of a layer
                timed at the tick's shapes (router, MoE FFN, expert bmm,
                shared expert, MLA decode), the tick's weight bytes against
                the HBM bound (and what only the routed experts would
                move), the MoE drop share at prefill and at decode (each
                request's prefill again, 16 ticks of 8 slots, outside the
                timed run); checks that retrieval ran both scans and the
                decode kernel never ran (MLA decodes in the absorbed form),
                that a 4-layer fp32 copy at capacity factor 16 decodes two
                ragged rows in one batch as each alone (1e-5), and that a
                2-layer fp32 copy routes and scores as the CPU does.
     lm.mixtral — mixtral-8x7b at full width cut to 2 layers (bf16): a
                4,608-token prompt against the 4,096 window, 8 decode
                steps that wrap; the decode kernel (G 4, S 4,096) against
                its plain version on the run's cache, 2 launches a step.
  7. gnn      — EGNN (get_config("egnn"): 4 layers, d_hidden 64, fp32,
                seeded random weights) over make_flat_graph at the
                ogb_products shape (2,449,029 nodes, 61,859,140 edges,
                d_feat 100): the segment-sum kernel against its plain
                version at one layer's real shape and timed beside its
                bound, its plain version and index_add_; 6 full-graph
                forwards (logits + CE sums; p50/p99 of the last 5), one
                profiled; checks that every layer of every forward ran the
                kernel once per chunk, that two forwards and a forward with
                half the chunk budget give the same bits, that a
                65,536-node copy matches the CPU, and that the molecule
                shape (128 graphs of 30 nodes / 64 edges as one
                disjoint-union graph) matches a per-graph loop on the CPU.
     gnn_train — EGNN training with AdamW through make_train_step and
                Trainer: (a) on phase 7's graph and LocalExec, one warm-up
                and 4 timed steps with a checkpoint every 2 (step ms
                beside the forward's, loss, grad norm, peak memory, the
                launches a step: the summing kernel's in the forward,
                layers x chunks, and the in-place kernel's in the
                backward's gather transposes, layers x 2 x blocks; one
                profiled step with its aten::add* device time and each
                segment kernel's launches the profiler saw beside the
                wrappers' counts); a step,
                its parts and half the chunk budget from the same state
                give the same bits; a run whose step 3 fails restores the
                step-2 checkpoint and equals the uninterrupted run at step
                4; the in-place kernel at one block's source and
                destination transposes against its plain version bit for
                bit, timed beside a touched-rows bound and index_add_ in
                place, and PR 21's full-N transpose beside it; (b) one
                step on a 16,384-node copy, gradients and new params
                against the CPU; (c) minibatch_lg: a 232,965-node,
                114,615,892-edge host graph, the neighbour sampler's CSR,
                4 steps of 1,024 fanout-(15, 10) trees (sampler ms and
                step ms apart); (d) one molecule step.
     mesh     — the mesh bodies on one controller, their shards on this
                card: (a) EGNN on phase 7's graph padded to 2,449,032
                nodes through full_graph_loss(mesh=) (the ring: to_ring,
                RingExec; each data shard's body in a thread of its own
                on its node blocks, collectives.spmd) at S = 4 and on a
                (2, 2) data x model grid: 3 forwards after a warm-up
                (one on the grid), p50/p99,
                to_ring's seconds, peak memory, the summing kernel's
                launches held to layers x shards x rounds x chunks a
                round, the loss sums within 1e-5 of LocalExec's, two ring
                forwards bit for bit, one profiled S = 4 forward (its
                profiled launches beside the wrappers'); (b) one
                make_train_step(mesh=) step at S = 4: step ms, peak memory, the in-place launches
                (layers x 2 x message blocks), loss and grad norm within
                1e-4 of gnn_train's first LocalExec step; (c) a 16,384-node
                copy at S = 4 and (2, 2), loss sums and gradients card
                against CPU within 1e-5, and at S = 4 each shard's node
                blocks (n_loc rows, on its device) and every tensor its
                body's operators return (on its device, none with the
                copy's 16,384 node rows), from a dispatch hook entered in
                each shard's thread; (g) with two cards or more, EGNN at
                ogbn-products with one data shard a card: the layout
                check, a forward and a step against LocalExec (1e-5,
                1e-4), each card's peak beside the one-card S = 4 peaks
                (one card: "not run: 1 card on this host"); (d)
                DimeNet's ring_loss at full_graph_sm (published config,
                bonds spread) at S = 2
                and (2, 2) against its local loss; (e) xDeepFM at its
                published config on a (2, 2) grid: the forward at 65,536
                rows bitwise equal to the unsharded one, retrieval over
                1,000,000 candidates within 1e-6, both timed beside the
                unsharded calls. The rag phase adds phi4-mini's prefill
                and decode_step over a (1, 4) grid (bitwise, one decode
                launch a layer) and rag_dsv2 DeepSeek-V2-Lite's 512-token
                prefill over a (1, 4) grid against prefill(None), a
                decode_step over it, the drop shares by data shard of a
                (2, 2) prefill, and one of its MoE layers in fp32 on a
                (2, 2) grid against each data shard's tokens through
                moe_ffn(mesh=None): the same keep masks, outputs within
                1e-5, two controls outside that bound ([mesh.lm]). (f)
                RAGEngine(mesh=) on the smoke phi4-mini over a (1, 2)
                grid: the token streams of the engine without a mesh.
     gnn_models — NequIP, DimeNet and Equiformer-v2 at their published
                configs (fp32, seeded random weights, TF32 off), each on
                the molecule cell (128 graphs of 30 nodes / 64 edges;
                DimeNet with its triplets), the full_graph_sm cell (2,708
                nodes, 10,556 edges, d_feat 1,433) and gnn_train's sampled
                minibatch_lg batch (DimeNet without triplets), NequIP also
                on phase 7's ogbn-products graph: forward p50/p99 (loss
                under no_grad), train-step p50/p99 where a step fits,
                edges/s, peak memory, the segment-sum and in-place
                launches per forward and per step held to their formulas,
                the Wigner-D launches (Equiformer-v2), one profiled
                forward or step per cell that trains, with each segment
                kernel's launches seen beside counted (the forward-only
                cells are not profiled: the dryrun phase took their
                time). Checks per arch: (a) 8
                molecules at full width and depth, logits and one step's
                new params card against CPU; (b) two forwards, and a
                forward at half the chunk budget, bit for bit; (c) two
                train steps from
                one state bit for bit; (d) rotation invariance of the
                molecule cell's logits; (e) both kernels against their
                plain versions at the new widths (289, 6,272 and 128
                summed; 291, 6,275 and 128 added in place), timed beside
                their byte bounds and index_add_.
     lm_train — LM training through models.lm.make_train_step (the GNN
                state freed first): (a) phi4-mini at full width and depth
                (bf16, seeded random weights), seq 4,096, micro-batch 1 x
                grad_accum 4 (global batch 4, cut from train_4k's 256),
                remat, q_block 1,024, AdamW (lr 3e-4, warm-up 100,
                cosine): one warm-up and 2 timed steps (step p50/p99,
                tokens/s, mfu against 989 TFLOP/s bf16, peak memory, the
                token transpose's launches a step: one per micro-batch),
                one micro-batch's step profiled (a whole step's events
                took the profiler ~50 s); the token transpose (the
                in-place kernel at 4,096 x 3,072 bf16 into 200,064
                rows) against its plain version bit for bit, timed beside
                its byte bound and index_put_(accumulate=True); (b)
                1-layer full-width copies
                of phi4-mini (grad_accum 2) and DeepSeek-V2-Lite (its MLA
                + MoE layer), their vocabularies cut to 32,768, one fp32
                step each at seq 64, card against CPU; (c) their bf16
                twins, two runs of one step bitwise; (d) the Trainer with
                checkpoints on the phi4-mini copy, a
                failure at step 3 restored bitwise; (e) python -m repro_torch.launch.train --arch
                phi4-mini-3.8b --steps 2 as a child process.
     recsys   — xDeepFM at its published config (get_config("xdeepfm"):
                39 fields of 100,000 ids, D 10, CIN 3 x 200, MLP 2 x 400,
                fp32, TF32 off, seeded random weights, SyntheticRecsysStream
                data) on the reference's four shapes: (a) the forward and
                one AdamW step on 256 rows, card against a CPU copy
                (logits, loss, each gradient and new param within 1e-4 of
                its leaf's largest); (b) two train_batch steps from one
                state bit for bit; (c) train_batch (65,536 rows): step
                p50/p99 after a warm-up, examples/s, the FLOP share of 67
                TFLOP/s fp32 (the dry run's formula), peak memory, one
                profiled step (the segment kernels' launches seen beside
                counted), two in-place launches a step; (d)
                serve_p99 (512) and serve_bulk (262,144) forwards
                p50/p99 and peak memory, the 512 rows against the same
                rows inside the bulk batch (1e-5); (e) retrieval_cand
                (1 x 1,000,000): p50, a planted copy of the user ranked
                first; (f) the in-place kernel at the tables' and
                linear_w's transposes (2,555,904 x 10 and x 1 fp32) and
                the summing kernel through embedding_bag(mode="sum")
                (65,536 bags of 1-40 ids), each against its plain version
                bit for bit, timed beside its bound and index_add_.
     launch_serve — python -m repro_torch.launch.serve as child processes
                on the card: --n-nodes 32768 --queries 256 --data-dir D,
                then --recover --rag on D (the reference's smoke
                phi4-mini), each exiting 0 with the reference's lines;
                the durable phase's crash harness sweep runs from here
                beside it and the dryrun phase's probes; recall@10 within
                0.05 of a --device cpu child at the first run's arguments
                (run beside them).
     dryrun   — the H100 dry run (python -m repro_torch.launch.dryrun)
                over the 40 cells of configs.all_cells(): its cells traced
                on the meta device (the LMs', xDeepFM's, and the
                singlepod/multipod grids' per-device state) run in a
                background child of this script from the build phase on
                (--dryrun-child, nice 10), its GNN cells' probes on the
                card here; (a) one [dryrun.cell] line per cell: 37 ok and
                the 3 dense LMs' long_500k skipped with the reference's
                reason (none refused by a kernel's check since the decode
                kernel takes 2^31 elements and more), fits false where PERF.md §4 cuts a
                cell for memory and true where this script runs the
                cell's step or call at its full shape; (b) the cells this
                script runs at their shapes (phi4-mini-train-4k at its cut
                batch 1 x 4, phi4-mini's decode tick over 8 full slots of
                2,048, xdeepfm-train-batch, xdeepfm-serve-bulk, EGNN's
                ogbn-products forward and step) predicted by the dry run's
                cell function and held against the same counter around
                the card's own run of the same work, untimed, in its
                phase: FLOPs within 0.1% (meta traces) or 5% (GNN
                probes), bytes within 10% (a meta trace's never under the
                count), peak within -5% / +10% plus 0.5 GiB (meta) or 25%
                (GNN) of max_memory_allocated; (c) each one's measured ms
                at least the dry run's compute term; (d) the mesh phase's
                ring at S = 4: the counter's collective bytes equal the
                rotations x shards x block bytes; (e) the card's
                total_memory and nvidia-smi line beside the 80 GB
                constant. The durable phase's crash harness sweep runs
                beside the probes.
  8. the kernels line, then the contract line. The segment sum's launches
     there count the index path's too (k-means cluster sums, hop
     out-weights), read phase by phase, the training runs' forwards and
     the mesh phase's ring forwards and step;
     the in-place kernel's (segment_sum_csr_accumulate) the GNN training
     runs' and the mesh phase's ring step's gather transposes and the LM
     runs' token transposes ((a)'s
     steps and (d)'s Trainer runs); both also count the gnn_models cells'
     forwards and steps (not their checks), and the recsys phase's: its
     train_batch steps' table transposes and its embedding_bag call; the
     scans' count the index phases' and both RAG cells' retrievals, the
     decode kernel's the phi4-mini cell, its decode_step over a mesh and
     the mixtral check.

It imports only torch, numpy and the port (``src/repro_torch``), and needs a
CUDA device: without one it exits 1 and prints no result. ``--durable-child
DIR VECS.npy`` is the durable phase's own child process, ``--dryrun-child
DIR`` the dryrun phase's.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense int8 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_TC_OPS = 1979e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
VEC_N, HYB_N, DIM, BATCH = 1_048_576, 131_072, 384, 256
# the hybrid phase's ingest runs the reference's host Louvain sweep, about
# 0.3 ms per node on a CPU core: ~40 s here, ~5 min at 1,048,576 nodes
HYB_CUT = ("hybrid phase at 131,072 nodes, not 1,048,576: host Louvain "
           "(~0.3 ms/node) would take ~5 min of the 20 min limit")
SCORE_ATOL = 1e-4     # fp32 sums over d=384 in another order (scores O(1))
# the maint phase reads every partition: its answer does not depend on the
# routing, so byte-identical row moves leave its bytes unchanged
MAINT_FULL_PROBE = 64
# the sharded phase's shard counts (serve_1m's cap 32,769 is odd: each pads)
SHARDS = (2, 4, 8)
# the durable phase: its script of writes (18 update batches of 256, 4
# delete batches of 16, a snapshot after batch 12), the two kill -9
# children's fault points (the 15th WAL append: an update before the
# snapshot; the snapshot's first leaf), and the free disk it needs (a
# ~2.5 GB snapshot, a ~1.6 GB ingest record, the corpus file for the
# children, two children's own logs)
DURABLE_BATCHES, DURABLE_DEL, DURABLE_SNAPSHOT_AFTER = 18, 16, 12
DURABLE_POINTS = ("wal.post_append:15", "snapshot.mid_write")
DURABLE_MIN_FREE = 10e9
# the facade phase: the NSW graph over the phase-5 index (degree 16, ef 64,
# as configured), its CPU twin at 16,384 rows, and the rerank lane's hashed
# documents (32 terms each, 16 for the batch, 4,096 buckets)
NSW_CUT = ("facade phase: the NSW graph over the 131,072-node hybrid index, "
           "not serve_1m: its build scores every row against 4 probed "
           "partitions of N/16 rows, so 1,048,576 rows cost ~64x the "
           "131,072 build")
NSW_CPU_ROWS = 16_384
NSW_TIE_ATOL = 1e-5   # neighbour scores recomputed in float64 (bf16 rows)
RERANK_NNZ, RERANK_T, RERANK_BUCKETS = 32, 16, 1 << 12
PROGRESSIVE = (1, 2, 4, 8, 16)
# the RAG cell: phi4-mini at full width, 8 decode slots over a 2,048-token
# cache (ROADMAP Queue 1 item 16)
RAG_SLOTS, RAG_SEQ, RAG_REQUESTS = 8, 2048, 32
# decode kernel vs its plain version: both round one fp32 result to bf16,
# so they differ by at most 1 bf16 ulp of outputs |out| < 2 (2^-7); the
# kernel phase holds each output to one ulp of itself instead
# (decode_attention.ref.bf16_excess: 2^-7 |ref| + 2^-16)
DECODE_BF16_ATOL = 2.0 ** -7
# the decode kernel's extents: the reference's smoke head dim 16
# (its phi4-mini heads: Hkv 2, G 2) at the tick's slots and histories in
# bf16 and fp32 (fp32 against fp32: DECODE_FP32_ATOL), and a bf16 cache of
# DECODE_PAST_2_31 = (B, S, Hkv, G, hd), 2.42e9 elements (9.66 GB of K and
# V) past 2^31, its plain version and SDPA DECODE_ROWS rows at a time; its
# control, the plain version of the rows past 2^31 without their first
# 64-position tile, must fail the bound
DECODE_FP32_ATOL = 1e-5
DECODE_PAST_2_31, DECODE_ROWS = (72, 32768, 8, 3, 128), 8
# the racecheck phase: tools/racecheck_torch.py on the card over
# get_config("hmgi") at d 384, RACE_ROWS rows in two modalities;
# RACE_SEEDS seeded interleavings of 3 searchers x 2 rounds against one
# writer, then RACE_FREE free-running searchers x RACE_ROUNDS beside the
# writer, then RetrievalService under RACE_CLIENTS client threads of
# RACE_REQUESTS requests each over RACE_QUERIES distinct queries
RACE_ROWS, RACE_SEEDS, RACE_FREE, RACE_ROUNDS = 16_384, 4, 8, 4
RACE_CLIENTS, RACE_REQUESTS, RACE_QUERIES = 16, 8, 64
# 2-layer full-width copy, card vs CPU: fp32 with TF32 off, the same
# function summed in another order on two devices; logits are O(1)
CPU_LOGIT_ATOL = 1e-3
# the MoE/MLA RAG cell (rag_dsv2): DeepSeek-V2-Lite at full width and
# depth on the RAG cell's slots and traffic; its capacity drops measured
# over DSV2_TICKS decode ticks outside the timed run; the 4-layer fp32
# copy's batched rows against solo rows (rtol = atol, the reference's
# tests/test_serving.py tolerance; fp32 logits O(1)); a router gap under
# NEAR_TIE may flip between two summation orders
DSV2 = "deepseek-v2-lite-16b"
DSV2_TICKS = 16
DSV2_SOLO_TOL = 1e-5
NEAR_TIE = 1e-6
# the [lm.mixtral] check: one prompt past the 4,096 window, steps that wrap
MIXTRAL_PROMPT, MIXTRAL_STEPS = 4608, 8
# the GNN cells: EGNN over the ogb_products shape in chunks of 4 Mi edges
# (~11 GB of per-edge temporaries), and the molecule shape
GNN_CHUNK_EDGES = 1 << 22
GNN_REPS = 5
# EGNN, card vs CPU (same weights, fp32, TF32 off): matmuls and sums in
# another order over 4 layers, relative to max(1, max |logit|)
GNN_CPU_RTOL = 1e-3
# the GNN training cells: one warm-up and TRAIN_STEPS timed Trainer steps at
# ogbn-products with a checkpoint every TRAIN_CKPT_EVERY steps, a step
# failure injected at TRAIN_FAIL_AT in the restart run; card vs CPU on a
# TRAIN_CPU_N-node copy; minibatch_lg (reddit-sized host graph, d_feat 602
# as the reference's dry run uses) with MB_ROOTS roots a batch, fanouts
# MB_FANOUTS, MB_STEPS steps
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 4, 2, 3
# cut from 65,536 nodes (35 s of CPU) to make room for the gnn_models phase
TRAIN_CPU_N = 16_384
MB_ROOTS, MB_FANOUTS, MB_STEPS, MB_D_FEAT = 1024, (15, 10), 4, 602
# the gnn_models phase: NequIP, DimeNet and Equiformer-v2 at their
# published configs (fp32) on the molecule, full_graph_sm and minibatch_lg
# cells, NequIP also at ogbn-products; forwards and steps timed after one
# warm-up (the ogbn-products forward: MODEL_OGB_REPS). Card vs CPU on
# MODEL_CPU_MOLECULES molecules (logits, gradients, one step's new params
# and first moments) at EGNN's 1e-3, and rotation invariance at
# tests/test_gnn.py's 1e-4, every arch held. DimeNet's spherical Bessel j_5
# and j_6 (an upward recurrence, unstable at z·r/c < l/2) amplify each
# device's rounding by orders of magnitude where two unit-sphere atoms are
# close (the reference's own logits move by 6.39 relative when the
# molecule cell's molecules are rotated: tests/test_torch_gnn_models.py):
# DimeNet is held on the same molecules with their bonds spread
# (``driver.spread_bonds``: 1.7 to 4.8 long), and its unit-sphere readings
# are printed beside, not held
MODEL_ARCHS = ("nequip", "dimenet", "equiformer-v2")
# timed calls after the warm-up; the cells of seconds a forward
# (nequip-ogbn-products, equiformer-v2-minibatch-lg) take MODEL_BIG_REPS
MODEL_FWD_REPS, MODEL_STEP_REPS, MODEL_BIG_REPS = 4, 2, 2
MODEL_CPU_MOLECULES = 8
MODEL_CPU_RTOL, MODEL_ROT_RTOL = 1e-3, 1e-4
# (b)'s cell and chunk budget per arch: a budget that cuts the cell's
# graph into several chunks, as its half does (the default budgets are one
# chunk there); DimeNet's sums do not go through the chunks
MODEL_BITWISE = {"nequip": ("minibatch-lg", 65_536),
                 "equiformer-v2": ("full-graph-sm", 4_096),
                 "dimenet": ("full-graph-sm", 0)}
# Equiformer-v2's eq_norm floors each l block's RMS at sqrt(1e-6): a node
# with no in-edges keeps l > 0 blocks of 0 and each norm's backward scales
# their gradient by 1e3, so at 12 layers the ln1/ln2 gradients of the first
# layers overflow, and the clipped AdamW step (a NaN global norm) makes
# every new param NaN. The reference's step does the same on these graphs
# (the port keeps its semantics): a step's loss must be finite and only
# ln1/ln2 gradients may be non-finite; comparisons match NaN for NaN, and
# (a)'s step is not clipped, so that its other leaves stay finite.
EQV2_NONFINITE_OK = ("ln1", "ln2")
# the forward-only cells (nequip-ogbn-products, equiformer-v2-minibatch-lg)
# are not profiled: aggregating their forwards' events took 46.5 s and
# 10.5 s of the cells' 80.0 s and 21.9 s on an H100, cut to make room for
# the dryrun phase; PERF.md §5 keeps the breakdowns of both
MODEL_PROFILE_CUT = ("not profiled: cut for the dryrun phase (on an H100, "
                     "46.5 s of nequip-ogbn-products' 80.0 s, 10.5 s of "
                     "equiformer-v2-minibatch-lg's 21.9 s); PERF.md §5 "
                     "keeps their breakdowns")
MODEL_CUTS = {
    "equiformer-v2-ogbn-products": (
        "not run: its node state (2,449,029 x 49 x 128 fp32) is 61.4 GB a "
        "tensor, and a forward ~1.5e16 FLOPs"),
    "dimenet-ogbn-products": (
        "not run: ~8 x 61.9 M = 495 M triplets, whose (T, 42) fp32 basis "
        "alone is 83 GB, built by a host pass over 61.9 M edges"),
    "equiformer-v2-minibatch-lg": (
        "forward only: a step keeps each layer's weighted messages "
        "(168,960 x 6,272 fp32, 4.2 GB) and node states (169,984 x 6,275 "
        "fp32, 4.3 GB each) for 12 layers, over 80 GB"),
    "dimenet-minibatch-lg": "without triplets, as the reference's "
                            "minibatch_loss runs it",
}
# the mesh phase: the ring's shards on this card (S = 4 and a (2, 2)
# grid), MESH_REPS timed forwards after a warm-up at S = 4 (one on the
# grid); the ring's loss sums against LocalExec's (and DimeNet's ring
# against its local loss) at MESH_LOCAL_RTOL, its train step's loss and
# gradient norm at MESH_STEP_RTOL, card against CPU at MESH_CPU_N nodes
# at MESH_CPU_RTOL, xDeepFM's retrieval over the grid at
# MESH_RETRIEVAL_RTOL (its forward at MESH_XDEEPFM_ROWS rows bitwise)
MESH_SHARDS, MESH_REPS, MESH_CPU_N = 4, 3, 16_384
MESH_LOCAL_RTOL, MESH_STEP_RTOL, MESH_CPU_RTOL = 1e-5, 1e-4, 1e-5
MESH_RETRIEVAL_RTOL, MESH_XDEEPFM_ROWS = 1e-6, 65_536
# the LMs over a mesh: DeepSeek-V2-Lite's prefill of MESH_PROMPT tokens on
# a (1, 4) grid against prefill(None) within MESH_BF16_RTOL of
# max(1, largest |logit|) (the experts' F slices summed in another order
# in bf16, through 27 layers of random weights: 3.0% of the largest logit
# on the H100), the same argmax up to near-ties, a smoke of the whole
# path; the mesh body itself is held in fp32, one MoE layer on a (2, 2)
# grid against its plain split within MESH_MOE_RTOL of its largest
# |output|; phi4-mini's MESH_DENSE_PROMPT-token prefill and decode bitwise
MESH_PROMPT, MESH_DENSE_PROMPT, MESH_BF16_RTOL = 512, 64, 2.0 ** -4
MESH_MOE_RTOL = 1e-5
# the LM training cell: phi4-mini at full width and depth, train_4k's
# sequence, micro-batch 1 x LM_ACCUM micro-batches, one warm-up and
# LM_STEPS timed steps; its checks on 1-layer full-width copies with the
# vocabulary cut to LM_CHECK_VOCAB (card vs CPU at LM_CPU_SEQ in fp32; two
# runs bitwise in bf16; the Trainer's restart at LM_CKPT_SEQ, which needs
# LM_CKPT_MIN_FREE of disk). DeepSeek-V2-Lite's copy is its MLA + MoE
# layer (no dense first layer; phi4-mini's copy runs a dense FFN).
# LM_CPU_SEQ was 128 and the Trainer ran the full 200,064 vocabulary (two
# 8.2 GB checkpoints, 100 s) until the gnn_models phase needed the time;
# the copies had 2 layers and the full vocabulary in the card-vs-CPU
# check (97 s, the CPU's embedding-sized work most of it) until the mesh
# phase needed it; 3 timed steps until the dryrun phase needed their 4.2 s.
LM_SEQ, LM_ACCUM, LM_STEPS = 4096, 4, 2
LM_CUT = ("lm_train: global batch 4 (micro-batch 1 x grad_accum 4), cut "
          "from train_4k's 256; seq 4,096, width, vocabulary and depth as "
          "published")
LM_CPU_SEQ, LM_CKPT_SEQ, LM_CHECK_VOCAB = 64, 512, 32_768
LM_CKPT_MIN_FREE = 8e9
# card vs CPU in fp32 (TF32 off): PR 20's 1e-4, relative to each leaf's
# largest |value| (to max(1, ...) for the params)
LM_CPU_RTOL = 1e-4
# the recsys cells: xDeepFM at its published config (fp32, TF32 off) on
# the reference's four shapes; card vs CPU on RECSYS_CPU_ROWS rows at
# RECSYS_CPU_RTOL of each leaf's largest |value| (to max(1, ...) for the
# new params); RECSYS_STEPS timed train steps after one warm-up; the
# serve_p99 rows against the same rows inside the serve_bulk batch at
# RECSYS_BULK_RTOL; the summing kernel's reading through embedding_bag at
# RECSYS_BAGS bags of 1-40 ids over field 0
RECSYS_CPU_ROWS, RECSYS_CPU_RTOL = 256, 1e-4
RECSYS_STEPS, RECSYS_BULK_RTOL, RECSYS_BAGS = 3, 1e-5, 65_536
RECSYS_SERVE_REPS = {"serve_p99": 20, "serve_bulk": 4, "retrieval_cand": 5}
# the launch_serve phase: the serving launcher as a child process on the
# card at SERVE_NODES nodes and SERVE_QUERIES queries (durable, then
# --recover, then --rag at the launcher's default size), its recall@10
# within SERVE_RECALL_TOL of a --device cpu child at the same arguments
SERVE_NODES, SERVE_QUERIES, SERVE_RECALL_TOL = 32_768, 256, 0.05
# the dryrun phase: DRYRUN_JOBS processes trace the meta cells in the
# background child; each cell this script runs at its shapes is predicted
# by the dry run and held to the counter around the card's run (FLOPs,
# bytes; the peak to max_memory_allocated): meta traces and GNN probes at
# their own tolerances, the peak's band (low, high) of the card's plus
# DRYRUN_PEAK_SLACK for a meta trace (the caching allocator's rounding,
# cuBLAS workspaces)
DRYRUN_JOBS = 3
# the 40 h100 records: every cell counted but the dense LMs' long_500k,
# which the reference skips
DRYRUN_STATUSES = {"ok": 37, "skipped": 3, "refused": 0}
DRYRUN_TOL = {"meta": dict(flops=1e-3, bytes=0.10, peak=(-0.05, 0.10)),
              "gnn": dict(flops=0.05, bytes=0.10, peak=(-0.25, 0.25))}
DRYRUN_PEAK_SLACK = 0.5 * 2 ** 30
# PERF.md §4: the cells cut for memory (fits must be false) and the cells
# whose step (GNN, train) or call this script runs at their full shape
# (fits must be true)
DRYRUN_NOT_FIT = ({("dimenet", "ogb_products"),
                   ("equiformer-v2", "ogb_products"),
                   ("equiformer-v2", "minibatch_lg")}
                  | {(a, "train_4k") for a in (
                      "deepseek-67b", "qwen2-72b", "phi4-mini-3.8b",
                      "mixtral-8x7b", "deepseek-v2-lite-16b")})
DRYRUN_FIT = ({("xdeepfm", s) for s in ("train_batch", "serve_p99",
                                         "serve_bulk", "retrieval_cand")}
              | {("egnn", s) for s in ("ogb_products", "minibatch_lg",
                                        "molecule")}
              | {(a, s) for a in ("nequip", "dimenet")
                 for s in ("molecule", "full_graph_sm", "minibatch_lg")}
              | {("equiformer-v2", s) for s in ("molecule",
                                                 "full_graph_sm")})
# the untimed counted runs of the cells the dryrun phase checks
COUNTED = {}


def line(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw, default=float), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, flush=None) -> float:
    """Median per-call device time of ``fn`` over ``reps`` calls (after one
    warm-up), with ``flush`` run outside the timed window before each. A
    ~0.5 ms device sleep is queued before the start event, so the host
    time that ``fn`` spends before its launches (Python, argument checks)
    overlaps the sleep and is not counted as device time."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def queued_ms(fn, calls: int) -> dict:
    """Device ms per call of ``fn`` over ``calls`` calls queued behind a
    ~100 ms device sleep: the host enqueues them all before the device
    reaches the first, so the host's gaps between small launches, which
    ``cuda_ms`` would count, do not enter the window. "not measured" when
    the enqueue outlasted the sleep (the window would hold host gaps)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(200_000_000)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    ev[2].synchronize()
    sleep_ms = ev[0].elapsed_time(ev[1])
    dev = ev[1].elapsed_time(ev[2]) / calls
    return dict(device_ms=dev if host < sleep_ms else "not measured",
                host_enqueue_ms=host / calls, sleep_ms=sleep_ms)


def host_ms(fn, reps: int):
    """(p50, p99) host-clock latency of ``fn`` (synchronised) in ms, after
    one warm-up call."""
    fn()
    return timed_ms(fn, reps)


def timed_ms(fn, reps: int):
    """(p50, p99) host-clock ms of ``reps`` synchronised calls of ``fn``,
    which the caller has warmed up."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(out, 50)), float(np.percentile(out, 99))


def profile_window(fn, top: int = 6, share_of="",
                   ops_top: int = 0) -> dict:
    """Device time by kernel over one synchronised call of ``fn`` after a
    warm-up call (see ``profile_once``)."""
    fn()
    torch.cuda.synchronize()
    return profile_once(fn, top, share_of, ops_top)[1]


PROFILE_LEAD_S = 0.02


def profile_once(fn, top: int = 6, share_of="", ops_top: int = 0,
                 op_sum: str = ""):
    """(fn's result, its profile): device time by kernel over one
    synchronised call of ``fn`` (torch.profiler / CUPTI; the window opens
    ``PROFILE_LEAD_S`` before the call, outside its wall time): the ``top``
    kernels by self device time, the device-busy sum, the host wall time,
    the device's idle share, with ``share_of`` (a name or a tuple of
    names) the device time, launches and share of busy time of the kernels
    whose names contain it, with ``ops_top`` the ``ops_top`` PyTorch
    operators (aten::bmm, aten::mm, ...) by the device time of the kernels
    each launched itself, with their call counts, and with ``op_sum`` the
    same summed over the operators whose names start with it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler can miss the kernels launched in the first
        # milliseconds of its window (tools/profile_drops_torch.py): the
        # host waits PROFILE_LEAD_S before fn's first launch
        time.sleep(PROFILE_LEAD_S)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # one aggregation of the events (it costs seconds on a long window)
    avgs = prof.key_averages()
    kern = [e for e in avgs
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy <= 0:
        return out, {"device_time": "not measured (the profiler saw no "
                                    "kernels)", "wall_ms": wall}
    def short(name: str) -> str:
        name = name.replace("(anonymous namespace)::", "")
        return name.removeprefix("void ").split("(")[0][:70]
    res = {"top_ms": [[short(e.key), e.self_device_time_total / 1e3]
                      for e in kern[:top]],
           "busy_ms": busy, "wall_ms": wall,
           "idle_share": max(0.0, 1.0 - busy / wall)}
    cpu_ops = [e for e in avgs
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.self_device_time_total > 0]
    cpu_ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    if ops_top:
        res["top_ops_ms"] = [[e.key, e.self_device_time_total / 1e3, e.count]
                             for e in cpu_ops[:ops_top]]
    if op_sum:
        hit = [e for e in cpu_ops if e.key.startswith(op_sum)]
        res[op_sum + "*"] = {
            "ms": sum(e.self_device_time_total for e in hit) / 1e3,
            "calls": sum(e.count for e in hit),
            "by_op": {e.key: [e.self_device_time_total / 1e3, e.count]
                      for e in hit}}
    for name in (share_of if isinstance(share_of, tuple)
                 else (share_of,) if share_of else ()):
        hit = [e for e in kern if name in e.key]
        ms = sum(e.self_device_time_total for e in hit) / 1e3
        res[name] = {"ms": ms, "launches": sum(e.count for e in hit),
                     "share_of_busy": ms / busy}
    return out, res


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """(ms, "operations" | "bytes"): the larger of the operations over
    ``peak`` and the bytes over HBM bandwidth."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def counted_run(cell: str, fn, *state, ms: float) -> None:
    """One untimed run of ``fn`` on the card under the dry run's counter
    (``roofline.trace.Counter``, its per-op callback outside every timed
    window), holding ``state`` (what the step takes) live from the start,
    stored in ``COUNTED[cell]`` for the dryrun phase with the card's own
    peak on the same footing: ``max_memory_allocated`` over the run less
    what was allocated before it, plus the state's bytes. ``ms``: the
    cell's timed p50 in its phase."""
    from repro_torch.roofline.trace import Counter
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with Counter() as c:
        held = c.track(*state)
        fn()
        torch.cuda.synchronize()
    COUNTED[cell] = dict(c.summary(), ms=ms, state_bytes=held,
                         card_peak_bytes=torch.cuda.max_memory_allocated()
                         - before + held,
                         counted_run_s=time.perf_counter() - t0)


def engine_tensors(ex) -> list:
    """The tensors an engine holds (the dry run's probes hold the same)."""
    from repro_torch.launch.dryrun import _engine_tensors
    return _engine_tensors({"exec": ex})


def agree_up_to_ties(sa, ia, sb, ib, atol: float) -> bool:
    """Scores within atol position by position; every id whose score clears
    the row's k-th score by more than atol is on both sides."""
    sa, sb = np.asarray(sa, np.float64), np.asarray(sb, np.float64)
    fa, fb = np.isfinite(sa), np.isfinite(sb)
    if not (fa == fb).all() or np.abs(np.where(fa, sa - sb, 0)).max() > atol:
        return False
    for ra, rb, xa, xb in zip(ia, ib, sa, sb):
        kth = np.min(np.where(np.isfinite(xa), xa, np.inf))
        sure_a = {int(i) for i, s in zip(ra, xa) if s > kth + atol}
        sure_b = {int(i) for i, s in zip(rb, xb) if s > kth + atol}
        if not sure_a <= set(map(int, rb)) or not sure_b <= set(map(int, ra)):
            return False
    return True


def smi_lines() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()


def smi_line() -> str:
    """The first card's name and power limit."""
    return smi_lines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script measures the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(smi, flush=True)
    line("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi)


def _ptxas_report(log: str, entry_re: str):
    """One "<instantiation>: <registers> regs, <static smem> B smem, <spill
    line>" per kernel."""
    out, entry, spills = [], "", ""
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            m = re.search(entry_re, ln)
            entry = ("/".join(g for g in m.groups() if g) if m
                     else ln.strip())
        elif "spill" in ln:
            spills = ln.strip()
        elif "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{entry}: {regs.group(1) if regs else '?'} regs, "
                       f"{smem.group(1) if smem else 0} B smem, {spills}")
    return out


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.ivf_topk import ops
    from repro_torch.kernels.segment_reduce import ops as sops
    t0 = time.perf_counter()
    # one nvcc per source, started together
    with ThreadPoolExecutor(max_workers=3) as pool:
        for f in [pool.submit(ops._lib), pool.submit(dops._lib),
                  pool.submit(sops._lib)]:
            f.result()
    secs, log = _build.build_log["ivf_topk"]
    dsecs, dlog = _build.build_log["decode_attention"]
    ssecs, slog = _build.build_log["segment_reduce"]
    # scans: "<chunk reduced in registers>" (1, 2, 4, 8, 16, 32; 0: through
    # shared memory; the probe path runs 16, the delta 1);
    # decode: "<dtype>/<hd>/<G>" (phi4-mini's tick runs bfloat16/128/3)
    ptxas = _ptxas_report(log, r"scan_mma_kernelILi(\d+)E")
    dptxas = _ptxas_report(
        dlog, r"decode_kernelI(?:13__nv_)?(f|bfloat16)Li(\d+)ELi(\d+)E")
    # segment sums: "<sum|accumulate>[/_team]/<dtype>/<elements per lane
    # load>[/<vectors a lane>]/<perm>" (the EGNN layers' sums run
    # sum/f/4/1/0)
    sptxas = _ptxas_report(
        slog, r"segment_(sum|accumulate)_kernel(_team)?I(?:13__nv_)?"
              r"(f|bfloat16)Li(\d+)E(?:Li(\d+)E)?Lb(\d)E")
    line("build", nvcc_s={"ivf_topk": secs, "decode_attention": dsecs,
                          "segment_reduce": ssecs},
         load_s=time.perf_counter() - t0, arch="sm_90a", ptxas=ptxas,
         ptxas_decode=dptxas, ptxas_segment=sptxas,
         ptxas_decode_tick=[e for e in dptxas
                            if e.startswith("bfloat16/128/3:")])


def quantized_slab(rows: int, gen: torch.Generator):
    from repro_torch.core.quantization import quantize
    data = torch.empty((rows, DIM), dtype=torch.int8, device="cuda")
    vmin = torch.empty((rows,), device="cuda")
    scale = torch.empty((rows,), device="cuda")
    step = 1 << 20
    for s in range(0, rows, step):
        v = torch.randn((min(step, rows - s), DIM), device="cuda", generator=gen)
        v /= v.norm(dim=1, keepdim=True)
        qv = quantize(v, 8)
        data[s:s + len(v)], vmin[s:s + len(v)] = qv.data, qv.vmin[:, 0]
        scale[s:s + len(v)] = qv.scale[:, 0]
    return data, vmin, scale


def _flush_and_queries(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flush_buf = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    q = torch.randn((BATCH, DIM), device="cuda", generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    return gen, flush_buf.zero_, q          # zero_: 256 MB > the 50 MB L2


SCAN_ROUTE = ("cuda: mma.sync.m16n8k32 s8 x s8 -> s32 (ldmatrix), rows by "
              "TMA bulk copy, query limbs by cp.async")


def scan_bounds(q_rows: float, d: int, nbytes: float):
    """The scans' bounds for q_rows (query, row) scores of width d: the
    int8 tensor-core operations of the L limb passes (the kernels' work)
    and, beside it, the fp32 figure of earlier runs (one pass on CUDA
    cores)."""
    from repro_torch.kernels.ivf_topk import ops
    bms, bby = bound(2.0 * ops.N_LIMBS * q_rows * d, nbytes, PEAK_INT8_TC_OPS)
    fp32_ms, fp32_by = bound(2.0 * q_rows * d, nbytes)
    return bms, bby, fp32_ms, fp32_by


def batch_independent(scan, args, sel) -> bool:
    """The rows ``sel`` of a batch's outputs have the bits of the same
    queries scanned alone (args[0], args[1] are queries and qsum; args[6]
    the probes, when there are)."""
    big = scan(*args)
    small_args = list(args)
    for i in (0, 1) + ((6,) if len(args) > 7 else ()):
        small_args[i] = args[i][sel].contiguous()
    small = scan(*small_args)
    torch.cuda.synchronize()
    return all(torch.equal(b[sel], s_) for b, s_ in zip(big, small))


def grouped_matmul_ms(slab, vmin, scale, probes, q, k_parts: int, cap: int,
                      flush):
    """(ms, width): the probe scan's library yardstick, the same dot
    products as one batched torch.matmul over the already-dequantized fp32
    slab (K, cap, d), queries grouped by probed partition (padded to the
    most-probed one, ``width``); dequantization not timed."""
    deq = ((slab.to(torch.float32) + 128.0) * scale[:, None]
           + vmin[:, None]).reshape(k_parts, cap, -1)
    hits = torch.bincount(probes.flatten().long(), minlength=k_parts)
    width = int(hits.max())
    qg = torch.zeros((k_parts, width, q.shape[1]), device="cuda")
    for p in range(k_parts):
        who = torch.nonzero((probes == p).any(dim=1)).flatten()
        qg[p, :len(who)] = q[who]
    deq_t = deq.transpose(1, 2)
    return cuda_ms(lambda: torch.matmul(qg, deq_t), 10, flush), width


def measure_probe() -> dict:
    """ivf_probe_scan against its plain version at serve_1m: Q=256, d=384,
    K=64, cap=32,769, n_probe=8, on a seeded slab of that shape; the same
    with skewed probes (all queries on 8 hot partitions); 8 queries alone
    against the batch (bitwise); 16 queries against the limb emulation
    (bitwise)."""
    from repro_torch.kernels.ivf_topk import ops, ref
    gen, flush, q = _flush_and_queries(0)
    k_parts, cap, n_probe, chunk = 64, 32_769, 8, 16
    slab, vmin, scale = quantized_slab(k_parts * cap, gen)
    qsum = q.sum(dim=1)
    aff = 128.0 * scale + vmin
    live = torch.rand((k_parts * cap,), device="cuda", generator=gen) > 0.1
    bias = torch.where(live, 0.0, ref.NEG).to(torch.float32)
    probes = torch.argsort(torch.rand((BATCH, k_parts), device="cuda",
                                      generator=gen), dim=1)[:, :n_probe]
    probes = probes.to(torch.int32).contiguous()
    hot = torch.argsort(torch.rand((BATCH, n_probe), device="cuda",
                                   generator=gen), dim=1)
    skewed = (hot * 5 + 3).to(torch.int32).contiguous()   # partitions 3..38
    checks = {}
    for name, pr in (("uniform", probes), ("skewed", skewed)):
        args = (q, qsum, slab, aff, scale, bias, pr, cap, chunk)
        km, ka = ops.probe_scan(*args)
        pm, pa = ref.probe_scan(*args)
        torch.cuda.synchronize()
        err = float((km - pm).abs().max())
        arg_eq = float((ka == pa).float().mean())
        check(err <= SCORE_ATOL, f"probe_scan ({name} probes) max |d score| "
                                 f"{err} > {SCORE_ATOL}")
        check(arg_eq >= 0.999, f"probe_scan ({name} probes) argmax agreement "
                               f"{arg_eq}")
        checks[name] = dict(max_abs_err=err, argmax_agreement=arg_eq)
        del pm, pa
    args = (q, qsum, slab, aff, scale, bias, probes, cap, chunk)
    sel = torch.arange(100, 108, device="cuda")
    check(batch_independent(ops.probe_scan, args, sel),
          "probe_scan: 8 queries alone differ from the batch in their bits")
    few = torch.arange(16, device="cuda")
    km, ka = ops.probe_scan(q[few].contiguous(), qsum[few].contiguous(), slab,
                            aff, scale, bias, probes[few].contiguous(), cap,
                            chunk)
    limbs, qstep = ops.query_limbs(q[few].contiguous())
    em, ea = ref.probe_scan_limbs(limbs, qstep, qsum[few], slab, aff, scale,
                                  bias, probes[few], cap, chunk)
    torch.cuda.synchronize()
    check(torch.equal(km, em) and torch.equal(ka, ea),
          "probe_scan differs from its limb emulation")
    m = n_probe * cap
    nchp = -(-cap // chunk)
    distinct = int(torch.unique(probes).numel())
    nbytes = (distinct * cap * (DIM + 12) + BATCH * DIM * 4 + BATCH * 4
              + BATCH * n_probe * 4 + 2 * BATCH * n_probe * nchp * 4)
    bms, bby, fp32_ms, fp32_by = scan_bounds(BATCH * m, DIM, nbytes)
    kms = cuda_ms(lambda: ops.probe_scan(*args), 20, flush)
    skewed_ms = cuda_ms(lambda: ops.probe_scan(
        q, qsum, slab, aff, scale, bias, skewed, cap, chunk), 20, flush)
    pms = cuda_ms(lambda: ref.probe_scan(*args), 2, flush)
    lms, width = grouped_matmul_ms(slab, vmin, scale, probes, q, k_parts,
                                   cap, flush)
    err = max(c["max_abs_err"] for c in checks.values())
    line("kernel.probe_scan", shape=dict(Q=BATCH, d=DIM, K=k_parts, cap=cap,
                                         n_probe=n_probe, chunk=chunk),
         route=SCAN_ROUTE, limbs=ops.N_LIMBS,
         checks=checks,
         batch_independent_bitwise=True, limb_emulation_bitwise=True,
         ms=kms, skewed_ms=skewed_ms, plain_ms=pms,
         library_ms=lms, library="torch.matmul (K,%d,d)x(K,d,cap) fp32, "
         "dequantized slab, queries grouped by partition" % width,
         bound_ms=bms, bound_by=bby, bound_fp32_ms=fp32_ms,
         bound_fp32_by=fp32_by, share_of_bound=bms / kms,
         gop_int8=2.0 * ops.N_LIMBS * BATCH * m * DIM / 1e9,
         gbytes=nbytes / 1e9, distinct_probed=distinct)
    return dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                bound_by=bby, max_abs_err=err)


def measure_shared(n: int, live_frac: float) -> dict:
    """ivf_shared_scan against its plain version: the delta scan, Q=256,
    N=n rows (live_frac of them live), d=384, chunk=1 (row indices
    equal); 8 queries alone against the batch and 16 against the limb
    emulation (bitwise)."""
    from repro_torch.kernels.ivf_topk import ops, ref
    gen, flush, q = _flush_and_queries(1)
    qsum = q.sum(dim=1)
    data, vmin, scale = quantized_slab(n, gen)
    aff = 128.0 * scale + vmin
    live = torch.rand((n,), device="cuda", generator=gen) < live_frac
    bias = torch.where(live, 0.0, ref.NEG).to(torch.float32)
    args = (q, qsum, data, aff, scale, bias, 1)
    km, ka = ops.shared_scan(*args)
    pm, pa = ref.shared_scan(*args)
    torch.cuda.synchronize()
    err = float((km - pm).abs().max())
    check(err <= SCORE_ATOL, f"shared_scan max |d score| {err} > {SCORE_ATOL}")
    check(bool((ka == pa).all()), "shared_scan row indices differ (chunk=1)")
    sel = torch.arange(40, 48, device="cuda")
    check(batch_independent(ops.shared_scan, args, sel),
          "shared_scan: 8 queries alone differ from the batch in their bits")
    few = torch.arange(16, device="cuda")
    km, ka = ops.shared_scan(q[few].contiguous(), qsum[few].contiguous(),
                             data, aff, scale, bias, 1)
    limbs, qstep = ops.query_limbs(q[few].contiguous())
    em, ea = ref.shared_scan_limbs(limbs, qstep, qsum[few], data, aff, scale,
                                   bias, 1)
    torch.cuda.synchronize()
    check(torch.equal(km, em) and torch.equal(ka, ea),
          "shared_scan differs from its limb emulation")
    nbytes = (n * (DIM + 12) + BATCH * DIM * 4 + BATCH * 4
              + 2 * BATCH * n * 4)
    bms, bby, fp32_ms, fp32_by = scan_bounds(BATCH * n, DIM, nbytes)
    kms = cuda_ms(lambda: ops.shared_scan(*args), 50, flush)
    pms = cuda_ms(lambda: ref.shared_scan(*args), 20, flush)
    deq_t = ((data.to(torch.float32) + 128.0) * scale[:, None] + vmin[:, None]).T
    lms = cuda_ms(lambda: torch.matmul(q, deq_t), 50, flush)
    line("kernel.shared_scan", shape=dict(Q=BATCH, N=n, d=DIM, chunk=1),
         live_frac=live_frac, route=SCAN_ROUTE, limbs=ops.N_LIMBS,
         max_abs_err=err,
         batch_independent_bitwise=True, limb_emulation_bitwise=True,
         ms=kms, plain_ms=pms, library_ms=lms,
         library="torch.matmul (Q,d)x(d,N) fp32, dequantized rows",
         bound_ms=bms, bound_by=bby, bound_fp32_ms=fp32_ms,
         bound_fp32_by=fp32_by, share_of_bound=bms / kms,
         gop_int8=2.0 * ops.N_LIMBS * BATCH * n * DIM / 1e9,
         gbytes=nbytes / 1e9)
    return dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                bound_by=bby, max_abs_err=err)


def cpu_copy(index):
    """The same index rebuilt on the CPU through state_tree/restore_state
    (the scan kernels' plain versions run there)."""
    from repro_torch.core.index import HMGIIndex
    tree, meta = index.state_tree()
    cpu = HMGIIndex(index.cfg, seed=index.seed, device="cpu")
    cpu.restore_state(tree, meta)
    return cpu


def phase_vector():
    from repro_torch.configs import get_config
    from repro_torch.core.index import HMGIIndex
    from repro_torch.data.synthetic import make_corpus
    t0 = time.perf_counter()
    # no graph in this phase: zero edge rates keep make_corpus's edge list
    # at one edge per node
    c = make_corpus(n_nodes=VEC_N, modality_dims={"text": DIM},
                    intra_p=0.0, inter_p=0.0, seed=0)
    rng = np.random.default_rng(1)
    attr = rng.integers(0, 10, VEC_N)
    data_s = time.perf_counter() - t0
    cfg = get_config("hmgi")
    index = HMGIIndex(cfg, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index.ingest({"text": (c.node_ids["text"], c.vectors["text"])}, VEC_N,
                 node_attrs={"a": attr})
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    split = index.metrics()["ingest_seconds"]
    # build overflow (rows past a partition's capacity) lands in the delta,
    # which grows to hold it: every search then scans this many delta rows
    d0 = index.modalities["text"].delta
    delta_rows, delta_cap = int(d0.count), int(d0.ids.shape[0])

    rows = rng.choice(VEC_N, BATCH, replace=False)
    queries = c.vectors["text"][rows] + 0.05 * rng.normal(
        size=(BATCH, DIM)).astype(np.float32)
    sv, si = index.search(queries, "text")
    check(tuple(sv.shape) == (BATCH, 10) and bool(torch.isfinite(sv).all()),
          "search: scores not finite (256, 10)")
    # exact top-10 on the card, over the ingested (normalised) vectors
    m = index.modalities["text"]
    qn = index._norm_queries(queries)
    exact = torch.topk(qn @ m.vectors.T, 10, dim=1).indices
    true_ids = m.ids[exact].cpu().numpy()
    got = si.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / 10
                            for a, b in zip(got, true_ids)]))
    top1 = float(np.mean(got[:, 0] == true_ids[:, 0]))
    p50, p99 = host_ms(lambda: index.search(queries, "text"), 20)
    prof = profile_window(lambda: index.search(queries, "text"), top=12)

    filt = {}
    for name, where, ok in (("sel0.1", ("a", "==", 3), lambda v: v == 3),
                            ("sel0.9", ("a", "!=", 3), lambda v: v != 3)):
        fv, fi = index.search(queries, "text", where=where)
        fi = fi.cpu().numpy()
        check(bool((fi >= 0).all()) and bool(ok(attr[fi]).all()),
              f"filtered search {name}: a result fails its predicate")
        fp50, fp99 = host_ms(lambda: index.search(queries, "text", where=where), 10)
        filt[name] = dict(mode=index.metrics()["filter_mode"], p50_ms=fp50,
                          p99_ms=fp99)

    # 16 queries on a CPU copy of the index (plain versions of the kernels)
    cpu = cpu_copy(index)
    cv, ci = cpu.search(queries[:16], "text")
    check(agree_up_to_ties(sv[:16].cpu(), si[:16].cpu(), cv, ci, SCORE_ATOL),
          "search on the card disagrees with the CPU copy")
    del cpu

    # update 256 existing ids (delta kernel with live rows), then delete 16
    upd_ids = c.node_ids["text"][rng.choice(VEC_N, BATCH, replace=False)]
    new = rng.normal(size=(BATCH, DIM)).astype(np.float32)
    index.insert("text", upd_ids, new)
    uv, ui = index.search(new, "text")
    check(bool((ui[:, 0].cpu().numpy() == upd_ids).all()),
          "updated rows are not at rank 1")
    index.delete("text", upd_ids[:16])
    dv, di = index.search(new[:16], "text")
    check(not np.isin(di.cpu().numpy(), upd_ids[:16]).any(),
          "deleted ids still returned")
    peak = torch.cuda.max_memory_allocated()
    line("vector", n=VEC_N, d=DIM, batch=BATCH, K=cfg.n_partitions,
         n_probe=cfg.n_probe, data_s=data_s, ingest_s=ingest_s,
         ingest_split_s=split, delta_rows_after_ingest=delta_rows,
         delta_capacity=delta_cap, recall_at_10=recall, top1_self=top1,
         search_p50_ms=p50, search_p99_ms=p99, filtered=filt,
         update_rank1=True, delete_gone=True, peak_mem_gib=peak / 2 ** 30,
         search_profile=prof)
    return index, c, delta_cap, delta_rows / delta_cap


def full_probe(index, q):
    """Every partition probed: the search's answer does not depend on the
    routing, so a byte-identical row move leaves its bytes unchanged."""
    sv, si = index.search(q, "text", n_probe=MAINT_FULL_PROBE)
    return sv.cpu(), si.cpu()


def same_bytes(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def visible_ids(m) -> torch.Tensor:
    """Every id the modality serves: slab rows not hidden by a tombstone or
    a superseded bit, and the delta's live rows."""
    from repro_torch.core import delta as delta_mod
    d = m.delta
    sids = m.ivf.ids.reshape(-1)
    sids = sids[sids >= 0]
    sids = sids[~(d.tombstones | d.superseded)[sids.long()]]
    live = torch.as_tensor(delta_mod.live_slots(d), device=d.ids.device)
    return torch.cat([sids, d.ids[live]])


def _merge_notes(trail: str):
    """(partition, sibling, moved, purged, overflow) of each merge in a
    maintenance trail."""
    return [tuple(map(int, g)) for g in re.findall(
        r"merge_cold\[p=(\d+) -> p=(\d+): moved (\d+), purged (\d+) dead, "
        r"(\d+) to delta\]", trail)]


def phase_maint(index, corpus):
    """Adaptive maintenance on the phase-4 index (serve_1m, the default
    config: maint_auto on), driving each action kind at that size:
    recluster (rows written off one centroid), merge_cold + split_hot
    (a skewed probe load on a full partition, then maintain), merge_cold
    (90% of the emptiest partition deleted), split_hot again through
    maybe_repartition, and drains (update batches of 256 past the delta's
    compaction watermark). Holds the moves to their contract (full-probe
    bytes unchanged by a merge without overflow, a split and a recluster;
    the card against a CPU copy after each pass; every write found, no
    delete back, no write dropped), then times one full compact() on the
    same index as the stop-the-world baseline."""
    from repro_torch import obs
    from repro_torch.core import delta as delta_mod
    from repro_torch.core import ivf as ivf_mod
    from repro_torch.core import partitioner
    from repro_torch.core.index import HMGIIndex
    m = index.modalities["text"]
    cfg = index.cfg
    k_parts, cap = m.ivf.n_partitions, m.ivf.capacity
    vecs = corpus.vectors["text"]
    rng = np.random.default_rng(21)
    obs.reset()
    q16 = (vecs[rng.choice(VEC_N, 16, replace=False)]
           + 0.05 * rng.normal(size=(16, DIM))).astype(np.float32)
    q256 = (vecs[rng.choice(VEC_N, BATCH, replace=False)]
            + 0.05 * rng.normal(size=(BATCH, DIM))).astype(np.float32)
    delta_live0 = int(delta_mod.live_slots(m.delta).size)
    delta_cap0 = int(m.delta.ids.shape[0])
    search_before = host_ms(lambda: index.search(q256, "text"), 10)
    maint_ms, insert_ms, trail, bytes_ok = {}, [], [], {}
    # ids deleted before the phase stay deleted: writes go to the others
    written = {}
    deleted = set(torch.nonzero(m.delta.tombstones).flatten().tolist())

    def maintain(**kw):
        t0 = time.perf_counter()
        rep = index.maintain("text", **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for kind in {a.kind for a, _ in rep.actions}:
            maint_ms.setdefault(kind, []).append(ms)
        trail.append(rep.describe())
        return rep

    def upsert(ids, rows):
        t0 = time.perf_counter()
        index.insert("text", ids, rows)
        torch.cuda.synchronize()
        insert_ms.append((time.perf_counter() - t0) * 1e3)
        for i, r in zip(ids, rows):
            written[int(i)] = r
        deleted.difference_update(int(i) for i in ids)

    def agree_cpu(tag):
        cpu = cpu_copy(index)
        gv, gi = index.search(q16, "text")
        cv, ci = cpu.search(q16, "text")
        check(agree_up_to_ties(gv.cpu(), gi.cpu(), cv, ci, SCORE_ATOL),
              f"maint {tag}: the card disagrees with the CPU copy")
        del cpu

    def skew_on(part):
        """Probe load on one partition: its own stored rows as queries at
        n_probe 1 (so its neighbours gain no hits), until it is the
        hottest live partition and its hits pass the planner's imbalance
        threshold by a quarter."""
        rows = torch.nonzero(m.ivf.ids[part] >= 0).flatten()[:BATCH]
        hq = ivf_mod._dequant_rows(*((m.ivf,) + ivf_mod.gather_slots(
            m.ivf, part * cap + rows)[:3]))
        for _ in range(200):
            hits = m.workload.hits_snapshot()
            if (hits[part] > 1.25 * cfg.maint_heat_imbalance * hits.mean()
                    and int(np.argmax(np.where(m.stats.parked, -1, hits)))
                    == part):
                return
            index.search(hq, "text", n_probe=1)
        fail(f"maint: the probe load on p={part} never passed the "
             "imbalance threshold")

    # (1) recluster: 256 updates with rows that land far off one centroid
    gen = torch.Generator(device="cuda").manual_seed(22)
    cand = torch.randn((1 << 16, DIM), device="cuda", generator=gen)
    cand /= cand.norm(dim=1, keepdim=True)
    a = partitioner.assign(cand, m.ivf.centroids).long()
    off = int(torch.bincount(a, minlength=k_parts).argmax())
    alive = np.setdiff1d(np.arange(VEC_N), np.fromiter(deleted, np.int64))
    upsert(rng.choice(alive, BATCH, replace=False).astype(np.int32),
           cand[a == off][:BATCH].cpu().numpy())
    # the drift signal those writes left: the mean assigned distance of
    # the writes against the members' at build. A unit row lies at most
    # 1 + |c| from a centroid c whose members average sqrt(1 - |c|^2), so
    # no write can reach the planner's threshold when
    # sqrt((1 + |c|) / (1 - |c|)) < 1 + threshold (``reachable_drift``).
    # When the writes fall short, the phase raises the partition's
    # recorded drift past it, as the reference's own recluster test does,
    # and the recluster runs as planned
    st = m.stats
    drift_off = float(st.drift_ratio()[off])
    c_norm = float(m.ivf.centroids[off].norm())
    reach = float(np.sqrt((1 + c_norm) / (1 - c_norm)) - 1)
    trigger = "writes"
    if drift_off < cfg.maint_drift_threshold:
        st.drift_sum[off] = (st.drift_cnt[off] * st.baseline[off]
                             * (1 + 2 * cfg.maint_drift_threshold))
        trigger = "recorded drift raised past the threshold"
    before = full_probe(index, q16)
    rep = maintain()
    check(any(a.kind == "recluster" for a, _ in rep.actions),
          f"maint: no recluster planned after off-centroid writes: "
          f"{rep.describe()}")
    bytes_ok["recluster"] = same_bytes(before, full_probe(index, q16))
    check(bytes_ok["recluster"], "maint: a recluster changed full-probe bytes")
    agree_cpu("recluster")

    # (2) merge_cold + split_hot by maintain: a skewed probe load on the
    # full partition that holds most of the delta's oldest live rows
    live = torch.as_tensor(delta_mod.live_slots(m.delta)[:BATCH],
                           device="cuda")
    hot = int(torch.bincount(partitioner.assign(
        m.delta.vectors[live], m.ivf.centroids).long(),
        minlength=k_parts).argmax())
    hot_fill = int(m.ivf.counts[hot]) / cap
    check(hot_fill >= cfg.maint_split_min_fill,
          f"maint: p={hot} is {hot_fill:.2f} full")
    before = full_probe(index, q16)      # (a search records heat too)
    skew_on(hot)
    for _ in range(4):
        rep = maintain()
        if any(a.kind == "split_hot" for a, _ in rep.actions):
            break
    check(any(a.kind == "split_hot" for a, _ in rep.actions),
          f"maint: no split of p={hot}: {trail[-3:]}")
    split_merges = _merge_notes(" ".join(trail))
    after = full_probe(index, q16)
    bytes_ok["split"] = same_bytes(before, after)
    overflow = sum(n[4] for n in split_merges)
    check(bytes_ok["split"] or overflow > 0,
          "maint: a split (and its enabling merge, no overflow) changed "
          "full-probe bytes")
    if not bytes_ok["split"]:
        # rows the enabling merge sent to the delta are scored in fp32 now
        check(agree_up_to_ties(*before, *after, 0.02),
              "maint: full-probe results moved beyond one int8 step")
    agree_cpu("split")

    # (3) merge_cold by deletes: 90% of the emptiest live partition, held
    # against a twin of the index without maintenance
    counts = m.ivf.counts.cpu().numpy()
    e = int(np.argmin(np.where(m.stats.parked, np.iinfo(np.int64).max,
                               counts)))
    e_ids = m.ivf.ids[e]
    e_ids = e_ids[e_ids >= 0]
    e_ids = e_ids[~(m.delta.tombstones | m.delta.superseded)[e_ids.long()]]
    e_ids = e_ids.cpu().numpy()
    del_ids = e_ids[: -(-9 * e_ids.size // 10)]
    twin = HMGIIndex(cfg.replace(maint_auto=False), seed=index.seed)
    twin.restore_state(*index.state_tree())
    twin.delete("text", del_ids)
    before = full_probe(twin, q16)
    del twin
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    index.delete("text", del_ids)
    torch.cuda.synchronize()
    delete_ms = (time.perf_counter() - t0) * 1e3
    deleted.update(int(i) for i in del_ids)
    for i in del_ids:
        written.pop(int(i), None)
    merges = [n for n in _merge_notes(index.metrics()["maintenance"])
              if n[0] == e]
    check(len(merges) == 1 and bool(m.stats.parked[e]),
          f"maint: deleting 90% of p={e} did not merge it: "
          f"{index.metrics()['maintenance']}")
    trail.append(index.metrics()["maintenance"])
    after = full_probe(index, q16)
    bytes_ok["merge"] = same_bytes(before, after)
    check(bytes_ok["merge"] or merges[0][4] > 0,
          "maint: a merge without overflow changed full-probe bytes")
    agree_cpu("merge")

    # (4) split_hot by maybe_repartition, on the fullest live partition
    counts = m.ivf.counts.cpu().numpy()
    hot2 = int(np.argmax(np.where(m.stats.parked, -1, counts)))
    before = full_probe(index, q16)
    skew_on(hot2)
    split_done, split_prof = profile_once(
        lambda: index.maybe_repartition("text"), top=8)
    check(split_done, f"maint: maybe_repartition did not split p={hot2}")
    bytes_ok["repartition"] = same_bytes(before, full_probe(index, q16))
    check(bytes_ok["repartition"],
          "maint: maybe_repartition changed full-probe bytes")
    agree_cpu("repartition")

    # (5) drains: update batches of 256 until the delta reaches its
    # compaction watermark, then a few more (each insert then maintains)
    alive = np.setdiff1d(np.arange(VEC_N), np.fromiter(deleted, np.int64))
    crossed, extra = None, 0
    for b in range(64):
        ids = rng.choice(alive, BATCH, replace=False).astype(np.int32)
        src = rng.choice(VEC_N, BATCH, replace=False)
        upsert(ids, (vecs[src] + 0.05 * rng.normal(size=(BATCH, DIM))
                     ).astype(np.float32))
        # past the watermark the insert maintains on its own (drains)
        if crossed is None and obs.counter(
                "maintenance.actions.compact_chunk").value:
            crossed = b + 1
        extra += crossed is not None
        if extra >= 4:
            break
    check(crossed is not None, "maint: the delta never reached its "
                               "compaction watermark")
    # the insert path's hook: passes that must free a chunk of delta slots
    for _ in range(3):
        maintain(need_rows=cfg.maint_chunk)
    agree_cpu("drain")
    counters = {k: v for k, v in obs.registry().to_dict()
                .get("counters", {}).items() if k.startswith("maintenance")}
    for kind in ("compact_chunk", "merge_cold", "split_hot", "recluster"):
        check(counters.get(f"maintenance.actions.{kind}", 0) >= 1,
              f"maint: no {kind} was applied ({counters})")
    drained = sum(int(n) for n in re.findall(r"drained (\d+) rows",
                                             " ".join(trail[-3:])))

    # every write found at rank 1 at full probe (a drained update whose
    # assigned partition is full keeps its old slot: at the default probe
    # finding it is a recall matter, counted), no delete back, no write
    # dropped
    w_ids = np.fromiter(written, np.int64)
    w_vecs = np.stack([written[int(i)] for i in w_ids])
    rank1_default = 0
    for s in range(0, w_ids.size, BATCH):
        want = w_ids[s:s + BATCH]
        _, got = index.search(w_vecs[s:s + BATCH], "text", k=1,
                              n_probe=MAINT_FULL_PROBE)
        miss = np.nonzero(got[:, 0].cpu().numpy() != want)[0]
        check(miss.size == 0, f"maint: written ids {want[miss[:5]]} are "
                              "not at rank 1 for their own vectors")
        _, got = index.search(w_vecs[s:s + BATCH], "text", k=1)
        rank1_default += int((got[:, 0].cpu().numpy() == want).sum())
    d_ids = np.fromiter(deleted, np.int64)
    for s in range(0, d_ids.size, BATCH):
        _, got = index.search(vecs[d_ids[s:s + BATCH]], "text")
        check(not np.isin(got.cpu().numpy(), d_ids).any(),
              "maint: a deleted id came back")
    vis = visible_ids(m)
    want = torch.as_tensor(alive, device="cuda")
    check(vis.numel() == want.numel() and torch.equal(
        torch.sort(vis.long()).values, want),
          f"maint: {vis.numel()} visible rows for {want.numel()} live ids")
    delta_live1 = int(delta_mod.live_slots(m.delta).size)
    delta_cap1 = int(m.delta.ids.shape[0])
    search_after = host_ms(lambda: index.search(q256, "text"), 10)
    hist = obs.registry().histograms()["index.maintain"]

    # the stop-the-world baseline: one full compaction of the same index
    t0 = time.perf_counter()
    index.compact("text")
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    search_compacted = host_ms(lambda: index.search(q256, "text"), 10)
    line("maint", n=VEC_N, K=k_parts, cap=cap, batch=BATCH,
         maintain_ms={k: dict(p50=float(np.percentile(v, 50)),
                              p99=float(np.percentile(v, 99)), n=len(v))
                      for k, v in maint_ms.items()},
         maintain_span_ms=dict(p50=hist.percentile(50),
                               p99=hist.percentile(99), n=hist.count),
         insert_batch_ms=dict(p50=float(np.percentile(insert_ms, 50)),
                              p99=float(np.percentile(insert_ms, 99)),
                              n=len(insert_ms)),
         recluster=dict(partition=off, write_drift=drift_off,
                        centroid_norm=c_norm, reachable_drift=reach,
                        threshold=cfg.maint_drift_threshold,
                        trigger=trigger),
         watermark_crossed_after_batches=crossed, delete_ms=delete_ms,
         repartition_profile=split_prof, counters=counters,
         rows_drained_by_forced_passes=drained,
         split_partitions=[hot, hot2],
         hot_fill=hot_fill, merged_partition=e, deleted=int(d_ids.size),
         written=int(w_ids.size),
         written_rank1_at_default_probe=rank1_default / w_ids.size,
         full_probe_bytes_unchanged=bytes_ok,
         merge_overflow=[n[4] for n in split_merges + merges],
         delta_live=dict(before=delta_live0, after=delta_live1,
                         after_compact=int(delta_mod.live_slots(
                             m.delta).size)),
         delta_capacity=dict(before=delta_cap0, after=delta_cap1),
         compact_s=compact_s,
         search_p50_ms=dict(before=search_before[0],
                            after=search_after[0],
                            after_compact=search_compacted[0]),
         search_p99_ms=dict(before=search_before[1],
                            after=search_after[1],
                            after_compact=search_compacted[1]),
         cpu_copy_agrees=True, writes_found=True, deletes_gone=True,
         no_write_dropped=True, trail=[t[:300] for t in trail[-6:]])


# ---------------------------------------------------------------------------
# sharded: the row-sharded stable scan at serve_1m, S shards on one card
# ---------------------------------------------------------------------------

def mesh_of(n: int, devices=None):
    """A 1-d ("data",) mesh of n shards, all on cuda:0 unless given."""
    from repro_torch.sharding import Mesh
    return Mesh(devices or ["cuda:0"] * n, ("data",))


def remesh(index, mesh) -> None:
    """Points a facade at another mesh and drops its replica (it is placed
    for the old mesh's devices)."""
    index.mesh = mesh
    index._drop_sharded(index.modalities["text"])


def tie_moves(got, want) -> int:
    """(scores, ids) pairs on one device: -1 unless the scores have the
    same bytes and every id that differs sits on a score that repeats in
    its row (an exact tie, whose order the merge may permute); else the
    number of such positions."""
    (gs, gi), (ws, wi) = got, want
    if not tensor_bytes_equal(gs, ws):
        return -1
    moved = torch.nonzero(gi != wi).tolist()
    for r, j in moved:
        if int((ws[r] == ws[r, j]).sum()) < 2:
            return -1
    return len(moved)


def live_layout(ivf, sharded: bool):
    """(id, partition, row bytes, vmin, scale) of every live slot of a
    single (K, cap) or sharded (S, K, cap_l) layout, sorted by id."""
    ids = ivf.ids
    k = ids.shape[-2]
    part = torch.arange(k, device=ids.device).view(
        (1, k, 1) if sharded else (k, 1)).expand(ids.shape)
    ok = ids >= 0
    order = torch.argsort(ids[ok])
    return [t[ok][order] for t in (ids, part, ivf.data, ivf.vmin, ivf.scale)]


def phase_sharded(index, corpus) -> None:
    """The row-sharded stable scan on the phase-4 index (serve_1m, after
    the maint phase), with no second ingest: its state in a facade over a
    mesh of S shards on this card. Layout (device_layout, explain,
    shard_index at S = 2, 4, 8 timed, the live rows and counts held to the
    single layout), equivalence (search_sharded against search at S = 2,
    4, 8 with n_probe 8 and 64, a predicate and precomputed probes; the
    facade's search, filtered search and query; search_bucketed 8 batched
    against alone; a maintain pass that changes the slab drops the
    replica, the next searches equal again), the probe kernel on each
    shard at cap_l against its plain version (launches not counted), and
    time (p50/p99 at S = 1, 2, 4, 8, span p50s, one profiled S = 4
    search)."""
    from repro_torch import obs
    from repro_torch.common.reduce import row_sum
    from repro_torch.core import ivf as ivf_mod
    from repro_torch.core import partitioner
    from repro_torch.core.cost_model import DeviceLayoutPlan
    from repro_torch.core.index import HMGIIndex
    from repro_torch.kernels.ivf_topk import ops, ref
    from repro_torch.query import Q
    from repro_torch.query.executor import search_bucketed
    phase_t0 = time.perf_counter()
    cfg = index.cfg
    m = index.modalities["text"]
    k_parts, cap = m.ivf.n_partitions, m.ivf.capacity
    vecs = corpus.vectors["text"]
    rng = np.random.default_rng(51)
    q256 = (vecs[rng.choice(VEC_N, BATCH, replace=False)]
            + 0.05 * rng.normal(size=(BATCH, DIM))).astype(np.float32)
    qn = index._norm_queries(q256)
    where = ("a", "==", 3)
    npass = index._node_pass(where)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = HMGIIndex(cfg, mesh=mesh_of(4), seed=index.seed)
    sh.restore_state(*index.state_tree())
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    sm = sh.modalities["text"]

    # (1) layout: the planner's choice under shard_layout="auto"
    slab_bytes = int(m.ivf.data.numel())
    check(cfg.shard_layout == "auto"
          and slab_bytes > cfg.shard_device_budget_bytes
          and sh.device_layout("text") == DeviceLayoutPlan("sharded", 4)
          and index.device_layout("text") == DeviceLayoutPlan("single", 1),
          f"sharded: layouts {sh.device_layout('text')} / "
          f"{index.device_layout('text')} for a {slab_bytes}-byte slab")
    explain = sh.explain(Q.vector("text", q256).topk(10))
    check("layout=sharded(x4)" in explain, f"sharded: explain {explain!r}")
    single_live = live_layout(m.ivf, False)
    relayout = {}
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (m.ivf.data, m.ivf.vmin, m.ivf.scale, m.ivf.ids))
    for n_sh in SHARDS:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lay = ivf_mod.shard_index(m.ivf, n_sh)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        out_bytes = sum(t.numel() * t.element_size() for t in (
            lay.data, lay.vmin, lay.scale, lay.ids, lay.counts))
        got = live_layout(lay, True)
        check(all(tensor_bytes_equal(a, b) for a, b in zip(got, single_live)),
              f"sharded: the S={n_sh} layout's live (id, partition, bytes, "
              "vmin, scale) set differs from the single layout's")
        # builds and compactions pack a partition's rows from slot 0 (a
        # compaction keeps a deleted row's slot as an empty one): where the
        # occupied slots are a prefix, the deal is even to within 1
        occ = m.ivf.ids >= 0
        prefix = occ.sum(1) == (torch.cumprod(occ.int(), 1).sum(1))
        spread = (lay.counts.max(0).values - lay.counts.min(0).values)
        check(bool((spread[prefix] <= 1).all())
              and torch.equal(lay.counts.sum(0), occ.sum(1, dtype=torch.int32)),
              f"sharded: S={n_sh} per-shard live counts (spread "
              f"{spread.tolist()}) against the single layout's")
        relayout[n_sh] = dict(
            ms=ms, gb_per_s=(in_bytes + out_bytes) / ms / 1e6,
            peak_delta_mib=peak / 2 ** 20,
            cap_l=int(lay.ids.shape[2]), pad=int(lay.ids.shape[2]) * n_sh - cap,
            packed_partitions=int(prefix.sum()),
            max_spread=int(spread.max()),
            max_spread_packed=int(spread[prefix].max()))
        del lay, got
    del single_live

    # (2) search_sharded against search, at the ivf level
    eq = {}
    for n_sh in SHARDS:
        mesh = mesh_of(n_sh)
        placed = ivf_mod.shard_placement(mesh)(ivf_mod.shard_index(m.ivf, n_sh))
        for n_probe in (8, 64):
            pr, _ = partitioner.assign_topk(qn, m.ivf.centroids, n_probe)
            for pname, passed in (("all", None), ("sel0.1", npass)):
                for prname, probes in (("probes", pr), ("centroids", None)):
                    want = ivf_mod.search(m.ivf, qn, n_probe=n_probe, k=10,
                                          probes=probes, node_pass=passed)
                    got = ivf_mod.search_sharded(
                        placed, qn, mesh, n_probe=n_probe, k=10,
                        probes=probes, node_pass=passed)
                    moved = tie_moves(got, want)
                    check(moved >= 0, f"sharded: search_sharded S={n_sh} "
                          f"n_probe={n_probe} {pname} {prname} differs from "
                          "search")
                    eq[f"S{n_sh}/p{n_probe}/{pname}/{prname}"] = moved

        if n_sh == 4:
            # each shard's probe kernel at cap_l against its plain version;
            # these launches are the comparison's, not the main path's
            saved = ops.probe_scan.launches
            pr = partitioner.assign_topk(qn, m.ivf.centroids, cfg.n_probe)[0]
            pr = pr.to(torch.int32).contiguous()
            qsum = row_sum(qn)
            per_shard, shard_args = [], None
            for loc in placed:
                data, vmin, scale, ids = loc.slab_view()
                bias = torch.where(ids >= 0, 0.0, ref.NEG).to(torch.float32)
                args = (qn, qsum, data, (128.0 * scale + vmin).contiguous(),
                        scale, bias, pr, loc.capacity, 16)
                km, ka = ops.probe_scan(*args)
                pm, pa = ref.probe_scan(*args)
                torch.cuda.synchronize()
                err = float((km - pm).abs().max())
                agree = float((ka == pa).float().mean())
                check(err <= SCORE_ATOL and agree >= 0.999,
                      f"sharded: a shard's probe kernel at cap_l "
                      f"{loc.capacity} differs from its plain version "
                      f"({err}, {agree})")
                per_shard.append(dict(max_abs_err=err, argmax_agreement=agree))
                shard_args = shard_args or args
                del km, ka, pm, pa
            gen, flush, _ = _flush_and_queries(7)
            cap_l = placed[0].capacity
            nchp = -(-cap_l // 16)
            distinct = int(torch.unique(pr).numel())
            nbytes = (distinct * cap_l * (DIM + 12) + BATCH * DIM * 4
                      + BATCH * 4 + BATCH * cfg.n_probe * 4
                      + 2 * BATCH * cfg.n_probe * nchp * 4)
            bms, bby, fp32_ms, _ = scan_bounds(BATCH * cfg.n_probe * cap_l,
                                               DIM, nbytes)
            data0, vmin0, scale0, _ = placed[0].slab_view()
            lib_ms, lib_width = grouped_matmul_ms(data0, vmin0, scale0, pr,
                                                  qn, k_parts, cap_l, flush)
            shard_kernel = dict(
                shape=dict(Q=BATCH, d=DIM, K=k_parts, cap_l=cap_l,
                           n_probe=cfg.n_probe, chunk=16),
                shards=per_shard,
                ms=cuda_ms(lambda: ops.probe_scan(*shard_args), 20, flush),
                plain_ms=cuda_ms(lambda: ref.probe_scan(*shard_args), 2,
                                 flush),
                library_ms=lib_ms,
                library="torch.matmul (K,%d,d)x(K,d,cap_l) fp32, shard 0's "
                        "dequantized slab, queries grouped by partition"
                        % lib_width,
                bound_ms=bms, bound_by=bby, bound_fp32_ms=fp32_ms,
                gbytes=nbytes / 1e9, distinct_probed=distinct)
            del data0, vmin0, scale0
            ops.probe_scan.launches = saved
            del flush, gen, shard_args
        del placed

    # (3) the facades: S = 4 on the card against the single layout
    fac = {}
    for name, fn in (
            ("search", lambda i: i.search(q256, "text")),
            ("where", lambda i: i.search(q256, "text", where=where)),
            ("query", lambda i: i.query(Q.vector("text", q256)
                                        .where(where).topk(10)))):
        moved = tie_moves(fn(sh), fn(index))
        check(moved >= 0, f"sharded: the mesh facade's {name} differs from "
                          "the single facade's")
        fac[name] = moved
    # (the single facade takes the same calls: the probe heat that plans
    # maintenance stays the same on both)
    bv, bi = search_bucketed(sh, q256[:8], "text", k=10)
    solo = [search_bucketed(sh, q256[i:i + 1], "text", k=10) for i in range(8)]
    search_bucketed(index, q256[:8], "text", k=10)
    for i in range(8):
        search_bucketed(index, q256[i:i + 1], "text", k=10)
    bucket_bytes = all(bv[i].tobytes() == solo[i][0].tobytes()
                       and bi[i].tobytes() == solo[i][1].tobytes()
                       for i in range(8))
    check(bucket_bytes, "sharded: search_bucketed gave 8 queries other bytes "
                        "batched than alone")

    # (4) writes: the same insert batches (256 updates, maint_auto on) on
    # both facades until a maintain pass changes the slab: at the latest
    # once the delta's append watermark reaches the compaction threshold
    dead = m.delta.tombstones[:VEC_N].cpu().numpy()
    alive = np.nonzero(~dead)[0]
    to_watermark = (int(cfg.compact_threshold * m.delta.ids.shape[0])
                    - int(m.delta.count))
    insert_ms, changed_after = [], None
    for b in range(max(to_watermark, 0) // BATCH + 8):
        for idx in (index, sh):         # the same probe heat on both
            idx.search(q256, "text")
        check(sm.ivf_sharded is not None, "sharded: no replica after a search")
        ids = rng.choice(alive, BATCH, replace=False).astype(np.int32)
        rows = (vecs[rng.choice(VEC_N, BATCH, replace=False)]
                + 0.05 * rng.normal(size=(BATCH, DIM))).astype(np.float32)
        index.insert("text", ids, rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sh.insert("text", ids, rows)
        torch.cuda.synchronize()
        insert_ms.append((time.perf_counter() - t0) * 1e3)
        if sm.ivf_sharded is None:
            changed_after = b + 1
            break
    check(changed_after is not None,
          f"sharded: no maintain pass changed the slab in {b + 1} insert "
          "batches")
    check(all(tensor_bytes_equal(getattr(m.ivf, f), getattr(sm.ivf, f))
              for f in ("data", "vmin", "scale", "ids", "centroids")),
          "sharded: the two facades' slabs differ after the same writes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh._ensure_sharded("text", 4)
    torch.cuda.synchronize()
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    for name, kw in (("search", {}), ("where", dict(where=where))):
        check(tie_moves(sh.search(q256, "text", **kw),
                        index.search(q256, "text", **kw)) >= 0,
              f"sharded: {name} differs after the maintain pass")

    # (5) time: S = 1 (the single facade), 2, 4, 8 in turns (the order
    # reversed every round), each mesh with its replica built beforehand
    setups = {}
    for n_sh in SHARDS:
        remesh(sh, mesh_of(n_sh))
        sh.search(q256, "text")
        setups[n_sh] = (sh.mesh, sm.ivf_sharded)

    def at(n_sh):
        sh.mesh, sm.ivf_sharded = setups[n_sh]
        return sh
    runs = {"1": lambda: index.search(q256, "text")}
    runs.update({str(n_sh): (lambda n_sh=n_sh: at(n_sh).search(q256, "text"))
                 for n_sh in SHARDS})
    samples = {name: [] for name in runs}
    for r in range(21):                 # round 0 warms up
        for name in (list(runs) if r % 2 else list(runs)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            if r:
                samples[name].append((time.perf_counter() - t0) * 1e3)
    lat = {name: (float(np.percentile(v, 50)), float(np.percentile(v, 99)))
           for name, v in samples.items()}
    at(4)
    del setups
    base_cfg = sh.cfg
    sh.cfg = base_cfg.replace(obs_sync_spans=True)
    obs.reset()
    for _ in range(20):
        sh.search(q256, "text")
    hist = obs.registry().histograms()
    spans = {n: dict(p50=hist[n].percentile(50), p99=hist[n].percentile(99),
                     n=hist[n].count)
             for n in ("sharded.scan", "sharded.merge", "query.seed_scan")}
    sh.cfg = base_cfg
    before = ops.probe_scan.launches
    prof = profile_window(lambda: sh.search(q256, "text"), top=8,
                          share_of="scan_mma_kernel<16>")
    per_search = (ops.probe_scan.launches - before) / 2   # warm-up + profiled
    check(per_search == 4, f"sharded: {per_search} probe launches a search "
                           "at S = 4")

    # (6) more than one card
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        remesh(sh, mesh_of(n_cards, [f"cuda:{i}" for i in range(n_cards)]))
        check(tie_moves(sh.search(q256, "text"),
                        index.search(q256, "text")) >= 0,
              f"sharded: search over {n_cards} cards differs from single")
        multi = dict(cards=n_cards, equal=True,
                     p50_ms=host_ms(lambda: sh.search(q256, "text"), 20)[0])
    else:
        multi = f"not run: {n_cards} card on this host"
    del sh
    torch.cuda.empty_cache()
    line("sharded", n=VEC_N, d=DIM, batch=BATCH, K=k_parts, cap=cap,
         slab_bytes=slab_bytes, budget_bytes=cfg.shard_device_budget_bytes,
         layout="sharded(x4)", explain=explain, restore_s=restore_s,
         shard_index=relayout, equivalence_tie_moves=eq,
         facade_tie_moves=fac, search_bucketed_8_vs_1_bytes=bucket_bytes,
         maintain_changed_slab_after_batches=changed_after,
         insert_batch_ms=dict(p50=float(np.percentile(insert_ms, 50)),
                              p99=float(np.percentile(insert_ms, 99)),
                              n=len(insert_ms)),
         replica_rebuild=dict(ms=rebuild_ms,
                              gb_per_s=2 * in_bytes / rebuild_ms / 1e6),
         search_ms={s_: dict(p50=v[0], p99=v[1]) for s_, v in lat.items()},
         spans_ms=spans, probe_launches_per_search=per_search,
         search_profile_s4=prof, shard_kernel_s4=shard_kernel,
         multi_card=multi, phase_s=time.perf_counter() - phase_t0)


def phase_sharded_hybrid(index, corpus) -> None:
    """[sharded.hybrid]: the 131,072-node index (a 100 MB slab, under the
    budget, so the layout is forced) in a facade over 4 shards on this
    card: plain, typed and filtered hybrid_search and one RAGEngine
    retrieve batch (a small LM; retrieval only) equal to the single
    facade's, and hybrid p50 beside it."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.cost_model import DeviceLayoutPlan
    from repro_torch.core.index import HMGIIndex
    from repro_torch.models import lm
    from repro_torch.serving.engine import EngineConfig, RAGEngine
    rng = np.random.default_rng(53)
    vecs = corpus.vectors["text"]
    q = (vecs[rng.choice(HYB_N, BATCH, replace=False)]
         + 0.05 * rng.normal(size=(BATCH, DIM))).astype(np.float32)
    sh = HMGIIndex(index.cfg.replace(shard_layout="sharded"),
                   mesh=mesh_of(4), seed=index.seed)
    sh.restore_state(*index.state_tree())
    check(index.device_layout("text") == DeviceLayoutPlan("single", 1)
          and sh.device_layout("text") == DeviceLayoutPlan("sharded", 4),
          "sharded.hybrid: layouts")
    moves = {}
    for name, kw in (("plain", {}), ("typed", dict(edge_type_mask=(0, 1))),
                     ("filtered", dict(where=("a", "<", 5)))):
        moved = tie_moves(sh.hybrid_search(q, "text", k=10, n_hops=2, **kw),
                          index.hybrid_search(q, "text", k=10, n_hops=2,
                                              **kw))
        check(moved >= 0, f"sharded.hybrid: {name} hybrid_search differs "
                          "from the single facade's")
        moves[name] = moved
    lat = {name: host_ms(lambda: i.hybrid_search(q, "text", k=10, n_hops=2),
                         10)
           for name, i in (("single", index), ("sharded_x4", sh))}
    lcfg = smoke_config("phi4-mini-3.8b")
    params = lm.init_lm(lcfg, seed=0)
    ecfg = EngineConfig(n_slots=1, max_seq=64, retrieve_k=4, hops=1,
                        maintenance_interval=0, retrieval_cache_capacity=0)
    got = [RAGEngine(lcfg, params, i, ecfg).retrieve(q[:32])
           for i in (sh, index)]
    ws = index.hybrid_search(q[:32], "text", k=4, n_hops=1)[0].cpu().numpy()
    for r, j in zip(*np.nonzero(got[0] != got[1])):
        check(int((ws[r] == ws[r, j]).sum()) > 1,
              "sharded.hybrid: RAGEngine.retrieve through the sharded path "
              "differs from the single facade's")
    del sh, params
    torch.cuda.empty_cache()
    line("sharded.hybrid", n=HYB_N, layout="sharded(x4) (forced)",
         hybrid_tie_moves=moves, retrieve_equal=True,
         retrieve_tie_moves=int((got[0] != got[1]).sum()),
         hybrid_ms={k: dict(p50=v[0], p99=v[1]) for k, v in lat.items()})


# ---------------------------------------------------------------------------
# durable: the write-ahead log, snapshots and recovery at serve_1m
# ---------------------------------------------------------------------------

def tensor_bytes_equal(a, b) -> bool:
    """Same shape, dtype and bytes (NaN, -0.0 and padding included)."""
    if isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor):
        return False
    if not isinstance(a, torch.Tensor):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape \
            and a.tobytes() == b.tobytes()
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    return bool(torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                            b.contiguous().reshape(-1).view(torch.uint8)))


def durable_script(vecs: np.ndarray):
    """The durable phase's writes, as ``chip_smoke.py`` and its kill -9
    children replay them: ingest, 18 update batches of 256 (ids from the
    upper half of the corpus) with a delete batch of 16 (from the lower
    half) after batches 3, 6, 9 and 15, a snapshot after batch 12, and a
    tail that holds a skewed probe load (256 queries around one row at
    n_probe 1, so one partition takes every hit), maybe_repartition() and
    a final explicit maintain(). ``("search", ...)`` and ``("snapshot",)``
    are not logged; every other entry is one WAL record (25 in all, 16
    before the snapshot)."""
    rng = np.random.default_rng(31)
    n = vecs.shape[0]
    dels = np.split(rng.choice(n // 2, 4 * DURABLE_DEL, replace=False)
                    .astype(np.int32), 4)
    ops = [("ingest",)]
    for b in range(1, DURABLE_BATCHES + 1):
        ids = (n // 2 + rng.choice(n - n // 2, BATCH, replace=False)
               ).astype(np.int32)
        src = rng.choice(n, BATCH, replace=False)
        ops.append(("insert", ids, (vecs[src] + 0.05 * rng.normal(
            size=(BATCH, DIM))).astype(np.float32)))
        if b in (3, 6, 9, 15):
            ops.append(("delete", dels.pop(0)))
        if b == DURABLE_SNAPSHOT_AFTER:
            ops.append(("snapshot",))
        if b == 15:
            skew = (vecs[7] + 0.01 * rng.normal(size=(BATCH, DIM))
                    ).astype(np.float32)
            ops += [("search", skew), ("repartition",)]
    ops.append(("maintain",))
    return ops


def apply_durable(index, script, vecs, attr, until=None, clock=None):
    """Applies ``script`` to ``index`` (a DurableHMGIIndex or a plain
    HMGIIndex, which skips the snapshots), stopping once ``until`` logged
    ops have run. ``clock``: a dict that receives each insert's ms and the
    snapshot's seconds (device synchronised). Returns the logged ops run."""
    done = 0
    for entry in script:
        kind = entry[0]
        if kind == "search":
            index.search(entry[1], "text", n_probe=1)
            continue
        if kind == "snapshot":
            if hasattr(index, "snapshot"):
                t0 = time.perf_counter()
                index.snapshot()
                if clock is not None:
                    clock["snapshot_s"] = time.perf_counter() - t0
            continue
        if until is not None and done >= until:
            break
        t0 = time.perf_counter()
        if kind == "ingest":
            index.ingest({"text": (np.arange(vecs.shape[0], dtype=np.int32),
                                   vecs)}, vecs.shape[0],
                         node_attrs={"a": attr})
        elif kind == "insert":
            index.insert("text", entry[1], entry[2])
        elif kind == "delete":
            index.delete("text", entry[1])
        elif kind == "repartition":
            split = index.maybe_repartition("text")
            if clock is not None:
                clock["repartition_split"] = split
        elif kind == "maintain":
            index.maintain()
        if clock is not None and kind == "insert":
            torch.cuda.synchronize()
            clock.setdefault("insert_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
        done += 1
    return done


def durable_attr() -> np.ndarray:
    return np.random.default_rng(1).integers(0, 10, VEC_N)


def durable_results(index, q) -> list:
    """Search (k 10), filtered search (sel ≈ 0.1) and full-probe results
    for the 256 queries, on the host."""
    return [t.cpu() for t in (
        *index.search(q, "text"),
        *index.search(q, "text", where=("a", "==", 3)),
        *index.search(q, "text", n_probe=MAINT_FULL_PROBE))]


def durable_child(data_dir: str, vec_file: str) -> None:
    """A kill -9 child: the durable script on a fresh DurableHMGIIndex, with
    ``HMGI_FAULTPOINT`` armed by the parent (it dies with exit code 137)."""
    from repro_torch.configs import get_config
    from repro_torch.persistence import DurableHMGIIndex
    vecs = np.load(vec_file)
    idx = DurableHMGIIndex(get_config("hmgi"), data_dir, seed=0)
    apply_durable(idx, durable_script(vecs), vecs, durable_attr())
    idx.close()


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _span_s(name: str) -> float:
    from repro_torch import obs
    h = obs.registry().histograms().get(name)
    return float(h.total / 1e3) if h is not None else float("nan")


def phase_durable(corpus) -> dict:
    """The durable lifecycle at serve_1m on the card (get_config("hmgi"):
    wal_sync_every 1, snapshot_keep 2): the durable script on a
    DurableHMGIIndex (WAL append of the 1.6 GB ingest record, insert-batch
    latency against the same stream on a plain HMGIIndex and at group
    commit 16, one snapshot), recover() by stage, the recovered index held
    to the live one byte for byte (every state leaf; search, filtered and
    full-probe bytes for 256 queries), two kill -9 children recovered and
    held to a golden replay of their durable prefix, and partitioner.fit
    repeated bitwise at serve_1m (the port's crash harness sweeps its nine
    points beside the dryrun phase: ``start_harness_sweep``). Returns the
    segment-sum launches of that repeat check, which are not the main
    path's."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import partitioner
    from repro_torch.core.index import HMGIIndex
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.persistence import DurableHMGIIndex, recover
    phase_t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="hmgi_durable_")
    procs = []
    try:
        free = shutil.disk_usage(root).free
        check(free >= DURABLE_MIN_FREE,
              f"durable: {free / 2 ** 30:.1f} GiB free under {root}, the "
              f"phase needs {DURABLE_MIN_FREE / 2 ** 30:.0f} GiB (a "
              "snapshot is ~2.5 GB, the ingest record ~1.6 GB, and two "
              "kill -9 children write their own); it is not shrunk to fit")
        cfg = get_config("hmgi")
        check(cfg.wal_sync_every == 1 and cfg.snapshot_keep == 2
              and cfg.maint_auto, "durable: get_config('hmgi') changed")
        vecs = np.ascontiguousarray(corpus.vectors["text"], np.float32)
        attr = durable_attr()
        script = durable_script(vecs)
        n_logged = sum(e[0] not in ("search", "snapshot") for e in script)
        rng = np.random.default_rng(41)
        q = (vecs[rng.choice(VEC_N, BATCH, replace=False)]
             + 0.05 * rng.normal(size=(BATCH, DIM))).astype(np.float32)
        torch.cuda.reset_peak_memory_stats()

        # (1) the same stream on a plain index, then durable at sync 1
        plain_clock = {}
        plain = HMGIIndex(cfg, seed=0)
        apply_durable(plain, script, vecs, attr, clock=plain_clock)
        del plain
        torch.cuda.empty_cache()
        obs.reset()
        live_dir = os.path.join(root, "live")
        clock = {}
        live = DurableHMGIIndex(cfg, live_dir, seed=0)
        t0 = time.perf_counter()
        apply_durable(live, script[:1], vecs, attr)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        ingest_append = obs.registry().histograms()["wal.append"]
        check(ingest_append.count == 1, "durable: the ingest was not one "
                                        "WAL record")
        wal_ingest_ms = ingest_append.vmax
        wal_ingest_bytes = dir_bytes(os.path.join(live_dir, "wal"))
        obs.reset()
        apply_durable(live, script[1:], vecs, attr, clock=clock)
        check(live.last_seq == n_logged,
              f"durable: {live.last_seq} WAL records for {n_logged} ops")
        check(clock.get("repartition_split") is True,
              "durable: maybe_repartition did not split under the skewed "
              "probe load")
        hists = obs.registry().histograms()
        wal_append = dict(p50=hists["wal.append"].percentile(50),
                          p99=hists["wal.append"].percentile(99),
                          n=hists["wal.append"].count)
        wal_fsync = dict(p50=hists["wal.fsync"].percentile(50),
                         p99=hists["wal.fsync"].percentile(99),
                         n=hists["wal.fsync"].count)
        snap_steps = sorted(os.listdir(os.path.join(live_dir, "snapshots")))
        check(len(snap_steps) == 1, f"durable: snapshots {snap_steps}")
        snap_bytes = dir_bytes(os.path.join(live_dir, "snapshots"))
        snap = dict(s=clock["snapshot_s"], bytes=snap_bytes,
                    gb_per_s=snap_bytes / clock["snapshot_s"] / 1e9,
                    to_host_s=_span_s("snapshot.to_host"),
                    write_s=_span_s("snapshot.write")
                    - _span_s("snapshot.to_host"))
        wal_tail_bytes = dir_bytes(os.path.join(live_dir, "wal"))

        # (2) group commit: the same stream at wal_sync_every 16
        g_clock = {}
        g_dir = os.path.join(root, "sync16")
        grouped = DurableHMGIIndex(cfg.replace(wal_sync_every=16), g_dir,
                                   seed=0)
        apply_durable(grouped, [e for e in script if e[0] != "snapshot"],
                      vecs, attr, clock=g_clock)
        grouped.close()
        del grouped
        shutil.rmtree(g_dir)
        torch.cuda.empty_cache()

        # (3) recover() by stage, and the recovered index against the live
        live_state, live_meta = live.state_tree()
        live_res = durable_results(live, q)
        obs.reset()
        with_spans = obs.sync_spans()
        obs.set_sync_spans(True)        # each stage's span waits for its copies
        t0 = time.perf_counter()
        rec = recover(cfg, live_dir, seed=0)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        obs.set_sync_spans(with_spans)
        trail = rec.metrics()["recovery"]
        replayed = int(obs.registry().gauge("recovery.replayed_ops").value)
        check(rec.device.type == "cuda" and rec.last_seq == n_logged
              and replayed == n_logged - (DURABLE_SNAPSHOT_AFTER + 4),
              f"durable: recovery trail {trail!r}")
        rec_state, rec_meta = rec.state_tree()
        diff = sorted(set(live_state) ^ set(rec_state)) + [
            k for k in live_state if k in rec_state
            and not tensor_bytes_equal(live_state[k], rec_state[k])]
        check(not diff and live_meta == rec_meta,
              f"durable: recovered state differs from the live one: {diff}")
        leaves = len(live_state)
        rec_res = durable_results(rec, q)
        check(all(tensor_bytes_equal(a, b) for a, b in zip(live_res, rec_res)),
              "durable: recovered search bytes differ from the live index")
        recover_split = dict(s=recover_s,
                             read_crc_s=_span_s("snapshot.read"),
                             restore_s=_span_s("recovery.restore"),
                             replay_s=_span_s("recovery.replay"),
                             replayed_ops=replayed, trail=trail)
        live.close()
        rec.close()
        del live, rec, live_state, rec_state
        torch.cuda.empty_cache()
        # the same directory recovered onto a mesh of 4 shards on this card:
        # the sharded replica is derived state, rebuilt by the first search
        t0 = time.perf_counter()
        rec = recover(cfg, live_dir, mesh=mesh_of(4), seed=0)
        torch.cuda.synchronize()
        mesh_recover_s = time.perf_counter() - t0
        check(rec.device_layout("text").n_shards == 4
              and rec.modalities["text"].ivf_sharded is None,
              "durable: the recovered index over a mesh is not sharded(x4)")
        check(all(tensor_bytes_equal(a, b) for a, b in zip(
            live_res, durable_results(rec, q))),
              "durable: recover(mesh=) gives other search bytes than the "
              "live index")
        recover_split["mesh_x4"] = dict(s=mesh_recover_s,
                                        search_bytes_equal=True)
        rec.close()
        del rec
        shutil.rmtree(live_dir)
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated()

        # (4) the checks that need other processes: two kill -9 children of
        # this script
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("HMGI_FAULTPOINT", None)
        vec_file = os.path.join(root, "vecs.npy")
        np.save(vec_file, vecs)
        kills = {}
        for point in DURABLE_POINTS:
            d = os.path.join(root, point.replace(":", "_"))
            p = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--durable-child", d, vec_file],
                env=dict(env, HMGI_FAULTPOINT=point),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                start_new_session=True)
            procs.append(p)
            kills[point] = (d, p)
        kill_res = {}
        for point, (d, p) in kills.items():
            _, err = p.communicate(timeout=600)
            check(p.returncode == 137,
                  f"durable: the child armed at {point} exited "
                  f"{p.returncode}, not 137:\n{err[-2000:]}")
            t0 = time.perf_counter()
            rec = recover(cfg, d, seed=0)
            torch.cuda.synchronize()
            r_s = time.perf_counter() - t0
            depth = rec.last_seq
            golden = HMGIIndex(cfg, seed=0)
            apply_durable(golden, script, vecs, attr, until=depth)
            same = all(tensor_bytes_equal(a, b) for a, b in zip(
                durable_results(rec, q), durable_results(golden, q)))
            check(same, f"durable: kill -9 at {point}: the recovered index "
                        f"differs from the golden prefix of {depth} ops")
            kill_res[point] = dict(exit=137, recovered_ops=depth,
                                   recover_s=r_s, bytes_equal=True,
                                   trail=rec.metrics()["recovery"])
            rec.close()
            del rec, golden
            shutil.rmtree(d)
            torch.cuda.empty_cache()

        # (5) fit repeated bitwise at serve_1m (the segment-sum route)
        x = torch.as_tensor(vecs, device="cuda")
        x = x / torch.clamp_min(torch.linalg.vector_norm(
            x, dim=-1, keepdim=True), 1e-12)
        before = sops.segment_sum_csr.launches
        fits, fit_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            fits.append(partitioner.fit(
                x, cfg.n_partitions, cfg.kmeans_iters,
                generator=torch.Generator().manual_seed(0)))
            torch.cuda.synchronize()
            fit_s.append(time.perf_counter() - t0)
        repeat_launches = sops.segment_sum_csr.launches - before
        # two launches an iteration (partitioner.run_sums)
        check(repeat_launches == 3 * 2 * cfg.kmeans_iters,
              f"durable: fit launched the segment sum {repeat_launches} "
              f"times for 3 x {cfg.kmeans_iters} iterations")
        check(all(tensor_bytes_equal(f.centroids, fits[0].centroids)
                  and tensor_bytes_equal(f.counts, fits[0].counts)
                  for f in fits[1:]),
              "durable: partitioner.fit gave other bytes in a repeat")
        # the card's cluster sums against their plain version on the CPU
        a = partitioner.assign(x, fits[0].centroids)
        before = sops.segment_sum_csr.launches
        sums_card = partitioner.run_sums(x, a, cfg.n_partitions).cpu()
        sops.segment_sum_csr.launches = before
        check(tensor_bytes_equal(sums_card, partitioner.run_sums(
            x.cpu(), a.cpu(), cfg.n_partitions)),
              "durable: run_sums on the card differs from its plain version")
        del x, fits, a

        free_min = shutil.disk_usage(root).free
        line("durable", n=VEC_N, d=DIM, batch=BATCH, ops_logged=n_logged,
             wal_sync_every=cfg.wal_sync_every,
             snapshot_keep=cfg.snapshot_keep, ingest_s=ingest_s,
             wal_ingest_append_ms=wal_ingest_ms,
             wal_ingest_bytes=wal_ingest_bytes,
             wal_tail_bytes=wal_tail_bytes,
             insert_batch_ms={name: dict(
                 p50=float(np.percentile(c["insert_ms"], 50)),
                 p99=float(np.percentile(c["insert_ms"], 99)),
                 n=len(c["insert_ms"]))
                 for name, c in (("plain", plain_clock),
                                 ("durable_sync1", clock),
                                 ("durable_sync16", g_clock))},
             wal_overhead_pct_p50={name: (
                 np.percentile(c["insert_ms"], 50)
                 / np.percentile(plain_clock["insert_ms"], 50) - 1) * 100
                 for name, c in (("sync1", clock), ("sync16", g_clock))},
             wal_append_ms=wal_append, wal_fsync_ms=wal_fsync,
             snapshot=snap, recover=recover_split,
             recovered_equals_live=dict(state_leaves=leaves,
                                        search_filtered_full_probe=True),
             kill9=kill_res,
             fit_repeat=dict(runs=3, bitwise=True, s=fit_s,
                             segment_sum_launches=repeat_launches,
                             run_sums_card_eq_plain=True),
             peak_mem_gib=peak / 2 ** 30, free_disk_gib=free / 2 ** 30,
             free_disk_min_gib=free_min / 2 ** 30,
             phase_s=time.perf_counter() - phase_t0)
        return repeat_launches
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


def start_harness_sweep() -> subprocess.Popen:
    """``python -m repro_torch.persistence.crash_harness --sweep`` on the
    card in the background: nine points, each a child killed with exit 137,
    recovered and held bit for bit to a golden replay (a 12-wide index; its
    minutes are the children's start-up). It leads its own process group,
    so that on a failure the harness's own children are stopped with it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("HMGI_FAULTPOINT", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.persistence.crash_harness",
         "--sweep"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    proc.t0 = time.perf_counter()
    return proc


def finish_harness_sweep(sweep: subprocess.Popen) -> None:
    """Waits for the sweep, holds it to nine clean points and prints its
    ``durable.sweep`` line."""
    out, _ = sweep.communicate(timeout=900)
    ok_lines = [ln for ln in out.splitlines() if ln.endswith("]")
                and " — OK [" in ln]
    check(sweep.returncode == 0 and len(ok_lines) == 9
          and "all 9 crash point(s)" in out,
          f"durable: the crash harness sweep on the card failed "
          f"(exit {sweep.returncode}):\n{out[-3000:]}")
    line("durable.sweep", points=len(ok_lines),
         s=time.perf_counter() - sweep.t0,
         lines=[ln[:110] for ln in ok_lines])


def phase_durable_hybrid(index, corpus) -> int:
    """The hybrid/131k index through a snapshot (no second ingest):
    write_snapshot -> read_snapshot -> restore_state into a fresh index;
    plain, typed and filtered hybrid_search byte-equal. Then the hop
    operator built three times, byte-equal (its out-weights run the
    segment-sum kernel). Returns the segment-sum launches of that repeat."""
    from repro_torch.core import traversal
    from repro_torch.core.index import HMGIIndex
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.persistence import snapshot as snap_mod
    root = tempfile.mkdtemp(prefix="hmgi_hybsnap_")
    try:
        rng = np.random.default_rng(43)
        vecs = corpus.vectors["text"]
        q = (vecs[rng.choice(HYB_N, BATCH, replace=False)]
             + 0.05 * rng.normal(size=(BATCH, DIM))).astype(np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap_mod.write_snapshot(root, index, 0)
        write_s = time.perf_counter() - t0
        nbytes = dir_bytes(root)
        t0 = time.perf_counter()
        tree, meta, _ = snap_mod.read_snapshot(root, index.cfg, 0)
        read_s = time.perf_counter() - t0
        back = HMGIIndex(index.cfg, seed=index.seed)
        t0 = time.perf_counter()
        back.restore_state(tree, meta)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del tree
        runs = {"plain": dict(), "typed": dict(edge_type_mask=(0, 1)),
                "filtered": dict(where=("a", "<", 5))}
        for name, kw in runs.items():
            a = index.hybrid_search(q, "text", k=10, n_hops=2, **kw)
            b = back.hybrid_search(q, "text", k=10, n_hops=2, **kw)
            check(all(tensor_bytes_equal(x, y) for x, y in zip(a, b)),
                  f"durable.hybrid: {name} hybrid_search bytes differ after "
                  "the snapshot round trip")
        del back
        g = index.graph
        before = sops.segment_sum_csr.launches
        ops_ = [traversal._push_operator(g, traversal._edge_weights(g, None))
                for _ in range(3)]
        launches = sops.segment_sum_csr.launches - before
        check(launches == 3 and all(
            tensor_bytes_equal(a.indices(), ops_[0].indices())
            and tensor_bytes_equal(a.values(), ops_[0].values())
            for a in ops_[1:]),
              f"durable.hybrid: the hop operator differs in a repeat "
              f"({launches} segment-sum launches)")
        line("durable.hybrid", n=HYB_N, edges=int(g.n_edges), bytes=nbytes,
             write_s=write_s, read_crc_s=read_s, restore_s=restore_s,
             gb_per_s_write=nbytes / write_s / 1e9,
             hybrid_bytes_equal=list(runs), push_operator_repeat_bitwise=3)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)

def phase_racecheck() -> dict:
    """The port's concurrency contract on the card (``tools/racecheck_torch
    .py``): (a) the canonical workload over a ``get_config("hmgi")`` index
    of RACE_ROWS rows at d 384 under RACE_SEEDS seeded interleavings, each
    bitwise the card's single-threaded oracle, no lockset warning, no
    in-place write to the published state a searcher holds; (b)
    RACE_FREE free-running searcher threads beside the writer, the same
    checks; then ``RetrievalService`` with micro-batching, a hot-result
    cache and admission under RACE_CLIENTS client threads, every response
    bitwise the request retrieved alone. Returns the scans' launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ivf_topk import ops
    from tools import racecheck_torch as rc
    phase_t0 = time.perf_counter()
    before = (ops.probe_scan.launches, ops.shared_scan.launches)
    wl = rc.Workload("cuda", cfg=get_config("hmgi"), n=RACE_ROWS, d=384)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - phase_t0
    seeds, points, ops_done, warnings, changes = [], 0, 0, 0, 0
    for seed in range(RACE_SEEDS):
        t0 = time.perf_counter()
        r = rc.canonical_workload(seed, workload=wl)
        check(r["ok"], f"racecheck seed {seed}: lockset warnings "
                       f"{r['warnings'][:3]}, mismatches {r['mismatches'][:3]}"
                       f", version changes {r['version_changes'][:3]}; "
                       f"repro: python -m tools.racecheck_torch --schedule "
                       f"'{r['schedule']}'")
        seeds.append(dict(seed=seed, points=r["points"], ops=r["ops"],
                          s=time.perf_counter() - t0))
        points += r["points"]
        ops_done += r["ops"]
        warnings += len(r["warnings"])
        changes += len(r["version_changes"])
    t0 = time.perf_counter()
    free = rc.free_running(wl, n_searchers=RACE_FREE, rounds=RACE_ROUNDS)
    check(free["ok"], f"racecheck free-running: mismatches "
                      f"{free['mismatches'][:3]}, version changes "
                      f"{free['version_changes'][:3]}")
    free_s = time.perf_counter() - t0
    changes += len(free["version_changes"])
    t0 = time.perf_counter()
    queries = np.random.default_rng(29).normal(
        size=(RACE_QUERIES, 384)).astype(np.float32)
    svc = rc.service_clients(wl.fresh(), queries, n_clients=RACE_CLIENTS,
                             per_client=RACE_REQUESTS, k=wl.k)
    check(svc["ok"], f"racecheck service: {svc['mismatches'][:3]}")
    svc_s = time.perf_counter() - t0
    launches = {"probe": ops.probe_scan.launches - before[0],
                "shared": ops.shared_scan.launches - before[1]}
    check(min(launches.values()) > 0,
          f"racecheck: a scan kernel was not launched: {launches}")
    ms = (time.perf_counter() - phase_t0) * 1e3
    line("racecheck", seeds=RACE_SEEDS, ops=ops_done + free["ops"]
         + svc["requests"], schedules=RACE_SEEDS, scheduling_points=points,
         lockset_warnings=warnings, version_changes=changes, ms=ms,
         nvidia_smi=smi_line(), rows=RACE_ROWS, d=384,
         by_seed=seeds, free_running=dict(searchers=RACE_FREE,
                                          rounds=RACE_ROUNDS, s=free_s),
         service=dict(clients=RACE_CLIENTS, requests=svc["requests"],
                      bitwise_alone=True, s=svc_s),
         build_s=build_s, launches=launches)
    return launches


def stage_bytes(index, raw_queries) -> dict:
    """Time-free, per stage: the rows of a batch of queries against each
    query alone, byte for byte (True = every row the same). The stages of
    a retrieval with one hop, each fed the batch's own inputs row by row:
    query normalisation, centroid scores and probes, the probe scan with
    its stage-2 rescore, the delta scan with its exact rescore, the hop,
    and fusion; and, for comparison, the library calls the port used
    before (``info_lib_*``: cuBLAS and the reduction kernels size their
    work from the whole batch)."""
    from repro_torch.core import delta as delta_mod
    from repro_torch.core import ivf as ivf_mod
    from repro_torch.core import partitioner
    from repro_torch.core import traversal as trav_mod
    from repro_torch.core.fusion import adaptive_weights
    from repro_torch.core.index import _fuse_candidates

    def rows_alone(fn, *args):
        big = fn(*args)
        big = big if isinstance(big, tuple) else (big,)
        for i in range(args[0].shape[0]):
            one = fn(*(a[i:i + 1] for a in args))
            one = one if isinstance(one, tuple) else (one,)
            if not all(torch.equal(b[i:i + 1], o) for b, o in zip(big, one)):
                return False
        return True

    m = index.modalities["text"]
    cfg = index.cfg
    raw = torch.as_tensor(raw_queries, device="cuda")
    q = index._norm_queries(raw)
    cents = m.ivf.centroids
    probes, _ = partitioner.assign_topk(q, cents, cfg.n_probe)
    k = 8
    sv, si = delta_mod.search_with_delta(m.ivf, m.delta, q, n_probe=cfg.n_probe,
                                         k=k, probes=probes)
    g = index.graph._replace(edge_weight=index.boosted_weights)
    gs = trav_mod.multi_hop_batch(g, si, sv, n_hops=1)
    w = adaptive_weights(sv, base_wv=cfg.w_vector, base_wg=cfg.w_graph)
    # rows gathered per query, as the delta's rescore (k + margin = 26)
    # and the probe path's stage 2 (k chunks of 16 = 160) take them
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {r: m.delta.vectors[torch.randint(
        0, max(int(m.delta.count), 1), (q.shape[0], r), device="cuda",
        generator=gen)] for r in (26, 160)}
    out = {
        "norm": rows_alone(index._norm_queries, raw),
        "centroid_scores": rows_alone(
            lambda x: partitioner.assign_topk(x, cents, cfg.n_probe), q),
        "probe_scan_stage2": rows_alone(
            lambda x, p: ivf_mod.search(m.ivf, x, n_probe=cfg.n_probe, k=k,
                                        probes=p), q, probes),
        "delta_rescore": rows_alone(
            lambda x: delta_mod._scan_delta(m.delta, x, k=k), q),
        "hops": rows_alone(
            lambda s, i: trav_mod.multi_hop_batch(g, i, s, n_hops=1), sv, si),
        "hops_same_twice": torch.equal(
            gs, trav_mod.multi_hop_batch(g, si, sv, n_hops=1)),
        "fusion": rows_alone(
            lambda s, i, x, a, b: _fuse_candidates(
                s, i, x, a, b, k_fuse=2 * k, frontier=3 * k),
            sv, si, gs, w.w_vector, w.w_graph),
        "info_lib_norm": rows_alone(
            lambda x: torch.linalg.vector_norm(x, dim=-1), raw),
        "info_lib_centroid_matmul": rows_alone(lambda x: x @ cents.T, q),
        "info_lib_einsum_rescore_26": rows_alone(
            lambda x, r: torch.einsum("qd,qrd->qr", x, r), q, rows[26]),
        "info_lib_einsum_rescore_160": rows_alone(
            lambda x, r: torch.einsum("qd,qrd->qr", x, r), q, rows[160]),
    }
    torch.cuda.synchronize()
    return out


def phase_hybrid():
    from repro_torch.configs import get_config
    from repro_torch.core.index import HMGIIndex
    from repro_torch.data.synthetic import make_corpus
    print(f"[hybrid.cut] {HYB_CUT}", flush=True)
    t0 = time.perf_counter()
    c = make_corpus(n_nodes=HYB_N, modality_dims={"text": DIM},
                    intra_p=96 / HYB_N, inter_p=2 / HYB_N, seed=0)
    rng = np.random.default_rng(2)
    attr = rng.integers(0, 10, HYB_N)
    data_s = time.perf_counter() - t0
    cfg = get_config("hmgi")
    index = HMGIIndex(cfg, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index.ingest({"text": (c.node_ids["text"], c.vectors["text"])}, HYB_N,
                 edges=(c.src, c.dst, c.edge_type), node_attrs={"a": attr})
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    rows = rng.choice(HYB_N, BATCH, replace=False)
    queries = c.vectors["text"][rows] + 0.05 * rng.normal(
        size=(BATCH, DIM)).astype(np.float32)
    runs = {"plain": dict(), "typed": dict(edge_type_mask=(0, 1)),
            "filtered": dict(where=("a", "<", 5))}
    res, lat = {}, {}
    for name, kw in runs.items():
        hv, hi = index.hybrid_search(queries, "text", k=10, n_hops=2, **kw)
        check(tuple(hv.shape) == (BATCH, 10) and bool(torch.isfinite(hv).all()),
              f"hybrid {name}: scores not finite (256, 10)")
        res[name] = (hv[:16].cpu(), hi[:16].cpu())
        lat[name] = host_ms(lambda: index.hybrid_search(
            queries, "text", k=10, n_hops=2, **kw), 10)
    check(bool((attr[res["filtered"][1].numpy()] < 5).all()),
          "filtered hybrid: a result fails its predicate")
    peak = torch.cuda.max_memory_allocated()
    prof = profile_window(lambda: index.hybrid_search(queries, "text", k=10,
                                                      n_hops=2))
    cpu = cpu_copy(index)
    for name, kw in runs.items():
        cv, ci = cpu.hybrid_search(queries[:16], "text", k=10, n_hops=2, **kw)
        check(agree_up_to_ties(*res[name], cv, ci, SCORE_ATOL),
              f"hybrid {name} on the card disagrees with the CPU copy")
    line("hybrid", n=HYB_N, edges=int(index.graph.n_edges), d=DIM,
         batch=BATCH, data_s=data_s, ingest_s=ingest_s,
         ingest_split_s=index.metrics()["ingest_seconds"],
         latency_ms={k: dict(p50=v[0], p99=v[1]) for k, v in lat.items()},
         cpu_copy_agrees=True, peak_mem_gib=peak / 2 ** 30,
         hybrid_profile=prof)
    del cpu
    return index, c


def nsw_scores(vectors: torch.Tensor, lists: torch.Tensor) -> np.ndarray:
    """float64 scores of each row against the rows its list names, over the
    bf16 copies the 16-bit build scores (-inf where the list pads)."""
    v = vectors.double()
    vb = vectors.to(torch.bfloat16).double()
    out = []
    for s in range(0, v.shape[0], 2048):
        li = lists[s:s + 2048].long()
        sc = (v[s:s + 2048, None, :] * vb[li.clamp(min=0)]).sum(-1)
        out.append(torch.where(li >= 0, sc, float("-inf")))
    return torch.cat(out).numpy()


def phase_facade(index, corpus) -> dict:
    """The NSW refine lane, the sparse-dense rerank, progressive search,
    label propagation and span traces on the phase-5 index (131,072 nodes);
    returns the probe and delta kernels' launches of this phase."""
    from repro_torch import obs
    from repro_torch.core import community, ivf as ivf_mod
    from repro_torch.core import nsw as nsw_mod, partitioner
    from repro_torch.core.graph_store import GraphStore
    from repro_torch.core.progressive import progressive_search
    from repro_torch.core.rerank import (SparseVectors, hash_terms,
                                         rrf_rerank, sparse_overlap_scores)
    from repro_torch.kernels.ivf_topk import ops
    from repro_torch.query.ast import Q
    from repro_torch.query.executor import execute, search_bucketed
    from repro_torch.query.planner import compile_plan
    print(f"[facade.cut] {NSW_CUT}", flush=True)
    m = index.modalities["text"]
    base_cfg = index.cfg
    start = (ops.probe_scan.launches, ops.shared_scan.launches)
    rng = np.random.default_rng(31)
    gen = torch.Generator().manual_seed(31)
    rows = rng.choice(HYB_N, BATCH, replace=False)
    queries = (corpus.vectors["text"][rows] + 0.05 * rng.normal(
        size=(BATCH, DIM))).astype(np.float32)
    qn = index._norm_queries(queries)
    true_ids = m.ids[torch.topk(qn @ m.vectors.T, 10, dim=1).indices
                     ].cpu().numpy()

    def recall(ids) -> float:
        ids = ids.cpu().numpy()
        return float(np.mean([len(set(a) & set(b)) / 10
                              for a, b in zip(ids, true_ids)]))

    # the graph at full size, as ingest(build_nsw=True) and compact build it
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph = nsw_mod.build(m.vectors, degree=base_cfg.nsw_degree,
                          generator=index.generator)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
    nb = graph.neighbors
    check(tuple(nb.shape) == (HYB_N, base_cfg.nsw_degree)
          and bool(((nb >= -1) & (nb < HYB_N)).all())
          and not bool((nb == torch.arange(HYB_N, device="cuda")[:, None])
                       .any()),
          "facade: the NSW graph's neighbour lists are malformed")
    m.nsw = graph

    # its CPU twin at 16,384 rows, the same rows and centroids: neighbours
    # equal up to ties, except on rows whose 4 probes differ between the
    # devices (near-tied centroid scores route a row another way)
    sub = m.vectors[:NSW_CPU_ROWS]
    cents = partitioner.fit(sub, 16, 16, generator=index.generator).centroids
    small = nsw_mod.build(sub, degree=base_cfg.nsw_degree, centroids=cents)
    t0 = time.perf_counter()
    small_cpu = nsw_mod.build(sub.cpu(), degree=base_cfg.nsw_degree,
                              centroids=cents.cpu())
    cpu_build_s = time.perf_counter() - t0
    pa = partitioner.assign_topk(sub, cents, 4)[0].sort(dim=1).values.cpu()
    pb = partitioner.assign_topk(sub.cpu(), cents.cpu(), 4)[0].sort(
        dim=1).values
    routed_apart = set(np.nonzero((pa != pb).any(dim=1).numpy())[0].tolist())
    na, nb_cpu = small.neighbors.cpu(), small_cpu.neighbors
    sa, sb = nsw_scores(sub.cpu(), na), nsw_scores(sub.cpu(), nb_cpu)
    apart = [int(i) for i in np.nonzero((na != nb_cpu).any(dim=1).numpy())[0]
             if not agree_up_to_ties(sa[i:i + 1], na[i:i + 1].numpy(),
                                     sb[i:i + 1], nb_cpu[i:i + 1].numpy(),
                                     NSW_TIE_ATOL)]
    check(set(apart) <= routed_apart,
          f"facade: the NSW build on the card and the CPU disagree beyond "
          f"ties on rows {apart[:10]} (rows routed apart: "
          f"{sorted(routed_apart)[:10]})")

    # nsw.search alone
    def nsw_alone():
        return nsw_mod.search(graph, qn, ef=base_cfg.nsw_ef, k=10)
    _, ni = nsw_alone()
    nsw_recall = recall(torch.where(ni >= 0, m.ids[ni.clamp(min=0).long()],
                                    -1))
    nsw_lat = host_ms(nsw_alone, 10)
    nsw_prof = profile_window(nsw_alone, top=6)

    # search with the NSW refine lane, beside plain search
    _, plain_i = index.search(queries, "text")
    plain_lat = host_ms(lambda: index.search(queries, "text"), 10)
    index.cfg = base_cfg.replace(use_nsw_refine=True)
    lv, li = index.search(queries, "text")
    lane_lat = host_ms(lambda: index.search(queries, "text"), 10)
    lane_prof = profile_window(lambda: index.search(queries, "text"), top=8)
    cpu = cpu_copy(index)
    cv, ci = cpu.search(queries[:16], "text")
    check(agree_up_to_ties(lv[:16].cpu(), li[:16].cpu(), cv, ci, SCORE_ATOL),
          "facade: the NSW lane on the card disagrees with the CPU copy")
    bv, bi = search_bucketed(index, queries[:8], "text", k=10)
    solo = [search_bucketed(index, queries[i:i + 1], "text", k=10)
            for i in range(8)]
    lane_bytes = all(bv[i].tobytes() == solo[i][0].tobytes()
                     and bi[i].tobytes() == solo[i][1].tobytes()
                     for i in range(8))
    check(lane_bytes, "facade: the NSW lane gave 8 queries other bytes "
                      "batched than alone")
    index.cfg = cpu.cfg = base_cfg

    # hybrid_search with the sparse-dense rerank over the fused set
    tok = torch.randint(0, RERANK_BUCKETS, (HYB_N, RERANK_NNZ), generator=gen)
    docs = SparseVectors(hash_terms(tok, RERANK_BUCKETS),
                         torch.rand((HYB_N, RERANK_NNZ), generator=gen))
    index.set_sparse_docs(docs)
    cpu.set_sparse_docs(docs)
    q_terms = hash_terms(torch.randint(0, RERANK_BUCKETS, (RERANK_T,),
                                       generator=gen), RERANK_BUCKETS)
    q_w = torch.rand((RERANK_T,), generator=gen)
    rr_kw = dict(k=10, n_hops=2, use_rerank=True, q_terms=q_terms,
                 q_term_weights=q_w)
    rv, ri = index.hybrid_search(queries, "text", **rr_kw)
    check(tuple(ri.shape) == (BATCH, 10) and bool((ri >= 0).all()),
          "facade: reranked hybrid ids malformed")
    rr_lat = host_ms(lambda: index.hybrid_search(queries, "text", **rr_kw),
                     10)
    rr_prof = profile_window(
        lambda: index.hybrid_search(queries, "text", **rr_kw), top=6)
    hy_lat = host_ms(lambda: index.hybrid_search(queries, "text", k=10,
                                                 n_hops=2), 10)
    # the fused set the lane reranks, as hybrid_search computes it
    phys = compile_plan(index, Q.vector("text", qn).traverse(2), k=10,
                        fusion_repr="sparse")
    fv, fi = execute(index, phys, truncate=False)
    width = int(fi.shape[1])
    match_elems = BATCH * width * RERANK_NNZ * RERANK_T
    # the rerank itself on the same fused set: card against CPU
    dev_docs = index.sparse_docs
    got = rrf_rerank(fv, sparse_overlap_scores(
        dev_docs, q_terms.cuda(), q_w.cuda(), fi), fi, k=10)
    want = rrf_rerank(fv.cpu(), sparse_overlap_scores(
        cpu.sparse_docs, q_terms, q_w, fi.cpu()), fi.cpu(), k=10)
    check(torch.equal(got[1].cpu(), want[1])
          and float((got[0].cpu() - want[0]).abs().max()) <= 1e-7,
          "facade: the rerank on the card disagrees with the CPU on the "
          "same fused set")
    # end to end on 16 queries: where the card's and the CPU's fused
    # orders are the same, the reranked ids are the same
    _, cfi = execute(cpu, compile_plan(
        cpu, Q.vector("text", cpu._norm_queries(queries[:16])).traverse(2),
        k=10, fusion_repr="sparse"), truncate=False)
    same_order = [i for i in range(16) if torch.equal(fi[i].cpu(), cfi[i])]
    cr = cpu.hybrid_search(queries[:16], "text", **rr_kw)
    check(all(torch.equal(ri[i].cpu(), cr[1][i]) for i in same_order),
          "facade: reranked ids on the card differ from the CPU copy's "
          "where the fused orders agree")
    del cpu

    # progressive rounds over the hybrid index's IVF
    rounds = list(progressive_search(m.ivf, qn, k=10,
                                     probe_schedule=PROGRESSIVE))
    prog_prof = profile_window(lambda: list(progressive_search(
        m.ivf, qn, k=10, probe_schedule=PROGRESSIVE)), top=6)
    prog_recall = [recall(r.ids) for r in rounds]
    prog_ms = list(np.diff([0.0] + [r.elapsed_s for r in rounds]) * 1e3)
    check(all(b >= a for a, b in zip(prog_recall, prog_recall[1:])),
          f"facade: progressive recall fell: {prog_recall}")
    one = ivf_mod.search(m.ivf, qn, n_probe=PROGRESSIVE[-1], k=10)
    check(len(rounds) == len(PROGRESSIVE) and agree_up_to_ties(
        rounds[-1].scores.cpu(), rounds[-1].ids.cpu(), one[0].cpu(),
        one[1].cpu(), SCORE_ATOL),
          "facade: the last progressive round differs from one-shot "
          f"n_probe {PROGRESSIVE[-1]}")

    # label propagation over the graph, against the CPU
    g = index.graph
    lp = community.label_propagation(g)
    lp_ms = cuda_ms(lambda: community.label_propagation(g), 5)
    lp_cpu = community.label_propagation(GraphStore(*(t.cpu() for t in g)))
    check(torch.equal(lp.cpu(), lp_cpu),
          "facade: label propagation on the card differs from the CPU")

    # stage times from the facade's own spans, device work synchronised
    obs.reset()
    index.cfg = base_cfg.replace(obs_sync_spans=True)
    sv0, si0 = index.search(queries, "text")
    sv1, si1, tr_s = index.search(queries, "text", trace=True)
    hv0, hi0 = index.hybrid_search(queries, "text", k=10, n_hops=2)
    hv1, hi1, tr_h = index.hybrid_search(queries, "text", k=10, n_hops=2,
                                         trace=True)
    *_, tr_r = index.hybrid_search(queries, "text", trace=True, **rr_kw)
    check(torch.equal(si0, si1) and torch.equal(sv0, sv1)
          and torch.equal(hi0, hi1) and torch.equal(hv0, hv1),
          "facade: traced results differ from untraced")
    for _ in range(10):
        index.search(queries, "text")
        index.hybrid_search(queries, "text", k=10, n_hops=2)
        index.hybrid_search(queries, "text", **rr_kw)
    hist = index.metrics()["obs"]["histograms"]
    stages = ("query.plan", "query.execute", "query.seed_scan",
              "query.traversal", "query.fusion", "query.rescore")
    stage_p50 = {n: hist[n]["p50"] for n in stages if n in hist}
    check(set(stage_p50) == set(stages),
          f"facade: spans missing: {set(stages) - set(stage_p50)}")

    def names(node):
        return [node.name] + [x for c in node.children for x in names(c)]
    index.cfg = base_cfg

    # the reference's MVCC sequence on the NSW lane (tests/
    # test_mvcc_updates.py::test_nsw_refine_respects_mvcc), on the card
    index.cfg = base_cfg.replace(use_nsw_refine=True)
    id5, id7 = int(m.ids[5]), int(m.ids[7])
    v5, v7 = m.vectors[5:6].clone(), m.vectors[7:8].clone()
    index.delete("text", np.array([id5], np.int32))
    _, di = index.search(v5, "text", k=10)
    check(not bool((di == id5).any()), "facade: a deleted id came back "
                                       "through the NSW lane")
    new = torch.zeros((1, DIM), device="cuda")
    new[0, 3] = 1.0
    index.insert("text", np.array([id7], np.int32), new)
    compact_s = None
    for stage in ("pre-compaction", "post-compaction"):
        sv, si = index.search(v7, "text", k=10)
        check(not bool(((si == id7) & (sv >= 0.9)).any()),
              f"facade: {stage}: the updated id showed its stale score")
        sv, si = index.search(new, "text", k=1)
        check(int(si[0, 0]) == id7 and float(sv[0, 0]) > 0.99,
              f"facade: {stage}: the updated id is not found by its "
              "new vector")
        if compact_s is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index.compact("text")
            torch.cuda.synchronize()
            compact_s = time.perf_counter() - t0
    check(m.nsw is not graph, "facade: compact() did not rebuild the graph")
    # the rag phase runs the index as before, without the graph
    index.cfg, m.nsw = base_cfg, None

    launches = {"probe": ops.probe_scan.launches - start[0],
                "shared": ops.shared_scan.launches - start[1]}
    check(launches["probe"] > 0 and launches["shared"] > 0,
          f"facade: a scan kernel was not launched in this phase: {launches}")
    line("facade", n=HYB_N, d=DIM, batch=BATCH, nsw=dict(
        degree=base_cfg.nsw_degree, ef=base_cfg.nsw_ef, build_s=build_s,
        build_peak_extra_gib=build_peak,
        graph_mib=(graph.vectors.numel() * 4 + graph.neighbors.numel() * 4)
        / 2 ** 20,
        cpu_twin=dict(rows=NSW_CPU_ROWS, cpu_build_s=cpu_build_s,
                      rows_differing_beyond_ties=len(apart),
                      rows_routed_apart=len(routed_apart),
                      entry_same=int(small.entry) == int(small_cpu.entry)),
        search_alone=dict(recall_at_10=nsw_recall, p50_ms=nsw_lat[0],
                          p99_ms=nsw_lat[1], profile=nsw_prof)),
         refine_lane=dict(recall_at_10=recall(li),
                          plain_recall_at_10=recall(plain_i),
                          p50_ms=lane_lat[0], p99_ms=lane_lat[1],
                          plain_p50_ms=plain_lat[0],
                          plain_p99_ms=plain_lat[1], cpu_copy_agrees=True,
                          bytes_8_batched_eq_alone=lane_bytes,
                          profile=lane_prof),
         rerank=dict(p50_ms=rr_lat[0], p99_ms=rr_lat[1],
                     hybrid_p50_ms=hy_lat[0],
                     rescore_span_p50_ms=stage_p50["query.rescore"],
                     fused_width_C=width, match_tensor_elems=match_elems,
                     match_bool_mib=match_elems / 2 ** 20,
                     contrib_fp32_mib=4 * match_elems / 2 ** 20,
                     nnz=RERANK_NNZ, terms=RERANK_T,
                     buckets=RERANK_BUCKETS, same_order_queries=len(
                         same_order), cpu_copy_agrees=True,
                     profile=rr_prof),
         progressive=dict(schedule=list(PROGRESSIVE), recall=prog_recall,
                          round_ms=prog_ms, last_equals_one_shot=True,
                          profile_5_rounds=prog_prof),
         label_propagation=dict(edges=int(g.n_edges), ms=lp_ms,
                                communities=int(lp.unique().numel()),
                                equals_cpu=True),
         spans=dict(search_tree=[x for r in tr_s.roots for x in names(r)],
                    hybrid_tree=[x for r in tr_h.roots for x in names(r)],
                    rerank_roots=[r.name for r in tr_r.roots],
                    p50_ms=stage_p50, traced_equals_untraced=True),
         mvcc=dict(delete_gone=True, stale_score_hidden=True,
                   compact_with_nsw_rebuild_s=compact_s),
         launches=launches)
    return launches


def _measure_decode_case(case: str, lengths) -> dict:
    """decode_attention at phi4-mini's decode tick (B 8, S 2048, Hkv 8,
    G 3, hd 128, bf16), row b valid on its first lengths[b] positions (a
    slot's history, as the engine's cache is): held against its plain
    version, twice for the same bits, then timed beside its bound, the
    plain version and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import (
        BF16_FLOOR, BF16_RTOL, bf16_excess, decode_attention_ref)
    b, s, hkv, g, hd = RAG_SLOTS, RAG_SEQ, 8, 3, 128
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(
        torch.bfloat16) for shape in ((b, hkv * g, hd), (b, s, hkv, hd),
                                      (b, s, hkv, hd)))
    lens = torch.as_tensor(np.asarray(lengths), device="cuda")
    valid = torch.arange(s, device="cuda")[None, :] < lens[:, None]

    def plain():
        return decode_attention_ref(q.view(b, hkv, g, hd), k, v,
                                    valid).view(b, hkv * g, hd)

    out = dops.decode_attention(q, k, v, valid)
    again = dops.decode_attention(q, k, v, valid)
    ref = plain()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    excess = bf16_excess(out, ref)
    check(excess <= 1.0,
          f"decode_attention ({case}) max |d out| {err}: {excess} x its "
          f"bound ({BF16_RTOL} |ref| + {BF16_FLOOR})")
    check(torch.equal(out.view(torch.int16), again.view(torch.int16)),
          f"decode_attention ({case}): two calls gave different bits")
    n_valid = int(np.sum(lengths))
    # each valid K and V row read once, the mask, q in and out
    nbytes = n_valid * hkv * hd * 2 * 2 + b * s + 2 * b * hkv * g * hd * 2
    flops = 4.0 * n_valid * hkv * g * hd
    bms, bby = bound(flops, nbytes)
    big = torch.ones(64 << 20, dtype=torch.int32, device="cuda")
    flush = big.zero_

    def kernel():
        return dops.decode_attention(q, k, v, valid)

    kms = cuda_ms(kernel, 50, flush)
    pms = cuda_ms(plain, 10, flush)
    # library yardstick (never called by the port): SDPA, same bool mask
    qs, ks, vs = q.view(b, hkv * g, 1, hd), k.transpose(1, 2), v.transpose(1, 2)
    mask = valid[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)

    lms = cuda_ms(sdpa, 50, flush)
    # the zero_ flush leaves L2 full of dirty lines, whose write-back the
    # timed call pays as it reads; a flush that reads leaves clean lines,
    # as the tick's weight reads do before the kernel
    def clean():
        big.sum()

    kms_clean, lms_clean = cuda_ms(kernel, 50, clean), cuda_ms(sdpa, 50, clean)
    line(f"kernel.decode_attention.{case}",
         shape=dict(B=b, S=s, Hkv=hkv, G=g, hd=hd, dtype="bfloat16"),
         valid_lengths=[int(x) for x in lengths],
         plan=dops.launch_plan(q, k), max_abs_err=err,
         share_of_tolerance=excess, same_bits_twice=True, ms=kms, plain_ms=pms, library_ms=lms,
         library="F.scaled_dot_product_attention(bool mask, enable_gqa=True)",
         ms_clean_l2=kms_clean, library_ms_clean_l2=lms_clean,
         bound_ms=bms, bound_by=bby, share_of_bound=bms / kms,
         share_of_bound_clean_l2=bms / kms_clean,
         mbytes=nbytes / 1e6, achieved_tb_s=nbytes / (kms * 1e-3) / 1e12)
    return dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                bound_by=bby, max_abs_err=err)


def measure_decode(lengths) -> dict:
    """The decode kernel at the tick shape with the slot histories
    ``lengths`` (the kernels line's numbers), then with all 8 slots at the
    full 2,048 history (the tick's worst case), then with short histories
    of 10-300 positions (4.6 MB: what a call costs beyond its bytes)."""
    ragged = _measure_decode_case("ragged", lengths)
    _measure_decode_case("full", [RAG_SEQ] * RAG_SLOTS)
    _measure_decode_case("short", [100, 200, 50, 300, 10, 64, 128, 256])
    return ragged


def measure_decode_extents() -> dict:
    """The decode kernel at the extents the reference takes: its smoke
    head dim 16 in bf16 and fp32 at the tick's slots and ragged histories,
    and a bf16 cache past 2^31 elements (``DECODE_PAST_2_31``), each
    against its plain version (bf16 output by output: ``bf16_excess``) and
    timed beside its bound and SDPA. The cache past 2^31 carries a control
    the bound must catch: the plain version of the rows that lie past 2^31
    with their first 64-position tile left out."""
    import torch.nn.functional as F
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import (
        BF16_FLOOR, BF16_RTOL, bf16_excess, decode_attention_ref)
    smoke = smoke_config("phi4-mini-3.8b")
    lens_tick = np.random.default_rng(13).integers(132, 1601, RAG_SLOTS)
    cases = [("hd16_bf16", (RAG_SLOTS, RAG_SEQ, smoke.n_kv_heads,
                            smoke.n_heads // smoke.n_kv_heads,
                            smoke.head_dim), torch.bfloat16, lens_tick),
             ("hd16_fp32", (RAG_SLOTS, RAG_SEQ, smoke.n_kv_heads,
                            smoke.n_heads // smoke.n_kv_heads,
                            smoke.head_dim), torch.float32, lens_tick)]
    b, s = DECODE_PAST_2_31[:2]
    lens = np.random.default_rng(31).integers(s // 2, s + 1, b)
    lens[-1] = s
    cases.append(("past_2_31", DECODE_PAST_2_31, torch.bfloat16, lens))
    out = {}
    for case, (b, s, hkv, g, hd), dtype, lengths in cases:
        gen = torch.Generator(device="cuda").manual_seed(hd + b)
        q, k, v = (torch.randn(shape, device="cuda", generator=gen,
                               dtype=dtype)
                   for shape in ((b, hkv * g, hd), (b, s, hkv, hd),
                                 (b, s, hkv, hd)))
        lens_t = torch.as_tensor(np.asarray(lengths), device="cuda")
        valid = torch.arange(s, device="cuda")[None, :] < lens_t[:, None]
        rows = DECODE_ROWS if case == "past_2_31" else b

        def plain_rows(i, mask):
            return decode_attention_ref(
                q[i:i + rows].view(-1, hkv, g, hd), k[i:i + rows],
                v[i:i + rows], mask[i:i + rows]).view(-1, hkv * g, hd)

        def plain():
            return torch.cat([plain_rows(i, valid) for i in range(0, b, rows)])

        def sdpa():
            return torch.cat([F.scaled_dot_product_attention(
                q[i:i + rows].view(-1, hkv * g, 1, hd),
                k[i:i + rows].transpose(1, 2), v[i:i + rows].transpose(1, 2),
                attn_mask=valid[i:i + rows, None, None, :], enable_gqa=True)
                for i in range(0, b, rows)])

        def kernel():
            return dops.decode_attention(q, k, v, valid)

        got, again, ref = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        big = case == "past_2_31"
        if dtype == torch.float32:
            tol, excess = DECODE_FP32_ATOL, err / DECODE_FP32_ATOL
        else:
            tol = f"{BF16_RTOL} |ref| + {BF16_FLOOR}"
            excess = bf16_excess(got, ref)
        check(excess <= 1.0, f"decode_attention ({case}) max |d out| {err}: "
                             f"{excess} x its bound ({tol})")
        control = {}
        if big:
            # rows from `first` on start past 2^31 elements of K and V
            first = -(-2 ** 31 // (s * hkv * hd))
            dropped = valid.clone()
            dropped[:, :64] = False
            ctl, want = plain_rows(first, dropped), ref[first:first + rows]
            share = bf16_excess(ctl, want)
            check(share > 1.0, f"decode_attention ({case}): the dropped-tile "
                               f"control is within the bound ({share} x)")
            control = dict(control=f"rows {first}-{first + rows - 1} without "
                                   f"positions 0-63", control_share=share,
                           control_max_abs=float(
                               (ctl.float() - want.float()).abs().max()))
            del ctl, want, dropped
        check(torch.equal(got, again),
              f"decode_attention ({case}): two calls gave different bits")
        ref_max = float(ref.float().abs().max())
        del got, again, ref
        flush = None if big else torch.ones(64 << 20, dtype=torch.int32,
                                            device="cuda").zero_
        n_valid = int(np.sum(lengths))
        es = q.element_size()
        nbytes = n_valid * hkv * hd * 2 * es + b * s + 2 * b * hkv * g * hd * es
        bms, bby = bound(4.0 * n_valid * hkv * g * hd, nbytes)
        reps = 5 if big else 50
        res = dict(shape=dict(B=b, S=s, Hkv=hkv, G=g, hd=hd,
                              dtype=str(dtype).replace("torch.", "")),
                   elements=b * s * hkv * hd, max_abs_err=err, tolerance=tol,
                   share_of_tolerance=excess, max_abs_ref=ref_max, **control,
                   same_bits_twice=True, plan=dops.launch_plan(q, k),
                   ms=cuda_ms(kernel, reps, flush),
                   plain_ms=cuda_ms(plain, 2 if big else 10, flush),
                   library_ms=cuda_ms(sdpa, 2 if big else 50, flush),
                   library="F.scaled_dot_product_attention(bool mask, "
                           "enable_gqa=True)"
                           + (f", {rows} rows a call" if big else ""),
                   bound_ms=bms, bound_by=bby, mbytes=nbytes / 1e6)
        res["share_of_bound"] = bms / res["ms"]
        line(f"kernel.decode_attention.{case}", **res,
             nvidia_smi=smi_line())
        out[case] = res
        del q, k, v, valid
        torch.cuda.empty_cache()
    return out


def _params_to(params, device):
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    return [_params_to(v, device) for v in params]


def sequential_decode(cfg, params, prompt, n: int, clen: int, device="cuda"):
    """One request alone: prefill, then single-row greedy decode."""
    from repro_torch.models import lm
    toks = torch.as_tensor(prompt, device=device)[None]
    logits, cache = lm.prefill(cfg, params, toks, margin=clen - len(prompt))
    gen = [int(torch.argmax(logits[0]))]
    pos = len(prompt)
    while len(gen) < n:
        lg, cache = lm.decode_step(cfg, params, cache,
                                   torch.tensor([gen[-1]], device=device),
                                   torch.tensor([pos], device=device))
        gen.append(int(torch.argmax(lg[0])))
        pos += 1
    return gen


def rag_traffic(corpus, vocab: int):
    """The RAG cells' traffic, from one seed: (rng, the 32 retrieval
    queries near corpus rows, prompts of 128-1,536 tokens in [0, vocab),
    32-64 new tokens each); the lengths do not depend on ``vocab``."""
    rng = np.random.default_rng(12)
    rows = rng.choice(HYB_N, RAG_REQUESTS, replace=False)
    queries = (corpus.vectors["text"][rows] + 0.05 * rng.normal(
        size=(RAG_REQUESTS, DIM))).astype(np.float32)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in rng.integers(128, 1537, RAG_REQUESTS)]
    news = [int(n) for n in rng.integers(32, 65, RAG_REQUESTS)]
    return rng, queries, prompts, news


def mesh_lm_dense(cfg, params) -> dict:
    """phi4-mini (dense) over a (1, 4) grid of this card: one prefill and
    one ``decode_step(mesh=)``, which runs the decode kernel once a layer;
    a dense model's mesh path is the unsharded one, bit for bit."""
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.models import lm
    gen = torch.Generator(device="cuda").manual_seed(31)
    tok = torch.randint(0, cfg.vocab_size, (1, MESH_DENSE_PROMPT),
                        device="cuda", generator=gen)
    m14 = grid((1, 4))
    with torch.no_grad():
        want, c0 = lm.prefill(cfg, params, tok, 1)
        got, c1 = lm.prefill(cfg, params, tok, 1, mesh=m14)
        nxt = torch.argmax(want, -1)
        d0, _ = lm.decode_step(cfg, params, c0, nxt, MESH_DENSE_PROMPT)
        before = dops.decode_attention.launches
        d1, _ = lm.decode_step(cfg, params, c1, nxt, MESH_DENSE_PROMPT,
                               mesh=m14)
        torch.cuda.synchronize()
        n = dops.decode_attention.launches - before
    same = torch.equal(got, want) and torch.equal(d1, d0)
    check(same and n == cfg.n_layers,
          f"mesh.lm {cfg.arch_id}: prefill/decode over the (1, 4) grid "
          f"bitwise {same}, {n} decode launches for {cfg.n_layers} layers")
    out = dict(model=cfg.arch_id, mesh=m14.shape, prompt=MESH_DENSE_PROMPT,
               bitwise=same, decode_launches=n)
    line("mesh.lm", **out)
    return out


def mesh_moe_layer(cfg, moe_p) -> dict:
    """One full-width MoE layer in fp32 on a (2, 2) grid (two data shards
    of MESH_PROMPT / 2 tokens, the experts' F split over "model") against
    its plain split: each data shard's tokens through moe_ffn(mesh=None)
    with the whole F, so at that shard's capacity. The keep masks must be
    equal and the outputs within MESH_MOE_RTOL of the largest |output|;
    two controls must fall outside that bound: model shard 0's F half
    alone (the psum over "model" left out) and the whole batch routed at
    one capacity (the per-data-shard capacity left out)."""
    from repro_torch.layers import moe
    p = {k: v.float() for k, v in moe_p.items()}
    f2 = p["w1"].shape[2] // 2
    half = dict(p, w1=p["w1"][..., :f2], w3=p["w3"][..., :f2],
                w2=p["w2"][:, :f2])
    gen = torch.Generator(device="cuda").manual_seed(37)
    x = torch.randn((2, MESH_PROMPT // 2, cfg.d_model), device="cuda",
                    generator=gen)
    cf = cfg.capacity_factor

    def split_run(pp, routings=None):
        return torch.cat([moe.moe_ffn(cfg, pp, x[d:d + 1],
                                      capacity_factor=cf,
                                      routings=routings)[0]
                          for d in range(2)])

    with torch.no_grad():
        want_r, got_r = [], []
        want = split_run(p, want_r)
        got = moe.moe_ffn(cfg, p, x, grid((2, 2)), capacity_factor=cf,
                          routings=got_r)[0]
        controls = dict(
            no_model_psum=split_run(half),
            batch_capacity=moe.moe_ffn(cfg, p, x, capacity_factor=cf)[0])
        torch.cuda.synchronize()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    ctl = {k: float((v - want).abs().max()) for k, v in controls.items()}
    keep = len(got_r) == 2 and all(
        torch.equal(a.keep, b.keep) and torch.equal(a.idx, b.idx)
        for a, b in zip(got_r, want_r))
    tol = MESH_MOE_RTOL * scale
    check(keep and err <= tol and min(ctl.values()) > tol,
          f"mesh.lm {cfg.arch_id}: fp32 MoE layer on (2, 2): keep masks "
          f"equal {keep}, max |diff| {err} against tolerance {tol} "
          f"({MESH_MOE_RTOL} of {scale}), controls {ctl} must exceed it")
    return dict(mesh=(2, 2), tokens_per_shard=MESH_PROMPT // 2,
                dtype="float32", keep_equal=keep, max_abs_err=err,
                scale=scale, tolerance_rel=MESH_MOE_RTOL,
                drops_by_data_shard=[float((~r.keep).float().mean())
                                     for r in got_r],
                controls_max_abs=ctl)


def mesh_lm_moe(cfg, params) -> dict:
    """(f) DeepSeek-V2-Lite over this card's shards: one prefill of
    MESH_PROMPT tokens on a (1, 4) grid (one data shard: the unsharded
    capacity; the experts' F split over "model") against prefill(None)
    within MESH_BF16_RTOL of the largest logit, the same argmax; one
    ``decode_step(mesh=)`` (MLA's absorbed decode, no decode kernel); the
    per-data-shard drop shares of a batch-2 prefill on a (2, 2) grid;
    ``mesh_moe_layer``."""
    from repro_torch.models import lm
    gen = torch.Generator(device="cuda").manual_seed(29)
    tok = torch.randint(0, cfg.vocab_size, (1, MESH_PROMPT), device="cuda",
                        generator=gen)
    m14 = grid((1, 4))
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, c0 = lm.prefill(cfg, params, tok, 1)
        torch.cuda.synchronize()
        t_none = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        got, c1 = lm.prefill(cfg, params, tok, 1, mesh=m14)
        torch.cuda.synchronize()
        t_mesh = (time.perf_counter() - t0) * 1e3
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        nxt = torch.argmax(want, -1)
        d0, _ = lm.decode_step(cfg, params, c0, nxt, MESH_PROMPT)
        d1, _ = lm.decode_step(cfg, params, c1, nxt, MESH_PROMPT, mesh=m14)
        d_err = float((d1.float() - d0.float()).abs().max())
        d_scale = float(d0.float().abs().max())
        del c0, c1
        tok2 = torch.randint(0, cfg.vocab_size, (2, MESH_PROMPT // 2),
                             device="cuda", generator=gen)
        routings = []
        lm.prefill(cfg, params, tok2, 1, mesh=grid((2, 2)),
                   moe_routings=routings)
        torch.cuda.synchronize()
    drops = [[float((~r.keep).float().mean()) for r in routings[d::2]]
             for d in range(2)]
    # the argmax may move only between logits closer than twice the error
    top2 = torch.topk(want.float(), 2, dim=-1).values[0]
    same_argmax = (torch.equal(torch.argmax(got, -1), nxt)
                   or float(top2[0] - top2[1]) <= 2 * err)
    ok = (err <= MESH_BF16_RTOL * max(1.0, scale)
          and d_err <= MESH_BF16_RTOL * max(1.0, d_scale)
          and same_argmax and bool(torch.isfinite(d1).all()))
    check(ok, f"mesh.lm {cfg.arch_id}: (1, 4) prefill differs by {err} "
              f"(scale {scale}), decode by {d_err} (scale {d_scale}), "
              f"tolerance {MESH_BF16_RTOL} of max(1, scale), same argmax "
              f"{same_argmax}")
    out = dict(model=cfg.arch_id, mesh=m14.shape, prompt=MESH_PROMPT,
               prefill_ms=dict(none=t_none, mesh=t_mesh),
               prefill_max_abs=err, logit_scale=scale,
               decode_max_abs=d_err, decode_scale=d_scale,
               tolerance_rel=MESH_BF16_RTOL, same_argmax=same_argmax,
               drops_2x2=dict(batch=2, tokens_per_shard=MESH_PROMPT // 2,
                              share_by_data_shard=[
                                  float(np.mean(d)) for d in drops],
                              by_layer=drops),
               layer_fp32_2x2=mesh_moe_layer(
                   cfg, params["layers"][cfg.first_dense_layers]["moe"]))
    line("mesh.lm", **out)
    return out


def phase_rag(index, corpus) -> dict:
    """The RAG serving path over the phase-5 index; returns the launches of
    its run (counts set to 0 just before it, read just after)."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.ivf_topk import ops
    from repro_torch.models import lm
    from repro_torch.serving.engine import EngineConfig, RAGEngine
    from repro_torch.serving.retrieval import RetrievalPlan, run_plan
    cfg = get_config("phi4-mini-3.8b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = RAGEngine(cfg, params, index, EngineConfig(
        n_slots=RAG_SLOTS, max_seq=RAG_SEQ, retrieve_k=4, hops=1))
    rng, queries, prompts, news = rag_traffic(corpus, cfg.vocab_size)
    obs.reset()
    obs.set_sync_spans(True)          # the prefill span waits for its work
    # the facade sets sync spans from its config at every search
    hyb_cfg, index.cfg = index.cfg, index.cfg.replace(obs_sync_spans=True)

    dops.decode_attention.launches = 0
    ops.probe_scan.launches = ops.shared_scan.launches = 0
    t0 = time.perf_counter()
    ids = engine.retrieve(queries)
    retrieve_ms = (time.perf_counter() - t0) * 1e3
    for i in range(RAG_REQUESTS):
        engine.submit(i, prompts[i], retrieved_ids=ids[i],
                      max_new_tokens=news[i])
    prof = None
    t0 = time.perf_counter()
    while engine.batcher.any_active:
        slots = engine.batcher.slots
        if (prof is None and engine.stats["ticks"] >= 16
                and all(sl.active and sl.remaining >= 2 for sl in slots)):
            # this tick and the profiler's warm-up tick are both pure
            # decode ticks: every slot is busy and none finishes
            prof = profile_window(engine.tick, top=8,
                                  share_of="decode_kernel")
        else:
            engine.tick()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"decode": dops.decode_attention.launches,
                "probe": ops.probe_scan.launches,
                "shared": ops.shared_scan.launches}
    obs.set_sync_spans(False)
    index.cfg = hyb_cfg

    ticks = engine.stats["ticks"]
    check(ticks > 0 and launches["decode"] == cfg.n_layers * ticks,
          f"rag: {launches['decode']} decode kernel launches for {ticks} "
          f"ticks of {cfg.n_layers} layers")
    check(launches["probe"] > 0, "rag: retrieval did not run the probe kernel")
    check(prof is not None, "rag: no steady decode tick was profiled")
    # the profiled tick ran the decode kernel once per layer: one kernel
    # per call, the split merge folded in
    dec_prof = prof.get("decode_kernel")
    check(dec_prof is None or dec_prof["launches"] == cfg.n_layers,
          f"rag: the profiled tick ran {dec_prof} decode kernels for "
          f"{cfg.n_layers} layers")
    reqs = engine.batcher.requests
    for i in range(RAG_REQUESTS):
        check(reqs[i].done and len(reqs[i].generated) == news[i],
              f"rag: request {i} gave {len(reqs[i].generated)} of "
              f"{news[i]} tokens")
    hist = obs.registry().histograms()
    dec, pre = hist["serving.decode_step"], hist["serving.prefill"]
    stall, tick_h = hist["maintenance.stall"], hist["serving.tick"]
    check(engine.maintenance is not None
          and engine.stats["maintenance_runs"] == stall.count > 0,
          f"rag: {engine.stats['maintenance_runs']} maintenance passes, "
          f"{stall.count} stall spans")
    prompt_lens = [len(reqs[i].prompt) for i in range(RAG_REQUESTS)]
    n_tokens = sum(news)
    peak = torch.cuda.max_memory_allocated()

    # retrieval's bytes do not depend on the batch (the serving contract):
    # 8 requests batched against each alone, and stage by stage; the bf16
    # full-depth streams against sequential decode are for information
    plan = RetrievalPlan(modality="text", k=4, n_hops=1)
    n_info = min(8, RAG_REQUESTS)
    sv, si = run_plan(index, plan, queries[:n_info])
    solo = [run_plan(index, plan, queries[i:i + 1]) for i in range(n_info)]
    bytes_same = all(sv[i].tobytes() == solo[i][0].tobytes()
                     and si[i].tobytes() == solo[i][1].tobytes()
                     for i in range(n_info))
    stages = stage_bytes(index, queries[:n_info])
    line("rag.stage_bytes", queries=n_info, **stages)
    check(bytes_same, "rag: search_many gave 8 requests other bytes batched "
                      f"than alone (stages: {stages})")
    check(all(v for k, v in stages.items() if not k.startswith("info_")),
          f"rag: a retrieval stage depends on its batch: {stages}")
    seq_same = [sequential_decode(cfg, params, reqs[i].prompt, news[i],
                                  RAG_SEQ) == reqs[i].generated
                for i in range(n_info // 2)]
    line("rag", model=cfg.arch_id, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim}",
         vocab=cfg.vocab_size, dtype=cfg.dtype,
         params_b=cfg.param_count() / 1e9,
         param_gib=lm.param_bytes(params) / 2 ** 30, init_s=init_s,
         index_nodes=HYB_N, n_slots=RAG_SLOTS, max_seq=RAG_SEQ,
         requests=RAG_REQUESTS, prompt_tokens=dict(
             min=min(prompt_lens), p50=float(np.median(prompt_lens)),
             max=max(prompt_lens), total=sum(prompt_lens)),
         new_tokens=n_tokens, retrieve_ms=retrieve_ms,
         prefill_ms=dict(p50=pre.percentile(50), p99=pre.percentile(99),
                         n=pre.count),
         decode_tick_ms=dict(p50=dec.percentile(50), p99=dec.percentile(99),
                             n=dec.count),
         tick_ms=dict(p50=tick_h.percentile(50), p99=tick_h.percentile(99),
                      n=tick_h.count),
         maintenance_stall_ms=dict(p50=stall.percentile(50),
                                   p99=stall.percentile(99), n=stall.count,
                                   interval=engine.cfg.maintenance_interval,
                                   budget_rows=engine.cfg
                                   .maintenance_budget_rows),
         decode_tokens_per_s_8_slots=RAG_SLOTS / (dec.percentile(50) / 1e3),
         run_s=run_s, tokens_per_s=n_tokens / run_s, ticks=ticks,
         launches=launches, peak_mem_gib=peak / 2 ** 30, tick_profile=prof,
         decode_kernel_in_tick=dec_prof if dec_prof is not None
         else "not measured (the profiler saw no kernels)",
         search_many_bytes_identical_8_vs_1=bytes_same,
         info_bf16_streams_equal_sequential=seq_same)
    launches["mesh_decode"] = mesh_lm_dense(cfg, params)["decode_launches"]
    full_tick(cfg, params)
    del engine, params
    torch.cuda.empty_cache()

    # a 4-layer fp32 copy at full width: 3 ragged requests on 2 slots give
    # the tokens of sequential per-request greedy decoding
    cfg4 = cfg.replace(n_layers=4, dtype="float32")
    p4 = lm.init_lm(cfg4, seed=1)
    eng4 = RAGEngine(cfg4, p4, None, EngineConfig(n_slots=2, max_seq=256))
    prompts4 = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in (37, 101, 64)]
    news4 = (9, 5, 12)
    for i, (pr, n) in enumerate(zip(prompts4, news4)):
        eng4.submit(i, pr, max_new_tokens=n)
    got4 = eng4.run_to_completion()
    want4 = {i: sequential_decode(cfg4, p4, pr, n, 256)
             for i, (pr, n) in enumerate(zip(prompts4, news4))}
    check(got4 == want4, f"rag fp32: batched streams {got4} differ from "
                         f"sequential {want4}")
    del eng4, p4
    torch.cuda.empty_cache()

    # a 2-layer fp32 copy at full width: the same weights on the CPU give
    # the same logits for one prefill + 4 decode steps
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    p2 = lm.init_lm(cfg2, seed=2)
    p2c = _params_to(p2, "cpu")
    prompt = rng.integers(0, cfg.vocab_size, 96).astype(np.int32)
    outs = []
    for dev, pp in (("cuda", p2), ("cpu", p2c)):
        lg, cache = lm.prefill(cfg2, pp, torch.as_tensor(prompt, device=dev)[None],
                               margin=8)
        logits = [lg[0].cpu()]
        tok, pos = int(torch.argmax(logits[0])), len(prompt)
        for _ in range(4):
            lg, cache = lm.decode_step(cfg2, pp, cache,
                                       torch.tensor([tok], device=dev),
                                       torch.tensor([pos], device=dev))
            logits.append(lg[0].cpu())
            tok, pos = int(torch.argmax(logits[-1])), pos + 1
        outs.append(torch.stack(logits))
    cpu_err = float((outs[0] - outs[1]).abs().max())
    same_argmax = bool((outs[0].argmax(-1) == outs[1].argmax(-1)).all())
    check(cpu_err <= CPU_LOGIT_ATOL and same_argmax,
          f"rag: 2-layer card vs CPU logits differ by {cpu_err} "
          f"(> {CPU_LOGIT_ATOL}) or in argmax")
    line("rag.checks", decode_launches_per_tick=launches["decode"] / ticks,
         fp32_4_layer_streams_equal_sequential=True,
         fp32_2_layer_card_vs_cpu_max_abs_logit=cpu_err,
         logit_scale=float(outs[1].abs().max()), tolerance=CPU_LOGIT_ATOL)
    return launches


def full_tick(cfg, params) -> None:
    """The dry run's decode cell at this script's slots (8 x 2,048): one
    decode step of phi4-mini with every slot at the cache's last position,
    so every cache position is valid (the dry run's worst case), timed
    (CUDA events) and counted once for the dryrun phase."""
    from repro_torch.models import lm
    with torch.no_grad():
        cache = lm.init_cache(cfg, RAG_SLOTS, RAG_SEQ)
        cache[2].copy_(torch.arange(RAG_SEQ, dtype=torch.int32,
                                    device="cuda").expand_as(cache[2]))
        tok = torch.zeros(RAG_SLOTS, dtype=torch.int32, device="cuda")

        def tick():
            return lm.decode_step(cfg, params, cache, tok, RAG_SEQ - 1)

        ms = cuda_ms(tick, 10)
        counted_run("phi4-mini-decode-8x2048", tick, params, cache, tok,
                    ms=ms)
    del cache


def routing_summary(routings) -> dict:
    """Capacity drops over a list of ``moe.Routing`` (one sync): dropped
    and routed (token, choice) assignments, their share, the mean number
    of experts that kept an assignment per call, the least near-tie gap."""
    from repro_torch.layers import moe
    if not routings:
        return dict(calls=0)
    dropped = int(torch.stack([(~r.keep).sum() for r in routings]).sum())
    routed = sum(int(r.keep.numel()) for r in routings)
    used = [int((torch.zeros(r.probs.shape[1] + 1, dtype=torch.int32,
                             device=r.keep.device)
                 .index_fill_(0, torch.where(r.keep, r.idx.reshape(-1),
                                             r.probs.shape[1]), 1)
                 [:-1].sum())) for r in routings]
    gap = float(torch.stack([moe.near_tie_gap(r) for r in routings]).min())
    return dict(calls=len(routings), dropped=dropped, routed=routed,
                drop_share=dropped / routed,
                experts_used_mean=float(np.mean(used)), min_gap=gap)


def tick_weight_bytes(cfg, params, n_slots: int) -> int:
    """Weight bytes one decode tick reads: every parameter once, of the
    embedding table only the n_slots gathered rows (the head is separate:
    the model is untied)."""
    from repro_torch.models import lm
    emb = params["embed"]
    row = emb.shape[1] * emb.element_size()
    return lm.param_bytes(params) - emb.shape[0] * row + n_slots * row


def phase_rag_dsv2(index, corpus) -> dict:
    """DeepSeek-V2-Lite (MLA, 64 routed experts top-6 + 2 shared) at full
    width and depth, bf16, seeded random weights, in RAGEngine over the
    phase-5 index with phase_rag's traffic; returns the launches of its
    run (counts set to 0 just before it, read just after)."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.ivf_topk import ops
    from repro_torch.layers import mla, moe
    from repro_torch.layers.mlp import swiglu
    from repro_torch.models import lm
    from repro_torch.serving.engine import EngineConfig, RAGEngine
    phase_t0 = time.perf_counter()
    cfg = get_config(DSV2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = RAGEngine(cfg, params, index, EngineConfig(
        n_slots=RAG_SLOTS, max_seq=RAG_SEQ, retrieve_k=4, hops=1))
    rng, queries, prompts, news = rag_traffic(corpus, cfg.vocab_size)
    obs.reset()
    obs.set_sync_spans(True)          # the prefill span waits for its work
    hyb_cfg, index.cfg = index.cfg, index.cfg.replace(obs_sync_spans=True)

    dops.decode_attention.launches = 0
    ops.probe_scan.launches = ops.shared_scan.launches = 0
    t0 = time.perf_counter()
    ids = engine.retrieve(queries)
    retrieve_ms = (time.perf_counter() - t0) * 1e3
    for i in range(RAG_REQUESTS):
        engine.submit(i, prompts[i], retrieved_ids=ids[i],
                      max_new_tokens=news[i])
    prof = None
    t0 = time.perf_counter()
    while engine.batcher.any_active:
        slots = engine.batcher.slots
        if (prof is None and engine.stats["ticks"] >= 16
                and all(sl.active and sl.remaining >= 2 for sl in slots)):
            prof = profile_window(engine.tick, top=10, ops_top=12)
        else:
            engine.tick()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"decode": dops.decode_attention.launches,
                "probe": ops.probe_scan.launches,
                "shared": ops.shared_scan.launches}
    obs.set_sync_spans(False)
    index.cfg = hyb_cfg

    ticks = engine.stats["ticks"]
    check(ticks > 0 and launches["decode"] == 0,
          f"rag.dsv2: {ticks} ticks, {launches['decode']} decode kernel "
          "launches (MLA decodes in the absorbed form, without the kernel)")
    check(launches["probe"] > 0 and launches["shared"] > 0,
          f"rag.dsv2: retrieval did not run both scans: {launches}")
    check(prof is not None, "rag.dsv2: no steady decode tick was profiled")
    reqs = engine.batcher.requests
    for i in range(RAG_REQUESTS):
        check(reqs[i].done and len(reqs[i].generated) == news[i],
              f"rag.dsv2: request {i} gave {len(reqs[i].generated)} of "
              f"{news[i]} tokens")
    hist = obs.registry().histograms()
    dec, pre = hist["serving.decode_step"], hist["serving.prefill"]
    stall, tick_h = hist["maintenance.stall"], hist["serving.tick"]
    check(engine.maintenance is not None
          and engine.stats["maintenance_runs"] == stall.count > 0,
          f"rag.dsv2: {engine.stats['maintenance_runs']} maintenance "
          f"passes, {stall.count} stall spans")
    peak = torch.cuda.max_memory_allocated()
    prompt_lens = [len(reqs[i].prompt) for i in range(RAG_REQUESTS)]
    n_tokens = sum(news)

    # capacity drops, outside the timed run: each request's prefill alone
    # (as the engine runs it), then DSV2_TICKS decode ticks of 8 slots
    # holding the first 8 requests
    pre_r = []
    for i in range(RAG_REQUESTS):
        lm.prefill(cfg, params, torch.as_tensor(reqs[i].prompt,
                                                device="cuda")[None],
                   moe_routings=pre_r)
    pre_drops = routing_summary(pre_r)
    del pre_r
    cache = lm.init_cache(cfg, RAG_SLOTS, RAG_SEQ)
    toks, pos = [], []
    for i in range(RAG_SLOTS):
        pr = reqs[i].prompt
        lg, one = lm.prefill(cfg, params, torch.as_tensor(pr, device="cuda")
                             [None], margin=RAG_SEQ - len(pr))
        for shared, c in zip(cache, one):
            shared[:, i].copy_(c[:, 0])
        toks.append(int(torch.argmax(lg[0])))
        pos.append(len(pr))
    del one
    tok = torch.tensor(toks, device="cuda")
    pos = torch.tensor(pos, device="cuda")
    dec_r = []
    for _ in range(DSV2_TICKS):
        lg, cache = lm.decode_step(cfg, params, cache, tok, pos,
                                   moe_routings=dec_r)
        tok, pos = torch.argmax(lg, dim=-1), pos + 1
    dec_drops = routing_summary(dec_r)
    del dec_r

    # the tick's bytes: every weight once (all 64 experts of every MoE
    # layer: the dense (E, cap, D) buffer runs each expert's GEMMs), the
    # valid latent cache once; and what only the routed experts would be
    wbytes = tick_weight_bytes(cfg, params, RAG_SLOTS)
    expert_bytes = 3 * cfg.d_model * cfg.moe_d_ff * 2
    n_moe = cfg.n_layers - cfg.first_dense_layers
    cache_bytes = (cfg.n_layers * int((cache[2][0] >= 0).sum())
                   * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2)
    routed_bytes = wbytes - n_moe * expert_bytes * (
        cfg.n_experts - dec_drops["experts_used_mean"])
    tick_bytes = dict(
        weights_gb=wbytes / 1e9, cache_gb=cache_bytes / 1e9,
        experts_gb=n_moe * cfg.n_experts * expert_bytes / 1e9,
        bound_ms=(wbytes + cache_bytes) / PEAK_HBM_BYTES * 1e3,
        routed_only_gb=routed_bytes / 1e9,
        routed_only_bound_ms=(routed_bytes + cache_bytes) / PEAK_HBM_BYTES
        * 1e3,
        busy_ms=prof.get("busy_ms"), decode_p50_ms=dec.percentile(50),
        share_of_bound_busy=((wbytes + cache_bytes) / PEAK_HBM_BYTES * 1e3
                             / prof["busy_ms"]) if "busy_ms" in prof
        else "not measured")

    # where the tick's device time goes, by part, at the tick's shapes
    # (layer 1 is the first MoE layer): device ms per call with the queue
    # kept full (``queued_ms``)
    lp = params["layers"][1]
    x8 = torch.randn((RAG_SLOTS, 1, cfg.d_model), device="cuda",
                     dtype=torch.bfloat16)
    xe = torch.randn((cfg.n_experts, 1, cfg.d_model), device="cuda",
                     dtype=torch.bfloat16)     # cap 1: the tick's buffer
    cl = tuple(c[1].clone() for c in cache)
    positions = pos[:, None]

    def experts():
        h = torch.bmm(xe, lp["moe"]["w1"])
        u = torch.bmm(xe, lp["moe"]["w3"])
        return torch.bmm(torch.nn.functional.silu(h) * u, lp["moe"]["w2"])

    parts = dict(
        router=queued_ms(lambda: moe.route(cfg, lp["moe"],
                                           x8.reshape(RAG_SLOTS, -1),
                                           cfg.capacity_factor), 8),
        moe_ffn=queued_ms(lambda: moe.moe_ffn(
            cfg, lp["moe"], x8, capacity_factor=cfg.capacity_factor), 8),
        expert_bmm=queued_ms(experts, 8),
        shared_expert=queued_ms(lambda: swiglu(lp["shared"], x8), 8),
        mla_decode=queued_ms(lambda: mla.mla_forward(
            cfg, lp["attn"], x8, positions, mode="decode", cache=cl,
            cache_pos=pos), 8))
    if all(isinstance(v["device_ms"], float) for v in parts.values()):
        parts["tick_device_from_parts_ms"] = (
            n_moe * (parts["moe_ffn"]["device_ms"]
                     + parts["shared_expert"]["device_ms"])
            + cfg.n_layers * parts["mla_decode"]["device_ms"])
    del cache, cl
    line("rag.dsv2", model=cfg.arch_id, layers=cfg.n_layers,
         d_model=cfg.d_model, attention=cfg.attention,
         experts=f"{cfg.n_experts} routed top-{cfg.top_k} + "
                 f"{cfg.n_shared_experts} shared, d_ff {cfg.moe_d_ff}",
         dtype=cfg.dtype, params_b=cfg.param_count() / 1e9,
         active_params_b=cfg.active_param_count() / 1e9,
         param_bytes=lm.param_bytes(params), init_s=init_s,
         index_nodes=HYB_N, n_slots=RAG_SLOTS, max_seq=RAG_SEQ,
         requests=RAG_REQUESTS, prompt_tokens=dict(
             min=min(prompt_lens), p50=float(np.median(prompt_lens)),
             max=max(prompt_lens), total=sum(prompt_lens)),
         new_tokens=n_tokens, retrieve_ms=retrieve_ms,
         prefill_ms=dict(p50=pre.percentile(50), p99=pre.percentile(99),
                         n=pre.count),
         decode_tick_ms=dict(p50=dec.percentile(50), p99=dec.percentile(99),
                             n=dec.count),
         tick_ms=dict(p50=tick_h.percentile(50), p99=tick_h.percentile(99),
                      n=tick_h.count),
         maintenance_stall_ms=dict(p50=stall.percentile(50),
                                   p99=stall.percentile(99), n=stall.count),
         decode_tokens_per_s_8_slots=RAG_SLOTS / (dec.percentile(50) / 1e3),
         run_s=run_s, tokens_per_s=n_tokens / run_s, ticks=ticks,
         launches=launches, peak_mem_gib=peak / 2 ** 30,
         moe_drops=dict(prefill=pre_drops, decode=dict(
             dec_drops, ticks=DSV2_TICKS, slots=RAG_SLOTS)),
         tick_profile=prof, tick_bytes=tick_bytes, tick_parts=parts,
         nvidia_smi=smi_line())
    mesh_lm_moe(cfg, params)
    del engine, params
    torch.cuda.empty_cache()

    # a 4-layer fp32 copy at full width, capacity factor 16 (no drops):
    # two ragged rows decoded in one batch equal each row decoded alone
    # (the reference's tests/test_serving.py case)
    cfg4 = cfg.replace(n_layers=4, dtype="float32", capacity_factor=16.0)
    p4 = lm.init_lm(cfg4, seed=1)
    la, lb = 37, 101
    pa = torch.as_tensor(rng.integers(0, cfg.vocab_size, la), device="cuda")
    pb = torch.as_tensor(rng.integers(0, cfg.vocab_size, lb), device="cuda")
    clen = 128
    _, ca = lm.prefill(cfg4, p4, pa[None], margin=clen - la)
    _, cb = lm.prefill(cfg4, p4, pb[None], margin=clen - lb)
    both = tuple(torch.cat([a, b], dim=1) for a, b in zip(ca, cb))
    ta, tb = torch.tensor([7], device="cuda"), torch.tensor([11],
                                                            device="cuda")
    ra, _ = lm.decode_step(cfg4, p4, ca, ta, torch.tensor([la], device="cuda"))
    rb, _ = lm.decode_step(cfg4, p4, cb, tb, torch.tensor([lb], device="cuda"))
    rab, _ = lm.decode_step(cfg4, p4, both, torch.cat([ta, tb]),
                            torch.tensor([la, lb], device="cuda"))
    solo = torch.cat([ra, rb])
    solo_err = float((rab - solo).abs().max())
    solo_ok = bool(torch.allclose(rab, solo, rtol=DSV2_SOLO_TOL,
                                  atol=DSV2_SOLO_TOL))
    check(solo_ok, f"rag.dsv2 fp32: batched rows differ from solo rows by "
                   f"{solo_err} (rtol = atol = {DSV2_SOLO_TOL})")
    del p4, ca, cb, both
    torch.cuda.empty_cache()

    # a 2-layer fp32 copy at full width (the dense first layer and one MoE
    # layer at the default capacity): prefill of 64 tokens and 4 greedy
    # decode steps on the card and on the CPU, the same weights; routing
    # equal (expert ids and kept pattern) unless a near-tie under 1e-6
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    p2 = lm.init_lm(cfg2, seed=2)
    p2c = _params_to(p2, "cpu")
    prompt = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
    outs, routes = [], []
    for dev, pp in (("cuda", p2), ("cpu", p2c)):
        rr = []
        lg, c2 = lm.prefill(cfg2, pp, torch.as_tensor(prompt, device=dev)
                            [None], margin=8, moe_routings=rr)
        logits = [lg[0].cpu()]
        tok, p = int(torch.argmax(logits[0])), len(prompt)
        for _ in range(4):
            lg, c2 = lm.decode_step(cfg2, pp, c2,
                                    torch.tensor([tok], device=dev),
                                    torch.tensor([p], device=dev),
                                    moe_routings=rr)
            logits.append(lg[0].cpu())
            tok, p = int(torch.argmax(logits[-1])), p + 1
        outs.append(torch.stack(logits))
        routes.append([(r.idx.cpu(), r.keep.cpu(), float(moe.near_tie_gap(r)))
                       for r in rr])
    near = min(g for rr in routes for _, _, g in rr)
    same_routes = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                      for a, b in zip(*routes))
    cpu_err = float((outs[0] - outs[1]).abs().max())
    same_argmax = bool((outs[0].argmax(-1) == outs[1].argmax(-1)).all())
    if near >= NEAR_TIE:
        check(same_routes, "rag.dsv2: 2-layer routing differs card vs CPU")
        check(cpu_err <= CPU_LOGIT_ATOL and same_argmax,
              f"rag.dsv2: 2-layer card vs CPU logits differ by {cpu_err} "
              f"(> {CPU_LOGIT_ATOL}) or in argmax")
    line("rag.dsv2.checks",
         fp32_4_layer_cf16_batched_vs_solo_max_abs=solo_err,
         solo_tolerance=DSV2_SOLO_TOL,
         fp32_2_layer_card_vs_cpu_max_abs_logit=cpu_err,
         logit_scale=float(outs[1].abs().max()), tolerance=CPU_LOGIT_ATOL,
         routing_equal=same_routes, router_min_gap=near,
         near_tie=("none under 1e-6: routing and logits checked"
                   if near >= NEAR_TIE else
                   "a near-tie under 1e-6: routing and logits not checked"),
         routed_calls=len(routes[0]), phase_s=time.perf_counter() - phase_t0)
    return launches


def phase_lm_mixtral() -> int:
    """mixtral-8x7b at full width cut to 2 layers (bf16, seeded random
    weights): one 4,608-token prompt against the 4,096 window (prefill
    truncates and rolls), then 8 greedy decode steps that wrap; the decode
    kernel (G 4, S 4,096, hd 128) against its plain version on the run's
    own cache. Returns the decode kernel launches of the run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models import lm
    phase_t0 = time.perf_counter()
    cfg = get_config("mixtral-8x7b").replace(n_layers=2)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_lm(cfg, seed=0)
    rng = np.random.default_rng(21)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, MIXTRAL_PROMPT),
                             device="cuda")[None]
    rr = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, cache = lm.prefill(cfg, params, prompt, margin=MIXTRAL_STEPS,
                           moe_routings=rr)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre_drops = routing_summary(rr)
    clen = cache[0].shape[2]
    check(clen == cfg.sliding_window,
          f"lm.mixtral: cache of {clen} slots, window {cfg.sliding_window}")
    dops.decode_attention.launches = 0
    tok, pos = torch.argmax(lg, dim=-1), MIXTRAL_PROMPT
    step_ms, all_finite = [], bool(torch.isfinite(lg.float()).all())
    dec_r = []
    for _ in range(MIXTRAL_STEPS):
        t0 = time.perf_counter()
        lg, cache = lm.decode_step(cfg, params, cache, tok, pos,
                                   moe_routings=dec_r)
        tok = torch.argmax(lg, dim=-1)
        all_finite &= bool(torch.isfinite(lg.float()).all())
        step_ms.append((time.perf_counter() - t0) * 1e3)
        pos += 1
    launches = dops.decode_attention.launches
    check(launches == cfg.n_layers * MIXTRAL_STEPS,
          f"lm.mixtral: {launches} decode kernel launches for "
          f"{MIXTRAL_STEPS} steps of {cfg.n_layers} layers")
    check(all_finite and tuple(lg.shape) == (1, cfg.vocab_size),
          f"lm.mixtral: logits {tuple(lg.shape)}, finite {all_finite}")
    # the kernel against its plain version on layer 0's wrapped window
    k, v, slot_pos = cache[0][0], cache[1][0], cache[2][0]
    now = pos - 1
    valid = ((slot_pos >= 0) & (slot_pos <= now)
             & (slot_pos > now - cfg.sliding_window))
    check(int(valid.sum()) == cfg.sliding_window,
          f"lm.mixtral: {int(valid.sum())} valid slots after the wrap")
    g = torch.Generator(device="cuda").manual_seed(22)
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    grp = cfg.n_heads // hkv
    q = torch.randn((1, cfg.n_heads, hd), device="cuda",
                    generator=g).to(torch.bfloat16)
    out = dops.decode_attention(q, k, v, valid)
    ref = decode_attention_ref(q.view(1, hkv, grp, hd), k, v,
                               valid).view(1, cfg.n_heads, hd)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    check(err <= DECODE_BF16_ATOL,
          f"lm.mixtral: decode kernel max |d out| {err} > {DECODE_BF16_ATOL}")
    nbytes = cfg.sliding_window * hkv * hd * 2 * 2 + 2 * cfg.n_heads * hd * 2
    kms = cuda_ms(lambda: dops.decode_attention(q, k, v, valid), 50)
    pms = cuda_ms(lambda: decode_attention_ref(q.view(1, hkv, grp, hd), k, v,
                                               valid), 10)
    # library yardstick (never called by the port): SDPA, same bool mask
    lms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q.view(1, cfg.n_heads, 1, hd), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid[:, None, None, :], enable_gqa=True), 50)
    line("lm.mixtral", model=cfg.arch_id, layers=cfg.n_layers,
         cut="2 of 32 layers (the model needs ~93 GB in bf16)",
         d_model=cfg.d_model, heads=f"{cfg.n_heads}/{hkv}x{hd}",
         experts=f"{cfg.n_experts} top-{cfg.top_k}, d_ff {cfg.d_ff}",
         window=cfg.sliding_window, prompt_tokens=MIXTRAL_PROMPT,
         decode_steps=MIXTRAL_STEPS, param_gib=lm.param_bytes(params) / 2 ** 30,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         prefill_ms=prefill_ms, decode_step_ms=dict(
             p50=float(np.median(step_ms)), max=max(step_ms)),
         moe_drops=dict(prefill=pre_drops, decode=routing_summary(dec_r)),
         decode_kernel=dict(shape=dict(B=1, S=cfg.sliding_window, Hkv=hkv,
                                       G=grp, hd=hd, dtype="bfloat16"),
                            max_abs_err=err, tolerance=DECODE_BF16_ATOL,
                            ms=kms, plain_ms=pms, library_ms=lms,
                            bound_ms=nbytes / PEAK_HBM_BYTES * 1e3),
         launches=launches, phase_s=time.perf_counter() - phase_t0)
    del params, cache
    torch.cuda.empty_cache()
    return launches


def plan_of(msgs, rowptr, perm, out, seg_lo: int = 0) -> dict:
    """The summing kernel's plan for a call (``ops.summing_plan``)."""
    from repro_torch.kernels.segment_reduce import ops as sops
    return sops.summing_plan(msgs, rowptr, perm, out, seg_lo)._asdict()


def measure_segment_small() -> float:
    """segment_sum against its plain version at small fp32/bf16 shapes,
    bit for bit: unsorted ids, dropped ids (-1 and >= n), empty segments,
    widths that take each load width. Returns the largest error (0: the
    check is bitwise)."""
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import (
        csr_from_ids, segment_sum_ref)
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst, plans = 0.0, {}
    for e, n, d in ((20_000, 3_000, 68), (5_000, 900, 3), (8_192, 2_000, 129),
                    (1, 4, 16), (0, 5, 8)):
        ids = torch.randint(-1, n + 3, (e,), device="cuda", generator=gen,
                            dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            msg = torch.randn((e, d), device="cuda", generator=gen).to(dtype)
            got = sops.segment_sum(msg, ids, n)
            want = segment_sum_ref(msg, ids, n)
            err = (got.float() - want.float()).abs()
            check(torch.equal(got, want),
                  f"segment_sum {dtype} E={e} n={n} d={d}: not bitwise equal "
                  f"to its plain version (max |d| "
                  f"{float(err.max()) if err.numel() else 0.0})")
            worst = max(worst, float(err.max()) if err.numel() else 0.0)
            plan = plan_of(msg, *csr_from_ids(ids, n), got)
            plans[f"{e}x{d}/{str(dtype)[6:]}"] = (
                f"{plan['route']} vec {plan['vec']} group {plan['group']} "
                f"slices {plan['slices']}")
    torch.cuda.synchronize()
    line("kernel.segment_sum.small", cases=10, bitwise=True,
         max_abs_err=worst, plans=plans)
    return worst


def measure_sum_routes() -> dict:
    """The summing kernel once on each route (``ops.sum_plan``: team,
    medium, wide) and each load it takes (a vector, and one element where
    the output starts off a 16-byte boundary), fp32 and bf16, at small
    shapes: with a perm (a hub of 40 entries among ~1.5) and without one
    into rows from ``seg_lo`` (empty segments among ~6), each bit for bit
    against its plain version, into a NaN-filled buffer: every row of the
    range written, no other. Its launches are not counted. Returns the
    count of cases run by "route/dtype/vec"."""
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_csr_ref
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(9)
    saved = sops.segment_sum_csr.launches
    ran = {}
    for d in (1, 10, 67, 128, 289, 3_072):         # team, medium, wide
        for dtype in (torch.float32, torch.bfloat16):
            for listed, off in ((True, False), (False, False), (True, True)):
                n = 1_000
                deg = torch.randint(0, 4 if listed else 12, (n,),
                                    device="cuda", generator=gen)
                deg[n // 2] = 40 if listed else 0
                rowptr = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
                rowptr[1:] = deg.cumsum(0)
                e = int(rowptr[-1])
                msg = torch.randn((e, d), device="cuda",
                                  generator=gen).to(dtype)
                perm = (torch.randperm(e, device="cuda", generator=gen).int()
                        if listed else None)
                flat = torch.full((2 * n * d + 1,), float("nan"),
                                  device="cuda", dtype=dtype)
                out = (flat[1:] if off else flat[:-1]).view(2 * n, d)
                lo = 0 if listed else n // 3
                want = segment_sum_csr_ref(msg, rowptr, perm)
                plan = sops.summing_plan(msg, rowptr, perm, out, lo)
                sops.segment_sum_csr(msg, rowptr, perm, out=out, seg_lo=lo)
                check(torch.equal(out[lo:lo + n], want)
                      and bool(out[:lo].isnan().all())
                      and bool(out[lo + n:].isnan().all()),
                      f"summing kernel, {plan}, {dtype}, perm {listed}: not "
                      f"bitwise equal to its plain version")
                key = f"{plan.route}/{str(dtype)[6:]}/vec {plan.vec}"
                ran[key] = ran.get(key, 0) + 1
    torch.cuda.synchronize()
    sops.segment_sum_csr.launches = saved
    check({k.split("/")[0] for k in ran} == {"team", "medium", "wide"},
          f"summing kernel: routes run {sorted(ran)}")
    line("kernel.segment_sum.routes", bitwise=True, cases_by_plan=ran,
         s=time.perf_counter() - t0)
    return ran


def measure_accumulate_routes() -> dict:
    """The in-place kernel once on each route (``ops.acc_plan``: team,
    medium, wide) and each load it takes (a vector, and one element where
    the output starts off a 16-byte boundary), fp32 and bf16, at small
    shapes: listed rows with a perm (a hub of 40 entries among ~1.5) and a
    range from ``seg_lo`` without one (empty segments among ~6), each bit
    for bit against its plain version. Its launches are not counted.
    Returns the count of cases run by "route/dtype/vec"."""
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import (
        segment_sum_csr_accumulate_ref)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(7)
    saved = sops.segment_sum_csr_accumulate.launches
    ran = {}
    for d in (1, 10, 67, 128, 291, 3_072):         # team, medium, wide
        for dtype in (torch.float32, torch.bfloat16):
            for listed, off in ((True, False), (False, False), (True, True)):
                n = 1_000
                deg = torch.randint(0, 4 if listed else 12, (n,),
                                    device="cuda", generator=gen)
                deg[n // 2] = 40 if listed else 0
                rowptr = torch.zeros(n + 1, dtype=torch.int32, device="cuda")
                rowptr[1:] = deg.cumsum(0)
                e = int(rowptr[-1])
                msg = torch.randn((e, d), device="cuda",
                                  generator=gen).to(dtype)
                perm = (torch.randperm(e, device="cuda", generator=gen).int()
                        if listed else None)
                rows = (torch.randperm(2 * n, device="cuda",
                                       generator=gen)[:n].int()
                        if listed else None)
                flat = torch.randn(2 * n * d + 1, device="cuda",
                                   generator=gen).to(dtype)
                out = (flat[1:] if off else flat[:-1]).view(2 * n, d)
                kw = dict(rows=rows, seg_lo=0 if listed else n // 3)
                want = segment_sum_csr_accumulate_ref(msg, rowptr, perm,
                                                      out=out.clone(), **kw)
                plan = sops.accumulate_plan(msg, rowptr, perm, out)
                got = sops.segment_sum_csr_accumulate(msg, rowptr, perm,
                                                      out=out, **kw)
                check(torch.equal(got, want),
                      f"in-place kernel, {plan}, {dtype}, listed {listed}: "
                      f"not bitwise equal to its plain version")
                key = f"{plan.route}/{str(dtype)[6:]}/vec {plan.vec}"
                ran[key] = ran.get(key, 0) + 1
    torch.cuda.synchronize()
    sops.segment_sum_csr_accumulate.launches = saved
    check({k.split("/")[0] for k in ran} == {"team", "medium", "wide"},
          f"in-place kernel: routes run {sorted(ran)}")
    line("kernel.segment_sum_accumulate.routes", bitwise=True,
         cases_by_plan=ran, s=time.perf_counter() - t0)
    return ran


def layer0_messages(cfg, params, g, ex) -> torch.Tensor:
    """EGNN layer 0's messages (E, d_hidden + 4) in the kernel's
    destination-sorted order, built block by block as ``push`` builds
    them."""
    from repro_torch.models.gnn import egnn
    payload = torch.cat([g.feats @ params["enc"], g.positions], -1)
    msg_fn = egnn.message_fn(cfg, params["layers"][0])
    msgs = torch.empty((ex.n_edges, cfg.d_hidden + 4), device="cuda")
    for (_, _, e0, e1, _), rows in ex.messages(msg_fn, payload):
        msgs[e0:e1] = rows
    return msgs


def measure_segment(cfg, params, g, ex, small_err: float) -> dict:
    """segment_sum_csr against its plain version at one EGNN layer's real
    shape (the sorted messages of layer 0, all 61,859,140 edges in one
    call), then timed beside its bound, the plain version and index_add_."""
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_csr_ref
    msgs = layer0_messages(cfg, params, g, ex)
    e, d = msgs.shape
    n = ex.n
    out = sops.segment_sum_csr(msgs, ex.rowptr)
    want = segment_sum_csr_ref(msgs, ex.rowptr)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    check(torch.equal(out, want),
          f"segment_sum at the layer shape: not bitwise equal to its plain "
          f"version (max |d| {err})")
    del want
    # each message read once, each output row written once, rowptr read
    nbytes = e * d * 4 + n * d * 4 + (n + 1) * 4
    bms, bby = bound(float(e * d), nbytes)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda").zero_
    kms = cuda_ms(lambda: sops.segment_sum_csr(msgs, ex.rowptr, out=out), 10,
                  flush)
    pms = cuda_ms(lambda: segment_sum_csr_ref(msgs, ex.rowptr), 3, flush)
    # library yardstick (never called by the port): index_add_ of the
    # sorted messages by destination (atomics), into a zeroed buffer once
    # for its check, then timed on the same buffer
    dst = ex.dst
    lib = torch.zeros_like(out).index_add_(0, dst, msgs)
    torch.cuda.synchronize()
    lib_err = float((lib - out).abs().max())
    lms = cuda_ms(lambda: lib.index_add_(0, dst, msgs), 10, flush)
    plan = plan_of(msgs, ex.rowptr, None, out)
    line("kernel.segment_sum", shape=dict(E=e, d=d, n=n, dtype="float32",
                                          perm=False),
         plan=plan, bitwise=True, max_abs_err=err,
         small_cases_max_abs_err=small_err, ms=kms,
         plain_ms=pms, library_ms=lms,
         library="Tensor.index_add_(0, dst, msgs) (atomics)",
         library_max_abs_diff=lib_err, bound_ms=bms, bound_by=bby,
         gbytes=nbytes / 1e9, achieved_tb_s=nbytes / (kms * 1e-3) / 1e12)
    del msgs, out, lib
    torch.cuda.empty_cache()
    return dict(ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                bound_by=bby, max_abs_err=max(err, small_err), plan=plan)


def phase_gnn(small_err: float):
    """EGNN full-graph inference at the ogb_products shape, then the
    molecule cell; returns (kernel measurement, launches of the
    full-graph run, (params, graph, LocalExec, forward p50 ms) for the
    training phase)."""
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import FlatGraph, LocalExec
    cfg = get_config("egnn")
    dims = {s.name: s.dims for s in get_shapes("egnn")}
    n, e, f = (dims["ogb_products"][k] for k in ("n_nodes", "n_edges",
                                                 "d_feat"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = gd.make_flat_graph(n, e, f, seed=0)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    params = gd.init_model(cfg, 0, f)
    t0 = time.perf_counter()
    ex = LocalExec(g, GNN_CHUNK_EDGES)
    torch.cuda.synchronize()
    exec_s = time.perf_counter() - t0
    deg = (ex.rowptr[1:] - ex.rowptr[:-1]).float()
    chunks = len(ex.chunks)
    kern = measure_segment(cfg, params, g, ex, small_err)

    def forward(ex=ex):
        logits = gd.node_logits_local(cfg, params, g, ex=ex)
        return logits, gd._ce_sums(logits, g.labels, g.node_mask)

    sops.segment_sum_csr.launches = 0
    times, logits = [], []
    for _ in range(1 + GNN_REPS):
        t0 = time.perf_counter()
        lg, sums = forward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg)
    launches = sops.segment_sum_csr.launches
    check(launches == cfg.n_layers * chunks * (1 + GNN_REPS),
          f"gnn: {launches} segment-sum launches for {1 + GNN_REPS} forwards "
          f"of {cfg.n_layers} layers x {chunks} chunks")
    check(tuple(lg.shape) == (n, gd.N_CLASSES)
          and bool(torch.isfinite(lg).all())
          and all(bool(torch.isfinite(v)) for v in sums.values())
          and float(sums["count"]) == n, "gnn: logits or sums not finite")
    p50 = float(np.percentile(times[1:], 50))
    p99 = float(np.percentile(times[1:], 99))
    def loss_forward():
        with torch.no_grad():        # the dry run's forward: the loss
            gd.train_loss(cfg, "full_graph", params, {"graph": g, "exec": ex})

    counted_run("egnn-ogbn-products.forward", loss_forward, params, g,
                engine_tensors(ex), ms=p50)
    prof = profile_window(forward, top=8)
    peak = torch.cuda.max_memory_allocated()
    line("gnn", cell="egnn-ogbn-products", model=cfg.arch_id,
         layers=cfg.n_layers, d_hidden=cfg.d_hidden, dtype=cfg.dtype,
         nodes=n, edges=e, d_feat=f, in_degree=dict(
             min=float(deg.min()), mean=float(deg.mean()),
             max=float(deg.max())),
         data_s=data_s, exec_build_s=exec_s, chunk_edges=GNN_CHUNK_EDGES,
         chunks=chunks, msg_block_edges=ex.block, forwards=1 + GNN_REPS,
         forward_ms=dict(p50=p50, p99=p99, all=times),
         edges_per_s=e / (p50 / 1e3), loss_sum=float(sums["loss_sum"]),
         correct=float(sums["correct"]), launches=launches,
         logits_sha256=hashlib.sha256(
             lg.detach().cpu().numpy().tobytes()).hexdigest(),
         peak_mem_gib=peak / 2 ** 30, forward_profile=prof)
    # (c) determinism: two forwards, and a forward with half the budget
    same = torch.equal(logits[0], logits[-1])
    check(same, "gnn: two full-graph forwards differ in their bits (max |d| "
                f"{float((logits[0] - logits[-1]).abs().max())})")
    del logits[:-1]
    half = LocalExec(g, GNN_CHUNK_EDGES // 2)
    half_chunks = len(half.chunks)
    lh = forward(half)[0]
    check(torch.equal(lh, logits[-1]),
          "gnn: a forward with half the chunk budget differs in its bits "
          f"(max |d| {float((lh - logits[-1]).abs().max())})")
    del half, logits, lh
    torch.cuda.empty_cache()

    # (d) a 65,536-node copy, ~25 in-edges per node: card vs CPU
    small = gd.make_flat_graph(65_536, 65_536 * 25, f, seed=1)
    got = gd.node_logits_local(cfg, params, small).cpu()
    want = gd.node_logits_local(cfg, _params_to(params, "cpu"),
                                FlatGraph(*(t.cpu() for t in small)))
    cpu_err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(cpu_err <= GNN_CPU_RTOL * max(1.0, scale),
          f"gnn: 65,536-node logits, card vs CPU, differ by {cpu_err} "
          f"(scale {scale})")
    del small

    # (e) the molecule cell: one disjoint-union graph per batch
    md = dims["molecule"]
    mparams = gd.init_model(cfg, 0, 4, n_out=1)
    mb, energy = gd.make_molecule_batch(md["batch"], md["n_nodes"],
                                        md["n_edges"], seed=0)
    sops.segment_sum_csr.launches = 0
    msums = gd.molecule_loss(cfg, mparams, mb, energy)
    torch.cuda.synchronize()
    mol_launches = sops.segment_sum_csr.launches
    check(mol_launches == cfg.n_layers,
          f"molecule: {mol_launches} launches for one batch of "
          f"{cfg.n_layers} layers")
    mp50, mp99 = host_ms(lambda: gd.molecule_loss(cfg, mparams, mb, energy),
                         20)
    cpu_p = _params_to(mparams, "cpu")
    loop = 0.0
    for b in range(md["batch"]):
        one = FlatGraph(*(t[b].cpu() for t in mb))
        pred = float((gd.node_logits_local(cfg, cpu_p, one)[:, 0]
                      * one.node_mask).sum())
        loop += (pred - float(energy[b])) ** 2
    mol_err = abs(float(msums["loss_sum"]) - loop)
    check(mol_err <= GNN_CPU_RTOL * max(1.0, abs(loop)),
          f"molecule: union loss {float(msums['loss_sum'])} vs per-graph CPU "
          f"loop {loop}")
    line("gnn.checks", launches_per_forward=launches / (1 + GNN_REPS),
         layers_x_chunks=cfg.n_layers * chunks, two_forwards_bitwise=True,
         half_budget_bitwise=True, half_budget_chunks=half_chunks,
         card_vs_cpu_65536_max_abs_logit=cpu_err, logit_scale=scale,
         tolerance_rel=GNN_CPU_RTOL, molecule=dict(
             cell="egnn-molecule", batch=md["batch"], n_nodes=md["n_nodes"],
             n_edges=md["n_edges"], batch_ms_p50=mp50, batch_ms_p99=mp99,
             launches_per_batch=mol_launches,
             loss_sum=float(msums["loss_sum"]), cpu_loop_loss_sum=loop,
             abs_diff=mol_err))
    return kern, launches, (params, g, ex, p50)


def seg_counts():
    """(summing kernel's, in-place kernel's) launch counts."""
    from repro_torch.kernels.segment_reduce import ops as sops
    return (sops.segment_sum_csr.launches,
            sops.segment_sum_csr_accumulate.launches)


SEG_KERNELS = ("segment_sum_kernel", "segment_accumulate_kernel")


def profile_segments(fn, **kw):
    """``profile_once(fn, share_of=SEG_KERNELS, ...)``, its profile also
    holding ``segment_launches``: each mode's kernel launches the profiler
    saw (each mode's kernels have their own names) beside the wrappers'
    counts over the same call."""
    c0 = seg_counts()
    out, prof = profile_once(fn, share_of=SEG_KERNELS, **kw)
    counted = [b - a for a, b in zip(c0, seg_counts())]
    seen = [prof.get(k, {}).get("launches") for k in SEG_KERNELS]
    prof["segment_launches"] = dict(profiled=seen, counted=counted,
                                    equal=seen == counted)
    return out, prof


def seg_zero() -> None:
    from repro_torch.kernels.segment_reduce import ops as sops
    sops.segment_sum_csr.launches = 0
    sops.segment_sum_csr_accumulate.launches = 0


def grads_of(cfg, kind, params, batch, peaks=None):
    """(loss, grads in leaf order, forward launches, backward launches) of
    one batch, the way a train step takes them; each launches a pair
    (summing kernel, in-place kernel). A ``peaks`` dict gets the device
    memory (GiB): the forward's peak, what it leaves allocated, and the
    backward's own peak."""
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.models.gnn import driver as gd
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    if peaks is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    l0 = seg_counts()
    loss, _ = gd.train_loss(cfg, kind, live, batch)
    l1 = seg_counts()
    if peaks is not None:
        torch.cuda.synchronize()
        peaks["forward"] = torch.cuda.max_memory_allocated() / 2 ** 30
        peaks["after_forward"] = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
    grads = torch.autograd.grad(loss, leaves(live))
    l2 = seg_counts()
    if peaks is not None:
        torch.cuda.synchronize()
        peaks["backward"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return (loss.detach(), grads, (l1[0] - l0[0], l1[1] - l0[1]),
            (l2[0] - l1[0], l2[1] - l1[1]))


def adamw_from(opt_cfg, grads, opt_state, params):
    """AdamW's new params from grads in leaf order (``grads_of``)."""
    from repro_torch.common.tree import tree_map
    from repro_torch.train.optimizer import adamw_update
    it = iter(grads)
    return adamw_update(opt_cfg, tree_map(lambda _: next(it), params),
                        opt_state, params)[0]


def train_launches_per_step(layers: int, n_edges: int, chunks: int):
    """(summing, in-place) kernel launches of one train step: the
    forward's summing launch per chunk and layer; the backward's two
    in-place launches (the gather transposes) per message block and layer
    (``LocalExec``'s block: the valid edges rounded up to a power of two,
    at most ``MSG_BLOCK_EDGES``), and no summing launch."""
    from repro_torch.models.gnn import common as gc
    block = min(gc.MSG_BLOCK_EDGES, 1 << max(0, n_edges - 1).bit_length())
    return layers * chunks, layers * 2 * -(-n_edges // block)


def trees_equal(a, b) -> bool:
    from repro_torch.common.tree import leaves
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def rel_err(got, want) -> float:
    """The largest |got - want| over the pairs of leaves, each relative to
    max(1, max |want|) of its leaf."""
    return max(float((a.cpu() - b.cpu()).abs().max())
               / max(1.0, float(b.abs().max())) for a, b in zip(got, want))


def train_run(cfg, kind, params, stream, total: int, ckpt_dir: str,
              ckpt_every: int, to_device=None, fail_at=None):
    """``Trainer.run`` of ``make_train_step(cfg, kind)``: (trainer, each
    step's metrics, each attempt's new params) with the metrics' tensors
    unread until the run ends."""
    from repro_torch.models.gnn import driver as gd
    from repro_torch.train.optimizer import init_adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig
    step = gd.make_train_step(cfg, kind)
    seen, firsts = [], []

    def recorded(p, o, b):
        out = step(p, o, b)
        seen.append(out[2])
        firsts.append(out[0])
        return out

    tcfg = TrainerConfig(total_steps=total, checkpoint_every=ckpt_every,
                         checkpoint_dir=ckpt_dir, log_every=1)
    tr = Trainer(tcfg, recorded, stream, params, init_adamw(params),
                 to_device)
    injected = {"n": 0}

    def inject(s):
        if s == fail_at and not injected["n"]:
            injected["n"] = 1
            raise RuntimeError(f"injected failure at step {s}")

    tr.run(fail_injector=inject if fail_at is not None else None)
    return tr, seen, firsts


def inplace_side(tag: str, cot, e: int, rowptr, perm, rows, seg_lo: int,
                 idx, base, flush) -> dict:
    """The in-place kernel at one gather transpose: ``cot``'s first ``e``
    rows (its cotangents) added by the CSR (``rowptr``, ``perm``) into
    ``base``'s listed ``rows`` (or those from ``seg_lo``), bit for bit
    against its plain version into copies of the same buffer, timed beside
    a bound that counts the cotangent once and each touched row read once
    and written once, its plain version, and ``index_add_(0, idx, cot)``
    into the same buffer in place. Prints the ``tag`` line; returns it."""
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import (
        segment_sum_csr_accumulate_ref)
    n, d = base.shape
    r = rowptr.numel() - 1
    kw = dict(rows=rows, seg_lo=seg_lo)
    out = sops.segment_sum_csr_accumulate(cot, rowptr, perm,
                                          out=base.clone(), **kw)
    ref = segment_sum_csr_accumulate_ref(cot, rowptr, perm,
                                         out=base.clone(), **kw)
    torch.cuda.synchronize()
    same = torch.equal(out, ref)
    err = float((out - ref).abs().max())
    check(same, f"{tag}: not bitwise equal to its plain version (max |d| "
                f"{err})")
    lib = base.clone().index_add_(0, idx, cot[:e])
    torch.cuda.synchronize()
    lib_err = float((lib - out).abs().max())
    # the cotangent, perm, rowptr and rows read once; each touched row
    # read once and written once
    nbytes = (e * d * 4 + (0 if perm is None else e * 4) + (r + 1) * 4
              + (0 if rows is None else r * 4) + 2 * r * d * 4)
    bms, bby = bound(float(e * d + r * d), nbytes)
    kms = cuda_ms(lambda: sops.segment_sum_csr_accumulate(
        cot, rowptr, perm, out=out, **kw), 10, flush)
    pms = cuda_ms(lambda: segment_sum_csr_accumulate_ref(
        cot, rowptr, perm, out=ref, **kw), 3, flush)
    lms = cuda_ms(lambda: lib.index_add_(0, idx, cot[:e]), 10, flush)
    res = dict(shape=dict(E=e, d=d, rows=r, n=n, dtype="float32",
                          perm=perm is not None),
               plan=sops.accumulate_plan(cot, rowptr, perm, out)._asdict(),
               max_abs_err=err, bitwise=same, ms=kms, plain_ms=pms,
               library_ms=lms,
               library="index_add_(0, idx, cot) into the same buffer, "
                       "in place (atomics)",
               library_max_abs_diff=lib_err, bound_ms=bms, bound_by=bby,
               gbytes=nbytes / 1e9,
               achieved_tb_s=nbytes / (kms * 1e-3) / 1e12)
    line(tag, **res)
    del out, ref, lib
    return res


def measure_transpose(ex) -> dict:
    """The backward's gather transposes at one message block (block 0:
    ``block`` cotangent rows of the payload's width, d = 67 fp32). PR 21's
    route first: the summing kernel over all N rows of a stable sort of the
    block's sources, against its plain version, timed. Then the in-place
    kernel at the block's source side (its distinct sources: the compacted
    CSR, perm, listed rows) and destination side (its range of
    destinations: its ``rowptr`` slice), each bit for bit against its plain
    version into the same random buffer, timed beside a bound that counts
    the cotangent once and each touched row read once and written once,
    its plain version, and ``index_add_`` into the same buffer in place.
    Returns the in-place kernel's kernels-line entry: one block's two
    transposes (ms, plain, bound and library summed), each side under
    ``sides``."""
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_csr_ref
    d = 64 + 3                                  # EGNN's payload [h, x]
    e, n = min(ex.block, ex.n_edges), ex.n
    gen = torch.Generator(device="cuda").manual_seed(31)
    cot = torch.randn((ex.block, d), device="cuda", generator=gen)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda").zero_
    keys, perm = torch.sort(ex.src[:e], stable=True)
    rowptr = torch.searchsorted(keys, torch.arange(
        n + 1, dtype=torch.int32, device="cuda")).to(torch.int32)
    perm = perm.to(torch.int32)
    got = sops.segment_sum_csr(cot, rowptr, perm)
    want = segment_sum_csr_ref(cot, rowptr, perm)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"segment_sum transpose: not bitwise "
                                  f"equal to its plain version (max |d| "
                                  f"{err})")
    nbytes = e * d * 4 + e * 4 + (n + 1) * 4 + n * d * 4
    bms, bby = bound(float(e * d), nbytes)
    kms = cuda_ms(lambda: sops.segment_sum_csr(cot, rowptr, perm), 10, flush)
    pms = cuda_ms(lambda: segment_sum_csr_ref(cot, rowptr, perm), 3, flush)
    lib = torch.zeros_like(got)
    src = ex.src[:e].long()
    lms = cuda_ms(lambda: lib.zero_().index_add_(0, src, cot[:e]), 10, flush)
    line("kernel.segment_sum.transpose",
         route="PR 21's: the summing kernel into all N rows, then "
               "autograd's (N, d) add", shape=dict(E=e, d=d, n=n,
                                                   dtype="float32",
                                                   perm=True),
         plan=plan_of(cot, rowptr, perm, got), bitwise=True, max_abs_err=err, ms=kms, plain_ms=pms, library_ms=lms,
         library="zero_ + index_add_(0, src, cot) (atomics)",
         bound_ms=bms, bound_by=bby, gbytes=nbytes / 1e9)
    del got, want, lib, keys, perm, rowptr
    torch.cuda.empty_cache()
    base = torch.randn((n, d), device="cuda", generator=gen)

    def side(name, rowptr, perm, rows, seg_lo, idx):
        return inplace_side(f"kernel.segment_sum_accumulate.{name}", cot, e,
                            rowptr, perm, rows, seg_lo, idx, base, flush)

    src_rp, src_perm, src_rows = ex._src_csr(0)
    dst_rp, dst_lo = ex._dst_csr(0)
    sides = {"source": side("source", src_rp, src_perm, src_rows, 0, src),
             "destination": side("destination", dst_rp, None, None, dst_lo,
                                 ex.dst[:e].long())}
    del cot, base
    torch.cuda.empty_cache()
    both = sides.values()
    return dict(max_abs_err=max(v["max_abs_err"] for v in both),
                ms=sum(v["ms"] for v in both),
                plain_ms=sum(v["plain_ms"] for v in both),
                bound_ms=sum(v["bound_ms"] for v in both),
                bound_by="bytes" if all(v["bound_by"] == "bytes"
                                        for v in both) else "operations",
                library_ms=sum(v["library_ms"] for v in both),
                measured="one message block's two transposes (source + "
                         "destination side); sides.token, the LM's token "
                         "transpose (lm_train), is not in the sums",
                sides=sides)


class ConstantStream:
    """The launcher's ``_GraphStream``: the same batch at every step."""

    def __init__(self, batch):
        self.batch = batch

    def batch_at(self, step):
        return self.batch


class SampledStream:
    """Minibatch batches drawn on the host: step s samples ``MB_ROOTS``
    roots and their fanout trees from generators seeded by (seed, s), so a
    restored run reads the batches an uninterrupted one read."""

    def __init__(self, sampler, positions: np.ndarray, seed: int = 0):
        self.sampler, self.pos, self.seed = sampler, positions, seed
        self.sample_ms = []

    def batch_at(self, step):
        t0 = time.perf_counter()
        rng = np.random.default_rng([self.seed, step])
        roots = rng.choice(self.sampler.n_nodes, MB_ROOTS, replace=False)
        self.sampler.rng = np.random.default_rng([self.seed, step, 1])
        b = self.sampler.sample(roots, MB_FANOUTS)
        safe = np.clip(b.nodes, 0, self.sampler.n_nodes - 1)
        pos = self.pos[safe] * (b.nodes >= 0)[..., None]
        self.sample_ms.append((time.perf_counter() - t0) * 1e3)
        return b, pos


def minibatch_to_card(sampled):
    from repro_torch.models.gnn.common import FlatGraph
    b, pos = sampled

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")

    g = FlatGraph(feats=t(b.feats), positions=t(pos.astype(np.float32)),
                  edge_src=t(b.edge_src), edge_dst=t(b.edge_dst),
                  edge_mask=t(b.edge_mask), node_mask=t(b.nodes >= 0),
                  labels=torch.zeros(b.nodes.shape, dtype=torch.int32,
                                     device="cuda"))
    return {"graph": g, "labels": t(b.labels)}


def phase_gnn_train(params, g, ex, forward_ms: float) -> int:
    """EGNN training: (a) Trainer steps at ogbn-products on phase_gnn's
    graph and LocalExec, (b) one step on a copy against the CPU, (c) the
    minibatch_lg cell through the sampler, (d) one molecule step. Returns
    the summing and the in-place kernels' launches of the cells' runs (the
    two Trainer runs and the molecule step; the checks' extra steps not
    counted), the in-place kernel's kernels-line entry and the last
    minibatch batch on the card (for the gnn_models phase), and the first
    full-graph step's (loss, grad norm) (for the mesh phase)."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.common.tree import leaves, tree_finite
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import FlatGraph, LocalExec
    from repro_torch.sparse.sampler import NeighborSampler, sizes_for_fanout
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    phase_t0 = time.perf_counter()
    cfg = get_config("egnn")
    dims = {s.name: s.dims for s in get_shapes("egnn")}
    root = tempfile.mkdtemp(prefix="gnn_train_")
    opt_cfg = AdamWConfig(lr=1e-3)
    try:
        # (a) full graph, through Trainer, a checkpoint every 2 steps
        blocks = -(-ex.n_edges // ex.block)
        fwd_formula, bwd_formula = train_launches_per_step(
            cfg.n_layers, ex.n_edges, len(ex.chunks))
        batch = {"graph": g, "exec": ex}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seg_zero()
        t0 = time.perf_counter()
        tr, seen, firsts = train_run(cfg, "full_graph", params,
                                     ConstantStream(batch), 1 + TRAIN_STEPS,
                                     os.path.join(root, "plain"),
                                     TRAIN_CKPT_EVERY)
        run_s = time.perf_counter() - t0
        full_launches, full_acc = seg_counts()
        peak = torch.cuda.max_memory_allocated()
        steps_ms = [h["time_s"] * 1e3 for h in tr.history]
        losses = [float(m["loss"]) for m in seen]
        gnorms = [float(m["grad_norm"]) for m in seen]
        lrs = [float(m["lr"]) for m in seen]
        check(full_launches == (1 + TRAIN_STEPS) * fwd_formula
              and full_acc == (1 + TRAIN_STEPS) * bwd_formula,
              f"gnn_train: {full_launches} summing and {full_acc} in-place "
              f"launches for {1 + TRAIN_STEPS} steps of {fwd_formula} and "
              f"{bwd_formula}")
        check(all(np.isfinite(losses + gnorms))
              and bool(tree_finite(tr.params)),
              f"gnn_train: a loss or gradient is not finite ({losses}, "
              f"{gnorms})")
        marks = {"trainer_run": run_s}
        t_mark = time.perf_counter()
        opt0 = init_adamw(params)
        first = firsts[0]
        del firsts
        # a profiled step from the same params and state, then the step's
        # parts (forward, backward, AdamW), with the launches of each
        prof_out, prof = profile_segments(
            lambda: gd.make_train_step(cfg, "full_graph")(params, opt0,
                                                          batch), top=10,
            op_sum="aten::add")
        peaks = {}
        _, grads, fwd_l, bwd_l = grads_of(cfg, "full_graph", params, batch,
                                          peaks)
        parts = adamw_from(opt_cfg, grads, opt0, params)
        del grads
        torch.cuda.synchronize()
        check(fwd_l == (fwd_formula, 0) and bwd_l == (0, bwd_formula),
              f"gnn_train: a step launched (summing, in-place) {fwd_l} in "
              f"the forward and {bwd_l} in the backward, the formula "
              f"({fwd_formula}, 0) and (0, {bwd_formula})")
        same_twice = trees_equal(prof_out[0], first) and trees_equal(parts,
                                                                     first)
        check(same_twice, "gnn_train: steps from the same params and state "
                          "differ in their bits")
        del prof_out, parts
        counted_run("egnn-ogbn-products.step", lambda: gd.make_train_step(
            cfg, "full_graph")(params, opt0, batch), params, opt0, g,
            engine_tensors(ex), ms=float(np.percentile(steps_ms[1:], 50)))
        marks["profiled_step_and_parts"] = time.perf_counter() - t_mark
        t_mark = time.perf_counter()
        half = LocalExec(g, GNN_CHUNK_EDGES // 2)
        half_chunks = len(half.chunks)
        hp = gd.make_train_step(cfg, "full_graph")(
            params, opt0, {"graph": g, "exec": half})[0]
        check(trees_equal(hp, first), "gnn_train: a step with half the chunk "
                                      "budget differs in its bits")
        del half, hp
        marks["half_budget_step"] = time.perf_counter() - t_mark
        t_mark = time.perf_counter()
        # restart contract: a failure at step 3 restores the step-2
        # checkpoint; at step 4 the state equals the plain run's
        fr, _, _ = train_run(cfg, "full_graph", params, ConstantStream(batch),
                             4, os.path.join(root, "faulty"),
                             TRAIN_CKPT_EVERY, fail_at=TRAIN_FAIL_AT)
        (rp, ro), rstep, _ = restore_checkpoint(
            os.path.join(root, "plain"), (params, opt0), step=4)
        restart_ok = (rstep == 4 and fr.step == 4
                      and trees_equal(fr.params, rp)
                      and trees_equal(fr.opt_state, ro))
        check(restart_ok, "gnn_train: the restarted run's state at step 4 "
                          "differs from the uninterrupted run's")
        del fr, rp, ro
        torch.cuda.empty_cache()
        marks["restart_run"] = time.perf_counter() - t_mark
        line("gnn_train", cell="egnn-ogbn-products-train",
             model=cfg.arch_id, layers=cfg.n_layers, d_hidden=cfg.d_hidden,
             dtype=cfg.dtype, nodes=g.n_nodes, edges=ex.n_edges,
             chunks=len(ex.chunks), msg_blocks=blocks, block_edges=ex.block,
             steps=1 + TRAIN_STEPS, warmup_steps=1,
             step_ms=dict(p50=float(np.percentile(steps_ms[1:], 50)),
                          p99=float(np.percentile(steps_ms[1:], 99)),
                          all=steps_ms),
             forward_ms_p50=forward_ms, trainer_run_s=run_s,
             loss=losses, grad_norm=gnorms, lr=lrs,
             peak_mem_gib=peak / 2 ** 30, step_parts_mem_gib=peaks,
             aten_add_device_ms=prof.get("aten::add*", {}).get("ms"),
             segment_sum_per_step=dict(forward=fwd_l[0], backward=bwd_l[0],
                                       formula="layers x chunks, forward"),
             in_place_per_step=dict(forward=fwd_l[1], backward=bwd_l[1],
                                    formula="layers x 2 x blocks, backward"),
             trainer_launches=dict(summing=full_launches,
                                   in_place=full_acc), step_profile=prof)
        t_mark = time.perf_counter()
        acc_kern = measure_transpose(ex)
        marks["transpose_kernel"] = time.perf_counter() - t_mark
        t_mark = time.perf_counter()

        # (b) one step on a smaller copy, card vs CPU
        f = g.feats.shape[1]
        small = gd.make_flat_graph(TRAIN_CPU_N, TRAIN_CPU_N * 25, f, seed=1)
        sb = {"graph": small}
        _, cg, _, _ = grads_of(cfg, "full_graph", params, sb)
        cpu_p = _params_to(params, "cpu")
        cb = {"graph": FlatGraph(*(t.cpu() for t in small))}
        t0 = time.perf_counter()
        _, hg, _, _ = grads_of(cfg, "full_graph", cpu_p, cb)
        cpu_step_s = time.perf_counter() - t0
        grad_err = rel_err(cg, hg)
        param_err = rel_err(
            leaves(adamw_from(opt_cfg, cg, init_adamw(params), params)),
            leaves(adamw_from(opt_cfg, hg, init_adamw(cpu_p), cpu_p)))
        check(grad_err <= GNN_CPU_RTOL and param_err <= GNN_CPU_RTOL,
              f"gnn_train: {TRAIN_CPU_N}-node step, card vs CPU: gradients "
              f"{grad_err}, new params {param_err} (relative)")
        del small, sb, cb, cg, hg
        marks["card_vs_cpu"] = time.perf_counter() - t_mark
        t_mark = time.perf_counter()

        # (c) minibatch_lg: host graph, the sampler, Trainer steps
        md = dims["minibatch_lg"]
        n_mb, e_mb = md["n_nodes"], md["n_edges"]
        t0 = time.perf_counter()
        hg_ = gd.make_flat_graph(n_mb, e_mb, MB_D_FEAT, seed=2, device="cpu")
        data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the edges in destination order (a stable sort on the card): the
        # sampler's own stable sort then meets sorted input, and its CSR,
        # draws and batches are those of the edges as drawn
        order = torch.sort(hg_.edge_dst.cuda(), stable=True).indices.cpu()
        sampler = NeighborSampler(n_mb, hg_.edge_src[order].numpy(),
                                  hg_.edge_dst[order].numpy(),
                                  hg_.feats.numpy(), hg_.labels.numpy(),
                                  seed=0)
        del order
        csr_s = time.perf_counter() - t0
        stream = SampledStream(sampler, hg_.positions.numpy())
        mparams = gd.init_model(cfg, 0, MB_D_FEAT)
        n_sub, n_edge = sizes_for_fanout(MB_FANOUTS)
        # every tree edge is valid (no node of this graph lacks in-edges)
        # and a batch is one chunk
        mb_formula = train_launches_per_step(cfg.n_layers, MB_ROOTS * n_edge,
                                             1)
        torch.cuda.reset_peak_memory_stats()
        seg_zero()
        kept = {}

        def to_card(sampled):
            kept["batch"] = minibatch_to_card(sampled)
            return kept["batch"]

        mtr, mseen, _ = train_run(cfg, "minibatch", mparams, stream, MB_STEPS,
                                  os.path.join(root, "minibatch"), MB_STEPS,
                                  to_device=to_card)
        mb_launches, mb_acc = seg_counts()
        mpeak = torch.cuda.max_memory_allocated()
        mlosses = [float(m["loss"]) for m in mseen]
        check((mb_launches, mb_acc) == tuple(MB_STEPS * f for f in mb_formula)
              and np.isfinite(mlosses + [float(m["grad_norm"])
                                         for m in mseen]).all(),
              f"gnn_train minibatch: launches {(mb_launches, mb_acc)} "
              f"(formula {MB_STEPS} x {mb_formula}), losses {mlosses}")
        mms = [h["time_s"] * 1e3 for h in mtr.history]
        line("gnn_train.minibatch", cell="egnn-minibatch-lg-train",
             host_graph=dict(nodes=n_mb, edges=e_mb, d_feat=MB_D_FEAT),
             data_s=data_s, sampler_csr_build_s=csr_s, roots=MB_ROOTS,
             fanouts=list(MB_FANOUTS), n_sub=n_sub, n_edge=n_edge,
             batch_nodes=MB_ROOTS * n_sub, batch_edges=MB_ROOTS * n_edge,
             steps=MB_STEPS, sampler_ms=stream.sample_ms,
             step_ms=dict(p50=float(np.percentile(mms[1:], 50)),
                          p99=float(np.percentile(mms[1:], 99)), all=mms),
             loss=mlosses, peak_mem_gib=mpeak / 2 ** 30,
             launches=dict(summing=mb_launches, in_place=mb_acc),
             launches_per_step=[mb_launches / MB_STEPS, mb_acc / MB_STEPS])
        del sampler, hg_, stream, mtr, mparams
        marks["minibatch_cell"] = time.perf_counter() - t_mark
        t_mark = time.perf_counter()

        # (d) one molecule step
        mo = dims["molecule"]
        molp = gd.init_model(cfg, 0, 4, n_out=1)
        mb, energy = gd.make_molecule_batch(mo["batch"], mo["n_nodes"],
                                            mo["n_edges"], seed=0)
        mstep = gd.make_train_step(cfg, "molecule")
        mbatch = {"graph": mb, "energy": energy}
        seg_zero()
        mout = mstep(molp, init_adamw(molp), mbatch)
        torch.cuda.synchronize()
        mol_launches, mol_acc = seg_counts()
        check((mol_launches, mol_acc) == train_launches_per_step(
                  cfg.n_layers, mo["batch"] * mo["n_edges"], 1)
              and bool(torch.isfinite(mout[2]["loss"]))
              and bool(tree_finite(mout[0])),
              f"gnn_train molecule: {(mol_launches, mol_acc)} launches, "
              f"loss {float(mout[2]['loss'])}")
        m50, m99 = host_ms(lambda: mstep(molp, init_adamw(molp), mbatch), 10)
        marks["molecule_cell"] = time.perf_counter() - t_mark
        line("gnn_train.checks", steps_from_same_state_bitwise=same_twice,
             half_budget_bitwise=True, half_budget_chunks=half_chunks,
             restart_at_step=TRAIN_FAIL_AT, restored_from_step=2,
             restart_bitwise=restart_ok, launches_match_formula=True,
             card_vs_cpu=dict(nodes=TRAIN_CPU_N, edges=TRAIN_CPU_N * 25,
                              grad_rel_err=grad_err,
                              new_param_rel_err=param_err,
                              tolerance_rel=GNN_CPU_RTOL,
                              cpu_grad_s=cpu_step_s),
             molecule=dict(cell="egnn-molecule-train", batch=mo["batch"],
                           n_nodes=mo["n_nodes"], n_edges=mo["n_edges"],
                           step_ms_p50=m50, step_ms_p99=m99,
                           launches_per_step=[mol_launches, mol_acc],
                           loss=float(mout[2]["loss"])),
             part_s=marks, phase_s=time.perf_counter() - phase_t0)
        return (full_launches + mb_launches + mol_launches,
                full_acc + mb_acc + mol_acc, acc_kern, kept["batch"],
                (losses[0], gnorms[0]))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def ring_grads(cfg, params, ring, mesh, ex=None):
    """(loss sums, gradients in leaf order) of the ring's training loss."""
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.models.gnn import driver as gd
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    batch = {"graph": ring} if ex is None else {"graph": ring, "exec": ex}
    loss, sums = gd.train_loss(cfg, "full_graph", live, batch, mesh)
    grads = torch.autograd.grad(loss, leaves(live))
    return {k: float(v.detach()) for k, v in sums.items()}, grads


def grid(shape, device="cuda:0"):
    """A mesh of ``device`` repeated over ``shape``: ("data",) for one
    axis, ("data", "model") for two."""
    from repro_torch.sharding import Mesh
    names = ("data",) if len(shape) == 1 else ("data", "model")
    return Mesh(np.array([device] * int(np.prod(shape)), dtype=object
                         ).reshape(shape), names)


def sums_rel(got: dict, want: dict) -> float:
    """The largest relative difference over the loss sums."""
    return max(abs(float(got[k]) - float(want[k]))
               / max(abs(float(want[k])), 1e-30) for k in want)


def ring_collectives(cfg, params, gp, ring, rex, mesh) -> None:
    """The dryrun phase's (d): one untimed ring forward at S = 4 under the
    dry run's counter. Each layer's push rotates every shard's block of
    the (N, d + 3) payload one step, rounds - 1 times: the counter's
    collective-permute bytes, over the shards, must equal rotations x
    shards x block bytes, and its count the rotations."""
    from repro_torch.models.gnn import driver as gd
    from repro_torch.roofline.trace import Counter
    with Counter() as c, torch.no_grad():
        gd.full_graph_loss(cfg, params, ring, mesh, ex=rex)
    rounds = int(ring.esrc_local.shape[1])
    shards = mesh.devices.size
    block = gp.n_nodes // shards * (cfg.d_hidden + 3) * 4
    rotations = cfg.n_layers * (rounds - 1)
    want = rotations * shards * block
    got = c.collective_total.get("collective-permute", 0.0)
    COUNTED["mesh.ring"] = dict(
        shards=shards, rounds=rounds, layers=cfg.n_layers,
        block_bytes=block, rotations=rotations, want_bytes=want,
        counted_bytes=got,
        counted_rotations=c.collective_ops["collective-permute"],
        per_device_bytes=c.collective_bytes.get("collective-permute", 0.0))
    check(got == want and c.collective_ops["collective-permute"] == rotations,
          f"mesh: the counter's ring bytes {got} ({c.collective_ops}) "
          f"against {rotations} rotations x {shards} shards x {block} bytes")


def mesh_rag_engine() -> dict:
    """``RAGEngine(mesh=)`` on the smoke phi4-mini (the reference's smoke
    config): 4 ragged requests on 2 slots over a (1, 2) grid of this card,
    the token streams equal to the engine's without a mesh."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import EngineConfig, RAGEngine
    t0 = time.perf_counter()
    cfg = smoke_config("phi4-mini-3.8b")
    params = lm.init_lm(cfg, 0, device="cuda")
    rng = np.random.default_rng(41)
    reqs = [rng.integers(0, cfg.vocab_size, int(n))
            for n in rng.integers(3, 20, 4)]
    streams = []
    for mesh in (None, grid((1, 2))):
        eng = RAGEngine(cfg, params, None,
                        EngineConfig(n_slots=2, max_seq=64), mesh,
                        device="cuda")
        for i, prompt in enumerate(reqs):
            eng.submit(i, prompt, max_new_tokens=6)
        streams.append(eng.run_to_completion())
    check(streams[0] == streams[1], f"mesh: RAGEngine over a (1, 2) grid "
                                    f"generated {streams[1]}, without a "
                                    f"mesh {streams[0]}")
    return dict(config="smoke phi4-mini-3.8b", mesh=[1, 2],
                requests=len(reqs),
                tokens=sum(len(t) for t in streams[0].values()),
                streams_equal=True, s=time.perf_counter() - t0)


def shard_layout(cfg, params, ring, mesh, n_nodes: int) -> dict:
    """One ring forward of EGNN through ``run_flat`` with a dispatch hook
    entered in each shard's thread (a ``TorchDispatchMode`` does not
    follow into the bodies' threads by itself): the node blocks each body
    gets (n_loc rows each, on its shard's device) and every tensor an
    operator returns inside it (on the shard's device, none with the
    graph's ``n_nodes`` node rows). Returns the readings and ``ok``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn import egnn
    from repro_torch.models.gnn.common import run_flat
    shards = mesh.devices.size
    n_loc = n_nodes // shards

    class Rows(TorchDispatchMode):
        def __init__(self, dev):
            super().__init__()
            self.dev, self.ops, self.bad, self.rows = dev, 0, [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.dim():
                    self.ops += 1
                    if t.device != self.dev or t.shape[0] == n_nodes:
                        self.bad.append([func.overloadpacket.__name__,
                                         list(t.shape), str(t.device)])
            return out

    per = []

    def apply_local(p, f, x, nm, lb, rex):
        dev = rex.ctx.device
        hook = Rows(dev)
        with hook:
            out = gd._ce_sums(egnn.node_logits(cfg, p, f, x, nm, rex), lb,
                              nm)
        per.append(dict(shard=rex.ctx.index, device=str(dev),
                        block_rows=[int(t.shape[0]) for t in (f, x, nm, lb)],
                        block_devices=sorted({str(t.device)
                                              for t in (f, x, nm, lb)}),
                        outputs=hook.ops, foreign_or_whole=len(hook.bad),
                        first_bad=hook.bad[:3]))
        return out

    with torch.no_grad():
        sums = run_flat(apply_local, ring, params, mesh)
    per.sort(key=lambda r: r["shard"])
    ok = (len(per) == shards and all(
        r["block_rows"] == [n_loc] * 4 and r["block_devices"] == [r["device"]]
        and r["foreign_or_whole"] == 0 and r["outputs"] > 0 for r in per))
    return dict(ok=ok, nodes=n_nodes, n_loc=n_loc, per_shard=per,
                loss_sums={k: float(v) for k, v in sums.items()})


def mesh_cards(cfg, params, g, local: dict, local_step, one_card: dict
               ) -> dict:
    """EGNN at ogbn-products with one data shard a card, over every card
    of the host (S = n): the per-shard layout (``shard_layout``), one
    timed forward and one ``make_train_step(mesh=)`` step, the loss sums
    within ``MESH_LOCAL_RTOL`` of ``LocalExec``'s (``local``) and the
    step's loss and grad norm within ``MESH_STEP_RTOL`` of ``local_step``,
    the launches held to their formulas, and each card's peak memory
    beside the one-card S = 4 peaks (``one_card``). One card: not run.
    Prints a ``[mesh.cards]`` line."""
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import RingExec, pad_to_shards, to_ring
    from repro_torch.sharding import Mesh
    from repro_torch.train.optimizer import init_adamw
    n = torch.cuda.device_count()
    if n < 2:
        res = dict(run=False, reason=f"not run: {n} card on this host",
                   cards=n)
        line("mesh.cards", **res)
        return res
    devices = [f"cuda:{i}" for i in range(n)]

    def sync():
        for i in range(n):
            torch.cuda.synchronize(i)

    def peaks():
        return [torch.cuda.max_memory_allocated(i) / 2 ** 30 for i in range(n)]

    def reset():
        for i in range(n):
            torch.cuda.reset_peak_memory_stats(i)

    t0 = time.perf_counter()
    mesh = Mesh(devices, ("data",))
    gp = pad_to_shards(g, n)
    ring = to_ring(gp, n)
    rex = RingExec.of(ring, mesh, GNN_CHUNK_EDGES)
    rex.engines
    sync()
    setup_s = time.perf_counter() - t0
    resident = [torch.cuda.memory_allocated(i) / 2 ** 30 for i in range(n)]
    seg_zero()
    layout = shard_layout(cfg, params, ring, mesh, gp.n_nodes)
    check(layout["ok"], f"mesh.cards: a shard's body held rows or tensors "
                        f"not its own: {layout['per_shard']}")
    reset()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = gd.full_graph_loss(cfg, params, ring, mesh, ex=rex)
    sync()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    fwd_peaks = peaks()
    fwd_l = seg_counts()
    per_fwd = cfg.n_layers * rex.chunk_count()
    check(fwd_l == (2 * per_fwd, 0),
          f"mesh.cards: {fwd_l} launches for 2 forwards of {per_fwd}")
    err = sums_rel(out, local)
    check(err <= MESH_LOCAL_RTOL,
          f"mesh.cards: ring loss sums {out} over {n} cards against "
          f"LocalExec's {local}: {err} > {MESH_LOCAL_RTOL}")
    reset()
    before = seg_counts()
    t0 = time.perf_counter()
    _, _, m = gd.make_train_step(cfg, "full_graph", mesh)(
        params, init_adamw(params), {"graph": ring, "exec": rex})
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_peaks = peaks()
    step_l = tuple(b - a for a, b in zip(before, seg_counts()))
    want = (per_fwd, cfg.n_layers * 2 * rex.block_count())
    check(step_l == want, f"mesh.cards step: {step_l} launches, the "
                          f"formula {want}")
    step_loss, step_gn = float(m["loss"]), float(m["grad_norm"])
    loss_err = abs(step_loss - local_step[0]) / abs(local_step[0])
    gn_err = abs(step_gn - local_step[1]) / abs(local_step[1])
    check(loss_err <= MESH_STEP_RTOL and gn_err <= MESH_STEP_RTOL,
          f"mesh.cards step: loss {step_loss} and grad norm {step_gn} "
          f"against LocalExec's {local_step}")
    res = dict(run=True, cards=n, devices=devices, smi=smi_lines(),
               padded_nodes=gp.n_nodes, setup_s=setup_s,
               resident_gib=resident,
               resident_note="cuda:0 also holds the global graph, "
                             "LocalExec's sort and the ring's arrays",
               layout=layout, forward_ms=fwd_ms, forward_peak_gib=fwd_peaks,
               loss_sums={k: float(v) for k, v in out.items()},
               rel_err_vs_local=err, step_ms=step_ms,
               step_peak_gib=step_peaks, step_launches=list(step_l),
               loss=step_loss, grad_norm=step_gn, loss_rel_err=loss_err,
               grad_norm_rel_err=gn_err, one_card_s4=one_card)
    del ring, rex, m, gp
    torch.cuda.empty_cache()
    line("mesh.cards", **res)
    return res


def phase_mesh(params, g, ex, forward_ms: float, local_step) -> tuple:
    """The mesh bodies on one controller, four shards of this card: (a)
    EGNN at ogbn-products (padded to 2,449,032 nodes) through
    ``full_graph_loss(mesh=)`` at S = 4 and on a (2, 2) grid against
    ``LocalExec``, (b) one ``make_train_step(mesh=)`` step at S = 4
    against the LocalExec step ``local_step`` = (loss, grad norm), (c) a
    16,384-node copy at S = 4 and (2, 2), card against the CPU, (d)
    DimeNet's ``ring_loss`` at full-graph-sm against its local loss, (e)
    xDeepFM's row-sharded tables on a (2, 2) grid. Each data shard's body
    runs in a thread of its own on its node blocks
    (``collectives.spmd``); (a) also profiles one S = 4 forward (the
    profiled launches beside the wrappers' counts), (c) also checks each
    shard's tensors (``shard_layout``), and with two cards or more the
    ring runs over every card (``mesh_cards``). Returns the (summing,
    in-place) kernel launches of (a)'s, (b)'s and the cards' runs."""
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.models.gnn import dimenet
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import (FlatGraph, RingExec,
                                               pad_to_shards, to_ring)
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.sharding import collectives as col
    from repro_torch.train.optimizer import init_adamw
    phase_t0 = time.perf_counter()
    cfg = get_config("egnn")
    with torch.no_grad():
        local = {k: float(v) for k, v in
                 gd.full_graph_loss(cfg, params, g, ex=ex).items()}
    gp = pad_to_shards(g, MESH_SHARDS)
    runs, launches = {}, [0, 0]
    # (a) the ring's forward at S = 4 and on the (2, 2) grid
    for shape, reps in (((MESH_SHARDS,), MESH_REPS), ((2, 2), 1)):
        mesh = grid(shape)
        t0 = time.perf_counter()
        ring = to_ring(gp, shape[0])
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rex = RingExec.of(ring, mesh, GNN_CHUNK_EDGES)
        rex.engines
        torch.cuda.synchronize()
        exec_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        seg_zero()
        times, sums = [], []
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            with torch.no_grad():
                out = gd.full_graph_loss(cfg, params, ring, mesh, ex=rex)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            sums.append(out)
        got = seg_counts()
        launches[0] += got[0]
        per_fwd = cfg.n_layers * rex.chunk_count()
        check(got == ((1 + reps) * per_fwd, 0),
              f"mesh {shape}: {got} launches for {1 + reps} forwards of "
              f"{per_fwd} (layers x shards x rounds x chunks a round)")
        bitwise = all(torch.equal(o[k], sums[0][k]) for o in sums[1:]
                      for k in o)
        check(bitwise, f"mesh {shape}: two ring forwards differ in their "
                       "bits")
        err = sums_rel(sums[-1], local)
        check(err <= MESH_LOCAL_RTOL,
              f"mesh {shape}: ring loss sums {sums[-1]} against LocalExec's "
              f"{local}: {err} > {MESH_LOCAL_RTOL}")
        timed = times[1:]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = None
        if shape == (MESH_SHARDS,):
            # one profiled forward: the bodies' threads launch, and the
            # profiler (CUPTI) sees every launch beside the wrappers' count
            with torch.no_grad():
                _, prof = profile_segments(
                    lambda: gd.full_graph_loss(cfg, params, ring, mesh,
                                               ex=rex), top=6)
            launches[0] += prof["segment_launches"]["counted"][0]
        runs["x".join(map(str, shape))] = dict(
            mesh=mesh.shape, to_ring_host_s=ring_s, exec_build_s=exec_s,
            e_cap=int(ring.esrc_local.shape[2]),
            rounds=int(ring.esrc_local.shape[1]),
            chunks_per_push=rex.chunk_count(),
            msg_blocks_per_push=rex.block_count(),
            forwards=1 + reps,
            forward_ms=dict(p50=float(np.percentile(timed, 50)),
                            p99=float(np.percentile(timed, 99)), all=times),
            peak_mem_gib=peak,
            launches=got[0], launches_per_forward=per_fwd,
            formula="layers x shards x rounds x chunks a round",
            profile=prof,
            loss_sums={k: float(v) for k, v in sums[-1].items()},
            rel_err_vs_local=err, bitwise_repeat=bitwise)
        if shape == (MESH_SHARDS,):
            ring4, ex4, mesh4 = ring, rex, mesh
        del ring, rex, sums
        torch.cuda.empty_cache()
    ring_collectives(cfg, params, gp, ring4, ex4, mesh4)
    # (b) one train step at S = 4 from the parameters of gnn_train's first
    # step
    step = gd.make_train_step(cfg, "full_graph", mesh4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seg_zero()
    col.STAGGER.update(nodes=0, seconds=0.0)
    t0 = time.perf_counter()
    _, _, m = step(params, init_adamw(params), {"graph": ring4, "exec": ex4})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    stagger = dict(col.STAGGER)
    step_l = seg_counts()
    launches[0] += step_l[0]
    launches[1] += step_l[1]
    blocks = ex4.block_count()
    check(step_l == (cfg.n_layers * ex4.chunk_count(),
                     cfg.n_layers * 2 * blocks),
          f"mesh step: {step_l} launches, the formula (layers x chunks, "
          f"layers x 2 x blocks) = ({cfg.n_layers * ex4.chunk_count()}, "
          f"{cfg.n_layers * 2 * blocks})")
    step_loss, step_gn = float(m["loss"]), float(m["grad_norm"])
    loss_err = abs(step_loss - local_step[0]) / abs(local_step[0])
    gn_err = abs(step_gn - local_step[1]) / abs(local_step[1])
    check(loss_err <= MESH_STEP_RTOL and gn_err <= MESH_STEP_RTOL,
          f"mesh step: loss {step_loss} and grad norm {step_gn} against "
          f"LocalExec's {local_step} "
          f"({loss_err}, {gn_err} > {MESH_STEP_RTOL})")
    step_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del ring4, ex4, step, m, gp
    torch.cuda.empty_cache()
    line("mesh", cell="egnn-ogbn-products-ring", model=cfg.arch_id,
         nodes=g.n_nodes, padded_nodes=g.n_nodes + (-g.n_nodes) % MESH_SHARDS,
         edges=int(g.edge_src.shape[0]), local_loss_sums=local,
         forward_ms_local_p50=forward_ms, runs=runs,
         step=dict(shards=MESH_SHARDS, step_ms=step_ms,
                   peak_mem_gib=step_peak, launches=dict(
                       summing=step_l[0], in_place=step_l[1]),
                   in_place_formula="layers x 2 x message blocks",
                   loss=step_loss, grad_norm=step_gn,
                   local_loss=local_step[0], local_grad_norm=local_step[1],
                   loss_rel_err=loss_err, grad_norm_rel_err=gn_err,
                   tolerance_rel=MESH_STEP_RTOL,
                   turn_nodes=stagger["nodes"],
                   turn_nodes_s=stagger["seconds"]))

    # (g) with two cards or more: one data shard a card
    seg_zero()
    cards = mesh_cards(cfg, params, g, local, local_step, dict(
        forward_peak_gib=runs[str(MESH_SHARDS)]["peak_mem_gib"],
        step_peak_gib=step_peak))
    launches = [a + b for a, b in zip(launches, seg_counts())]

    # (c) a 16,384-node copy, card against the CPU
    f = g.feats.shape[1]
    small = gd.make_flat_graph(MESH_CPU_N, MESH_CPU_N * 25, f, seed=1)
    cpu_small = FlatGraph(*(t.cpu() for t in small))
    cpu_p = _params_to(params, "cpu")
    cpu_checks = {}
    for shape in ((MESH_SHARDS,), (2, 2)):
        c_sums, c_grads = ring_grads(cfg, params, to_ring(small, shape[0]),
                                     grid(shape))
        if shape == (MESH_SHARDS,):
            c_sums_4 = c_sums
        h_sums, h_grads = ring_grads(cfg, cpu_p, to_ring(cpu_small, shape[0]),
                                     grid(shape, "cpu"))
        s_err, g_err = sums_rel(c_sums, h_sums), rel_err(c_grads, h_grads)
        check(s_err <= MESH_CPU_RTOL and g_err <= MESH_CPU_RTOL,
              f"mesh {shape} card vs CPU at {MESH_CPU_N} nodes: loss sums "
              f"{s_err}, gradients {g_err} > {MESH_CPU_RTOL}")
        cpu_checks["x".join(map(str, shape))] = dict(
            loss_sums_rel_err=s_err, grad_rel_err=g_err)
    layout = shard_layout(cfg, params, to_ring(small, MESH_SHARDS),
                          grid((MESH_SHARDS,)), MESH_CPU_N)
    check(layout["ok"], f"mesh: a shard's body at {MESH_CPU_N} nodes held "
                        f"rows or tensors not its own: {layout['per_shard']}")
    check(sums_rel(layout["loss_sums"], c_sums_4) <= MESH_CPU_RTOL,
          f"mesh: the hooked forward's loss sums {layout['loss_sums']} "
          f"against the ring's {c_sums_4}")
    del small, cpu_small, cpu_p

    # (d) DimeNet's line-graph ring at full-graph-sm (bonds spread), a
    # triplet cap above the largest in-degree (the ring and the local path
    # keep the same triplets: ROADMAP.md Queue 3)
    dcfg = get_config("dimenet")
    sm = {s.name: s.dims for s in get_shapes("dimenet")}["full_graph_sm"]
    dg = gd.spread_bonds(gd.make_flat_graph(sm["n_nodes"], sm["n_edges"],
                                            sm["d_feat"], seed=3))
    dparams = gd.init_model(dcfg, 0, sm["d_feat"])
    cap = int(torch.bincount(dg.edge_dst[dg.edge_mask].long()).max()) + 1
    trip = dimenet.build_triplets(dg.edge_src.cpu(), dg.edge_dst.cpu(),
                                  dg.edge_mask.cpu(), cap)
    with torch.no_grad():
        dlocal = gd.full_graph_loss(dcfg, dparams, dg, triplets=trip)
        dimenet_runs = {}
        for shape in ((2,), (2, 2)):
            ring, *tri = dimenet.build_triplet_ring(dg, shape[0], cap)
            t0 = time.perf_counter()
            got = gd.full_graph_loss(dcfg, dparams, ring, grid(shape),
                                     tuple(tri))
            torch.cuda.synchronize()
            err = sums_rel(got, dlocal)
            check(err <= MESH_LOCAL_RTOL,
                  f"mesh dimenet {shape}: ring loss sums against local "
                  f"{err} > {MESH_LOCAL_RTOL}")
            dimenet_runs["x".join(map(str, shape))] = dict(
                rel_err_vs_local=err, ms=(time.perf_counter() - t0) * 1e3,
                t_cap=int(tri[0].shape[2]))
    del dg, dparams, trip, ring, tri

    # (e) xDeepFM on a (2, 2) grid: forward bitwise, retrieval to 1e-6
    xcfg = get_config("xdeepfm")
    xshapes = {s.name: s.dims for s in get_shapes("xdeepfm")}
    xp = xdeepfm.init(xcfg, 0)
    m22 = grid((2, 2))
    ids = recsys_batch(xcfg, MESH_XDEEPFM_ROWS)["ids"]
    with torch.no_grad():
        fwd = {"none": xdeepfm.forward(xcfg, xp, ids),
               "mesh": xdeepfm.forward(xcfg, xp, ids, m22)}
        same = torch.equal(fwd["none"], fwd["mesh"])
        check(same, "mesh xdeepfm: forward over the (2, 2) grid differs from "
                    f"the unsharded forward (max |d| "
                    f"{float((fwd['none'] - fwd['mesh']).abs().max())})")
        fwd_ms = {k: cuda_ms(lambda m=m: xdeepfm.forward(xcfg, xp, ids, m),
                             3) for k, m in (("none", None), ("mesh", m22))}
        n_cand = xshapes["retrieval_cand"]["n_candidates"]
        gen = torch.Generator(device="cuda").manual_seed(47)
        cands = torch.randint(0, xcfg.vocab_per_field,
                              (n_cand, xcfg.n_sparse), device="cuda",
                              generator=gen, dtype=torch.int32)
        user = cands[n_cand // 3].clone()
        r0 = xdeepfm.retrieval_score(xcfg, xp, user, cands)
        r1 = xdeepfm.retrieval_score(xcfg, xp, user, cands, m22)
        r_err = float((r1 - r0).abs().max() / r0.abs().max())
        check(r_err <= MESH_RETRIEVAL_RTOL,
              f"mesh xdeepfm: retrieval over the grid differs by {r_err} > "
              f"{MESH_RETRIEVAL_RTOL}")
        r_ms = {k: cuda_ms(lambda m=m: xdeepfm.retrieval_score(
            xcfg, xp, user, cands, m), 3) for k, m in (("none", None),
                                                       ("mesh", m22))}
    del xp, ids, fwd, cands, r0, r1
    torch.cuda.empty_cache()
    rag_engine = mesh_rag_engine()
    line("mesh.checks", card_vs_cpu=dict(nodes=MESH_CPU_N,
                                         edges=MESH_CPU_N * 25,
                                         tolerance_rel=MESH_CPU_RTOL,
                                         **cpu_checks),
         shard_layout=layout, cards=dict(run=cards["run"],
                                         cards=cards["cards"]),
         dimenet=dict(cell="dimenet-full-graph-sm", nodes=sm["n_nodes"],
                      edges=sm["n_edges"], cap_per_edge=cap,
                      tolerance_rel=MESH_LOCAL_RTOL, **dimenet_runs),
         xdeepfm=dict(mesh=m22.shape, rows=MESH_XDEEPFM_ROWS,
                      forward_bitwise=same, forward_ms=fwd_ms,
                      candidates=n_cand, retrieval_rel_err=r_err,
                      retrieval_ms=r_ms, tolerance_rel=MESH_RETRIEVAL_RTOL),
         rag_engine=rag_engine, phase_s=time.perf_counter() - phase_t0)
    return tuple(launches)


def model_launches(cfg, ex, triplets: bool) -> dict:
    """The segment-sum (summing) launches of a forward, which are a train
    step's too, and the in-place launches of a step's backward, of ``cfg``
    on its engine ``ex``, with their formulas."""
    layers, chunks = cfg.n_layers, len(ex.chunks)
    blocks = -(-ex.n_edges // ex.block)
    if cfg.model == "nequip":
        # one push a layer: a sum per chunk; per block, the payload
        # gathers' two transposes
        return dict(forward=layers * chunks, step_in_place=layers * 2 * blocks,
                    formula="layers x chunks; layers x 2 x blocks")
    if cfg.model == "equiformer_v2":
        # push_attn: per chunk the softmax denominators' sum and the
        # messages' sum; per block the logits' two transposes and the
        # messages' source transpose (their destination rows give only a
        # position to the detached edge frame: no gradient), per chunk the
        # denominators' gather transpose
        return dict(forward=2 * layers * chunks,
                    step_in_place=layers * (3 * blocks + chunks),
                    formula="2 x layers x chunks; layers x (3 x blocks + "
                            "chunks)")
    t = int(triplets)
    # per block the edge -> node sum (and the triplet -> edge sum); the h
    # gathers' two transposes once, m's by the triplets per block
    return dict(forward=layers * (1 + t), step_in_place=2 + layers * t,
                formula="blocks x (1 + triplets); 2 + blocks x triplets")


def model_cell(cfg, cell: str, kind: str, batch, params, ex, train: bool,
               reason: str = "", reps: int = MODEL_FWD_REPS) -> dict:
    """One cell of the gnn_models phase: forward p50/p99 (the loss under
    no_grad), and with ``train`` a train step's, edges/s, peak memory,
    the launches per forward and per step held to ``model_launches``,
    one profiled step (a forward for Equiformer-v2, whose step's events
    take the profiler ~15 s to aggregate; none where no step runs:
    ``MODEL_PROFILE_CUT``). Prints a ``gnn_models`` line."""
    from repro_torch.common.tree import tree_finite
    from repro_torch.models.gnn import driver as gd
    from repro_torch.train.optimizer import init_adamw
    trip = batch.get("triplets")
    want = model_launches(cfg, ex, trip is not None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cell_t0 = time.perf_counter()

    def forward():
        with torch.no_grad():
            return gd.train_loss(cfg, kind, params, batch)

    c0 = seg_counts()
    loss, _ = forward()
    torch.cuda.synchronize()
    fl = tuple(b - a for a, b in zip(c0, seg_counts()))
    check(fl == (want["forward"], 0) and bool(torch.isfinite(loss)),
          f"gnn_models {cell}: a forward launched (summing, in-place) {fl}, "
          f"the formula ({want['forward']}, 0); loss {float(loss)}")
    f50, f99 = timed_ms(forward, reps)
    res = dict(cell=cell, model=cfg.arch_id, layers=cfg.n_layers,
               d_hidden=cfg.d_hidden, l_max=cfg.l_max, dtype=cfg.dtype,
               kind=kind, nodes=ex.n, edges=ex.n_edges,
               triplets=None if trip is None else int(trip.t_mask.sum()),
               chunks=len(ex.chunks), chunk_edges=ex.chunk_edges,
               block_edges=ex.block, loss=float(loss),
               forward_ms=dict(p50=f50, p99=f99),
               edges_per_s=ex.n_edges / (f50 * 1e-3),
               launches_per_forward=dict(summing=fl[0], in_place=fl[1]),
               launch_formula=want["formula"])
    if train:
        profile_step = cfg.model != "equiformer_v2"
        step = gd.make_train_step(cfg, kind)
        opt0 = init_adamw(params)
        c0 = seg_counts()
        out = step(params, opt0, batch)
        torch.cuda.synchronize()
        sl = tuple(b - a for a, b in zip(c0, seg_counts()))
        finite = bool(tree_finite(out[0]))
        check(sl == (want["forward"], want["step_in_place"])
              and bool(torch.isfinite(out[2]["loss"]))
              and (finite or cfg.model == "equiformer_v2"),
              f"gnn_models {cell}: a step launched (summing, in-place) {sl}, "
              f"the formula ({want['forward']}, {want['step_in_place']}); "
              f"loss {float(out[2]['loss'])}, new params finite {finite}")
        res["new_params_finite"] = finite
        del out
        s50, s99 = timed_ms(lambda: step(params, opt0, batch),
                            min(reps, MODEL_STEP_REPS))
        prof_t0 = time.perf_counter()
        _, prof = profile_segments((lambda: step(params, opt0, batch))
                                   if profile_step else forward, top=8)
        res.update(step_ms=dict(p50=s50, p99=s99),
                   launches_per_step=dict(summing=sl[0], in_place=sl[1]),
                   profiled="one train step" if profile_step
                   else "one forward")
    else:
        prof_t0 = time.perf_counter()
        prof = MODEL_PROFILE_CUT
        res.update(step_ms="not run", why_forward_only=reason,
                   profiled="none")
    res.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               cell_s=time.perf_counter() - cell_t0,
               profile_s=time.perf_counter() - prof_t0, profile=prof)
    line("gnn_models", **res)
    return res


def wigner_launches(l_max: int, rows: int) -> dict:
    """The ATen ops one ``wigner_d_from_rotation`` call runs (views not
    counted; each launches one kernel here), counted by the dispatcher,
    and its device ms, at ``rows`` edge frames."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.equivariant.spherical import (rotation_to_align_z,
                                                   wigner_d_from_rotation)

    class OpCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not getattr(func, "is_view", False):
                self.ops[str(func)] = self.ops.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))

    gen = torch.Generator(device="cuda").manual_seed(11)
    R = rotation_to_align_z(torch.randn((rows, 3), device="cuda",
                                        generator=gen))
    wigner_d_from_rotation(R, l_max)
    with OpCount() as count:
        wigner_d_from_rotation(R, l_max)
    return dict(rows=rows, launches_per_call=sum(count.ops.values()),
                ops=count.ops,
                ms_per_call=cuda_ms(lambda: wigner_d_from_rotation(R, l_max),
                                    5))


def summing_width(tag: str, msgs, rowptr, perm, flush) -> dict:
    """The summing kernel at one call's shape (fp32): against its plain
    version bit for bit, timed beside its byte bound, the plain version
    and ``index_add_`` of each message by its segment (a message no
    segment reads goes to an extra row). Prints the ``tag`` line, with
    the call's plan; returns it."""
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import segment_sum_csr_ref
    e, d = msgs.shape
    n = rowptr.numel() - 1
    out = sops.segment_sum_csr(msgs, rowptr, perm)
    want = segment_sum_csr_ref(msgs, rowptr, perm)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    check(torch.equal(out, want), f"{tag}: not bitwise equal to its plain "
                                  f"version (max |d| {err})")
    del want
    deg = (rowptr[1:] - rowptr[:-1]).long()
    pos = torch.repeat_interleave(torch.arange(n, device="cuda"), deg)
    ids = torch.full((e,), n, dtype=torch.int64, device="cuda")
    if perm is None:
        ids[:pos.numel()] = pos
    else:
        ids[perm[:pos.numel()].long()] = pos
    nbytes = (e * d * 4 + n * d * 4 + (n + 1) * 4
              + (0 if perm is None else e * 4))
    bms, bby = bound(float(e * d), nbytes)
    kms = cuda_ms(lambda: sops.segment_sum_csr(msgs, rowptr, perm, out=out),
                  10, flush)
    pms = cuda_ms(lambda: segment_sum_csr_ref(msgs, rowptr, perm), 3, flush)
    lib = torch.zeros((n + 1, d), device="cuda").index_add_(0, ids, msgs)
    torch.cuda.synchronize()
    lib_err = float((lib[:n] - out).abs().max())
    lms = cuda_ms(lambda: lib.index_add_(0, ids, msgs), 10, flush)
    res = dict(shape=dict(E=e, d=d, n=n, dtype="float32",
                          perm=perm is not None),
               plan=plan_of(msgs, rowptr, perm, out), bitwise=True,
               max_abs_err=err, ms=kms, plain_ms=pms, library_ms=lms,
               library="index_add_(0, ids, msgs) (atomics)",
               library_max_abs_diff=lib_err, bound_ms=bms, bound_by=bby,
               gbytes=nbytes / 1e9,
               achieved_tb_s=nbytes / (kms * 1e-3) / 1e12)
    line(tag, **res)
    del out, lib
    return res


def block_transposes(tag: str, ex, d: int, flush) -> dict:
    """The in-place kernel at block 0's two gather transposes of a sized
    engine, at the payload's width ``d`` (random cotangents and buffer):
    ``inplace_side`` for its sources and its destinations."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    e = min(ex.block, ex.n_edges)
    cot = torch.randn((ex.block, d), device="cuda", generator=gen)
    base = torch.randn((ex.n, d), device="cuda", generator=gen)
    src_rp, src_perm, src_rows = ex._src_csr(0)
    dst_rp, dst_lo = ex._dst_csr(0)
    out = {"source": inplace_side(f"{tag}.source", cot, e, src_rp, src_perm,
                                  src_rows, 0, ex.src[:e].long(), base,
                                  flush),
           "destination": inplace_side(f"{tag}.destination", cot, e, dst_rp,
                                       None, None, dst_lo,
                                       ex.dst[:e].long(), base, flush)}
    del cot, base
    torch.cuda.empty_cache()
    return out


def leaf_names(tree, prefix: str = "") -> list:
    """The leaves' paths of a params tree, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}.{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def nan_rel_err(got, want, floor: float = 1.0) -> float:
    """``rel_err`` that matches NaN for NaN: inf where the two leaves'
    non-finite elements differ, else the largest |got - want| over the
    finite ones, each relative to max(floor, max |want|) of its leaf."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.detach().cpu(), b.detach().cpu()
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        if not torch.equal(fa, fb):
            return float("inf")
        if bool(fb.any()):
            worst = max(worst, float((a[fb] - b[fb]).abs().max())
                        / max(floor, float(b[fb].abs().max())))
    return worst


def leaf_floor(tensors) -> float:
    """1e-6 of the largest finite |value| over all the leaves: the scale
    below which a leaf is held relative to the whole tree, not itself."""
    return 1e-6 * max(float(t[torch.isfinite(t)].abs().max())
                      for t in tensors if bool(torch.isfinite(t).any()))


def bits_equal(a, b) -> bool:
    """Two trees with the same bits (NaN for NaN)."""
    from repro_torch.common.tree import leaves

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    return all(x.dtype == y.dtype and torch.equal(bits(x), bits(y))
               for x, y in zip(leaves(a), leaves(b)))


def card_vs_cpu(cfg, mb, energy, params) -> dict:
    """The molecule batch ``mb`` (one disjoint-union graph, DimeNet with
    its triplets) at ``params``, card against CPU: the logits relative to
    max(1, max |CPU logit|); the gradients and one AdamW step's first
    moments relative to each leaf's max |CPU value| (``leaf_floor`` at
    least); the step's new params relative to max(1, max |CPU param|); the
    card's non-finite gradient leaves, none but Equiformer-v2's ln1/ln2
    (``EQV2_NONFINITE_OK``), matched NaN for NaN (``nan_rel_err``). The
    step has no warm-up and no clipping, and Adam's eps is 1e-3, so that
    its first update is a smooth function of the gradient (at 1e-8 it is
    near sign(g) where |g| is near eps)."""
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.models.gnn import dimenet
    from repro_torch.models.gnn import driver as gd
    from repro_torch.models.gnn.common import FlatGraph
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_adamw)
    cpu_p = _params_to(params, "cpu")
    cpu_mb = FlatGraph(*(t.cpu() for t in mb))
    trips = [None, None]
    if cfg.model == "dimenet":
        arrays = [t.numpy() for t in (cpu_mb.edge_src, cpu_mb.edge_dst,
                                      cpu_mb.edge_mask)]
        trips = [dimenet.build_batch_triplets(*arrays, device=dev)
                 for dev in ("cuda", "cpu")]
    logits = []
    for p, g, t in ((params, mb, trips[0]), (cpu_p, cpu_mb, trips[1])):
        u = gd.disjoint_union(g)
        with torch.no_grad():
            logits.append(gd.node_logits_local(
                cfg, p, u, None if t is None
                else gd.union_triplets(t, g.edge_src.shape[1])).cpu())
    scale = float(logits[1].abs().max())
    logit_err = float((logits[0] - logits[1]).abs().max()) / max(1.0, scale)
    _, g_card, _, _ = grads_of(cfg, "molecule", params, {
        "graph": mb, "energy": energy, "triplets": trips[0]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, g_cpu, _, _ = grads_of(cfg, "molecule", cpu_p, {
        "graph": cpu_mb, "energy": energy.cpu(), "triplets": trips[1]})
    cpu_grad_s = time.perf_counter() - t0
    bad = [n for n, g in zip(leaf_names(params), g_card)
           if not bool(torch.isfinite(g).all())]
    allowed = EQV2_NONFINITE_OK if cfg.model == "equiformer_v2" else ()
    check(all(n.rsplit(".", 1)[-1] in allowed for n in bad),
          f"gnn_models {cfg.arch_id}: non-finite gradients in {bad}")
    g_cpu = [g.cpu() for g in g_cpu]
    grad_err = nan_rel_err(g_card, g_cpu, leaf_floor(g_cpu))
    opt = AdamWConfig(lr=1e-3, eps=1e-3, warmup_steps=0, clip_norm=0.0)
    steps = []
    for p, g in ((params, g_card), (cpu_p, g_cpu)):
        it = iter(g)
        new_p, st, _ = adamw_update(opt, tree_map(lambda _: next(it), p),
                                    init_adamw(p), p)
        steps.append((leaves(new_p), [m.cpu() for m in leaves(st.mu)]))
    param_err = nan_rel_err(steps[0][0], steps[1][0])
    mu_err = nan_rel_err(steps[0][1], steps[1][1], leaf_floor(steps[1][1]))
    return dict(logit_rel_err=logit_err, logit_scale=scale,
                grad_rel_err=grad_err, new_param_rel_err=param_err,
                new_mu_rel_err=mu_err, non_finite_grad_leaves=bad,
                cpu_grad_s=cpu_grad_s)


def model_cpu_check(cfg, arch: str) -> dict:
    """(a) ``card_vs_cpu`` on 8 molecules at full width and depth, held to
    ``MODEL_CPU_RTOL``: DimeNet's on the molecules with their bonds
    spread (``driver.spread_bonds``), with its unit-sphere readings beside
    (not held)."""
    from repro_torch.models.gnn import driver as gd
    mb, energy = gd.make_molecule_batch(MODEL_CPU_MOLECULES, 30, 64, seed=7)
    params = gd.init_model(cfg, 0, 4, n_out=1)
    out = dict(molecules=MODEL_CPU_MOLECULES, tolerance_rel=MODEL_CPU_RTOL)
    if cfg.model == "dimenet":
        out["unit_sphere_not_held"] = card_vs_cpu(cfg, mb, energy, params)
        mb = gd.spread_bonds(mb)
        out["bonds"] = dict(spread=gd.SPREAD_SCALE, r_min=gd.SPREAD_R_MIN,
                            kept=float(mb.edge_mask.float().mean()))
    held = card_vs_cpu(cfg, mb, energy, params)
    worst = max(held[k] for k in ("logit_rel_err", "grad_rel_err",
                                  "new_param_rel_err", "new_mu_rel_err"))
    check(worst <= MODEL_CPU_RTOL,
          f"gnn_models {arch}: {MODEL_CPU_MOLECULES} molecules, card vs CPU: "
          f"{held} (relative; tolerance {MODEL_CPU_RTOL})")
    return dict(out, **held)


def model_bitwise(cfg, params, g, trip, budget: int = 0) -> dict:
    """(b) two forwards' logits (on the driver's engine, or at the chunk
    budget ``budget``), and a forward's at half that engine's chunk budget,
    bit for bit."""
    from repro_torch.models.gnn import driver as gd
    ex = gd.engine(cfg, g, *([budget] if budget else []))
    half = gd.engine(cfg, g, max(1, ex.chunk_edges // 2))
    with torch.no_grad():
        outs = [gd.node_logits_local(cfg, params, g, trip, ex=e)
                for e in (ex, ex, half)]
    same = torch.equal(outs[0], outs[1])
    half_same = torch.equal(outs[0], outs[2])
    check(same and half_same,
          f"gnn_models {cfg.arch_id}: forwards differ in their bits (twice: "
          f"{same}, half the chunk budget: {half_same})")
    return dict(nodes=g.n_nodes, two_forwards_bitwise=same,
                half_budget_bitwise=half_same, chunk_edges=ex.chunk_edges,
                chunks=len(ex.chunks), half_budget_chunks=len(half.chunks))


def model_step_bitwise(cfg, kind, params, batch) -> dict:
    """(c) two train steps from one state: new params, moments and loss bit
    for bit; and two gradients' leaves bit for bit (NaN for NaN: where a
    non-finite gradient makes the clipped step's every new value NaN, as
    Equiformer-v2's does, the gradients still hold each finite leaf)."""
    from repro_torch.models.gnn import driver as gd
    from repro_torch.train.optimizer import init_adamw
    step = gd.make_train_step(cfg, kind)
    opt0 = init_adamw(params)
    a, b = (step(params, opt0, batch) for _ in range(2))
    same = bits_equal(a[:2] + (a[2]["loss"],), b[:2] + (b[2]["loss"],))
    del a, b
    ga, gb = (list(grads_of(cfg, kind, params, batch)[1]) for _ in range(2))
    grads_same = bits_equal(ga, gb)
    finite = sum(bool(torch.isfinite(g).all()) for g in ga)
    check(same and grads_same,
          f"gnn_models {cfg.arch_id}: two steps from one state differ in "
          f"their bits (steps {same}, gradients {grads_same})")
    return dict(steps=same, gradients=grads_same, leaves=len(ga),
                finite_gradient_leaves=finite)


def rotation_err(cfg, params, mb, device: str) -> float:
    """The molecule batch's logits with rotated positions against without,
    relative to the largest |logit|, on ``device`` (DimeNet with the
    batch's triplets)."""
    from repro_torch.models.gnn import dimenet
    from repro_torch.models.gnn import driver as gd
    q, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    rot = torch.from_numpy(q.astype(np.float32)).to(device)
    p = _params_to(params, device)
    u = gd.disjoint_union(type(mb)(*(x.to(device) for x in mb)))
    t = None
    if cfg.model == "dimenet":
        t = gd.union_triplets(dimenet.build_batch_triplets(
            *(x.cpu().numpy() for x in (mb.edge_src, mb.edge_dst,
                                        mb.edge_mask)), device=device),
            mb.edge_src.shape[1])
    with torch.no_grad():
        l1 = gd.node_logits_local(cfg, p, u, t)
        l2 = gd.node_logits_local(
            cfg, p, u._replace(positions=u.positions @ rot.T), t)
    return float((l1 - l2).abs().max() / (l1.abs().max() + 1e-9))


def model_rotation(cfg, arch, params, mb) -> dict:
    """(d) the molecule cell's molecules rotated on the card, held to
    ``MODEL_ROT_RTOL``; DimeNet's with their bonds spread, its unit-sphere
    reading beside the CPU's (not held)."""
    from repro_torch.models.gnn import driver as gd
    out = dict(tolerance_rel=MODEL_ROT_RTOL)
    if cfg.model == "dimenet":
        out["unit_sphere_not_held"] = dict(
            rel_err=rotation_err(cfg, params, mb, "cuda"),
            cpu_rel_err=rotation_err(cfg, params, mb, "cpu"))
        mb = gd.spread_bonds(mb)
    rel = rotation_err(cfg, params, mb, "cuda")
    check(rel <= MODEL_ROT_RTOL,
          f"gnn_models {arch}: rotating the molecules moves the logits by "
          f"{rel} (relative) > {MODEL_ROT_RTOL}")
    return dict(out, rel_err=rel)


def measure_run_sums(index) -> dict:
    """The summing kernel as k-means' cluster sums at serve_1m
    (``partitioner.run_sums``, two launches a Lloyd iteration of every
    ``fit``): the phase-4 index's rows (1,048,576 × 384 fp32) by their
    nearest centroid, in runs of ``RUN_ROWS`` (perm), then the runs into
    the clusters; each through ``summing_width``. Its launches are not
    counted. Returns the two readings."""
    from repro_torch.core import partitioner
    from repro_torch.kernels.segment_reduce import ops as sops
    saved = sops.segment_sum_csr.launches
    m = index.modalities["text"]
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda").zero_
    a = partitioner.assign(m.vectors, m.ivf.centroids)
    starts, perm, run_ptr = partitioner.run_csr(a, m.ivf.centroids.shape[0])
    res = {"runs": summing_width("kernel.segment_sum.kmeans_runs", m.vectors,
                                 starts, perm, flush)}
    partials = sops.segment_sum_csr(m.vectors, starts, perm)
    res["clusters"] = summing_width("kernel.segment_sum.kmeans_clusters",
                                    partials, run_ptr, None, flush)
    torch.cuda.synchronize()
    sops.segment_sum_csr.launches = saved
    del a, starts, perm, partials
    return res


def measure_hop_degrees(index) -> dict:
    """The summing kernel as the hop operator's out-degrees on the hybrid
    graph (``traversal._push_operator``: each source's edge weights, d 1,
    summed in edge order over the graph's CSR), through ``summing_width``.
    Its launches are not counted."""
    from repro_torch.core import traversal
    from repro_torch.kernels.segment_reduce import ops as sops
    saved = sops.segment_sum_csr.launches
    g = index.graph
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda").zero_
    ew = traversal._edge_weights(g, None)[:, None].contiguous()
    res = summing_width("kernel.segment_sum.hop_degrees", ew, g.indptr, None,
                        flush)
    torch.cuda.synchronize()
    sops.segment_sum_csr.launches = saved
    return res


def phase_gnn_models(g_ogb, ex_ogb, mb_batch) -> dict:
    """NequIP, DimeNet and Equiformer-v2 at their published configs: the
    molecule, full_graph_sm and minibatch_lg cells of each (gnn_train's
    sampled batch), NequIP on phase 7's ogbn-products graph; checks (a)-(e)
    of each. Returns the launches of the cells' runs (checks not counted)
    and the kernel measurements at the new widths."""
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.equivariant.spherical import sh_dim
    from repro_torch.kernels.segment_reduce.ref import csr_from_ids
    from repro_torch.models.gnn import dimenet, nequip
    from repro_torch.models.gnn import driver as gd
    from repro_torch.sparse.segment import csr_by_row
    phase_t0 = time.perf_counter()
    dims = {s.name: s.dims for s in get_shapes("nequip")}
    sm, mo = dims["full_graph_sm"], dims["molecule"]
    g_sm = gd.make_flat_graph(sm["n_nodes"], sm["n_edges"], sm["d_feat"],
                              seed=3)
    mol, energy = gd.make_molecule_batch(mo["batch"], mo["n_nodes"],
                                         mo["n_edges"], seed=0)
    mb_graph = mb_batch["graph"]
    mb_union = gd.disjoint_union(mb_graph)
    d_mb = mb_graph.feats.shape[-1]
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda").zero_
    line("gnn_models.cut", cuts=MODEL_CUTS)
    launches = [0, 0]
    cells, checks, seg_w, acc_w = {}, {}, {}, {}

    def counted(fn):
        c0 = seg_counts()
        out = fn()
        c1 = seg_counts()
        launches[0] += c1[0] - c0[0]
        launches[1] += c1[1] - c0[1]
        return out

    for arch in MODEL_ARCHS:
        cfg = get_config(arch)
        is_dn = cfg.model == "dimenet"
        t_sm = t_mol = None
        if is_dn:
            t_sm = dimenet.build_triplets(*(t.cpu().numpy() for t in (
                g_sm.edge_src, g_sm.edge_dst, g_sm.edge_mask)))
            t_mol = dimenet.build_batch_triplets(*(t.cpu().numpy() for t in (
                mol.edge_src, mol.edge_dst, mol.edge_mask)))
        # the cells
        p_mol = gd.init_model(cfg, 0, 4, n_out=1)
        cells[f"{arch}-molecule"] = counted(lambda: model_cell(
            cfg, f"{arch}-molecule", "molecule",
            {"graph": mol, "energy": energy, "triplets": t_mol}, p_mol,
            gd.engine(cfg, gd.disjoint_union(mol)), True))
        p_sm = gd.init_model(cfg, 0, sm["d_feat"])
        ex_sm = gd.engine(cfg, g_sm)
        b_sm = {"graph": g_sm, "triplets": t_sm, "exec": ex_sm}
        cells[f"{arch}-full-graph-sm"] = counted(lambda: model_cell(
            cfg, f"{arch}-full-graph-sm", "full_graph", b_sm, p_sm, ex_sm,
            True))
        p_mb = gd.init_model(cfg, 0, d_mb)
        ex_mb = gd.engine(cfg, mb_union)
        mb_train = cfg.model != "equiformer_v2"
        cells[f"{arch}-minibatch-lg"] = counted(lambda: model_cell(
            cfg, f"{arch}-minibatch-lg", "minibatch", mb_batch, p_mb, ex_mb,
            mb_train, "" if mb_train else MODEL_CUTS[
                "equiformer-v2-minibatch-lg"],
            reps=MODEL_FWD_REPS if mb_train else MODEL_BIG_REPS))
        if cfg.model == "nequip":
            p_ogb = gd.init_model(cfg, 0, g_ogb.feats.shape[1])
            ex_n = nequip.engine(cfg, ex_ogb)
            cells["nequip-ogbn-products"] = counted(lambda: model_cell(
                cfg, "nequip-ogbn-products", "full_graph",
                {"graph": g_ogb, "exec": ex_ogb}, p_ogb, ex_n, False,
                "an inference cell: forward p50/p99 at full size",
                reps=MODEL_BIG_REPS))
        torch.cuda.empty_cache()
        # the checks (not counted)
        checks_t0 = time.perf_counter()
        ck = {"card_vs_cpu": model_cpu_check(cfg, arch)}
        b_cell, b_budget = MODEL_BITWISE[arch]
        ck["bitwise"] = dict(
            model_bitwise(cfg, *((p_mb, mb_union, None)
                                 if b_cell == "minibatch-lg"
                                 else (p_sm, g_sm, t_sm)), b_budget),
            cell=f"{arch}-{b_cell}")
        ck["two_steps_bitwise"] = model_step_bitwise(cfg, "full_graph", p_sm,
                                                     b_sm)
        ck["rotation"] = model_rotation(cfg, arch, p_mol, mol)
        # (e) the kernels at this model's widths
        if cfg.model == "nequip":
            lo, hi, e0, e1, rp = ex_n.chunks[0]
            d = cfg.d_hidden * sh_dim(cfg.l_max)
            gen = torch.Generator(device="cuda").manual_seed(41)
            msgs = torch.randn((e1 - e0, d + 1), device="cuda", generator=gen)
            seg_w[f"{arch}_{d + 1}"] = summing_width(
                f"kernel.segment_sum.{arch}", msgs, rp, None, flush)
            del msgs
            acc_w[f"{arch}_{d + 3}"] = block_transposes(
                f"kernel.segment_sum_accumulate.{arch}", ex_n, d + 3, flush)
            del p_ogb, ex_n
        elif cfg.model == "equiformer_v2":
            lo, hi, e0, e1, rp = ex_mb.chunks[0]
            d = cfg.d_hidden * sh_dim(cfg.l_max)
            gen = torch.Generator(device="cuda").manual_seed(43)
            msgs = torch.randn((e1 - e0, d), device="cuda", generator=gen)
            seg_w[f"{arch}_{d}"] = summing_width(
                f"kernel.segment_sum.{arch}", msgs, rp, None, flush)
            del msgs
            acc_w[f"{arch}_{d + 3}"] = block_transposes(
                f"kernel.segment_sum_accumulate.{arch}", ex_mb, d + 3, flush)
            ck["wigner_d"] = dict(
                wigner_launches(cfg.l_max, ex_mb.block),
                calls_per_forward="layers x 2 x blocks (the logits' and the "
                                  "messages' edge message)",
                calls_per_step="2 x that (the checkpointed blocks run "
                               "again in the backward)",
                calls={c: 2 * cfg.n_layers * -(-cells[c]["edges"]
                                               // cells[c]["block_edges"])
                       for c in cells if c.startswith(arch)})
        else:
            d = cfg.d_hidden
            ts, td, tm = t_sm
            gen = torch.Generator(device="cuda").manual_seed(47)
            contrib = torch.randn((ts.numel(), d), device="cuda",
                                  generator=gen)
            rp, perm = csr_from_ids(torch.where(tm, td, -1),
                                    g_sm.edge_src.numel())
            seg_w[f"{arch}_{d}"] = summing_width(
                f"kernel.segment_sum.{arch}", contrib, rp, perm, flush)
            rp, perm, rows = csr_by_row(ts)
            base = torch.randn((g_sm.edge_src.numel(), d), device="cuda",
                               generator=gen)
            acc_w[f"{arch}_{d}"] = {"triplet_source": inplace_side(
                f"kernel.segment_sum_accumulate.{arch}.triplet_source",
                contrib, ts.numel(), rp, perm, rows, 0, ts.long(), base,
                flush)}
            del contrib, base
        line("gnn_models.checks", arch=arch,
             checks_s=time.perf_counter() - checks_t0, **ck)
        checks[arch] = ck
        del p_mol, p_sm, p_mb, ex_sm, ex_mb, b_sm
        torch.cuda.empty_cache()
    line("gnn_models.launches", summing=launches[0], in_place=launches[1],
         phase_s=time.perf_counter() - phase_t0)
    return dict(launches=launches, segment_widths=seg_w,
                accumulate_widths=acc_w)


def lm_train_flops(cfg, seqs: int, seq: int) -> float:
    """A train step's FLOPs with remat: 6·N per token (the tied embedding
    counted once, as the logits' weight), the attention's 12·L·S²·D per
    sequence (forward and backward, the full S × S the port computes), and
    one more forward of the rematerialised layers (2·N_layer per token and
    4·L·S²·D per sequence)."""
    n = cfg.param_count()
    emb = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    tokens = seqs * seq
    per_layer_attn = seq * seq * cfg.n_heads * cfg.resolved_head_dim * seqs
    layers = cfg.n_layers - cfg.first_dense_layers
    return (6.0 * n * tokens + 12.0 * cfg.n_layers * per_layer_attn
            + 2.0 * (n - emb) * layers / cfg.n_layers * tokens
            + 4.0 * layers * per_layer_attn)


def lm_batch(cfg, accum: int, micro: int, seq: int, step: int = 0):
    """The LM stream's batch ``step`` (the port's ``SyntheticLMStream``),
    shaped (accum, micro, seq) when accum > 1."""
    from repro_torch.data.pipeline import SyntheticLMStream
    b = SyntheticLMStream(cfg.vocab_size, accum * micro, seq,
                          seed=0).batch_at(step)
    shape = (accum, micro, seq) if accum > 1 else (micro, seq)
    return {k: torch.from_numpy(v.reshape(shape)).to("cuda")
            for k, v in b.items()}


def tree_clone(tree):
    from repro_torch.common.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


def leaf_rel_errs(got, want, floor_one: bool) -> float:
    """The largest |got - want| over the pairs of leaves, each relative to
    its leaf's largest |want| (to max(1, that) with ``floor_one``)."""
    from repro_torch.common.tree import leaves
    worst = 0.0
    for a, b in zip(leaves(got), leaves(want)):
        b = b.cpu()
        scale = float(b.abs().max())
        scale = max(1.0, scale) if floor_one else max(scale, 1e-30)
        worst = max(worst, float((a.cpu() - b).abs().max()) / scale)
    return worst


def inplace_reading(tag: str, flat: torch.Tensor, d: int, n_rows: int,
                    dtype: torch.dtype, seed: int, library: str) -> dict:
    """The in-place kernel at a row gather's transpose: the gather of
    ``flat``'s rows gets a random cotangent (flat.numel() × d, ``dtype``),
    added in place into a random (n_rows, d) buffer over its distinct rows;
    against its plain version bit for bit (into the same buffer), timed
    beside a bound that counts the cotangent, perm, offsets and rows once
    and each touched row read once and written once, its plain version and
    ``library`` ("index_put_" with accumulate, or "index_add_") into the
    same buffer in place. Prints the ``tag`` line; returns it. The kernel's
    launch count is left as it was."""
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.kernels.segment_reduce.ref import (
        segment_sum_csr_accumulate_ref)
    from repro_torch.sparse.segment import csr_by_row
    gen = torch.Generator(device="cuda").manual_seed(seed)
    e = flat.numel()
    cot = torch.randn((e, d), device="cuda", generator=gen).to(dtype)
    base = torch.randn((n_rows, d), device="cuda", generator=gen).to(dtype)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda").zero_
    rowptr, perm, rows = csr_by_row(flat)
    r = rows.numel()
    saved = sops.segment_sum_csr_accumulate.launches
    out = sops.segment_sum_csr_accumulate(cot, rowptr, perm, out=base.clone(),
                                          rows=rows)
    ref = segment_sum_csr_accumulate_ref(cot, rowptr, perm, out=base.clone(),
                                         rows=rows)
    idx = flat.long()
    if library == "index_put_":
        lib_fn = lambda buf: buf.index_put_((idx,), cot,      # noqa: E731
                                            accumulate=True)
        lib_name = ("index_put_((ids,), cot, accumulate=True) into the same "
                    "buffer, in place")
    else:
        lib_fn = lambda buf: buf.index_add_(0, idx, cot)       # noqa: E731
        lib_name = ("index_add_(0, ids, cot) into the same buffer, in place "
                    "(atomics)")
    lib = lib_fn(base.clone())
    torch.cuda.synchronize()
    same = torch.equal(out, ref)
    err = float((out.float() - ref.float()).abs().max())
    check(same, f"{tag}: the in-place kernel is not bitwise equal to its "
                f"plain version (max |d| {err})")
    lib_err = float((lib.float() - out.float()).abs().max())
    es = cot.element_size()
    nbytes = e * d * es + e * 4 + (r + 1) * 4 + r * 4 + 2 * r * d * es
    bms, bby = bound(float(e * d + r * d), nbytes)
    kms = cuda_ms(lambda: sops.segment_sum_csr_accumulate(
        cot, rowptr, perm, out=out, rows=rows), 20, flush)
    pms = cuda_ms(lambda: segment_sum_csr_accumulate_ref(
        cot, rowptr, perm, out=ref, rows=rows), 5, flush)
    lms = cuda_ms(lambda: lib_fn(lib), 20, flush)
    sops.segment_sum_csr_accumulate.launches = saved
    res = dict(shape=dict(E=e, d=d, rows=r, n=n_rows,
                          dtype=str(dtype).removeprefix("torch."),
                          perm=True),
               plan=sops.accumulate_plan(cot, rowptr, perm, out)._asdict(),
               max_abs_err=err, bitwise=same,
               ms=kms, plain_ms=pms, library_ms=lms, library=lib_name,
               library_max_abs_diff=lib_err, bound_ms=bms, bound_by=bby,
               gbytes=nbytes / 1e9,
               achieved_tb_s=nbytes / (kms * 1e-3) / 1e12)
    line(tag, **res)
    del out, ref, lib, base, cot
    torch.cuda.empty_cache()
    return res


def measure_token_transpose(tokens: torch.Tensor, d: int, n_rows: int):
    """The token lookup's transpose at the train step's shape: one
    micro-batch's cotangent (tokens × d, bf16) added in place into an
    (n_rows, d) bf16 gradient over its distinct tokens
    (``inplace_reading``, beside ``index_put_(accumulate=True)``)."""
    return inplace_reading("kernel.segment_sum_accumulate.token",
                           tokens.reshape(-1), d, n_rows, torch.bfloat16, 41,
                           "index_put_")


def lm_cpu_check(name: str, cfg, seed: int, accum: int, micro: int):
    """One train step of ``cfg`` (fp32) on the card and on the CPU from the
    same params: loss, grad norm, new params and moments compared (the
    router's near-ties, where a MoE model's routing may flip, are checked
    first and such a case is not compared, with a warning)."""
    from repro_torch.layers import moe
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.common.tree import tree_map
    params = lm.init_lm(cfg, seed, device="cuda")
    cpu_p = tree_map(lambda t: t.to("cpu", copy=True), params)
    batch = lm_batch(cfg, accum, micro, LM_CPU_SEQ, step=seed)
    cpu_b = {k: v.cpu() for k, v in batch.items()}
    gap = float("inf")
    if cfg.moe:
        routings = []
        with torch.no_grad():
            for t in batch["tokens"].reshape(-1, micro, LM_CPU_SEQ):
                lm.forward(cfg, params, t, moe_routings=routings)
        gap = float(torch.stack([moe.near_tie_gap(r) for r in routings]).min())
    # eps 1e-3: Adam's first update is then a smooth function of the
    # gradient (at 1e-8 it is near sign(g) where |g| is near eps)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, eps=1e-3)
    opts = lm.ExecOpts(q_block=64)
    step = lm.make_train_step(cfg, None, opts, ocfg, grad_accum=accum)
    cp, co, cm = step(params, init_adamw(params), batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hp, ho, hm = step(cpu_p, init_adamw(cpu_p), cpu_b)
    cpu_s = time.perf_counter() - t0
    res = dict(cell=name, layers=cfg.n_layers, seq=LM_CPU_SEQ,
               grad_accum=accum, micro_batch=micro, router_gap=gap,
               cpu_step_s=cpu_s, tolerance_rel=LM_CPU_RTOL)
    if gap < NEAR_TIE:
        print(f"chip_smoke: warning: {name}: router near-tie {gap:.2e} < "
              f"{NEAR_TIE}: card vs CPU not compared", flush=True)
        res["compared"] = False
        return res
    loss_err = abs(float(cm["loss"]) - float(hm["loss"])) / abs(
        float(hm["loss"]))
    gn_err = abs(float(cm["grad_norm"]) - float(hm["grad_norm"])) / abs(
        float(hm["grad_norm"]))
    p_err = leaf_rel_errs(cp, hp, True)
    m_err = max(leaf_rel_errs(co.mu, ho.mu, False),
                leaf_rel_errs(co.nu, ho.nu, False))
    check(max(loss_err, gn_err, p_err, m_err) <= LM_CPU_RTOL,
          f"lm_train {name}, card vs CPU: loss {loss_err}, grad norm "
          f"{gn_err}, params {p_err}, moments {m_err} (relative)")
    res.update(compared=True, loss=float(cm["loss"]), loss_rel_err=loss_err,
               grad_norm_rel_err=gn_err, new_param_rel_err=p_err,
               moment_rel_err=m_err)
    return res


def lm_bitwise_check(cfg, seed: int, accum: int, micro: int) -> bool:
    """Two runs of one bf16 step from the same params and state: params,
    moments and loss with the same bits."""
    from repro_torch.common.tree import leaves
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    params = lm.init_lm(cfg, seed, device="cuda")
    state = init_adamw(params)
    batch = lm_batch(cfg, accum, micro, LM_CPU_SEQ, step=seed)
    step = lm.make_train_step(cfg, None, lm.ExecOpts(q_block=64),
                              AdamWConfig(lr=1e-3, warmup_steps=1),
                              grad_accum=accum)
    outs = [step(tree_clone(params), tree_clone(state), batch)
            for _ in range(2)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(
        leaves(outs[0][:2]) + [outs[0][2]["loss"]],
        leaves(outs[1][:2]) + [outs[1][2]["loss"]]))


def lm_trainer_restart(cfg, root: str) -> dict:
    """The Trainer with the LM step: 4 steps with a checkpoint every 2 (and
    the Trainer's own at the end); a run whose step 3 fails restores the
    step-2 checkpoint and must equal the uninterrupted run at step 4, bit
    for bit. The uninterrupted run
    keeps its step-4 state in memory (its directory is removed before the
    restarted run, so two checkpoints at most are on disk)."""
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def to_device(b):
        return {k: torch.from_numpy(v.reshape(2, 1, LM_CKPT_SEQ)).to("cuda")
                for k, v in b.items()}

    def run(total, d, fail_at=None):
        params = lm.init_lm(cfg, 5, device="cuda")
        step = lm.make_train_step(cfg, None, lm.ExecOpts(q_block=256),
                                  AdamWConfig(lr=1e-3, warmup_steps=1),
                                  grad_accum=2)
        tcfg = TrainerConfig(total_steps=total,
                             checkpoint_every=TRAIN_CKPT_EVERY,
                             checkpoint_dir=d, log_every=1)
        tr = Trainer(tcfg, step, SyntheticLMStream(cfg.vocab_size, 2,
                                                   LM_CKPT_SEQ, seed=3),
                     params, init_adamw(params), to_device)
        injected = {"n": 0}

        def inject(s):
            if s == fail_at and not injected["n"]:
                injected["n"] = 1
                raise RuntimeError(f"injected failure at step {s}")

        t0 = time.perf_counter()
        tr.run(fail_injector=inject if fail_at is not None else None)
        return tr, time.perf_counter() - t0

    from repro_torch.common.tree import leaves
    seg_zero()
    plain, plain_s = run(TRAIN_FAIL_AT + 1, os.path.join(root, "plain"))
    ckpt_bytes = dir_bytes(os.path.join(root, "plain"))
    shutil.rmtree(os.path.join(root, "plain"), ignore_errors=True)
    faulty, faulty_s = run(TRAIN_FAIL_AT + 1, os.path.join(root, "faulty"),
                           TRAIN_FAIL_AT)
    launches = seg_counts()[1]
    same = (faulty.step == plain.step == TRAIN_FAIL_AT + 1
            and all(torch.equal(a, b) for a, b in zip(
                leaves((faulty.params, faulty.opt_state)),
                leaves((plain.params, plain.opt_state)))))
    check(same, "lm_train: the restarted run's state at step 4 differs "
                "from the uninterrupted run's")
    shutil.rmtree(os.path.join(root, "faulty"), ignore_errors=True)
    return dict(steps=TRAIN_FAIL_AT + 1, restart_at_step=TRAIN_FAIL_AT,
                restored_from_step=2, restart_bitwise=same, seq=LM_CKPT_SEQ,
                vocab=cfg.vocab_size,
                grad_accum=2, plain_run_s=plain_s, restarted_run_s=faulty_s,
                checkpoint_dir_gb=ckpt_bytes / 1e9,
                losses=[h["loss"] for h in plain.history],
                launches=launches)


def phase_lm_train() -> tuple:
    """LM training (phi4-mini, the reference's ``make_train_step``
    semantics): (a) full width and depth, train_4k's sequence, micro-batch
    1 x grad_accum 4, one warm-up and 2 timed steps, one micro-batch's
    step profiled; the token transpose at its shape; (b) 1-layer
    full-width copies of
    phi4-mini and DeepSeek-V2-Lite (its MLA + MoE layer) with the
    vocabulary cut to LM_CHECK_VOCAB, one fp32 step each, card against
    CPU; (c) their bf16 twins, two runs of one step bitwise; (d) the
    Trainer's restart with checkpoints on the phi4-mini copy; (e) the
    launcher as a child process. Returns (the in-place kernel's launches of (a)'s and
    (d)'s runs, the token transpose's measurement)."""
    from repro_torch.common.tree import leaves, tree_finite
    from repro_torch.configs import get_config
    from repro_torch.kernels.segment_reduce import ops as sops
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    phase_t0 = time.perf_counter()
    cfg = get_config("phi4-mini-3.8b")
    # (a) full width and depth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gib = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, 0, device="cuda")
    state = init_adamw(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gib = torch.cuda.memory_allocated() / 2 ** 30 - held_gib
    opts = lm.ExecOpts(remat=True, q_block=1024)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=100, schedule="cosine")
    step = lm.make_train_step(cfg, None, opts, ocfg, grad_accum=LM_ACCUM)
    batches = [lm_batch(cfg, LM_ACCUM, 1, LM_SEQ, step=s)
               for s in range(2 + LM_STEPS)]
    seg_zero()
    steps_ms, metrics = [], []
    for s in range(1 + LM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[s])
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    main_launches = seg_counts()[1]
    check(main_launches == (1 + LM_STEPS) * LM_ACCUM,
          f"lm_train: the token transpose launched {main_launches} times in "
          f"{1 + LM_STEPS} steps of {LM_ACCUM} micro-batches")
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    check(bool(np.isfinite(losses + gnorms).all())
          and bool(tree_finite(params)),
          f"lm_train: a loss, grad norm or param is not finite ({losses}, "
          f"{gnorms})")
    # the profile holds one micro-batch's step (1 x 4,096 tokens and the
    # update): a whole step's events took the profiler 50.7 s to aggregate
    # on an H100, cut for the dryrun phase
    one_mb = lm.make_train_step(cfg, None, opts, ocfg)
    mb_batch = {k: v[0] for k, v in batches[-1].items()}
    prof_t0 = time.perf_counter()
    _, prof = profile_once(lambda: one_mb(params, state, mb_batch), top=10,
                           share_of=("segment_accumulate_kernel",),
                           ops_top=8)
    prof["profile_s"] = time.perf_counter() - prof_t0
    prof["window"] = ("one micro-batch's step: 1 x 4,096 tokens, its "
                      "backward and the AdamW update")
    prof_launches = seg_counts()[1] - main_launches
    timed = steps_ms[1:]
    p50 = float(np.percentile(timed, 50))
    counted_run("phi4-mini-train-4k", lambda: step(params, state,
                                                   batches[-1]),
                params, state, batches[-1], ms=p50)
    tokens = LM_ACCUM * LM_SEQ
    flops = lm_train_flops(cfg, LM_ACCUM, LM_SEQ)
    line("lm_train", cell="phi4-mini-train-4k", model=cfg.arch_id,
         layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
         dtype=cfg.dtype, params=cfg.param_count(), seq=LM_SEQ,
         micro_batch=1, grad_accum=LM_ACCUM, global_batch=LM_ACCUM,
         cut=LM_CUT, remat=opts.remat, q_block=opts.q_block,
         init_s=init_s, held_before_gib=held_gib, state_gib=state_gib,
         warmup_steps=1,
         step_ms=dict(p50=p50, p99=float(np.percentile(timed, 99)),
                      all=steps_ms),
         tokens_per_s=tokens / (p50 * 1e-3), tflops_per_step=flops / 1e12,
         mfu=flops / (p50 * 1e-3) / PEAK_BF16_TC_FLOPS,
         mfu_of="989 TFLOP/s dense bf16 (H100 SXM data sheet)",
         peak_mem_gib=peak / 2 ** 30, loss=losses, grad_norm=gnorms,
         lr=[float(m["lr"]) for m in metrics],
         token_transpose_per_step=main_launches / (1 + LM_STEPS),
         profiled_step_token_transposes=prof_launches, step_profile=prof)
    token_kern = measure_token_transpose(batches[0]["tokens"][0], cfg.d_model,
                                         cfg.vocab_size)
    del params, state, batches, metrics, step
    torch.cuda.empty_cache()

    marks = {"main_cell": time.perf_counter() - phase_t0}
    t_mark = time.perf_counter()
    # (b) card vs CPU, fp32, 1 layer at full width
    one = cfg.replace(n_layers=1, vocab_size=LM_CHECK_VOCAB)
    dsv2 = get_config(DSV2).replace(n_layers=1, first_dense_layers=0,
                                    vocab_size=LM_CHECK_VOCAB)
    cpu = [lm_cpu_check("phi4-mini-1l", one.replace(dtype="float32"), 1, 2, 1),
           lm_cpu_check("deepseek-v2-lite-1l", dsv2.replace(dtype="float32"),
                        2, 1, 2)]
    torch.cuda.empty_cache()
    marks["card_vs_cpu"] = time.perf_counter() - t_mark
    t_mark = time.perf_counter()
    # (c) their bf16 twins, two runs of one step
    bitwise = {"phi4-mini-1l": lm_bitwise_check(one, 1, 2, 1),
               "deepseek-v2-lite-1l": lm_bitwise_check(dsv2, 2, 1, 2)}
    check(all(bitwise.values()),
          f"lm_train: two runs of one bf16 step differ in their bits "
          f"({bitwise})")
    torch.cuda.empty_cache()
    marks["bitwise_twins"] = time.perf_counter() - t_mark
    t_mark = time.perf_counter()
    # (d) the Trainer's restart with checkpoints
    root = tempfile.mkdtemp(prefix="lm_train_")
    try:
        free = shutil.disk_usage(root).free
        check(free >= LM_CKPT_MIN_FREE,
              f"lm_train: {free / 1e9:.1f} GB free under {root}, the "
              f"Trainer check needs {LM_CKPT_MIN_FREE / 1e9:.0f}")
        restart = lm_trainer_restart(one, root)
        torch.cuda.empty_cache()
        marks["trainer_restart"] = time.perf_counter() - t_mark
        # (e) the launcher, as a user runs it, in a child process
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "phi4-mini-3.8b", "--steps", "2", "--ckpt-dir",
             os.path.join(root, "launch")], env=env, capture_output=True,
            text=True, timeout=600)
        launch_s = time.perf_counter() - t0
        marks["launcher_child"] = launch_s
    finally:
        shutil.rmtree(root, ignore_errors=True)
    final = re.findall(r"final loss: (\S+)", child.stdout)
    check(child.returncode == 0 and final and np.isfinite(float(final[-1])),
          f"lm_train: the launcher exited {child.returncode}, stdout "
          f"{child.stdout[-500:]!r}, stderr {child.stderr[-1500:]!r}")
    line("lm_train.checks", card_vs_cpu=cpu, two_runs_bitwise=bitwise,
         trainer=restart, launcher=dict(
             command="python -m repro_torch.launch.train --arch "
                     "phi4-mini-3.8b --steps 2", exit=child.returncode,
             final_loss=float(final[-1]), wall_s=launch_s),
         left_out="a full-depth checkpoint (46 GB of host copy and disk "
                  "writes); the Trainer runs on the 1-layer copy with the "
                  f"vocabulary cut to {LM_CHECK_VOCAB:,}",
         part_s=marks, phase_s=time.perf_counter() - phase_t0)
    return main_launches + restart["launches"], token_kern


def recsys_flops(cfg, rows: int, kind: str) -> dict:
    """FLOPs of ``rows`` examples by the reference dry run's formula
    (src/repro/launch/dryrun.py:363): per example 2·p·m·D·H for each CIN
    layer and 2·d_in·h for each MLP layer, times 3 for a train step
    (forward and backward); 2·F·D a retrieval candidate. ``executed`` adds
    what a port train step also runs: the checkpointed CIN forward
    again."""
    m, d = cfg.n_sparse, cfg.embed_dim
    prev, cin = m, 0
    for h in cfg.cin_layers:
        cin += 2 * prev * m * d * h
        prev = h
    d_in, mlp = m * d, 0
    for h in cfg.mlp_layers:
        mlp += 2 * d_in * h
        d_in = h
    if kind == "retrieval":
        return {"model": 2.0 * m * d * rows, "executed": 2.0 * m * d * rows}
    model = float((cin + mlp) * rows * (3 if kind == "train" else 1))
    return {"model": model,
            "executed": model + (cin * rows if kind == "train" else 0)}


def recsys_batch(cfg, rows: int, step: int = 0) -> dict:
    """Batch ``step`` of the port's ``SyntheticRecsysStream(seed=0)`` on
    the card."""
    from repro_torch.data.pipeline import SyntheticRecsysStream
    b = SyntheticRecsysStream(cfg.n_sparse, cfg.vocab_per_field, rows,
                              seed=0).batch_at(step)
    return {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}


def leaf_errs(names, got, want, floor: float = 0.0) -> dict:
    """Per leaf: [max |got - want|, that over max(floor, max |want|)]."""
    out = {}
    for n, a, b in zip(names, got, want):
        d = float((a.detach().cpu() - b.detach()).abs().max())
        out[n] = [d, d / max(floor, float(b.abs().max()), 1e-30)]
    return out


def recsys_cpu_check(cfg, params, ocfg) -> dict:
    """(a): the forward and one AdamW train step on RECSYS_CPU_ROWS rows
    of the stream, on the card and on a CPU copy of the same params:
    logits, loss, every gradient leaf and every new param, each within
    RECSYS_CPU_RTOL of its leaf's largest |value| (max(1, ...) for the
    params)."""
    from repro_torch.common.tree import leaves, tree_map
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.train.optimizer import init_adamw
    t0 = time.perf_counter()
    batch = recsys_batch(cfg, RECSYS_CPU_ROWS, step=0)
    hp = tree_map(lambda t: t.cpu(), params)
    hb = {k: v.cpu() for k, v in batch.items()}
    names = sorted(params)
    with torch.no_grad():
        logits = leaf_errs(["logits"], [xdeepfm.forward(cfg, params,
                                                        batch["ids"])],
                           [xdeepfm.forward(cfg, hp, hb["ids"])])["logits"]
    losses, grads = [], []
    for p, b in ((params, batch), (hp, hb)):
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        loss, _ = xdeepfm.loss_fn(cfg, live, b)
        grads.append(torch.autograd.grad(loss, leaves(live)))
        losses.append(loss.detach())
    loss = leaf_errs(["loss"], losses[:1], losses[1:])["loss"]
    grad = leaf_errs(names, *grads)
    step = xdeepfm.make_train_step(cfg, ocfg)
    dp = step(params, init_adamw(params), batch)[0]
    new = leaf_errs(names, leaves(dp), leaves(step(hp, init_adamw(hp),
                                                   hb)[0]), floor=1.0)
    worst = max([logits[1], loss[1]] + [v[1] for v in grad.values()]
                + [v[1] for v in new.values()])
    check(worst <= RECSYS_CPU_RTOL,
          f"recsys: card against CPU {worst} > {RECSYS_CPU_RTOL} (logits "
          f"{logits}, loss {loss}, grads {grad}, new params {new})")
    return dict(rows=RECSYS_CPU_ROWS, tolerance_rel=RECSYS_CPU_RTOL,
                logits=logits, loss=loss, grad=grad, new_params=new,
                worst_rel=worst, s=time.perf_counter() - t0)


def recsys_bag_reading(tables: torch.Tensor) -> tuple:
    """(f)'s summing kernel through ``embedding_bag(mode="sum")``: bags of
    1-40 ids (sorted bag ids, as EmbeddingBag's offsets give them) over
    field 0, the path's call against the same call on the CPU (the plain
    versions) bit for bit, the call timed; then ``summing_width`` at its
    shape. Returns (the path call's summing launches, the reading)."""
    from repro_torch.kernels.segment_reduce.ref import csr_from_ids
    from repro_torch.models.recsys.embedding_bag import embedding_bag
    gen = torch.Generator(device="cuda").manual_seed(43)
    n = RECSYS_BAGS
    sizes = torch.randint(1, 41, (n,), device="cuda", generator=gen)
    bags = torch.repeat_interleave(torch.arange(n, device="cuda"),
                                   sizes).to(torch.int32)
    flat = torch.randint(0, tables.shape[1], (bags.numel(),), device="cuda",
                         generator=gen, dtype=torch.int32)
    before = seg_counts()[0]
    out = embedding_bag(tables, flat, bags, n, 0, "sum")
    launches = seg_counts()[0] - before
    check(launches == 1, f"recsys: embedding_bag(mode='sum') launched the "
                         f"summing kernel {launches} times, not once")
    want = embedding_bag(tables[:1].cpu(), flat.cpu(), bags.cpu(), n, 0,
                         "sum")
    same = torch.equal(out.cpu(), want)
    check(same, f"recsys: embedding_bag on the card differs from the CPU "
                f"(max |d| {float((out.cpu() - want).abs().max())})")
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda").zero_
    call_ms = cuda_ms(lambda: embedding_bag(tables, flat, bags, n, 0, "sum"),
                      10, flush)
    rows = tables[0].index_select(0, flat.long())
    rowptr, perm = csr_from_ids(bags, n)
    res = summing_width("kernel.segment_sum.recsys_bag", rows, rowptr, perm,
                        flush)
    res.update(bags=n, ids=int(flat.numel()), bag_sizes="1-40 uniform",
               embedding_bag_ms=call_ms, embedding_bag_bitwise_cpu=same)
    del out, rows
    return launches, res


def phase_recsys() -> tuple:
    """xDeepFM at its published config (F 39, V 100,000, D 10, CIN 3 x
    200, MLP 2 x 400, fp32, seeded random weights, data from
    ``SyntheticRecsysStream(seed=0)``) on the reference's four shapes:
    (a) card against CPU; (b) two train steps from one state bit for bit;
    (c) train_batch: step p50/p99 after a warm-up, examples/s, FLOP share,
    peak memory, one profiled step, in-place launches a step; (d)
    serve_p99 and serve_bulk forwards, the 512 rows against the same rows
    inside the bulk batch; (e) retrieval_cand with a planted copy of the
    user; (f) the in-place kernel at the tables' and linear_w's
    transposes, the summing kernel through embedding_bag. Returns (the
    summing kernel's launches, the in-place kernel's, the readings)."""
    from repro_torch.common.tree import leaves, tree_finite
    from repro_torch.configs import get_config, get_shapes
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.models.recsys.embedding_bag import flat_ids
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    phase_t0 = time.perf_counter()
    cfg = get_config("xdeepfm")
    shapes = {s.name: s for s in get_shapes("xdeepfm")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = xdeepfm.init(cfg, 0, device="cuda")
    state = init_adamw(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1000)
    step = xdeepfm.make_train_step(cfg, ocfg)
    cpu = recsys_cpu_check(cfg, params, ocfg)
    torch.cuda.empty_cache()

    # (c) train_batch: one warm-up and RECSYS_STEPS timed steps
    rows = shapes["train_batch"]["batch"]
    batches = [recsys_batch(cfg, rows, s) for s in range(1 + RECSYS_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seg_zero()
    steps_ms, metrics = [], []
    for s in range(1 + RECSYS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[s])
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    sum_launches, acc_launches = seg_counts()
    check(sum_launches == 0 and acc_launches == 2 * (1 + RECSYS_STEPS),
          f"recsys: {1 + RECSYS_STEPS} train steps launched the summing "
          f"kernel {sum_launches} times and the in-place one {acc_launches} "
          f"(2 a step: the tables' and linear_w's transposes)")
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    check(bool(np.isfinite(losses).all()) and bool(tree_finite(params)),
          f"recsys: a loss or param is not finite ({losses})")
    # (b) two steps from one state
    a = step(params, state, batches[0])
    b = step(params, state, batches[0])
    bitwise = bits_equal(a[:2], b[:2]) and torch.equal(a[2]["loss"],
                                                       b[2]["loss"])
    check(bitwise, "recsys: two train steps from one state differ in their "
                   "bits")
    del a, b
    _, prof = profile_segments(lambda: step(params, state, batches[-1]),
                               top=8, ops_top=8)
    timed = steps_ms[1:]
    p50 = float(np.percentile(timed, 50))
    counted_run("xdeepfm-train-batch", lambda: step(params, state,
                                                    batches[-1]),
                params, state, batches[-1], ms=p50)
    flops = recsys_flops(cfg, rows, "train")
    train = dict(
        rows=rows, warmup_steps=1, step_ms=dict(
            p50=p50, p99=float(np.percentile(timed, 99)), all=steps_ms),
        examples_per_s=rows / (p50 * 1e-3),
        tflops_per_step=flops["model"] / 1e12,
        tflops_executed_per_step=flops["executed"] / 1e12,
        flop_share=flops["model"] / (p50 * 1e-3) / PEAK_FP32_FLOPS,
        executed_flop_share=flops["executed"] / (p50 * 1e-3)
        / PEAK_FP32_FLOPS,
        flops_formula="src/repro/launch/dryrun.py:363: per example "
                      "sum 2*p*m*D*H (CIN) + sum 2*d_in*h (MLP), x3 a train "
                      "step; executed adds the checkpointed CIN forward",
        flop_share_of="67 TFLOP/s fp32 (H100 SXM data sheet; TF32 off)",
        peak_mem_gib=peak / 2 ** 30, loss=losses,
        acc=[float(m["acc"]) for m in metrics],
        grad_norm=[float(m["grad_norm"]) for m in metrics],
        inplace_launches_per_step=acc_launches / (1 + RECSYS_STEPS),
        inplace_formula="2 a step: one gather for the tables, one for "
                        "linear_w, each transposed by one launch",
        step_profile=prof)
    flat = flat_ids(batches[0]["ids"], cfg.vocab_per_field)
    del batches, metrics
    torch.cuda.empty_cache()

    # (d) serve_p99 and serve_bulk forwards; (e) retrieval_cand
    bulk_rows = shapes["serve_bulk"]["batch"]
    small_rows = shapes["serve_p99"]["batch"]
    bulk = recsys_batch(cfg, bulk_rows, step=100)["ids"]
    small = bulk[:small_rows].clone()
    serve = {}
    with torch.no_grad():
        for name, ids in (("serve_p99", small), ("serve_bulk", bulk)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            f50, f99 = host_ms(lambda: xdeepfm.forward(cfg, params, ids),
                               RECSYS_SERVE_REPS[name])
            fl = recsys_flops(cfg, ids.shape[0], "serve")["model"]
            peak = torch.cuda.max_memory_allocated()
            if name == "serve_bulk":
                counted_run("xdeepfm-serve-bulk",
                            lambda: xdeepfm.forward(cfg, params, ids),
                            params, ids, ms=f50)
            serve[name] = dict(
                rows=ids.shape[0], forward_ms=dict(p50=f50, p99=f99),
                examples_per_s=ids.shape[0] / (f50 * 1e-3),
                flop_share=fl / (f50 * 1e-3) / PEAK_FP32_FLOPS,
                peak_mem_gib=peak / 2 ** 30,
                peak_above_held_gib=(peak - held) / 2 ** 30)
        got = xdeepfm.forward(cfg, params, small)
        want = xdeepfm.forward(cfg, params, bulk)[:small_rows]
        rel = float((got - want).abs().max()) / float(want.abs().max())
        serve["p99_rows_in_bulk"] = dict(max_rel_err=rel,
                                         tolerance_rel=RECSYS_BULK_RTOL,
                                         bitwise=torch.equal(got, want))
        check(rel <= RECSYS_BULK_RTOL,
              f"recsys: serve_p99's rows differ from the same rows in "
              f"serve_bulk by {rel} > {RECSYS_BULK_RTOL}")
        del bulk, small, got, want
        torch.cuda.empty_cache()
        n_cand = shapes["retrieval_cand"]["n_candidates"]
        gen = torch.Generator(device="cuda").manual_seed(47)
        cands = torch.randint(0, cfg.vocab_per_field, (n_cand, cfg.n_sparse),
                              device="cuda", generator=gen,
                              dtype=torch.int32)
        user = torch.randint(0, cfg.vocab_per_field, (cfg.n_sparse,),
                             device="cuda", generator=gen, dtype=torch.int32)
        planted = n_cand // 2 + 17
        cands[planted] = user
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r50, r99 = host_ms(lambda: xdeepfm.retrieval_score(cfg, params, user,
                                                           cands),
                           RECSYS_SERVE_REPS["retrieval_cand"])
        scores = xdeepfm.retrieval_score(cfg, params, user, cands)
        top2 = torch.topk(scores, 2)
        first = int(top2.indices[0])
        check(first == planted, f"recsys: the planted candidate {planted} "
                                f"ranks below {first}")
        serve["retrieval_cand"] = dict(
            candidates=n_cand, score_ms=dict(p50=r50, p99=r99),
            candidates_per_s=n_cand / (r50 * 1e-3),
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            planted=planted, ranked_first=first,
            margin=float(top2.values[0] - top2.values[1]))
        del cands, scores
        torch.cuda.empty_cache()

    # (f) the kernels at these shapes
    n_rows = cfg.n_sparse * cfg.vocab_per_field
    readings = {
        "tables": inplace_reading("kernel.segment_sum_accumulate.recsys_tables",
                                  flat, cfg.embed_dim, n_rows, torch.float32,
                                  53, "index_add_"),
        "linear_w": inplace_reading(
            "kernel.segment_sum_accumulate.recsys_linear_w", flat, 1, n_rows,
            torch.float32, 59, "index_add_")}
    bag_launches, readings["bag_sum"] = recsys_bag_reading(params["tables"])
    line("recsys", model=cfg.arch_id, n_sparse=cfg.n_sparse,
         vocab_per_field=cfg.vocab_per_field, embed_dim=cfg.embed_dim,
         cin_layers=cfg.cin_layers, mlp_layers=cfg.mlp_layers,
         dtype=cfg.dtype, param_count_reference_formula=cfg.param_count(),
         params_in_tree=n_params, cin_chunk_rows=xdeepfm.CIN_CHUNK_ROWS,
         init_s=init_s, card_vs_cpu=cpu, two_steps_bitwise=bitwise,
         train_batch=train, **serve,
         launches=dict(segment_sum=bag_launches,
                       segment_sum_accumulate=acc_launches),
         phase_s=time.perf_counter() - phase_t0)
    del params, state, flat
    torch.cuda.empty_cache()
    return bag_launches, acc_launches, readings


def serve_recall(stdout: str) -> float:
    m = re.search(r"recall@10=(\S+)", stdout)
    check(m is not None, f"launch_serve: no recall@10 in {stdout[-500:]!r}")
    return float(m.group(1))


def phase_launch_serve() -> dict:
    """The serving launcher as a user runs it, as child processes on the
    card: ``--n-nodes SERVE_NODES --queries SERVE_QUERIES --data-dir D``,
    then ``--recover --rag`` on D (RAG generation with the reference's
    smoke phi4-mini over the recovered index), and beside them ``--rag``
    alone (the plain index); each must exit 0 and print the reference's
    lines. A ``--device cpu`` child at the first run's arguments runs
    beside them too; the card's recall@10 must be within SERVE_RECALL_TOL
    of it."""
    phase_t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve"]
    size = ["--n-nodes", str(SERVE_NODES), "--queries", str(SERVE_QUERIES)]
    root = tempfile.mkdtemp(prefix="launch_serve_")
    data = os.path.join(root, "data")
    runs = (("durable", size + ["--data-dir", data],
             ("ingest+build:", "vector search:", "hybrid search (2 hops):",
              "ingest-while-search:", "snapshot:")),
            ("recover_rag", size + ["--data-dir", data, "--recover",
                                    "--rag"],
             ("recover:", "vector search:", "ingest-while-search:",
              "snapshot:", "RAG generated:")))
    rag_want = ("ingest+build:", "vector search:", "RAG generated:")
    out = {}

    def start(args):
        return subprocess.Popen(cmd + args, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def record(name, args, want, rc, stdout, stderr, t0):
        lines = stdout.splitlines()
        missing = [w for w in want
                   if not any(ln.startswith(w) for ln in lines)]
        check(rc == 0 and not missing,
              f"launch_serve {name}: exit {rc}, missing lines {missing}, "
              f"stdout {stdout[-800:]!r}, stderr {stderr[-1500:]!r}")
        out[name] = dict(args=" ".join(args), exit=rc,
                         wall_s=time.perf_counter() - t0,
                         recall=serve_recall(stdout), lines=lines)

    cpu = start(size + ["--device", "cpu"])
    rag_t0 = time.perf_counter()
    rag = start(["--rag"])
    try:
        for name, args, want in runs:
            t0 = time.perf_counter()
            r = subprocess.run(cmd + args, env=env, capture_output=True,
                               text=True, timeout=300)
            record(name, args, want, r.returncode, r.stdout, r.stderr, t0)
        rag_stdout, rag_stderr = rag.communicate(timeout=300)
        record("rag", ["--rag"], rag_want, rag.returncode, rag_stdout,
               rag_stderr, rag_t0)
        t0 = time.perf_counter()
        cpu_stdout, cpu_stderr = cpu.communicate(timeout=600)
        check(cpu.returncode == 0, f"launch_serve: the --device cpu child "
                                   f"exited {cpu.returncode}: "
                                   f"{cpu_stderr[-1500:]!r}")
    finally:
        for child in (cpu, rag):
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(root, ignore_errors=True)
    cpu_recall = serve_recall(cpu_stdout)
    gap = abs(out["durable"]["recall"] - cpu_recall)
    check(gap <= SERVE_RECALL_TOL,
          f"launch_serve: recall@10 {out['durable']['recall']} on the card, "
          f"{cpu_recall} on the CPU (gap {gap} > {SERVE_RECALL_TOL})")
    res = dict(command="python -m repro_torch.launch.serve", runs=out,
               cpu=dict(args=" ".join(size + ["--device", "cpu"]),
                        recall=cpu_recall, waited_s=time.perf_counter() - t0,
                        lines=cpu_stdout.splitlines()),
               recall_gap=gap, recall_tolerance=SERVE_RECALL_TOL,
               phase_s=time.perf_counter() - phase_t0)
    line("launch_serve", **res)
    return res


# the meta cells the dryrun phase predicts beside the 40: phi4-mini's train
# step at this script's cut batch (micro-batch 1 x 4) and its decode tick
# at this script's slots
DRYRUN_LM_CHECKS = {
    "phi4-mini-train-4k": ("train", {"seq_len": LM_SEQ,
                                     "global_batch": LM_ACCUM}),
    "phi4-mini-decode-8x2048": ("decode", {"seq_len": RAG_SEQ,
                                           "global_batch": RAG_SLOTS}),
}


def dryrun_child(out: str) -> None:
    """The dryrun phase's background child (``--dryrun-child DIR``), on the
    host's CPU and never the card: the dry run's cells traced on the meta
    device (``--cells traced``: the LM and xDeepFM cells on the h100 mesh,
    every cell's per-device state on the grids) in ``DRYRUN_JOBS``
    processes, then ``DRYRUN_LM_CHECKS``' predictions."""
    os.nice(10)
    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    rc = dryrun.main(["--mesh", "all", "--cells", "traced", "--out", out,
                      "--force", "--jobs", str(DRYRUN_JOBS)])
    cfg = get_config("phi4-mini-3.8b")
    preds = {name: dryrun.count_cell(cfg, ShapeSpec(name, kind, dims))
             for name, (kind, dims) in DRYRUN_LM_CHECKS.items()}
    preds["child_s"] = time.perf_counter() - t0
    with open(os.path.join(out, "predictions.json"), "w") as f:
        json.dump(preds, f, default=float)
    raise SystemExit(rc)


def start_dryrun_child() -> dict:
    out = tempfile.mkdtemp(prefix="dryrun_")
    log = open(os.path.join(out, "child.log"), "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--dryrun-child", out], stdout=log,
                            stderr=subprocess.STDOUT)
    return {"dir": out, "proc": proc, "log": log}


def stop_dryrun_child(child: dict) -> None:
    if child["proc"].poll() is None:
        child["proc"].kill()
        child["proc"].wait()
    child["log"].close()
    shutil.rmtree(child["dir"], ignore_errors=True)


def _dryrun_compare(cell: str, pred: dict, how: str) -> dict:
    """(b) and (c) for one cell: the dry run's prediction against the
    counter around the card's run (``COUNTED``)."""
    from repro_torch.roofline import analysis
    got = COUNTED[cell]
    tol = DRYRUN_TOL[how]
    f_rel = pred["flops_total"] / got["flops_total"] - 1
    b_rel = pred["bytes"] / got["bytes"] - 1
    card = got["card_peak_bytes"]
    lo, hi = tol["peak"]
    slack = DRYRUN_PEAK_SLACK if how == "meta" else 0.0
    compute_ms = analysis.compute_seconds(pred["flops"]) * 1e3
    res = dict(cell=cell, method=pred["method"],
               flops_pred=pred["flops_total"],
               flops_counted=got["flops_total"], flops_rel=f_rel,
               bytes_pred=pred["bytes"], bytes_counted=got["bytes"],
               bytes_rel=b_rel, peak_pred_gib=pred["peak_bytes"] / 2 ** 30,
               peak_counted_gib=got["peak_bytes"] / 2 ** 30,
               peak_card_gib=card / 2 ** 30,
               peak_rel_card=pred["peak_bytes"] / card - 1,
               ms=got["ms"], compute_term_ms=compute_ms,
               memory_term_ms=pred["bytes"] / analysis.HBM_BW * 1e3,
               counted_ops=got["ops"], counted_run_s=got["counted_run_s"],
               kernels_counted={k: v["launches"]
                                for k, v in got["kernels"].items()},
               assumptions=pred["assumptions"], tolerances=tol)
    check(abs(f_rel) <= tol["flops"],
          f"dryrun {cell}: FLOPs predicted {pred['flops_total']:.6e}, "
          f"counted {got['flops_total']:.6e} ({f_rel:+.4%})")
    check(abs(b_rel) <= tol["bytes"] and (how != "meta" or b_rel >= 0),
          f"dryrun {cell}: bytes predicted {pred['bytes']:.6e}, counted "
          f"{got['bytes']:.6e} ({b_rel:+.4%})")
    check(card * (1 + lo) - slack <= pred["peak_bytes"]
          <= card * (1 + hi) + slack,
          f"dryrun {cell}: peak predicted {pred['peak_bytes'] / 2 ** 30:.3f} "
          f"GiB, the card's {card / 2 ** 30:.3f} GiB")
    check(got["ms"] >= compute_ms,
          f"dryrun {cell}: measured {got['ms']:.3f} ms under the dry run's "
          f"compute term {compute_ms:.3f} ms")
    return res


def phase_dryrun(child: dict, sweep: subprocess.Popen) -> dict:
    """(a)-(e) of the dryrun phase (the module docstring): the GNN cells'
    probes on the card, the background child's records, the checks. The
    durable phase's crash harness sweep (``sweep``, started before the
    launch_serve phase) runs beside the probes, which are counted and not
    timed."""
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    return _phase_dryrun(child, sweep, phase_t0)


def stop_harness_sweep(sweep: subprocess.Popen) -> None:
    """Stops the sweep's process group if it still runs (a failed phase)."""
    if sweep.poll() is None:
        os.killpg(sweep.pid, signal.SIGKILL)
        sweep.wait()


def _phase_dryrun(child: dict, sweep, phase_t0: float) -> dict:
    from repro_torch.configs import all_cells, get_config, get_shapes
    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis
    out = child["dir"]
    # (a) the GNN cells' probes on the card
    t0 = time.perf_counter()
    rc = dryrun.main(["--mesh", "h100", "--cells", "probed", "--out", out,
                      "--force"])
    probes_s = time.perf_counter() - t0
    check(rc == 0, f"dryrun: the GNN probes exited {rc}")
    egnn = {s.name: s for s in get_shapes("egnn")}
    t0 = time.perf_counter()
    egnn_fwd = dryrun.count_cell(get_config("egnn"), egnn["ogb_products"],
                                 "cuda", train=False)
    fwd_probe_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        child_rc = child["proc"].wait(timeout=900)
    except subprocess.TimeoutExpired:
        child_rc = "timed out"
    waited_s = time.perf_counter() - t0
    child["log"].flush()
    with open(os.path.join(out, "child.log")) as f:
        child_log = f.read()
    check(child_rc == 0, f"dryrun: the meta child exited {child_rc}: "
                         f"{child_log[-3000:]}")
    finish_harness_sweep(sweep)
    recs, statuses = {}, {"ok": 0, "skipped": 0, "refused": 0}
    for arch, shape in all_cells():
        for mesh in dryrun.MESHES:
            path = os.path.join(out, mesh, f"{arch}__{shape.name}.json")
            check(os.path.exists(path), f"dryrun: no record {path}")
            with open(path) as f:
                recs[(mesh, arch, shape.name)] = json.load(f)
    for (mesh, arch, name), rec in recs.items():
        st = rec["status"]
        if st == "failed":
            check(dryrun.refused_by_kernel(rec),
                  f"dryrun {mesh} {arch} {name} failed: {rec['error']}")
            st = "refused"
        if mesh != "h100":
            continue
        statuses[st] += 1
        row = dict(arch=arch, shape=name, status=st)
        if st == "skipped":
            row["skip_reason"] = rec["skip_reason"]
        elif st == "refused":
            row["error"] = rec["error"]
        else:
            row.update(method=rec["method"], params=rec["params"],
                       opt_state_bytes=rec["opt_state_bytes"],
                       flops=rec["flops"], bytes=rec["bytes"],
                       peak_gib=rec["peak_bytes"] / 2 ** 30,
                       fits=rec["fits"], compute_ms=rec["compute_s"] * 1e3,
                       memory_ms=rec["memory_s"] * 1e3,
                       bound_ms=rec["bound_ms"], dominant=rec["dominant"],
                       model_flops=rec["meta"]["model_flops"],
                       useful_ratio=rec["useful_ratio"],
                       assumptions=rec["assumptions"],
                       trace_s=rec["trace_s"])
            key = (arch, name)
            if key in DRYRUN_NOT_FIT or key in DRYRUN_FIT:
                check(rec["fits"] == (key in DRYRUN_FIT),
                      f"dryrun {arch} {name}: fits {rec['fits']} "
                      f"(peak {rec['peak_bytes'] / 2 ** 30:.2f} GiB), "
                      f"PERF.md §4 says {key in DRYRUN_FIT}")
        line("dryrun.cell", **row)
    check(sum(statuses.values()) == 40,
          f"dryrun: {sum(statuses.values())} h100 records, not 40")
    # the decode kernel takes decode_32k's 2^32-element caches
    check(statuses == DRYRUN_STATUSES,
          f"dryrun: h100 statuses {statuses}, not {DRYRUN_STATUSES}")
    grids = {}
    for (mesh, arch, name), rec in recs.items():
        if mesh != "h100" and rec["status"] == "ok":
            grids.setdefault(mesh, {})[f"{arch}/{name}"] = dict(
                state_gib=rec["state_bytes_per_device"] / 2 ** 30,
                fits=rec["fits"])
    line("dryrun.grids", per_device_state=grids, terms=dryrun.GRID_NOT_COUNTED)
    # (b), (c) the cells this script runs, against the card's counted run
    with open(os.path.join(out, "predictions.json")) as f:
        preds = json.load(f)
    child_s = preds.pop("child_s")
    h100 = {(a, n): r for (m, a, n), r in recs.items() if m == "h100"}
    pairs = [("phi4-mini-train-4k", preds["phi4-mini-train-4k"], "meta"),
             ("phi4-mini-decode-8x2048", preds["phi4-mini-decode-8x2048"],
              "meta"),
             ("xdeepfm-train-batch", h100[("xdeepfm", "train_batch")],
              "meta"),
             ("xdeepfm-serve-bulk", h100[("xdeepfm", "serve_bulk")], "meta"),
             ("egnn-ogbn-products.forward", egnn_fwd, "gnn"),
             ("egnn-ogbn-products.step", h100[("egnn", "ogb_products")],
              "gnn")]
    checks = []
    for cell, pred, how in pairs:
        checks.append(_dryrun_compare(cell, pred, how))
        line("dryrun.check", **checks[-1])
    # (d) the ring's collective bytes (checked in the mesh phase)
    # (e) the card's memory beside the dry run's constant
    props = torch.cuda.get_device_properties(0)
    res = dict(statuses=statuses, total_memory=props.total_memory,
               hbm_bytes_constant=analysis.HBM_BYTES, nvidia_smi=smi_line(),
               ring_collectives=COUNTED["mesh.ring"],
               gnn_probes_s=probes_s, egnn_forward_probes_s=fwd_probe_s,
               child_s=child_s, waited_for_child_s=waited_s,
               phase_s=time.perf_counter() - phase_t0)
    line("dryrun", **res)
    return res


def main():
    # the port must import before anything is printed: a copy of this
    # script without the repository fails here, with nothing on stdout
    from repro_torch.kernels.ivf_topk import ops
    from repro_torch.kernels.segment_reduce import ops as sops
    phase_device()
    phase_build()
    child = start_dryrun_child()
    try:
        run_phases(child)
    finally:
        stop_dryrun_child(child)


def run_phases(child: dict) -> None:
    from repro_torch.kernels.ivf_topk import ops
    from repro_torch.kernels.segment_reduce import ops as sops
    kern = {"probe": measure_probe(),
            "shared": measure_shared(4096, 0.5),   # the configured delta
            # slot histories as the RAG phase's prompts make them
            "decode": measure_decode(np.random.default_rng(13).integers(
                132, 1601, RAG_SLOTS))}
    measure_decode_extents()
    small_seg_err = measure_segment_small()
    sum_routes = measure_sum_routes()
    measure_accumulate_routes()
    ops.probe_scan.launches = 0
    ops.shared_scan.launches = 0
    # the index path runs the segment sum too (k-means sums, hop weights):
    # its count is read and set to 0 again after each phase, without the
    # launches of the phases' repeat checks
    sops.segment_sum_csr.launches = 0
    seg = {}

    def seg_read(phase: str, excluded: int = 0) -> None:
        seg[phase] = sops.segment_sum_csr.launches - excluded
        sops.segment_sum_csr.launches = 0

    index, corpus, delta_cap, delta_live = phase_vector()
    after_vector = (ops.probe_scan.launches, ops.shared_scan.launches)
    seg_read("vector")
    index_sums = {f"kmeans_384_{k}": v
                  for k, v in measure_run_sums(index).items()}
    phase_maint(index, corpus)
    after_maint = (ops.probe_scan.launches, ops.shared_scan.launches)
    seg_read("maint")
    phase_sharded(index, corpus)
    after_sharded = (ops.probe_scan.launches, ops.shared_scan.launches)
    seg_read("sharded")
    del index
    torch.cuda.empty_cache()
    seg_read("durable", phase_durable(corpus))
    after_durable = (ops.probe_scan.launches, ops.shared_scan.launches)
    del corpus
    torch.cuda.empty_cache()
    index, corpus = phase_hybrid()
    after_hybrid = (ops.probe_scan.launches, ops.shared_scan.launches)
    seg_read("hybrid")
    index_sums["hop_degrees_1"] = measure_hop_degrees(index)
    phase_sharded_hybrid(index, corpus)
    after_sharded_hybrid = (ops.probe_scan.launches, ops.shared_scan.launches)
    seg_read("sharded.hybrid")
    facade = phase_facade(index, corpus)
    seg_read("facade", phase_durable_hybrid(index, corpus))
    race = phase_racecheck()
    seg_read("racecheck")
    launches = {"probe": ops.probe_scan.launches,
                "shared": ops.shared_scan.launches}
    check(launches["probe"] > 0 and launches["shared"] > 0,
          f"a kernel was not launched on the main path: {launches}")
    rag = phase_rag(index, corpus)
    seg_read("rag")
    dsv2 = phase_rag_dsv2(index, corpus)
    seg_read("rag.dsv2")
    index_seg = sum(seg.values())
    check(seg["vector"] > 0 and seg["durable"] > 0 and seg["hybrid"] > 0,
          f"the segment sum was not launched on the index path: {seg}")
    del index, corpus
    torch.cuda.empty_cache()
    mixtral_decode = phase_lm_mixtral()
    if delta_cap != 4096:
        # the delta grew at ingest: hold and time the delta kernel at the
        # size the serve_1m searches actually scanned
        kern["shared"] = measure_shared(delta_cap, delta_live)
    kern["segment"], gnn_launches, trained = phase_gnn(small_seg_err)
    (train_launches, train_acc, kern["accumulate"],
     mb_batch, local_step) = phase_gnn_train(*trained)
    check(train_acc > 0, "the in-place kernel was not launched by training")
    torch.cuda.empty_cache()
    mesh_launches = phase_mesh(*trained, local_step)
    check(min(mesh_launches) > 0,
          f"a segment kernel was not launched by the mesh phase: "
          f"{mesh_launches}")
    g_ogb, ex_ogb = trained[1], trained[2]
    del trained
    torch.cuda.empty_cache()
    models = phase_gnn_models(g_ogb, ex_ogb, mb_batch)
    check(min(models["launches"]) > 0,
          f"a segment kernel was not launched by gnn_models: "
          f"{models['launches']}")
    kern["segment"]["widths"] = dict(models["segment_widths"], **index_sums)
    kern["segment"]["routes"] = sum_routes
    kern["accumulate"]["widths"] = models["accumulate_widths"]
    del g_ogb, ex_ogb, mb_batch
    torch.cuda.empty_cache()
    lm_acc, kern["accumulate"]["sides"]["token"] = phase_lm_train()
    torch.cuda.empty_cache()
    rec_sum, rec_acc, rec_kern = phase_recsys()
    kern["segment"]["widths"]["xdeepfm_bag_10"] = rec_kern["bag_sum"]
    kern["accumulate"]["widths"]["xdeepfm_10"] = {"tables":
                                                  rec_kern["tables"]}
    kern["accumulate"]["widths"]["xdeepfm_1"] = {"linear_w":
                                                 rec_kern["linear_w"]}
    # the crash harness sweep (the durable phase's, ~2-3 min of child
    # start-ups) runs from here beside launch_serve and the dryrun probes
    sweep = start_harness_sweep()
    try:
        phase_launch_serve()
        phase_dryrun(child, sweep)
    finally:
        stop_harness_sweep(sweep)
    line("launches", vector=dict(zip(("probe", "shared"), after_vector)),
         maint={"probe": after_maint[0] - after_vector[0],
                "shared": after_maint[1] - after_vector[1]},
         sharded={"probe": after_sharded[0] - after_maint[0],
                  "shared": after_sharded[1] - after_maint[1]},
         durable={"probe": after_durable[0] - after_sharded[0],
                  "shared": after_durable[1] - after_sharded[1]},
         hybrid={"probe": after_hybrid[0] - after_durable[0],
                 "shared": after_hybrid[1] - after_durable[1]},
         sharded_hybrid={
             "probe": after_sharded_hybrid[0] - after_hybrid[0],
             "shared": after_sharded_hybrid[1] - after_hybrid[1]},
         facade=facade, racecheck=race, rag=rag, rag_dsv2=dsv2,
         lm_mixtral={"decode": mixtral_decode},
         gnn={"segment_sum": gnn_launches},
         gnn_train={"segment_sum": train_launches,
                    "segment_sum_accumulate": train_acc},
         mesh={"segment_sum": mesh_launches[0],
               "segment_sum_accumulate": mesh_launches[1]},
         gnn_models={"segment_sum": models["launches"][0],
                     "segment_sum_accumulate": models["launches"][1]},
         lm_train={"segment_sum_accumulate": lm_acc},
         recsys={"segment_sum": rec_sum, "segment_sum_accumulate": rec_acc},
         index_path_segment_sum=dict(seg, total=index_seg))
    src = "src/repro_torch/kernels/ivf_topk/csrc/ivf_topk.cu"
    kernels = [
        dict(name="ivf_probe_scan", route="cuda", source=src,
             replaces="src/repro/kernels/ivf_topk/ivf_topk.py:134",
             launches=launches["probe"] + rag["probe"] + dsv2["probe"],
             **kern["probe"]),
        dict(name="ivf_shared_scan", route="cuda", source=src,
             replaces="src/repro/kernels/ivf_topk/ivf_topk.py:68",
             launches=launches["shared"] + rag["shared"] + dsv2["shared"],
             **kern["shared"]),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/decode_attention/csrc/"
                    "decode_attention.cu",
             replaces="src/repro/kernels/decode_attention/"
                      "decode_attention.py:78",
             launches=rag["decode"] + rag["mesh_decode"] + mixtral_decode,
             **kern["decode"]),
        dict(name="segment_sum", route="cuda",
             source="src/repro_torch/kernels/segment_reduce/csrc/"
                    "segment_reduce.cu",
             replaces="src/repro/kernels/segment_reduce/"
                      "segment_reduce.py:50",
             launches=(gnn_launches + train_launches + mesh_launches[0]
                       + models["launches"][0] + index_seg + rec_sum),
             **kern["segment"]),
        dict(name="segment_sum_csr_accumulate", route="cuda",
             source="src/repro_torch/kernels/segment_reduce/csrc/"
                    "segment_reduce.cu",
             replaces="src/repro/kernels/segment_reduce/"
                      "segment_reduce.py:50",
             launches=(train_acc + mesh_launches[1] + models["launches"][1]
                       + lm_acc + rec_acc),
             **kern["accumulate"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--durable-child"]:
        durable_child(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--dryrun-child"]:
        dryrun_child(sys.argv[2])
    else:
        main()
