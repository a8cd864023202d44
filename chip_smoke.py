#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card (H100), nvcc and a C compiler; builds every
kernel of the main path from the sources in this checkout. Phases, one
result line each; any failure raises and exits non-zero:

  gpu      card name and power limit (nvidia-smi)
  build    B1 (label propagation), B2 (segmented count), the stratum
           sweep (B2 redesigned), B3 (k-core peel round), the peel
           fixpoint (B3 redesigned), B4 (segment sum and its gradient
           gather), B5 (GEMM), B6 (flash attention) and B6's backward with
           nvcc for sm_90a, the host
           forest engine with cc, all started together; each kernel's
           registers, shared memory and spills
  construct  a CollegeMsg-scale temporal graph (SNAP CollegeMsg: 1,899
           users, 59,835 messages, 193 days), generated from a seed; its 37
           core-time strata swept on the card (the device engine: one
           stratum_sweep launch per t_uv block, ceil(t_max / 256) = 1, on
           the route its size picks, and no B2 launch) and on the host
           (the fused numpy sweep): every stratum array-equal; both times,
           the probes and climbs; the build's split (pair CSR, _tuv_rows,
           upload, the kernel by CUDA events, download, host compression
           and stratification), the kernel's byte bound and serial chain
           (the longest stratum's probes); the whole build under
           torch.profiler (idle share); the kernel against its plain
           version on the card, stratum k0 alone (the old path's cost) and
           every stratum: rows, carry and counts equal; the k range
           (default_ks) peeled on the card, one kcore_fixpoint launch per
           k_max probe
  index    the k-stratified PECB index: forests built on the host from the
           card-built strata, so everything served below comes from them;
           its k_max_graph peeled on the card
  kernel   B1 against its plain PyTorch version at (256, N) on the card:
           bit-identical int32 output; kernel, plain and bound times (the
           bound counts link bytes for the active pairs only). B2 on the
           sweep's first operands (ts = 1, k = 2, c = 0), on the CSR with
           random thresholds and on random unsorted ids with -1 pads; B3a
           and B3b on the graph's 59,835 edges with random alive and on the
           peel's own first-round operands: all bit-identical to their plain
           versions; kernel, plain and library times per call (CUDA events:
           the device time with the host ahead, behind a device sleep, the
           time back to back and the host time) and the bound
  peel     the main path of B3, redesigned: ``ops.kcore_fixpoint`` on the
           card, one launch of the fixpoint kernel per k (every round on
           the card, no host read between rounds), counted: over the
           CollegeMsg graph's 17,474 distinct pairs for every k of the
           index and k_max + 1 (38 fixpoints), then over an
           sx-superuser-scale graph (SNAP sx-superuser: 194,085 users,
           1,443,339 interactions; generated from a seed): 461,605
           distinct pairs, k = 2..k_max + 1 (121 fixpoints). For each: one
           launch per fixpoint and no B3a/B3b launch; every mask
           bit-equal to the plain version on the card and every round
           count equal, in the counted run and in the timed one; each k at
           CollegeMsg scale and k in {2, k_max/4, k_max/2, k_max,
           k_max + 1} at sx-superuser scale equal to the host's distinct
           k-core; the wall of all fixpoints, each one's device time by
           CUDA events, the serial chain (the longest fixpoint's rounds)
           and the byte bound; the old path (B3a + B3b and a flag read
           per round) timed on the same operands
  baselines  the paper's comparison (Figures 4-6) at CollegeMsg scale:
           k_max on the card (kcore.k_max, one kcore_fixpoint launch per
           probe of its doubling and bisection) equal to numpy's; at 0.5,
           0.7 and 0.9 of it (bench_vary_k's shares; 0.7 is bench_paper's
           default k) edge_core_times on the card, equal to the host
           engine's, and PECB, CT-MSF and EF built from it: bytes, build
           seconds, EF's chain forests, distinct cores and enumerated core
           edges, every count equal to the reference package's; at the
           default k Borůvka's MSF as torch ops on the card at every start
           time, equal to Kruskal and to EF's stored forest (rounds, ms
           per start time); 1,000 random_queries at each k through PECB,
           CT-MSF and EF on the host (us per query) and the PECB's device
           batch on B1 in buckets of 256 (q/s), all four equal; 64 of them
           against tccs_oracle and tccs_oracle_edges on the card (one
           fixpoint launch per window) and EF's and CT-MSF's four answer
           modes; the phase's seconds, peak memory and launches
  upload   the index to the card
  serve    the main path through launch.serve: mixed-k vertex queries at
           bucket 256, one edges-mode batch at bucket 16, one 64-window
           sweep, each checked against the port's Algorithm 1; B1's launch
           count over this phase must be > 0
  plain    one served batch with B1 as the loop body against the same
           batch with the plain round on the card: identical labels and
           masks; the batch's time by stage; the share of active (query,
           node) pairs; B1 and its plain version timed on that batch's
           first-round operands (the kernel record)
  profile  the same batch served once more under torch.profiler: device
           busy time, idle share, B1's share, the top kernels
  epoch    the epoch planes at CollegeMsg scale through the entry points:
           epoch 0 = g.split_at(189) (bench_streaming.py's frac 0.98)
           built cold on the card, then the days 190..193 as four suffix
           epochs (extend, extend_stratified_core_times on the device
           engine, one stratum_sweep launch each, extend_stratified_index,
           refresh_device), each followed by one batch of 256 mixed-k
           vertex queries through batch_query_full_mixed on B1 (every
           fourth window ends on the newest day; 32 held to Algorithm 1,
           0 mismatches); the day-193 index equal to the cold build of the
           whole graph in every field and its mirror array for array; then
           one trim, expire_before(96) (bench_retention.py's frac 0.5),
           through the shrinks and refresh_device, equal to a cold card
           build of the trimmed graph, freeing device memory, and one more
           batch. Per epoch the edges, |K| and seconds per stage (the
           sweep with its kernel by CUDA events, the download, recompress
           + stratify, the forest extend or shrink, the refresh with its
           reused/suffix/full counts and bytes) beside the cold build's;
           the last daily epoch once more on the host engine (capped at
           30 s); the phase's launches, seconds and peak device memory
  engine   the port's serving engine (ServingEngine on the card) at
           CollegeMsg scale, bench_engine.py's settings (max_batch 256,
           flush 2 ms, no cache): the registry's cold build of epoch 0 =
           g.split_at(189) through warmup; 2,048 mixed-k specs open loop
           from 4 caller threads and at offered loads of 250 and 1,000
           q/s (q/s, e2e p50/p95/p99, batches and padded slots); 32
           straggler submissions of 3 on the host route, held to one device
           batch too; the stream twice through a 4,096-entry cache; a
           64-window sweep equal to serve.serve_sweep's; 16 EDGES/SUBGRAPH
           specs at max_batch 16 (peak device memory); the days 190..193
           ingested one at a time while a caller thread keeps serving (each
           refresh's time, p99 before and during the refreshes, answers
           from the old epoch before each swap), the day-193 handle equal
           to the cold build of g in every field; retain(96), the trimmed
           handle equal to a cold card build; the Chrome trace exported and
           loaded. 256 sampled answers of each stream held to Algorithm 1;
           B1 launches equal to the rounds the engines ran, stratum_sweep
           launches to the builds and extends; each line carries the
           card's name and power limit
  multi    the sharded query plane: ServingEngine(devices=...) over every
           visible card (cuda:0 twice, two shards on one card, where one is
           visible, which the phase says), [engine]'s epoch 0 and settings:
           a one-shard engine and the sharded one each build cold through
           warmup, the sharded handle's replicas each equal to to_device on
           their card; [serve]'s stream (1,024 mixed-k specs in batches of
           256) through both, q/s, batch latency and rounds by shard each,
           every sharded answer bit-equal to the one-shard one, 64 to
           Algorithm 1; one day ingested and one trim, every new replica
           equal to to_device; B1 launches equal to the rounds of every
           shard. On two cards or more, B5, B6 and B6's backward on their
           wgmma routes launched on cuda:0 then cuda:1 against their plain
           versions (the per-device shared-memory opt-in)
  store    the disk tier at CollegeMsg scale: an engine with store_dir
           (max_batch 256, flush 2 ms, no cache) builds epoch 0 =
           g.split_at(189) cold on the card and writes it through (a full
           commit), ingests the days 190..193 (one stratum_sweep launch
           and one commit each, mode and bytes printed), retain(96),
           closes; a second engine on the same directory adopts the graph
           and promotes the stored index with no build (source disk, one
           promotion, no stratum_sweep launch; the split: open_latest with
           crc verification, from_parts, upload, beside the cold build's
           seconds), equal to a cold card build of the trimmed graph in
           every field and mirror array; 256 mixed-k random_queries(seed=9)
           through B1 with route disk, all equal to Algorithm 1; 16 EDGES
           and SUBGRAPH specs at max_batch 16; one more day ingested onto
           the promoted handle as a delta commit, equal to a cold card
           build of the grown graph; one byte of the newest segment
           flipped (the previous epoch recovered and promoted, equal to
           its cold build); every manifest deleted (warmup falls back to a
           cold build, source build); the serving CLI twice on one store
           directory (the second run, --expect-warm, promoted, 0
           mismatches); graphsage-reddit's 192,384 parameters checkpointed
           from the card (save, save_async + wait) and restored onto cuda:0
           bit-equal; the bytes on disk, commits by mode, loads,
           store_load_failures and store_commit_failures (both 0), B1
           launches equal to the engines' rounds, stratum_sweep launches
           to the builds and ingests, seconds and peak device memory
  lm       first B6's single-tile check of its wgmma route (S = Q K^T from
           TMA-loaded tiles, then P V with P in bf16 registers, against the
           plain version); then glm4-9b at full width and depth
           (9,399,951,360 parameters, bf16, drawn on the card from a seed):
           prefill of 1 x 4,096 tokens through make_serve_step(spec,
           "prefill_32k") and 8 greedy decode steps of batch 16 at the end
           of a 32,768-slot cache through make_serve_step(spec,
           "decode_32k"), each counted (B5 and B6 launch counts must be >
           0; every prefill B5 launch on the wgmma route and every B6 one
           on the wgmma route, every decode B5 launch on the skinny route
           and every B6 one on the split route); the prefill's logits
           against the same forward with the plain versions on the card; a
           16-token decode against the prefill's logits at each position;
           B5 and B6 against their plain versions at the path's shapes
           (B6 also at a ragged 4,000 positions, causal S != T, dh 64 and
           16, f16 and f32, each case with its route), timed beside their
           bounds and library yardsticks; one prefill and one decode step
           under torch.profiler (device busy, idle share, B5's and B6's
           shares); tokens/s and the model-FLOP share of 989 TFLOP/s
  lm-smoke glm4-smoke and codeqwen-smoke (2 layers, dh 16) on the card in
           bf16 and f32, and the bf16 models over an f32 KV cache: prefill
           and decode through make_serve_step, counted (B6 on the mma route
           at bf16 prefill, split at bf16 decode, f32 for f32 q), logits
           against the same steps with the plain versions and decode
           against prefill
  gnn      graphsage-reddit at full width (602 -> 128 -> 128, 41 classes,
           192,384 f32 parameters drawn on the card from a seed) serving
           8 minibatches of 1,024 seed vertices, fanout (15, 10), from a
           pool at Reddit's published scale (232,965 nodes, 114.5M directed
           edges, 602 features; generated from a seed), each padded to
           minibatch_lg's 169,984 nodes and 337,920 edges and sent through
           make_serve_step(spec, "minibatch_lg"), counted (B4 and B5 launch
           counts must be > 0, every B5 launch on the f32 route); each
           batch's logits against the same forward
           with the plain versions on the card; B4 against its plain version
           on the first batch's operands (d = 602, 128, 1) and on random
           unsorted ids with -1 and >= S entries, B5's f32 path at the
           layers' shapes, each timed beside its bound and library
           yardstick (index_add_, torch.matmul); sampling, copy and forward
           times per batch, seeds/s; one forward under torch.profiler
  train    the training path: glm4-9b at full width cut in depth (n_layer
           40 -> 8, batch 256 -> 1, one sequence of train_4k's 4,096
           tokens from launch.train's TokenStream batches at the full
           vocab, remat) through configs.make_train_step for 4 AdamW steps,
           the first counted (B5 28L + 3 launches on the wgmma route, 14L + 2
           of them gradient products; B6 2L forward on wgmma, L backward on
           wgmma from the lse the forward kept); losses finite, the first
           near ln(vocab); step seconds, tokens/s, the model-FLOP share, the
           host data time, AdamW's seconds, peak memory, one step under
           torch.profiler, the step and B6 backward's share of busy beside
           the mma backward's; B6's backward at the path's shape given the
           forward's lse against the plain backward (dq, dk, dv within
           bwd_error_bound, lse, bitwise reproducible, bit-equal with
           lse=None), timed beside its bound, floor and SDPA's, and B5's
           gradient products against their plain versions, each timed beside
           its bound and library call; a 1-layer full-width model's loss and
           every gradient against the plain versions; graphsage-reddit at
           minibatch_lg's full dims through make_batch_fn and
           make_train_step (B4 5, its gather 1, B5 13 per step), loss and
           gradients against the plain versions, steps/s, seeds/s and the
           sampler's host time, B4's gather bit-equal to its plain version
           and timed; the training CLI with --inject-failure on the card for
           both, the replayed losses equal to an uninterrupted run's (bit for
           bit for glm4; within rtol 1e-5 for GraphSAGE, and whether they
           are bit-equal)
  moe      the MoE LMs: qwen2-moe-a2.7b at full width and depth
           (14,315,735,040 parameters, 2,689,124,352 active; 60 experts of
           1,408, top-4, 4 shared; bf16, drawn on the card from a seed):
           prefill 1 x 4,096 through make_serve_step(spec, "prefill_32k")
           and 4 greedy decode steps of batch 4 over a 32,768-slot cache
           through make_serve_step(spec, "decode_32k"), each counted (B5 per
           layer: 4 attention projections, the router on the f32 route,
           3 per expert and 9 for the shared experts, wgmma at prefill and
           skinny at decode; B6 once a layer); the routing (capacity C,
           dropped assignments, the smallest top-K margin); the prefill's
           logits against the plain versions replaying the kernel run's
           routes, and the assignments a plain run routing on its own sends
           elsewhere; an 8-token decode against a prefill of those tokens,
           each step replaying the prefill's routes of its tokens; the MoE
           layer's pieces (router, route + dispatch, experts, combine,
           shared experts) timed alone; B5 at the expert shapes and the f32
           router against its plain version; tokens/s, the model-FLOP share
           on the active parameters, expert rows executed against assigned,
           decode ms per step, launches, idle share and peak memory.
           dbrx-132b and qwen1.5-110b at full width cut to 2 layers:
           prefill 1 x 4,096 counted and against the plain versions (routes
           replayed). The train step on qwen2-moe at full width, 4 layers,
           one sequence of 4,096, remat: launches counted, the remat
           recompute's routes equal to the first pass's, a repeat from the
           same state bit-equal in loss and every parameter; a 1-layer
           full-width model's loss and every gradient against the plain
           versions with the routes replayed; at 4 layers, the bf16
           kernels' and plain versions' gradients each against an f32
           plain run, and the f32 kernels' against the f32 plain versions;
           routing alone (the stable sort that breaks ties as
           jax.lax.top_k) beside torch.topk, with the tied tokens counted
  mgn      meshgraphnet at full width and depth (15 layers, hidden 128,
           2-layer MLPs; f32, drawn on the card from a seed): serving on
           full_graph_sm's full dims (2,708 nodes, 21,504 padded directed
           edges, 1,433 features) through make_serve_step, counted (B5 99,
           B4 15 a forward, all B5 on the f32 route), outputs against the
           plain versions; 3 make_train_step steps on launch.train's
           batches, the first counted (B5 295, B4 45, its gather 15), the
           loss and every gradient against the plain versions (relu pattern
           replayed); serving at ogb_products' shape with n and e divided
           by 16 (153,064 nodes, 7,732,736 directed edges): counted,
           against the plain versions, its peak memory, and B4 (the layer
           aggregation) and B5 (the edge MLP's 384 -> 128 product) at its
           shapes beside their bounds and library calls
  geo      nequip (5 layers, C 32) and mace (2 layers, C 128, correlation
           3) at full width and depth on molecule's full dims (128
           molecules of 30 atoms, 16,384 directed edges with 1,024 padding
           edges at node 0; one-hot species; from a seed): energies through
           make_serve_step and forces by autograd, each counted and against
           the plain versions; a rotated copy within the reference's
           equivariance tolerances; 3 train steps (energy + 10 x force loss,
           so the step differentiates the forces again through B4 and B5),
           the first counted; the loss and every gradient, and the force
           loss's gradient alone, against the plain versions; molecules/s,
           step seconds, idle shares, peak memory
  recsys   mind at the reference's full width (8,388,608 items x 64, 4
           interests, 3 routing iterations, histories of 50; f32, drawn on
           the card from a seed) on all four RECSYS_SHAPES cells, nothing
           cut: serve_p99 (512 users x 100 candidates: p50 and p99 ms
           over 60 calls, users/s, host ms, idle share), serve_bulk
           (262,144 x 100: s per batch, users/s, peak memory) and
           retrieval_cand (1 x 1,000,000: ms per query, peak memory)
           through make_serve_step, each counted (B5 1 per serve call, 2
           per retrieval, no B4) and its scores against the plain
           versions; train_batch (65,536 users from launch.train's
           InteractionStream) through make_train_step, the first step
           counted (B5 6, 4 of them gradients; B4 1 for the item table's
           gradient over the one lookup of history and targets; 1 plan):
           step s, users/s, the model-FLOP share of 67 TFLOP/s, the step
           taken apart (lookup, routing, loss, backward, AdamW), peak
           memory, the host's data s; the loss and both gradients against
           the plain versions and bit-equal in two evaluations; the
           training CLI with --inject-failure replayed bit-equal; B4 at
           the table gradient's shape (3,342,336 rows into 8,388,608) and
           B5 at the S gradient's (64 x 3,276,800 @ 3,276,800 x 64, K
           split) and the in-batch shapes against their plain versions,
           timed beside their bounds, index_add_ and torch.matmul
  runtime  the runtime and launch modules on the card's one-rank NCCL
           mesh: mind at full width through the vocab-parallel lookup
           (serve_p99, the train batch's loss and both gradients,
           retrieval_cand bit-equal to the default lookup, counted; zero
           rows for ids out of range; one train step; B4 at the lookup's
           table gradient); remesh of a restored mind checkpoint,
           bit-equal; qwen2-moe-a2.7b at full width: layer 0's MoE through
           the all-to-all dispatch against its plain versions (routes
           replayed) and against moe_ffn at capacity 8.0, the full prefill
           with the a2a and the sharding hooks set against today's; the
           int8 compressed mean over a MoE train step's gradients; the dry
           run on the card's mesh (a cell of each family, then more
           while under 20 s) and the report's tables
  contracts  the kernel-contract witness and the lock witness armed
           (REPRO_KERNEL_WITNESS=1, REPRO_LOCK_WITNESS=1) over the TCCS
           main path: the card build of the CollegeMsg graph (the sweep and
           the fixpoints of its k range), to_device (the layout checked on
           upload) and 256 mixed-k queries through serving/executor.py,
           counted, every answer equal to Algorithm 1; then one call of
           every other contract at the main paths' full-width operands (B5
           wgmma, skinny and f32, B6 wgmma and split, B6's backward, B4 and
           its gather, B2, its bisection, B3a, B3b, both probes): no
           problem, every contract recorded; the calls and the largest
           declared shared memory per contract; disarmed, the wrapper's
           host us per call against its __wrapped__ at glm4's decode matmul
           and at B1 (at most 2 us added)
  mesh     the dense LM step under the (data, model) mesh: glm4-9b at
           full width cut to 8 layers through the partitioner on the
           card's one-rank NCCL mesh (make_serve_step / make_train_step
           with mesh, init_params(mesh=) placing each leaf as it is
           drawn): one prefill of 1 x 4,096 and one train step, counted,
           each bit-equal to the unsharded one (logits; loss, norm, lr,
           every parameter and both moments); the collectives per step
           (none: an exchange over one rank would be a copy); B5 at the
           local shapes of 2 and 4 model ranks (ffn.wi's ragged N among
           them, the row-parallel K, wq, the gathered wk, the head's
           vocab shard) and B6 over one kv head against their plain
           versions, timed beside their bounds and library calls; then
           qwen2-moe-a2.7b the same way (4 layers); then mind at full
           width through its partition (models.recsys.Partition): one
           serve_p99 call and one train step of 65,536 users, counted,
           bit-equal to the unsharded ones (scores; loss, norm, lr, S,
           item_embed, both moments), no collective; B4 and B5 at the
           local shapes of the four-card meshes (the table gradient over
           a rank's ids into its rows, the logits and their gradients on
           B / data users) against their plain versions, bounds and
           index_add_ / torch.matmul

The card builds, ingests and trims of epoch, engine, multi and store
peel their k ranges on the card too; a ``[kcore]`` line sums
kcore_fixpoint's launches. Then a line of kernel records (JSON), the
nvidia-smi line, and last
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --multi`` runs gpu, build and multi alone (on a
machine with several cards: the card-to-card path and the second card's
B5/B6), then [mesh] across the cards: one rank process per card (four
at most, two on two or three cards; ``chip_smoke.py --mesh-rank r world
dir``), NCCL over a FileStore, every rank under one hard timeout and all
killed if one fails. glm4-9b at 8 layers on every (data, model) mesh of
the world, each step's loss, norm, gathered gradients and updated
parameters within 5e-2 of one card's step on the same batch; on four
cards glm4-9b at all 40 layers trained two steps on (2, 2) (step s,
tokens/s, model-FLOP share, peak GiB per card, collectives) and served
on (1, 4) (prefill and decode at the head of the cache within 5e-2 of
max|logit| of one card's; decode at the end of the cache timed, its
distance from one card's beside one card's own kernels-vs-plain
spread); the parts mind, gnn, moe and dbrx (``MESH_PARTS``) run too,
each in rank processes of its own: mind at its published config (the
2 GiB table's rows over model, the in-batch softmax over the whole
batch) on each mesh against one card's steps and serve cells, a
per-rank softmax planted and caught; the GNNs edge-parallel and
node-sharded (``models.gnn.NodeShard``) against one card's steps and
each other. Then the same last two lines.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: SNAP CollegeMsg's published scale (users, messages, days)
COLLEGEMSG = dict(n=1899, m=59835, t_max=193, seed=7)
#: the glm4 train step and B6's backward's share of its busy time when the
#: backward ran on the mma route (H100 80GB HBM3 at 700 W; PERF.md section
#: 6), printed beside this run's
MMA_BWD_STEP_S, MMA_BWD_SHARE = 0.4521, 0.059
#: SNAP sx-superuser's published scale (users, temporal interactions;
#: snap.stanford.edu/data/sx-superuser.html), days cut to 2,000: the
#: [peel] phase's second graph (461,605 distinct pairs, k_max 121)
SX_SUPERUSER = dict(n=194085, m=1443339, t_max=2000, seed=7)
#: ks of the sx-superuser peel checked against the host's k-core (each
#: ~0.14 s there), as shares of k_max; k_max + 1 is checked too
SX_HOST_KS = (0.0, 0.25, 0.5, 1.0)
BUCKET = 256


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall(fn):
    """(result, seconds) of ``fn`` with the card synchronised after it."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def queued_ms(fn, host: float, iters: int = 20) -> float | None:
    """Device time of one call of ``fn`` in ms, host time excluded: the
    card first sleeps long enough for the host to enqueue ``iters`` calls
    (``host`` ms each, measured by :func:`host_ms`) between two CUDA
    events, so the device runs them back to back. None when the host fell
    behind the sleep all the same (the start event had completed by the
    time the last call was enqueued)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * iters * host + 1.0) * 2e6))  # ~2 GHz cycles
    start.record()
    for _ in range(iters):
        fn()
    ahead = not start.query()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters if ahead else None


def host_ms(fn, iters: int = 20) -> float:
    """Host time of one call of ``fn`` in ms: ``iters`` calls enqueued back
    to back without a synchronisation (few enough that the launch queue
    does not fill), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return t * 1e3


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| of two integer or boolean tensors (0 when the
    tensors are empty)."""
    if not got.numel():
        return 0
    return int((got.long() - want.long()).abs().max())


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """Raise unless ``got`` equals ``want`` exactly (dtype, shape, values);
    returns the max abs error (0)."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"(max abs err {max_abs_err(got, want)})")
    return max_abs_err(got, want)


def device_rows(prof):
    """(name, device us, count) of every CUDA kernel row of a profile:
    device rows only, since a CPU op's row repeats its kernels' time."""
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def top_rows(rows, n=5) -> str:
    return "; ".join(f"{k[:48]} {t / 1e3:.2f}ms x{c}"
                     for k, t, c in sorted(rows, key=lambda r: -r[1])[:n])


#: the [lm] phase's model, served at full width and depth, and the seed of
#: its weights, tokens and stand-in cache
LM_ARCH = "glm4-9b"
LM_SEED = 13
#: prefill 1 x LM_SEQ tokens (prefill_32k's batch and length cut by the
#: plain comparison's memory); decode LM_DECODE_BATCH sequences (decode_32k's
#: 128 cut by the cache's memory) over decode_32k's 32,768 slots, LM_STEPS
#: timed steps; decode against prefill over an LM_PREFIX-token prefix
LM_SEQ = 4096
LM_DECODE_BATCH = 16
LM_STEPS = 8
LM_PREFIX = 16
#: whole-model checks in bf16 (kernels against the plain versions, decode
#: against prefill): the largest |difference| of the two evaluations'
#: logits within this share of the largest |logit|. The two differ only in
#: summation order and in where bf16 rounds (B6 rounds P to bf16 before PV,
#: the plain version does not), and 40 layers of bf16 roundings (2^-8 each)
#: decorrelate; tests/test_torch_transformer.py holds a narrow 40-layer
#: bf16 model's decode against its prefill at this bound on the CPU.
LM_LOGIT_TOL = 5e-2
#: B6 against its plain version: elementwise within
#: flash_attention.error_bound (2e-2 of |plain| for the bf16 roundings of
#: the output, plus 1e-2 of the largest |plain| in the element's row for the
#: kernel's bf16 P). Each case prints the outputs' typical size beside it,
#: and shows that the bound rejects the plain version with the last key
#: tile left out.
#: B5 against its plain version, elementwise on f32 outputs: the same exact
#: products summed in f32 in another order, an error that grows with K
B5_RTOL = 1e-4
B5_ATOL_PER_K = 1e-6


def call_times(fn, iters: int = 20) -> tuple[float, str]:
    """(ms, clause) of one call of ``fn``: ``ms`` its device time with the
    host ahead (:func:`queued_ms`), or its time back to back where the
    host fell behind; the clause gives both and the host time."""
    ms = cuda_ms(fn, iters=iters, warmup=2)
    host = host_ms(fn, iters=iters)
    dev = queued_ms(fn, host, iters=iters)
    what = ("not measured with the host ahead (it fell behind)"
            if dev is None else f"{dev:.6f} ms on the device with the host "
            "ahead")
    return (dev or ms, f"{what}, {ms:.6f} ms per call back to back, "
            f"{host:.6f} ms of host time")


def show(times: dict) -> str:
    """One clause per function timed by :func:`call_times`."""
    return "; ".join(f"{name} {clause}" for name, (_, clause) in
                     times.items())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def top1(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of rows whose arg-max over the last axis agree."""
    return float((got.argmax(-1) == want.argmax(-1)).float().mean())


def is_b5(key: str) -> bool:
    return any(name in key for name in ("gemm_tma<", "gemm_bf16_masked(",
                                        "gemm_f32<", "splitk_reduce("))


def b5_routes(sm, want: dict, what: str) -> str:
    """Raise unless B5's launches by route (``sm.matmul.routes``) are
    ``want`` on every route; returns them as a clause."""
    got = {r: n for r, n in sm.matmul.routes.items() if n}
    if got != want:
        raise AssertionError(f"{what} launched B5 by route {got}, not {want}")
    return ", ".join(f"{n} on the {r} route" for r, n in got.items())


def ptxas_kernels(log: str) -> list[str]:
    """One 'kernel: registers, shared memory, spills' entry per kernel of a
    ``-Xptxas -v`` log."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name, spills = ln.split("'")[1], ""
        elif "spill stores" in ln and name:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spills}")
            name = None
    return out


def is_b6(key: str) -> bool:
    return any(name in key for name in ("flash_wgmma<", "flash_mma<",
                                        "flash_combine<", "flash_simt<"))


def b6_routes(fa, want: dict, what: str) -> str:
    """Raise unless B6's launches by route (``fa.flash_attention.routes``)
    are ``want`` on every route; returns them as a clause."""
    got = {r: n for r, n in fa.flash_attention.routes.items() if n}
    if got != want:
        raise AssertionError(f"{what} launched B6 by route {got}, not {want}")
    return ", ".join(f"{n} on the {r} route" for r, n in got.items())


def is_b4(key: str) -> bool:
    return "segsum<" in key


def profiled(fn, kernels: dict, shares: dict | None = None) -> str:
    """``fn`` once under torch.profiler: wall, device busy, idle share, the
    share in the busy time of each kernel of ``kernels`` (name -> a test of
    a device row's name) with the launches the profiler recorded for it
    (it can drop records), the top device rows and the top host operations
    by their own time. ``shares``, where given, receives each kernel's
    share of busy by name, and the busy seconds as ``busy_s``."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t = wall(fn)
    rows = device_rows(prof)
    busy = sum(us for _, us, _ in rows) / 1e6
    if not busy:
        return f"wall {t:.4f}s, device busy not measured (no device events)"
    if shares is not None:
        shares["busy_s"] = busy
    parts = []
    for name, test in kernels.items():
        secs = sum(us for k, us, _ in rows if test(k)) / 1e6
        n = sum(c for k, _, c in rows if test(k))
        if shares is not None:
            shares[name] = secs / busy
        parts.append(f"{name} {secs:.4f}s ({secs / busy:.3f} of busy, "
                     f"{n} launches recorded)")
    host = [(e.key, e.self_cpu_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    return (f"wall {t:.4f}s, device busy {busy:.4f}s (idle share "
            f"{1 - busy / t:.3f}), " + ", ".join(parts) + "; top kernels: "
            + top_rows(rows) + "; top host operations (self time, profiler "
            "on): " + top_rows(host))


def lm_phase(dev) -> list[dict]:
    """[lm]: the LM serving path on the card at full width and depth.

    The model (:data:`LM_ARCH`) is drawn on the card from :data:`LM_SEED`.
    Prefill runs ``1 x LM_SEQ`` tokens through ``make_serve_step(spec,
    "prefill_32k")``, decode ``LM_DECODE_BATCH`` sequences over
    decode_32k's cache through ``make_serve_step(spec, "decode_32k")``,
    each once with the launch counts set to 0 just before and read just
    after. Checks: the prefill's logits against the same forward with the
    plain versions on the card; an ``LM_PREFIX``-token decode against the
    prefill's logits at each position; B5 and B6 against their plain
    versions at the path's shapes. Returns the kernel records of B5 and
    B6."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import transformer as tfm

    b6_probe(dev)
    spec = configs.get(LM_ARCH)
    cfg = spec.model_cfg
    L = cfg.n_layer
    seq, batch, steps, prefix = LM_SEQ, LM_DECODE_BATCH, LM_STEPS, LM_PREFIX
    pre_dims = dict(spec.shapes["prefill_32k"], batch=1, seq=seq)
    slots = spec.shapes["decode_32k"]["seq"]
    dec_dims = dict(spec.shapes["decode_32k"], batch=batch, seq=slots)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    torch.cuda.reset_peak_memory_stats()

    model, t_init = wall(lambda: tfm.init_params(cfg, gen, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count}")
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    print(f"[lm] {LM_ARCH} at full width and depth ({L} layers, d_model "
          f"{cfg.d_model}, {cfg.n_head} query heads over {cfg.n_kv} kv heads "
          f"of {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, QKV bias "
          f"{cfg.qkv_bias}): {n_params:,} parameters, {gb:.2f} GB in "
          f"{cfg.dtype}, drawn on the card from seed {LM_SEED} in "
          f"{t_init:.2f}s")

    # -- prefill: the main path, counted ----------------------------------
    prefill = configs.make_serve_step(spec, "prefill_32k")
    toks = torch.randint(0, cfg.vocab, (1, seq), generator=gen, device=dev)
    sm.reset_counts()
    fa.reset_counts()
    logits, t_first = wall(lambda: prefill(model, {"tokens": toks}))
    b5_pre, b6_pre = sm.matmul.launches, fa.flash_attention.launches
    if (b5_pre, b6_pre) != (7 * L + 1, L):
        raise AssertionError(f"prefill launched B5 {b5_pre} and B6 {b6_pre} "
                             f"times, not {7 * L + 1} and {L}")
    routes_pre = b5_routes(sm, {"wgmma": 7 * L + 1}, "prefill")
    b6_routes_pre = b6_routes(fa, {"wgmma": L}, "prefill")
    if logits.shape != (1, seq, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not finite (1, S, vocab)")
    _, t_pre = wall(lambda: prefill(model, {"tokens": toks}))
    with mock.patch.object(kernel_ops, "matmul", ref.matmul), \
            mock.patch.object(kernel_ops, "flash_attention",
                              ref.flash_attention):
        plain, t_plain = wall(lambda: prefill(model, {"tokens": toks}))
    err_pre, agree_pre = rel_err(logits, plain), top1(logits, plain)
    del plain
    if not err_pre <= LM_LOGIT_TOL:
        raise AssertionError(f"prefill with the kernels differs from the "
                             f"plain versions by {err_pre} of max|logit|")
    flops_pre = configs.model_flops(spec, "prefill_32k", dims=pre_dims)
    print(f"[lm] prefill 1 x {seq} tokens through make_serve_step(spec, "
          f"'prefill_32k'): {t_pre:.4f}s = {seq / t_pre:.1f} tokens/s (first "
          f"call {t_first:.4f}s); model FLOPs {flops_pre:.4e} = "
          f"{flops_pre / t_pre / 989e12:.4f} of 989 TFLOP/s; launches B5 "
          f"{b5_pre} ({routes_pre}), B6 {b6_pre} ({b6_routes_pre}). Logits "
          f"against the same "
          f"forward with the plain versions on the card ({t_plain:.4f}s): "
          f"largest |diff| {err_pre:.4e} of max|logit| (tolerance "
          f"{LM_LOGIT_TOL}), top-1 agreement {agree_pre:.4f}")
    print(f"[lm] prefill under torch.profiler: "
          + profiled(lambda: prefill(model, {"tokens": toks}),
                     {"B5": is_b5, "B6": is_b6}))

    # -- kernels against their plain versions at the prefill's shapes ------
    p0 = model.layers[0]
    pos = torch.arange(seq, dtype=torch.int32, device=dev)[None, :]
    with torch.inference_mode():
        h = tfm.rms_norm(model.embed[toks], p0.ln1)
        q, k, v = tfm.qkv(p0, cfg, h, pos, tfm.partition_of(model))
        act = tfm.silu(tfm.linear(h, p0.ffn.wg)) * tfm.linear(h, p0.ffn.wi)
        h = h[0]
    b5_cases = {"prefill wq": (h, p0.wq), "prefill wk": (h, p0.wk),
                "prefill ffn.wi": (h, p0.ffn.wi),
                "prefill ffn.wo": (act[0], p0.ffn.wo),
                "prefill head": (h, model.head)}
    ragged = min(4000, seq)
    b6_cases = {"prefill causal S = T": (q, k, v, True, seq),
                f"prefill causal ragged S = T = {ragged}": tuple(
                    x[:, :ragged].contiguous() for x in (q, k, v)) + (
                    True, ragged),
                f"prefill causal S = {seq} over T = {3 * seq // 4}": (
                    q, k[:, :3 * seq // 4].contiguous(),
                    v[:, :3 * seq // 4].contiguous(), True, 3 * seq // 4),
                "prefill causal f16": (q.half(), k.half(), v.half(), True,
                                       seq)}
    b6_cases.update(b6_small_cases(dev, gen))
    results = kernel_checks(b5_cases, b6_cases)
    del h, q, k, v, act, logits, b6_cases

    # -- decode ------------------------------------------------------------
    decode = configs.make_serve_step(spec, "decode_32k")
    cache = tfm.init_cache(cfg, batch, slots, device=dev)
    cache["k"].normal_(generator=gen)          # a stand-in cache from the seed
    cache["v"].normal_(generator=gen)
    cache_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    pre_toks = torch.randint(0, cfg.vocab, (batch, prefix), generator=gen,
                             device=dev)
    want = prefill(model, {"tokens": pre_toks})
    errs, agrees = [], []
    for i in range(prefix):
        step, cache = decode(model, {"tokens": pre_toks[:, i:i + 1],
                                     "cache": cache, "cache_len": i})
        errs.append(rel_err(step, want[:, i]))
        agrees.append(top1(step, want[:, i]))
    del want, step
    if not max(errs) <= LM_LOGIT_TOL:
        raise AssertionError(f"decode differs from prefill by {max(errs)} "
                             f"of max|logit|")
    print(f"[lm] decode against prefill: {batch} sequences of {prefix} "
          f"tokens decoded one by one into the {slots}-slot cache (the "
          f"other {slots - prefix} slots hold random values, masked), each "
          f"step's logits against a {batch} x {prefix} prefill's at that "
          f"position: largest |diff| {max(errs):.4e} of max|logit| "
          f"(tolerance {LM_LOGIT_TOL}; per step "
          f"{' '.join(f'{e:.2e}' for e in errs)}), top-1 agreement "
          f"{sum(agrees) / len(agrees):.4f}")

    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev)
    sm.reset_counts()
    fa.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        out, cache = decode(model, {"tokens": tok, "cache": cache,
                                    "cache_len": slots - steps + i})
        tok = out.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / steps
    b5_dec, b6_dec = sm.matmul.launches, fa.flash_attention.launches
    if (b5_dec, b6_dec) != (steps * (7 * L + 1), steps * L):
        raise AssertionError(f"decode launched B5 {b5_dec} and B6 {b6_dec} "
                             f"times")
    routes_dec = b5_routes(sm, {"skinny": steps * (7 * L + 1)}, "decode")
    b6_routes_dec = b6_routes(fa, {"split": steps * L}, "decode")
    if out.shape != (batch, cfg.vocab) or not bool(torch.isfinite(out).all()):
        raise AssertionError("decode logits are not finite (B, vocab)")
    flops_dec = configs.model_flops(spec, "decode_32k", dims=dec_dims)
    print(f"[lm] decode {batch} x 1 tokens over the {slots}-slot cache "
          f"({cache_gb:.2f} GB) through make_serve_step(spec, 'decode_32k'), "
          f"{steps} greedy steps at cache_len {slots - steps}..{slots - 1}: "
          f"{t_dec * 1e3:.3f} ms per step = {batch / t_dec:.1f} tokens/s; "
          f"model FLOPs {flops_dec:.4e} per step = "
          f"{flops_dec / t_dec / 989e12:.4f} of 989 TFLOP/s; launches B5 "
          f"{b5_dec} ({routes_dec}), B6 {b6_dec} ({b6_routes_dec}); peak "
          f"device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[lm] one decode step under torch.profiler: " + profiled(
        lambda: decode(model, {"tokens": tok, "cache": cache,
                               "cache_len": slots - 1}),
        {"B5": is_b5, "B6": is_b6}))

    # -- kernels against their plain versions at the decode's shapes -------
    pos = torch.full((batch, 1), slots - 1, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        h = tfm.rms_norm(model.embed[tok], p0.ln1)
        q, _, _ = tfm.qkv(p0, cfg, h, pos, tfm.partition_of(model))
        act = tfm.silu(tfm.linear(h, p0.ffn.wg)) * tfm.linear(h, p0.ffn.wi)
        h, act = h[:, 0], act[:, 0]
    ck, cv = cache["k"][0], cache["v"][0]
    short = min(1000, slots)
    results.update(kernel_checks(
        {"decode wq": (h, p0.wq), "decode ffn.wi": (h, p0.ffn.wi),
         "decode ffn.wo": (act, p0.ffn.wo), "decode head": (h, model.head)},
        {f"decode t_real = {slots}": (q, ck, cv, False, slots),
         f"decode t_real = {short}": (q, ck, cv, False, short)}))

    csrc = "src/repro_torch/kernels/csrc/"
    b5, b6 = results["prefill ffn.wi"], results["prefill causal S = T"]
    b5_err = max(r["max_abs_err"] for r in results.values() if r["b5"])
    b6_err = max(r["max_abs_err"] for r in results.values() if not r["b5"])
    return [
        {"name": "matmul", "route": "cuda", "source": csrc + "matmul.cu",
         "replaces": "src/repro/kernels/segment_matmul.py:52",
         "launches": b5_pre + b5_dec, "max_abs_err": b5_err, "ms": b5["ms"],
         "plain_ms": b5["plain_ms"], "bound_ms": b5["bound_ms"],
         "bound_by": b5["bound_by"], "library_ms": b5["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": csrc + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:96",
         "launches": b6_pre + b6_dec, "max_abs_err": b6_err, "ms": b6["ms"],
         "plain_ms": b6["plain_ms"], "bound_ms": b6["bound_ms"],
         "bound_by": b6["bound_by"], "library_ms": b6["library_ms"]}]


def kernel_checks(b5_cases: dict, b6_cases: dict, tag: str = "lm") -> dict:
    """B5 ``(a, b)`` and B6 ``(q, k, v, causal, t_real)`` cases, each held
    against its plain version on the same inputs and timed beside its
    bound: the kernel's and the library call's times (:func:`call_times`)
    and the plain version's time back to back; one ``[tag]`` line per
    case. Returns each case's numbers (``ms`` and ``library_ms`` as
    :func:`call_times` gives them)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm

    out = {}
    for name, (a, b) in b5_cases.items():
        (M, K), N = a.shape, b.shape[1]
        got, want = sm.matmul(a, b), ref.matmul(a, b)
        torch.cuda.synchronize()
        err, ok = 0.0, True
        rows = max(1, 2**28 // max(N, 1))    # the check's temporaries
        for r in range(0, M, rows):
            diff = (got[r:r + rows] - want[r:r + rows]).abs()
            err = max(err, float(diff.max()))
            ok &= bool((diff <= B5_RTOL * want[r:r + rows].abs()
                        + B5_ATOL_PER_K * K).all())
        if not ok:
            raise AssertionError(f"B5 {name} disagrees with its plain version "
                                 f"(max abs err {err})")
        del got, want, diff
        heavy = M * N * K > 1e11
        t, kern = call_times(lambda: sm.matmul(a, b), 5 if heavy else 20)
        lib_ms, lib = call_times(lambda: torch.matmul(a, b),
                                 5 if heavy else 20)
        plain_ms = cuda_ms(lambda: ref.matmul(a, b), iters=2, warmup=1)
        bf16 = a.dtype == torch.bfloat16
        bound = sm.bound_ms(M, N, K, a.dtype)
        peak = sm.BF16_FLOP_PER_S if bf16 else sm.F32_FLOP_PER_S
        by = ("operations" if 2.0 * M * N * K / peak * 1e3 >= bound
              else "bytes")
        out[name] = dict(b5=True, max_abs_err=err, ms=t, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by)
        print(f"[{tag}] B5 {name} ({M} x {K}) @ ({K} x {N}), "
              f"{'bf16' if bf16 else 'f32'} -> f32, "
              f"{sm.plan(M, N, K, a.dtype)}: max abs err "
              f"{err:.3e} against the plain version (tolerance {B5_RTOL} "
              f"relative + {B5_ATOL_PER_K * K:.2e}); kernel {kern}; plain "
              f"{plain_ms:.4f} ms back to back; library torch.matmul "
              f"({'bf16 out' if bf16 else 'f32, TF32 off'}) {lib}; bound "
              f"{bound:.4f} ms ({by}) = {bound / t:.3f} of the kernel's "
              f"time; {2.0 * M * N * K / t / 1e9:.1f} TFLOP/s")
    for name, (q, k, v, causal, t_real) in b6_cases.items():
        B, S, H, dh = q.shape
        Hkv = k.shape[2]
        kdt = torch.float32 if q.dtype == torch.float64 else q.dtype
        p = fa.plan(B, S, H, Hkv, t_real, causal, fa.kernel_width(dh), kdt)
        route = p.route
        before = fa.flash_attention.routes[route]
        got = fa.flash_attention(q, k, v, causal=causal, t_real=t_real)
        want = ref.flash_attention(q, k, v, causal=causal, t_real=t_real)
        torch.cuda.synchronize()
        if fa.flash_attention.routes[route] != before + 1:
            raise AssertionError(f"B6 {name} did not launch on the {route} "
                                 "route")
        tol = fa.error_bound(want)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        worst = float((diff / tol.clamp_min(1e-30)).max())
        if not bool((diff <= tol).all()):
            raise AssertionError(f"B6 {name} disagrees with its plain version "
                                 f"(max abs err {err}, {worst} of the bound)")
        typical = float(want.float().abs().mean())
        largest = float(want.float().abs().max())
        # the bound's reach: the plain version without its last keys
        cut_keys = fa.CHECK_CUT_KEYS
        cut = ref.flash_attention(q, k, v, causal=causal,
                                  t_real=t_real - cut_keys)
        caught = float(((cut.float() - want.float()).abs() > tol)
                       .float().mean())
        if not caught > 0:
            raise AssertionError(f"B6 {name}: the bound does not see the "
                                 f"last {cut_keys} keys left out")
        del got, want, diff, tol, cut
        t, kern = call_times(lambda: fa.flash_attention(
            q, k, v, causal=causal, t_real=t_real))
        plain_ms = cuda_ms(lambda: ref.flash_attention(
            q, k, v, causal=causal, t_real=t_real), iters=2, warmup=1)
        qt = q.transpose(1, 2).contiguous()          # (B, heads, len, dh)
        kt, vt = (x[:, :t_real].transpose(1, 2).contiguous() for x in (k, v))
        lib_ms, lib = call_times(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        del qt, kt, vt
        item = q.element_size()
        bound = fa.bound_ms(B, S, H, Hkv, t_real, causal, dh, item)
        peak = fa.F32_FLOP_PER_S if item >= 4 else fa.BF16_FLOP_PER_S
        flops = 4.0 * dh * B * H * fa.attended_pairs(S, t_real, causal)
        by = "operations" if flops / peak * 1e3 >= bound else "bytes"
        out[name] = dict(b5=False, max_abs_err=err, ms=t, plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=bound, bound_by=by)
        tolerance = (f"{fa.F32_TOL} of |plain| + {fa.F32_TOL}"
                     if q.dtype in (torch.float32, torch.float64) else
                     f"{fa.RTOL} of |plain| + {fa.ROW_ATOL} of its row's "
                     "largest")
        print(f"[{tag}] B6 {name}: q ({B}, {S}, {H}, {dh}) over k, v ({B}, "
              f"{k.shape[1]}, {Hkv}, {dh}), {str(q.dtype)[6:]}, t_real "
              f"{t_real}, causal {causal}, {p}: max "
              f"abs err {err:.3e} against the plain version, {worst:.3f} of "
              f"the bound ({tolerance}) at most; |plain| typically "
              f"{typical:.3e}, largest {largest:.3e}; without the last "
              f"{cut_keys} keys the plain version breaks the bound in "
              f"{caught:.3e} of the elements; kernel {kern}; plain "
              f"{plain_ms:.4f} ms back to back; library "
              f"scaled_dot_product_attention (enable_gqa) {lib}; bound "
              f"{bound:.4f} ms ({by}) = {bound / t:.3f} of the kernel's "
              f"time; {flops / t / 1e9:.1f} TFLOP/s")
    return out


def b6_probe(dev) -> None:
    """B6's single-tile check, before anything else of B6 runs: the wgmma
    route's S = Q K^T (SS wgmma from TMA-loaded, swizzled tiles) within
    f32 rounding of the plain product, and P V (P in bf16 registers, RS
    wgmma, V MN-major) within ``error_bound`` of the plain version. A
    descriptor or layout mistake shows here on one tile."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    q = torch.randn(64, 128, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(128, 128, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    s, o = fa.rs_probe(q, k, v)
    torch.cuda.synchronize()
    s_want = q.float() @ k.float().T
    s_err = float(((s - s_want).abs() / (1e-4 + 1e-5 * s_want.abs())).max())
    want = ref.flash_attention(*(x.float()[None, :, None] for x in (q, k, v)))
    tol = fa.error_bound(want.bfloat16())[0, :, 0]
    want = want[0, :, 0]
    o_err = float(((o - want).abs() / tol).max())
    if not (s_err <= 1 and o_err <= 1):
        raise AssertionError(f"B6's single-tile check failed: S at {s_err} "
                             f"and O at {o_err} of their tolerances")
    print(f"[lm] B6 single-tile check of the wgmma route (64 x 128 q, 128 "
          f"keys, dh 128, bf16): S = Q K^T max abs err "
          f"{float((s - s_want).abs().max()):.3e} (tolerance 1e-4 + 1e-5 "
          f"of |S|, {s_err:.3f} of it); O with P in bf16 registers max abs "
          f"err {float((o - want).abs().max()):.3e} ({o_err:.3f} of "
          f"error_bound)")


def b6_small_cases(dev, gen) -> dict:
    """B6 cases at small sizes for the routes and dtypes the glm4-9b path
    does not take: dh 64 (wgmma), dh 16 (mma and split), f16, f32, dh 12
    (zero-padded to 16), dh 136 and 256 (wide) and f64 (computed in f32)."""
    cases = {}
    for name, (B, S, T, H, Hkv, dh, dt, causal, t_real) in {
            "dh 64 causal": (2, 600, 600, 16, 4, 64, torch.bfloat16, True,
                             600),
            "dh 16 causal": (2, 300, 300, 4, 2, 16, torch.bfloat16, True,
                             300),
            "dh 16 decode": (4, 1, 400, 4, 2, 16, torch.bfloat16, False,
                             333),
            "f16 dh 64 decode": (4, 1, 3000, 16, 1, 64, torch.float16, False,
                                 2900),
            "f32 dh 16 causal": (2, 300, 300, 4, 2, 16, torch.float32, True,
                                 300),
            "f32 dh 128 decode": (4, 1, 2000, 32, 2, 128, torch.float32,
                                  False, 1999),
            "dh 12 causal": (2, 300, 300, 4, 2, 12, torch.bfloat16, True,
                             300),
            "dh 136 causal": (2, 300, 300, 4, 2, 136, torch.bfloat16, True,
                              300),
            "f32 dh 256 decode": (4, 1, 2000, 8, 2, 256, torch.float32,
                                  False, 1999),
            "f64 dh 64 causal": (2, 300, 300, 4, 2, 64, torch.float64, True,
                                 300)}.items():
        q = torch.randn(B, S, H, dh, generator=gen, device=dev).to(dt)
        k, v = (torch.randn(B, T, Hkv, dh, generator=gen, device=dev).to(dt)
                for _ in range(2))
        cases[name] = (q, k, v, causal, t_real)
    return cases


#: the [lm-smoke] phase: the smoke configs of the two dense LMs (2 layers,
#: d_model 64, dh 16; glm4-smoke GQA 2:1 with QKV bias, codeqwen-smoke MHA)
#: on the card in bf16 and f32, weights drawn from LM_SEED: prefill
#: LM_SMOKE_BATCH x LM_SMOKE_SEQ tokens, then those tokens decoded one by
#: one into an LM_SMOKE_SLOTS-slot cache (the model's dtype, and f32 under
#: a bf16 model)
LM_SMOKE_ARCHS = ("glm4-9b", "codeqwen1.5-7b")
LM_SMOKE_BATCH, LM_SMOKE_SEQ, LM_SMOKE_SLOTS = 4, 96, 160
#: f32 logits (kernels against plain versions, decode against prefill):
#: elementwise within this relative plus absolute tolerance, the f32 bound
#: of tests/test_torch_transformer.py
LM_SMOKE_F32_TOL = 2e-3


def logits_err(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """The share of its tolerance the largest logit difference takes: bf16
    against LM_LOGIT_TOL of max|logit|, f32 elementwise against
    LM_SMOKE_F32_TOL relative plus absolute. At most 1 passes."""
    if dtype == torch.float32:
        d = (got.float() - want.float()).abs()
        return float((d / (LM_SMOKE_F32_TOL * (1 + want.float().abs())))
                     .max())
    return rel_err(got, want) / LM_LOGIT_TOL


def lm_smoke_phase(dev) -> tuple[int, int]:
    """[lm-smoke]: the smoke LMs on the card through B5 and B6, each run
    counted (B5 7L + 1 launches a forward or step; B6 L, on the route its
    dtype and head width give), against the same steps with the plain
    versions, decode against prefill. Returns the phase's B5 and B6
    launches."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import transformer as tfm

    B, S, slots = LM_SMOKE_BATCH, LM_SMOKE_SEQ, LM_SMOKE_SLOTS
    plain_ops = (mock.patch.object(kernel_ops, "matmul", ref.matmul),
                 mock.patch.object(kernel_ops, "flash_attention",
                                   ref.flash_attention))
    n5 = n6 = 0
    for arch in LM_SMOKE_ARCHS:
        spec = configs.get(arch)
        for dt in (torch.bfloat16, torch.float32):
            cfg = dataclasses.replace(spec.smoke_cfg, dtype=dt)
            L = cfg.n_layer
            gen = torch.Generator(device=dev).manual_seed(LM_SEED)
            model = tfm.init_params(cfg, gen, device=dev)
            prefill = configs.make_serve_step(spec, "prefill_32k", cfg)
            decode = configs.make_serve_step(spec, "decode_32k", cfg)
            toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                 device=dev)
            attn = "f32" if dt == torch.float32 else "mma"
            sm.reset_counts()
            fa.reset_counts()
            logits = prefill(model, {"tokens": toks})
            torch.cuda.synchronize()
            if sm.matmul.launches != 7 * L + 1:
                raise AssertionError(f"{cfg.name} prefill launched B5 "
                                     f"{sm.matmul.launches} times")
            b6 = b6_routes(fa, {attn: L}, f"{cfg.name} prefill")
            n5, n6 = n5 + sm.matmul.launches, n6 + L
            with plain_ops[0], plain_ops[1]:
                plain = prefill(model, {"tokens": toks})
            e_pre = logits_err(logits, plain, dt)
            if not e_pre <= 1:
                raise AssertionError(f"{cfg.name} prefill with the kernels "
                                     f"differs from the plain versions "
                                     f"({e_pre} of the tolerance)")
            what = [f"prefill {B} x {S} ({b6}) against the plain versions "
                    f"{e_pre:.3f} of the tolerance"]
            for cdt in ((dt, torch.float32) if dt == torch.bfloat16
                        else (dt,)):
                cache = tfm.init_cache(cfg, B, slots, dtype=cdt, device=dev)
                cache["k"].normal_(generator=gen)    # masked slots
                cache["v"].normal_(generator=gen)
                plain_cache = {n: c.clone() for n, c in cache.items()}
                sm.reset_counts()
                fa.reset_counts()
                steps = [decode(model, {"tokens": toks[:, i:i + 1],
                                        "cache": cache, "cache_len": i})[0]
                         for i in range(S)]
                torch.cuda.synchronize()
                if sm.matmul.launches != S * (7 * L + 1):
                    raise AssertionError(f"{cfg.name} decode launched B5 "
                                         f"{sm.matmul.launches} times")
                route = "f32" if cdt == torch.float32 else "split"
                b6 = b6_routes(fa, {route: S * L}, f"{cfg.name} decode")
                b5 = ", ".join(f"{n} {r}" for r, n in
                               sm.matmul.routes.items() if n)
                n5, n6 = n5 + sm.matmul.launches, n6 + S * L
                with plain_ops[0], plain_ops[1]:
                    plain = [decode(model, {"tokens": toks[:, i:i + 1],
                                            "cache": plain_cache,
                                            "cache_len": i})[0]
                             for i in range(S)]
                e_plain = max(logits_err(a, b, dt)
                              for a, b in zip(steps, plain))
                e_pre = max(logits_err(steps[i], logits[:, i], dt)
                            for i in range(S))
                if not (e_plain <= 1 and e_pre <= 1):
                    raise AssertionError(
                        f"{cfg.name} decode over a {cdt} cache: "
                        f"{e_plain} (plain versions) and {e_pre} (prefill) "
                        f"of the tolerance")
                what.append(f"decode of those {S} tokens over a {slots}-slot "
                            f"{str(cdt)[6:]} cache (B5 {b5}; B6 {b6}) "
                            f"against the plain versions {e_plain:.3f} and "
                            f"against prefill {e_pre:.3f} of the tolerance")
            tol = (f"{LM_SMOKE_F32_TOL} relative + absolute"
                   if dt == torch.float32 else
                   f"{LM_LOGIT_TOL} of max|logit|")
            print(f"[lm-smoke] {cfg.name} ({L} layers, d_model "
                  f"{cfg.d_model}, {cfg.n_head} query heads over {cfg.n_kv} "
                  f"kv heads of {cfg.d_head}) in {str(dt)[6:]}, tolerance "
                  f"{tol}: " + "; ".join(what))
    return n5, n6


#: the [gnn] phase: graphsage-reddit at full width on minibatch_lg's static
#: shape (its seeds, fanout and padding), GNN_BATCHES minibatches, over a
#: pool at Reddit's published scale: random_powerlaw_graph(232,965,
#: GNN_AVG_DEG) keeps 114.5M of its 114.6M directed edges (self-loops
#: dropped; Reddit has 114,615,892). Pool, features, labels, seeds and
#: weights come from GNN_SEED.
GNN_ARCH = "graphsage-reddit"
GNN_SHAPE = "minibatch_lg"
GNN_SEED = 17
GNN_BATCHES = 8
GNN_AVG_DEG = 492
#: B4 against its plain version, elementwise: rtol = atol = 1e-4
#: (tests/test_kernels.py's segment-sum tolerance: the same f32 rows added
#: in another order). A forward with the kernels against the same forward
#: with the plain versions: the largest |difference| within this share of
#: the largest |logit| (f32 throughout; two layers of f32 sums reordered).
B4_TOL = 1e-4
GNN_LOGIT_TOL = 1e-4


#: at a segment of very many rows (a power-law hub of the whole
#: ogb_products graph: ~300,000 rows a rank into node 0) two orders of f32
#: adds of random-signed rows part by ~u * sqrt(N) * |partial sums|, past
#: 1e-4 where the sum cancels; there the check adds this share of the
#: segment's sum of |rows| (2^-20 = 16 u) to B4_TOL's bound. The kernel
#: stays bit-equal to ref.segment_sum_tiled, its exact mirror
B4_SUM_TOL = 2.0 ** -20


def b4_checks(cases: dict, tag: str = "gnn", sum_tol: float = 0.0) -> dict:
    """B4 ``(vals, ids, S)`` cases. Each builds its plan once
    (``segment_plan``, timed apart), then holds the kernel (with the plan)
    against its plain version on the same inputs (rtol = atol =
    :data:`B4_TOL`, plus ``sum_tol`` of each segment's sum of |rows|:
    :data:`B4_SUM_TOL` at the mesh's hub segments), against itself on a
    second call and against the plain mirror of its decomposition
    (``ref.segment_sum_tiled``), both bit for bit; then timed beside its
    bound (with its share of it) and its plain version, and for ids all in
    range (the paths') beside the library call ``torch.zeros(S,
    d).index_add_(0, ids, vals)`` (where some are out of range, over the
    rows in range, picked beforehand: no one PyTorch call drops ids). The
    bound reads the rows in range only (the kernel reads no other: the
    work this run's ids need). One ``[tag]`` line per case; returns each
    case's numbers."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm

    out = {}
    for name, (vals, ids, S) in cases.items():
        (E, d), dev = vals.shape, vals.device
        plan = sm.segment_plan(ids, S)
        got, want = sm.segment_sum(vals, plan, S), ref.segment_sum(vals, ids, S)
        again = sm.segment_sum(vals, plan, S)
        tile, fans = sm.segment_tiles(E, d)
        mirror = ref.segment_sum_tiled(vals, plan, tile, fans)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        bound = B4_TOL + B4_TOL * want.abs()
        if sum_tol:
            bound += sum_tol * ref.segment_sum(vals.abs(), ids, S)
        if not bool((diff <= bound).all()):
            raise AssertionError(f"B4 {name} disagrees with its plain version "
                                 f"(max abs err {err})")
        del bound
        if not (torch.equal(got, again) and torch.equal(got, mirror)):
            raise AssertionError(f"B4 {name}: two calls or the kernel and "
                                 f"its tiled mirror differ in their bits")
        ok = (ids >= 0) & (ids < S)
        kept = int(ok.sum())
        in_range = kept == E
        del got, want, diff, again, mirror
        bound = (sm.segment_sum_bound_ms(kept, d, S)
                 + 4 * (E - kept) / sm.HBM_BYTES_PER_S * 1e3)
        line = (f"[{tag}] B4 {name}: ({E} x {d}) into {S} segments: max abs "
                f"err {err:.3e} against the plain version (tolerance "
                f"{B4_TOL} + {B4_TOL} of |plain|"
                + (f" + {sum_tol:.3e} of the segment's sum of |rows|"
                   if sum_tol else "") + "); bit-equal on a second "
                f"call and to ref.segment_sum_tiled (tile {tile}, fans "
                f"{fans})")
        plan_ms, plan_clause = call_times(lambda: sm.segment_plan(ids, S))
        t, kern = call_times(lambda: sm.segment_sum(vals, plan, S))
        plain_ms = cuda_ms(lambda: ref.segment_sum(vals, ids, S), iters=5,
                           warmup=1)
        rec = dict(max_abs_err=err, bound_ms=bound, ms=t, plain_ms=plain_ms,
                   plan_ms=plan_ms, share=bound / t)
        line += (f"; kernel with its plan {kern}; bound {bound:.6f} ms "
                 f"(bytes: 4*E_in*d + 4*E + 4*S*d at 3.35 TB/s, E_in = "
                 f"{kept:,} rows in range) = "
                 f"{bound / t:.3f} of the kernel's time; plan (segment_plan: "
                 f"stable sort, searchsorted; "
                 f"{sm.segment_plan_bytes(E, S):,} bytes beside the ids) "
                 f"{plan_clause}; plain {plain_ms:.6f} ms back to back")
        if in_range:
            lib_ms, lib = call_times(lambda: torch.zeros(
                (S, d), device=dev).index_add_(0, ids, vals))
            line += f"; library torch.zeros(S, d).index_add_ {lib}"
        else:
            kept_ids, kept_vals = ids[ok], vals[ok]
            lib_ms, lib = call_times(lambda: torch.zeros(
                (S, d), device=dev).index_add_(0, kept_ids, kept_vals))
            del kept_ids, kept_vals
            line += (f"; library torch.zeros(S, d).index_add_ over the "
                     f"{kept:,} rows in range (picked beforehand) {lib}")
        rec.update(library_ms=lib_ms)
        out[name] = rec
        print(line)
    return out


def gnn_phase(dev) -> tuple[dict, int, float]:
    """[gnn]: GraphSAGE serving on the card at full width.

    Builds the pool on the host, draws the model on the card, then serves
    :data:`GNN_BATCHES` sampled minibatches through
    ``make_serve_step(spec, GNN_SHAPE)`` with the launch counts set to 0
    just before and read just after; each batch's logits are held against
    the same forward with the plain versions on the card. Then B4 and B5's
    f32 path against their plain versions at the path's shapes, a profiled
    forward and the peak device memory. Returns B4's kernel record, B5's
    launches in this phase's main path and B5's largest error here."""
    from repro_torch import configs
    from repro_torch.data import graph_sampler as gs
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import gnn

    spec = configs.get(GNN_ARCH)
    dims = spec.shapes[GNN_SHAPE]
    cfg = configs.cell_model_cfg(spec, GNN_SHAPE)
    n_pool, n_pad = dims["pool_nodes"], dims["n"]
    e_pad = int(np.ceil(2 * dims["e"] / 512)) * 512     # directed, padded
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    src, dst = gs.random_powerlaw_graph(n_pool, GNN_AVG_DEG, seed=GNN_SEED)
    t_gen = time.perf_counter() - t0
    rng = np.random.default_rng(GNN_SEED)
    feats = rng.standard_normal((n_pool, dims["d_feat"]), dtype=np.float32)
    labels = rng.integers(0, cfg.n_classes, n_pool).astype(np.int32)
    t0 = time.perf_counter()
    g = gs.CSRGraph(n_pool, src, dst)
    t_csr = time.perf_counter() - t0
    n_edges = int(src.shape[0])
    del src, dst
    print(f"[gnn] pool at Reddit's published scale: {n_pool:,} nodes, "
          f"{n_edges:,} directed edges (random_powerlaw_graph(n, "
          f"{GNN_AVG_DEG}), seed {GNN_SEED}; Reddit has "
          f"{dims['pool_edges']:,}), {dims['d_feat']} N(0, 1) f32 features "
          f"and {cfg.n_classes} labels per node; generated in {t_gen:.2f}s, "
          f"CSR built in {t_csr:.2f}s on the host")

    gen = torch.Generator(device=dev).manual_seed(GNN_SEED)
    model = gnn.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count}")
    print(f"[gnn] {GNN_ARCH} at full width ({cfg.n_layers} layers, d_in "
          f"{cfg.d_in}, hidden {cfg.d_hidden}, {cfg.n_classes} classes): "
          f"{n_params:,} f32 parameters drawn on the card from seed "
          f"{GNN_SEED}")

    # -- the main path: GNN_BATCHES minibatches, counted -------------------
    serve = configs.make_serve_step(spec, GNN_SHAPE)
    keys = ("node_feat", "src", "dst", "edge_mask", "seed_mask")
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain versions' f32
    sm.reset_counts()
    sm.segment_sum.launches = sm.segment_plan.builds = 0
    stats, first = [], None
    for i in range(GNN_BATCHES):
        seeds = rng.choice(n_pool, dims["seeds"], replace=False)
        t0 = time.perf_counter()
        batch = gs.sample_subgraph_batch(g, feats, labels, seeds,
                                         dims["fanout"], rng,
                                         pad_nodes=n_pad, pad_edges=e_pad)
        t_sample = time.perf_counter() - t0
        feed, t_copy = wall(lambda: {k: torch.as_tensor(batch[k]).to(dev)
                                     for k in keys})
        logits, t_fwd = wall(lambda: serve(model, feed))
        seed_logits = logits[feed["seed_mask"]]
        answer = seed_logits.argmax(-1)
        if logits.shape != (n_pad, cfg.n_classes) or not bool(
                torch.isfinite(logits).all()) or answer.shape != (
                dims["seeds"],):
            raise AssertionError(f"batch {i}: logits are not finite "
                                 f"({n_pad}, {cfg.n_classes})")
        with mock.patch.object(kernel_ops, "segment_sum", ref.segment_sum), \
                mock.patch.object(kernel_ops, "matmul", ref.matmul), \
                mock.patch.object(kernel_ops, "segment_plan",
                                  lambda ids, num_segments: ids):
            plain = serve(model, feed)
        err = rel_err(logits, plain)
        agree = top1(seed_logits, plain[feed["seed_mask"]])
        if not err <= GNN_LOGIT_TOL:
            raise AssertionError(f"batch {i}: the forward with the kernels "
                                 f"differs from the plain versions by {err} "
                                 f"of max|logit|")
        stats.append(dict(sample=t_sample, copy=t_copy, fwd=t_fwd, err=err,
                          agree=agree, edges=int(batch["edge_mask"].sum())))
        if first is None:
            first = feed
        del logits, plain, batch
    b4_n, b5_n = sm.segment_sum.launches, sm.matmul.launches
    plans_n = sm.segment_plan.builds
    if b4_n <= 0 or b5_n <= 0:
        raise AssertionError("the GNN path launched B4 or B5 no time")
    if plans_n != GNN_PLANS[GNN_ARCH]["serve"] * GNN_BATCHES:
        raise AssertionError(f"{GNN_BATCHES} forwards built {plans_n} B4 "
                             f"plans")
    if (b4_n, b5_n) != (2 * cfg.n_layers * GNN_BATCHES,
                        (2 * cfg.n_layers + 1) * GNN_BATCHES):
        raise AssertionError(f"{GNN_BATCHES} forwards launched B4 {b4_n} and "
                             f"B5 {b5_n} times")
    routes_gnn = b5_routes(sm, {"f32": b5_n}, "the GNN path")
    seeds_n = dims["seeds"]
    steady = stats[1:] or stats
    fwd = sum(r["fwd"] for r in steady) / len(steady)
    e2e = sum(r["sample"] + r["copy"] + r["fwd"] for r in steady) / len(steady)
    flops = configs.model_flops(spec, GNN_SHAPE, dims=dict(dims,
                                                           kind="serve"))
    for i, r in enumerate(stats):
        print(f"[gnn] batch {i}: {seeds_n} seeds, {r['edges']:,} real of "
              f"{e_pad:,} edges; sampling {r['sample']:.4f}s on the host, "
              f"copy to the card {r['copy'] * 1e3:.3f} ms, forward "
              f"{r['fwd'] * 1e3:.3f} ms; logits within {r['err']:.3e} of "
              f"max|logit| of the plain versions' (tolerance "
              f"{GNN_LOGIT_TOL}), seeds' top-1 agreement {r['agree']:.4f}")
    print(f"[gnn] main path: {GNN_BATCHES} minibatches through "
          f"make_serve_step(spec, '{GNN_SHAPE}') at ({n_pad:,} nodes, "
          f"{e_pad:,} edges); launches B4 {b4_n}, B5 {b5_n} ({routes_gnn}); "
          f"B4 plans built {plans_n} (one a forward, for dst, shared by "
          f"both layers' sums and counts); "
          f"after the first "
          f"batch: forward {fwd * 1e3:.3f} ms = {seeds_n / fwd:.1f} seeds/s "
          f"on the card, {e2e:.4f}s per batch with sampling and copy = "
          f"{seeds_n / e2e:.1f} seeds/s end to end; model FLOPs "
          f"{flops:.4e} per forward = {flops / fwd / 67e12:.4f} of the "
          f"67 TFLOP/s f32 peak")
    print(f"[gnn] one forward under torch.profiler: " + profiled(
        lambda: serve(model, first), {"B4": is_b4, "B5": is_b5}))

    # -- B4 and B5 against their plain versions at the path's shapes ------
    x0, src0, dst0, mask0 = (first[k] for k in ("node_feat", "src", "dst",
                                                "edge_mask"))
    with torch.inference_mode():
        h1 = gnn.sage_layer(model.layers[0], x0, src0, dst0, mask0)
        h2 = gnn.sage_layer(model.layers[1], h1, src0, dst0, mask0)
        agg1 = x0[src0] * mask0[:, None]
        agg2 = h1[src0] * mask0[:, None]
    ids = rng.integers(0, n_pad, e_pad)
    u = rng.random(e_pad)
    ids[u < 0.1] = -1
    ids[(u >= 0.1) & (u < 0.15)] = n_pad + 7
    rand_ids = torch.as_tensor(ids.astype(np.int32), device=dev)
    rand_vals = torch.randn(e_pad, dims["d_feat"], generator=gen, device=dev)
    b4 = b4_checks({
        "layer-1 neighbour sum (d = 602)": (agg1, dst0, n_pad),
        "layer-2 neighbour sum (d = 128)": (agg2, dst0, n_pad),
        "degree count (d = 1)": (mask0[:, None], dst0, n_pad),
        "random unsorted ids, 10% -1, 5% >= S (d = 602)": (
            rand_vals, rand_ids, n_pad)})
    del agg1, agg2, rand_vals
    b5 = kernel_checks({"layer-1 w_self": (x0, model.layers[0].w_self),
                        "layer-2 w_self": (h1, model.layers[1].w_self),
                        "head": (h2, model.head)}, {}, tag="gnn")
    # a forward's device time, and the kernels' share of it from the
    # per-call times above (the profiler can drop records)
    fwd_dev, fwd_clause = call_times(lambda: serve(model, first), iters=10)
    b4_ms = (b4["layer-1 neighbour sum (d = 602)"]["ms"]
             + b4["layer-2 neighbour sum (d = 128)"]["ms"]
             + 2 * b4["degree count (d = 1)"]["ms"])
    b5_ms = (2 * b5["layer-1 w_self"]["ms"] + 2 * b5["layer-2 w_self"]["ms"]
             + b5["head"]["ms"])
    print(f"[gnn] one forward on the first batch: {fwd_clause}; its 4 B4 "
          f"calls take {b4_ms:.6f} ms ({b4_ms / fwd_dev:.3f} of the device "
          f"time) and its 5 B5 calls {b5_ms:.6f} ms ({b5_ms / fwd_dev:.3f}) "
          f"by the per-call times above; served, the forward took "
          f"{fwd * 1e3:.3f} ms of wall: idle share "
          f"{1 - fwd_dev / (fwd * 1e3):.3f}")
    print(f"[gnn] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f}s")

    main = b4["layer-1 neighbour sum (d = 602)"]
    record = {"name": "segment_sum", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/segment_sum.cu",
              "replaces": "src/repro/kernels/segment_matmul.py:104",
              "launches": b4_n,
              "max_abs_err": max(r["max_abs_err"] for r in b4.values()),
              "ms": main["ms"], "plain_ms": main["plain_ms"],
              "bound_ms": main["bound_ms"], "bound_by": "bytes",
              "library_ms": main["library_ms"]}
    return record, b5_n, max(r["max_abs_err"] for r in b5.values())


#: the [train] phase: glm4-9b at full width cut in depth to TRAIN_LAYERS of
#: its 40 layers (one card's memory: the reference's f32 moments make 40
#: layers 112.8 GB of state alone) on train_4k's sequence of TRAIN_SEQ
#: tokens, batch TRAIN_BATCH of its 256, TRAIN_STEPS steps (the first
#: counted, the rest timed); the plain comparison on a 1-layer model of the
#: same width (the plain attention's (32, 4,096, 4,096) f32 scores fit)
TRAIN_ARCH = "glm4-9b"
TRAIN_LAYERS = 8
TRAIN_SEQ, TRAIN_BATCH = 4096, 1
TRAIN_STEPS = 4
TRAIN_SEED = 19
#: bf16 gradients, kernels against the plain versions: each leaf within this
#: share of its largest |plain gradient| (PERF.md section 2's bf16 logits
#: bound), the loss within TRAIN_LOSS_TOL of itself. The key bias's gradient
#: sums the positions' key gradients, which nearly cancel (before RoPE a
#: row's key gradients sum to zero), so it is held to the scale its
#: per-position errors add up to: the same layer's wk gradient's
TRAIN_GRAD_TOL = 5e-2
TRAIN_LOSS_TOL = 1e-2
#: f32 GraphSAGE gradients: within this share of each leaf's largest
GNN_GRAD_TOL = 1e-4
#: the restart check: the --smoke CLI for RESTART_STEPS steps, a checkpoint
#: every RESTART_EVERY, a failure injected at RESTART_FAIL
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 6, 2, 3


def grad_leaf_errs(got: dict, want: dict) -> dict:
    """Each gradient's largest |kernel - plain| over the largest |plain| of
    its scale leaf (the key bias takes wk's: see TRAIN_GRAD_TOL)."""
    out = {}
    for name, g in got.items():
        scale_of = name.replace(".bk", ".wk") if name.endswith(".bk") else name
        scale = float(want[scale_of].float().abs().max())
        out[name] = float((g.float() - want[name].float()).abs().max()) / max(
            scale, 1e-30)
    return out


class ReluPattern:
    """One run's relu pattern, replayed on another run. GraphSAGE's relu
    has a kink at 0. The kernels and the plain versions sum in other
    orders, and ``index_add_``'s float atomics change the plain version's
    order from run to run, so a pre-activation within the f32 rounding of
    0 can take one sign in one run and the other in the next. Both
    gradients are then right, and differ by that entry's whole term: at
    graphsage-reddit's minibatch_lg such a flip put layers.1.w_self's
    gradient 1.06e-2 of its scale off the plain one's (H100 80GB HBM3,
    700 W), where the gradients otherwise agree within 7e-6. ``record`` is relu that keeps each call's input; ``replay``
    multiplies the n-th call's input by the n-th kept input's mask
    (> 0), so the second run differentiates the same piece of the
    function as the first. It counts in ``flips`` the entries whose own
    sign disagreed, and keeps the kept inputs' least nonzero |value|
    (``nearest``) and the two runs' largest difference (``gap``)."""

    def __init__(self):
        self.inputs, self.flips, self.entries = [], 0, 0
        self.nearest, self.gap = float("inf"), 0.0
        self._relu, self._next = torch.relu, 0

    def record(self, x: torch.Tensor) -> torch.Tensor:
        self.inputs.append(x.detach().clone())
        return self._relu(x)

    def replay(self, x: torch.Tensor) -> torch.Tensor:
        kept = self.inputs[self._next]
        self._next += 1
        mask = kept > 0
        self.flips += int(((x.detach() > 0) != mask).sum())
        self.entries += mask.numel()
        nonzero = kept[kept != 0]
        if nonzero.numel():
            self.nearest = min(self.nearest, float(nonzero.abs().min()))
        self.gap = max(self.gap, float((x.detach() - kept).abs().max()))
        return x * mask


def plain_ops():
    """Patches that put the plain versions in the models' kernel calls (the
    differentiable ops of kernels/ops.py): autograd then runs through plain
    PyTorch, on the id vectors (no B4 plan is built)."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    return [mock.patch.object(kernel_ops, "matmul", ref.matmul),
            mock.patch.object(kernel_ops, "flash_attention",
                              ref.flash_attention),
            mock.patch.object(kernel_ops, "segment_sum", ref.segment_sum),
            mock.patch.object(kernel_ops, "gather_rows",
                              lambda x, idx: x[idx.long()]),
            mock.patch.object(kernel_ops, "segment_plan",
                              lambda ids, num_segments: ids)]


def loss_and_grads(spec, cfg, model, batch, plain: bool = False,
                   relu=None, loss_fn=None):
    """(loss, {name: gradient}) of one batch, with the kernels or, with
    ``plain``, the plain versions; ``relu``, where given, stands in for
    ``torch.relu`` during the call (see :class:`ReluPattern`);
    ``loss_fn(model, batch)`` another loss than the cell's. A parameter the
    loss does not reach gets a zero gradient."""
    from repro_torch import configs
    loss_fn = loss_fn or configs.loss_for(spec, cfg)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    with contextlib.ExitStack() as stack:
        for patch in plain_ops() if plain else ():
            stack.enter_context(patch)
        if relu is not None:
            stack.enter_context(mock.patch.object(torch, "relu", relu))
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
    return float(loss.detach()), dict(zip(params, grads))


def b6_bwd_check(q, k, v, causal: bool, smi: str) -> dict:
    """B6's backward against the plain backward on the same inputs (``do``
    drawn from a seed), given the forward's lse as the train step gives it:
    dq, dk and dv within ``bwd_error_bound``, lse within 1e-4, bitwise
    reproducible, and bit-equal with ``lse=None`` (which takes lse from one
    more counted forward launch); timed beside its bound (five products),
    the routes' seven-product floor, the plain version and the library call
    (scaled_dot_product_attention's backward with enable_gqa, its forward
    run once outside the timing)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    B, S, H, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    gen = torch.Generator(device=q.device).manual_seed(TRAIN_SEED)
    do = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    plan = fa.bwd_plan(B, S, H, Hkv, T, causal, dh, q.dtype)
    before = fa.flash_attention_bwd.routes[plan.route]
    got = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    if fa.flash_attention_bwd.routes[plan.route] != before + 1:
        raise AssertionError(f"B6's backward did not launch on its "
                             f"{plan.route} route")
    want = ref.flash_attention_bwd(q, k, v, o, do, causal=causal)
    scales = ref.flash_attention_bwd_scales(q, k, v, o, do, causal=causal)
    worst, err = {}, 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        diff = (a.float() - w.float()).abs()
        bound = fa.bwd_error_bound(w, *scales[name])
        worst[name] = float((diff / bound).max())
        err = max(err, float(diff.max()))
        if not bool((diff <= bound).all()):
            raise AssertionError(f"B6's backward: {name} disagrees with the "
                                 f"plain version ({worst[name]} of the bound)")
    lse_err = float((got[3] - want[3].float()).abs().max())
    if not lse_err <= 1e-4:
        raise AssertionError(f"B6's backward: lse off by {lse_err}")
    again = fa.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("B6's backward is not bitwise reproducible")
    fwd = fa.flash_attention.launches
    own = fa.flash_attention_bwd(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    if fa.flash_attention.launches != fwd + 1 or not all(
            torch.equal(a, b) for a, b in zip(got, own)):
        raise AssertionError("B6's backward with lse=None did not take lse "
                             "from one forward launch, bit-equal")
    del got, want, scales, again, own
    t, kern = call_times(lambda: fa.flash_attention_bwd(
        q, k, v, o, do, causal=causal, lse=lse), iters=10)
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd(
        q, k, v, o, do, causal=causal), iters=1, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms, lib = call_times(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    del out, qt, kt, vt, dot
    size = q.element_size()
    bound = fa.bwd_bound_ms(B, S, H, Hkv, T, T, causal, dh, size)
    floor = fa.bwd_bound_ms(B, S, H, Hkv, T, T, causal, dh, size, products=7)
    print(f"[train] B6 backward at the path's shape: q ({B}, {S}, {H}, {dh}) "
          f"over k, v ({B}, {T}, {Hkv}, {dh}), {str(q.dtype)[6:]}, causal "
          f"{causal}, {plan}: dq, dk, dv at {worst['dq']:.3f}, "
          f"{worst['dk']:.3f}, {worst['dv']:.3f} of bwd_error_bound at most "
          f"(max abs err {err:.3e}), lse (the forward's) within {lse_err:.2e} "
          f"of the plain one, bitwise reproducible, bit-equal with lse=None "
          f"(one forward launch); kernel {kern}; plain {plain_ms:.4f} ms back "
          f"to back; library scaled_dot_product_attention backward "
          f"(enable_gqa) {lib}; {t / lib_ms:.3f}x the library's time; bound "
          f"{bound:.4f} ms (operations: five products of the attended pairs "
          f"at 989 TFLOP/s) = {bound / t:.3f} of the kernel's time; the "
          f"routes' floor (seven products) {floor:.4f} ms = {floor / t:.3f} "
          f"| {smi}")
    return dict(max_abs_err=err, ms=t, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by="operations", kernel_route=plan.route,
                floor_ms=floor)


def b4_gather_check(dout, ids, what: str, smi: str) -> dict:
    """B4's gradient gather against its plain version, bit for bit, and
    timed beside its bound, the plain version and the library call
    ``dout.index_select(0, ids)`` (every id of a sampled batch is in range,
    so no clamp is needed there)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm

    got = sm.segment_gather(dout, ids)
    want = ref.segment_gather(dout, ids, torch.float32)
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"B4's gather ({what}) differs from its plain "
                             f"version (max abs err {err})")
    del got, want
    E, d = ids.shape[0], dout.shape[1]
    if not bool(((ids >= 0) & (ids < dout.shape[0])).all()):
        raise AssertionError("the path's ids lie outside [0, S)")
    idl = ids.long()
    t, kern = call_times(lambda: sm.segment_gather(dout, ids))
    plain_ms = cuda_ms(lambda: ref.segment_gather(dout, ids, torch.float32),
                       iters=5, warmup=1)
    lib_ms, lib = call_times(lambda: dout.index_select(0, idl))
    rows = int(torch.unique(ids).numel())
    bound = sm.segment_gather_bound_ms(E, d, rows)
    print(f"[train] B4 gather {what}: ({dout.shape[0]} x {d}) rows gathered "
          f"by {E} ids ({rows} distinct): bit-equal to the plain version; "
          f"kernel {kern}; plain {plain_ms:.6f} ms back to back; library "
          f"index_select {lib}; bound {bound:.6f} ms (bytes: 4*rows*d + 4*E "
          f"+ 4*E*d at 3.35 TB/s) = {bound / t:.3f} of the kernel's time | "
          f"{smi}")
    return dict(max_abs_err=err, ms=t, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound, bound_by="bytes")


def restart_check(arch: str, dev, smi: str) -> bool:
    """The training CLI (``--smoke``, on the card) with a checkpoint every
    RESTART_EVERY steps and a failure injected at RESTART_FAIL, against an
    uninterrupted run: the replayed steps' losses must equal the
    uninterrupted ones bit for bit for the LM, within rtol 1e-5 for
    GraphSAGE; the line says whether they were bit-equal. Returns
    whether they were bit-equal."""
    from repro_torch.launch import train as train_cli

    base = ["--arch", arch, "--smoke", "--steps", str(RESTART_STEPS),
            "--log-every", str(10 * RESTART_STEPS), "--device", str(dev)]
    with contextlib.redirect_stdout(sys.stderr):
        clean = train_cli.main(base)
        with tempfile.TemporaryDirectory() as d:
            replayed = train_cli.main(base + [
                "--ckpt-dir", d, "--ckpt-every", str(RESTART_EVERY),
                "--inject-failure", str(RESTART_FAIL)])
    back = (RESTART_FAIL // RESTART_EVERY) * RESTART_EVERY
    want = clean[:RESTART_FAIL] + clean[back:]
    if len(replayed) != len(want) or not all(np.isfinite(replayed)):
        raise AssertionError(f"{arch}: the restarted run gave {replayed}")
    exact = replayed == want
    if arch.startswith("graphsage"):
        np.testing.assert_allclose(replayed, want, rtol=1e-5)
    elif not exact:
        raise AssertionError(f"{arch}: the restarted run's losses {replayed} "
                             f"are not the uninterrupted run's {want}")
    print(f"[train] restart: launch.train --arch {arch} --smoke --steps "
          f"{RESTART_STEPS} --ckpt-every {RESTART_EVERY} --inject-failure "
          f"{RESTART_FAIL} on the card: rolled back to step {back}, "
          f"{len(replayed)} losses, the replayed ones "
          f"{'bit-equal to' if exact else 'within rtol 1e-5 of'} the "
          f"uninterrupted run's ({' '.join(f'{x:.6f}' for x in replayed)})"
          f"{'' if exact else ' (not bit-equal)'} | "
          f"{smi}")
    return exact


def train_phase(dev, smi: str) -> dict:
    """[train]: the training path on the card through its entry points.

    glm4-9b at full width, TRAIN_LAYERS layers, remat, one sequence of
    TRAIN_SEQ tokens from ``launch.train.make_batch_fn`` (TokenStream at the
    full vocab) through ``configs.make_train_step``: the first step
    counted (every launch of B5 and its gradient, B6 and its backward
    asserted from the code), then timed steps, the step split into data,
    forward + backward and AdamW, one step under torch.profiler; the
    kernels at the path's shapes against their plain versions; a 1-layer
    full-width model's loss and gradients against the plain versions;
    then graphsage-reddit at minibatch_lg the same way; then the restart
    check of the CLI. Returns the launches and records of the phase."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    spec = configs.get(TRAIN_ARCH)
    full = spec.model_cfg
    cfg = dataclasses.replace(full, n_layer=TRAIN_LAYERS)
    L = cfg.n_layer
    dims = dict(spec.shapes["train_4k"], batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    model, t_init = wall(lambda: configs.init_params(spec, cfg, gen,
                                                     device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count}")
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    step = configs.make_train_step(spec, cfg, opt_cfg)
    state = adamw.init_state(dict(model.named_parameters()))
    batch_fn = train_cli.make_batch_fn(spec, cfg, dims, dev)
    print(f"[train] {TRAIN_ARCH} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_head} query heads over {cfg.n_kv} kv heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, QKV bias), cut "
          f"in depth: reduced n_layer {full.n_layer} -> {L}; batch "
          f"{spec.shapes['train_4k']['batch']} -> {TRAIN_BATCH} (seq "
          f"{TRAIN_SEQ}); remat {cfg.remat}; {n_params:,} parameters in "
          f"{cfg.dtype}, drawn on the card from seed {TRAIN_SEED} in "
          f"{t_init:.2f}s; AdamW with f32 moments | {smi}")

    losses, step_s, data_s = [], [], []
    for i in range(TRAIN_STEPS):
        batch, t_data = wall(lambda: batch_fn(i))
        if i == 0:
            sm.reset_counts()
            fa.reset_counts()
            fa.reset_bwd_counts()
        (_, state, m), t = wall(lambda: step(model, state, batch))
        if i == 0:
            b5, b5_grad = sm.matmul.launches, sm.matmul_grads.launches
            b5_by_route = b5_routes(sm, {"wgmma": 28 * L + 3}, "a train step")
            b6, b6_bwd = fa.flash_attention.launches, \
                fa.flash_attention_bwd.launches
            b6_by_route = b6_routes(fa, {"wgmma": 2 * L}, "a train step")
            want = (28 * L + 3, 14 * L + 2, 2 * L, L)
            if (b5, b5_grad, b6, b6_bwd) != want:
                raise AssertionError(
                    f"a train step launched B5 {b5} (gradients {b5_grad}), B6 "
                    f"{b6} and its backward {b6_bwd} times, not {want}")
            if fa.flash_attention_bwd.routes["wgmma"] != L:
                raise AssertionError("B6's backward left the wgmma route: "
                                     f"{fa.flash_attention_bwd.routes}")
        losses.append(float(m["loss"]))
        step_s.append(t)
        data_s.append(t_data)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses are not finite: {losses}")
    ln_v = float(np.log(cfg.vocab))
    if not abs(losses[0] - ln_v) <= 1.5:
        raise AssertionError(f"the first loss {losses[0]} is not near ln("
                             f"{cfg.vocab}) = {ln_v}")
    timed = sorted(step_s[1:])
    t_step = timed[len(timed) // 2]
    tokens = TRAIN_SEQ * TRAIN_BATCH
    flops = configs.model_flops(spec, "train_4k", dims=dims, model_cfg=cfg)
    data_step = sorted(data_s[1:])[len(data_s[1:]) // 2]
    print(f"[train] main path: {TRAIN_STEPS} steps of make_train_step, the "
          f"first counted: B5 {b5} per step ({b5_by_route}: 7L + 1 forward, "
          f"7L recomputed by remat, 14L + 2 gradient products = {b5_grad}), "
          f"B6 forward {b6} ({b6_by_route}: L + L recomputed), B6 backward "
          f"{b6_bwd} (all on the wgmma route); losses "
          f"{' '.join(f'{x:.4f}' for x in losses)} (ln {cfg.vocab} = "
          f"{ln_v:.4f}); step {t_step:.4f}s (median of {len(timed)} timed; "
          f"first {step_s[0]:.4f}s) = {tokens / t_step:.1f} tokens/s; model "
          f"FLOPs {flops:.4e} per step = {flops / t_step / 989e12:.4f} of "
          f"989 TFLOP/s; data (TokenStream.batch on the host at vocab "
          f"{cfg.vocab} + upload) {data_step:.4f}s per step, outside the "
          f"step; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")

    # -- the step's split, and one step under the profiler ----------------
    batch = batch_fn(TRAIN_STEPS)
    params = dict(model.named_parameters())
    (_, grads), t_fb = wall(lambda: loss_and_grads(spec, cfg, model, batch))
    _, t_opt = wall(lambda: adamw.apply_updates(opt_cfg, params, grads,
                                                state))
    del grads
    t_copy = cuda_ms(lambda: model.head.t().contiguous(), iters=3, warmup=1)
    print(f"[train] step split: forward + backward {t_fb:.4f}s, AdamW "
          f"{t_opt:.4f}s ({n_params:,} parameters, f32 moments), data "
          f"{data_step:.4f}s on the host; B5's gradient copies each "
          f"transposed operand: the head's (1.24 GB) takes {t_copy:.4f} ms "
          f"| {smi}")
    shares = {}
    print(f"[train] one train step under torch.profiler: " + profiled(
        lambda: step(model, state, batch),
        {"B5": is_b5, "B6": lambda k: "flash_wgmma<" in k,
         "B6 backward": lambda k: "flash_bwd" in k}, shares) + f" | {smi}")
    print(f"[train] beside the step with the mma backward (H100 80GB HBM3, "
          f"700 W): step {t_step:.4f}s (then {MMA_BWD_STEP_S}s), forward + "
          f"backward "
          f"{t_fb:.4f}s, AdamW {t_opt:.4f}s; B6's backward "
          f"{shares.get('B6 backward', float('nan')):.3f} of the busy time "
          f"(then {MMA_BWD_SHARE}) | {smi}")
    del model, state, params, batch
    torch.cuda.empty_cache()

    # -- kernels at the path's shapes ---------------------------------------
    one = dataclasses.replace(full, n_layer=1, remat=False)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    m1 = configs.init_params(spec, one, gen, device=dev)
    b1 = batch_fn(0)
    p0 = m1.layers[0]
    pos = torch.arange(TRAIN_SEQ, dtype=torch.int32, device=dev)[None, :]
    with torch.no_grad():
        # the id vocab, which TokenStream emits now and then, takes the
        # last row, as in transformer.train_forward
        ids = b1["tokens"].long().clamp(0, one.vocab - 1)
        h = tfm.rms_norm(m1.embed[ids], p0.ln1)
        q, k, v = tfm.qkv(p0, one, h, pos, tfm.partition_of(m1))
        q, k, v = (x.contiguous() for x in (q, k, v))
    b6_rec = b6_bwd_check(q, k, v, True, smi)
    del q, k, v
    g2 = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)

    def rnd(*shape):
        return torch.randn(shape, generator=g2, device=dev).bfloat16()

    x2, dq_ = h[0].contiguous(), rnd(TRAIN_SEQ, cfg.n_head * cfg.d_head)
    dff, dvoc = rnd(TRAIN_SEQ, cfg.d_ff), rnd(TRAIN_SEQ, cfg.vocab)
    b5g = kernel_checks({
        "grad dA of wq (dC @ wq^T)": (dq_, p0.wq.detach().t().contiguous()),
        "grad dB of ffn.wi (x^T @ dC)": (x2.t().contiguous(), dff),
        "grad dA of ffn.wo (dC @ wo^T)": (
            rnd(TRAIN_SEQ, cfg.d_model),
            p0.ffn.wo.detach().t().contiguous()),
        "grad dB of head (x^T @ dC)": (x2.t().contiguous(), dvoc),
        "grad dA of head (dC @ head^T)": (
            dvoc, m1.head.detach().t().contiguous())}, {}, tag="train")
    del x2, dq_, dff, dvoc, h

    # -- a 1-layer full-width model: kernels against the plain versions ----
    (loss_k, grads_k), t_k = wall(lambda: loss_and_grads(spec, one, m1, b1))
    (loss_p, grads_p), t_p = wall(lambda: loss_and_grads(spec, one, m1, b1,
                                                         plain=True))
    errs = grad_leaf_errs(grads_k, grads_p)
    worst = max(errs, key=errs.get)
    if not abs(loss_k - loss_p) <= TRAIN_LOSS_TOL * abs(loss_p):
        raise AssertionError(f"1-layer loss {loss_k} with the kernels, "
                             f"{loss_p} with the plain versions")
    if not errs[worst] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"gradient {worst} differs from the plain "
                             f"version's by {errs[worst]} of its scale")
    print(f"[train] 1-layer full-width {TRAIN_ARCH}, one sequence of "
          f"{TRAIN_SEQ}: loss {loss_k:.6f} with the kernels ({t_k:.3f}s), "
          f"{loss_p:.6f} with the plain versions on the card ({t_p:.3f}s; "
          f"tolerance {TRAIN_LOSS_TOL} relative); every one of the "
          f"{len(errs)} gradients within {errs[worst]:.3e} of its largest "
          f"|plain| at most ({worst}; tolerance {TRAIN_GRAD_TOL}; per leaf "
          + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()) + f") | {smi}")
    del m1, grads_k, grads_p
    torch.cuda.empty_cache()
    peak_lm = torch.cuda.max_memory_allocated() / 2**30

    # -- graphsage-reddit at minibatch_lg ------------------------------------
    torch.cuda.reset_peak_memory_stats()
    gspec = configs.get(GNN_ARCH)
    gcfg = configs.cell_model_cfg(gspec, GNN_SHAPE)
    gdims = dict(gspec.shapes[GNN_SHAPE])
    gfn, t_graph = wall(lambda: train_cli.make_batch_fn(gspec, gcfg, gdims,
                                                        dev))
    gmodel = configs.init_params(gspec, gcfg,
                                 torch.Generator(device=dev).manual_seed(
                                     TRAIN_SEED), device=dev)
    gstep = configs.make_train_step(gspec, gcfg, opt_cfg)
    gstate = adamw.init_state(dict(gmodel.named_parameters()))
    seeds_n = max(gdims["n"] // 8, 2)
    g_losses, g_step, g_data = [], [], []
    for i in range(TRAIN_STEPS):
        gb, t_data = wall(lambda: gfn(i))
        if i == 0:
            sm.reset_counts()
            sm.segment_sum.launches = sm.segment_gather.launches = 0
            sm.segment_plan.builds = 0
            first_gb = gb
        (_, gstate, m), t = wall(lambda: gstep(gmodel, gstate, gb))
        if i == 0:
            counts = (sm.segment_sum.launches, sm.segment_gather.launches,
                      sm.matmul.launches, sm.matmul_grads.launches)
            g_plans = sm.segment_plan.builds
            if g_plans != GNN_PLANS[GNN_ARCH]["train"]:
                raise AssertionError(f"a GraphSAGE train step built {g_plans} "
                                     f"B4 plans")
            if counts != (5, 1, 13, 8):
                raise AssertionError(f"a GraphSAGE train step launched B4 "
                                     f"{counts[0]}, its gather {counts[1]} "
                                     f"and B5 {counts[2]} (gradients "
                                     f"{counts[3]}) times, not (5, 1, 13, 8)")
            g_routes = b5_routes(sm, {"f32": 13}, "a GraphSAGE train step")
        g_losses.append(float(m["loss"]))
        g_step.append(t)
        g_data.append(t_data)
    if not all(np.isfinite(g_losses)):
        raise AssertionError(f"GraphSAGE losses are not finite: {g_losses}")
    gt = sorted(g_step[1:])[len(g_step[1:]) // 2]
    gd = sorted(g_data[1:])[len(g_data[1:]) // 2]
    E = int(first_gb["src"].shape[0])
    print(f"[train] {GNN_ARCH} at {GNN_SHAPE}'s full dims ({gdims['n']:,} "
          f"nodes, d_in {gcfg.d_in}, hidden {gcfg.d_hidden}, "
          f"{gcfg.n_classes} classes) through launch.train's make_batch_fn "
          f"(power-law graph, average degree 6, built in {t_graph:.2f}s; "
          f"{seeds_n:,} seeds a step, fanout (5, 5), {E:,} edges padded) and "
          f"make_train_step: first step counted: B4 {counts[0]} (4 forward, "
          f"1 the neighbour gather's gradient), B4 gather {counts[1]}, B5 "
          f"{counts[2]} ({g_routes}; {counts[3]} of them gradients), B4 "
          f"plans {g_plans} (dst and src, reused by the backward); losses "
          f"{' '.join(f'{x:.4f}' for x in g_losses)}; step {gt:.4f}s = "
          f"{1 / gt:.3f} steps/s = {seeds_n / gt:.1f} seeds/s trained on the "
          f"card; the sampler {gd:.4f}s per step on the host (outside the "
          f"step) | {smi}")
    pattern = ReluPattern()
    (gl_k, gg_k), _ = wall(lambda: loss_and_grads(
        gspec, gcfg, gmodel, first_gb, relu=pattern.record))
    (gl_p, gg_p), _ = wall(lambda: loss_and_grads(
        gspec, gcfg, gmodel, first_gb, plain=True, relu=pattern.replay))
    gerrs = grad_leaf_errs(gg_k, gg_p)
    gworst = max(gerrs, key=gerrs.get)
    if not (abs(gl_k - gl_p) <= 1e-5 * abs(gl_p)
            and gerrs[gworst] <= GNN_GRAD_TOL):
        raise AssertionError(f"GraphSAGE: loss {gl_k} against {gl_p}, "
                             f"gradient {gworst} off by {gerrs[gworst]} "
                             f"({pattern.flips} relu inputs flipped; per "
                             f"leaf {gerrs})")
    print(f"[train] GraphSAGE loss {gl_k:.7f} with the kernels, {gl_p:.7f} "
          f"with the plain versions; gradients within {gerrs[gworst]:.3e} of "
          f"each leaf's largest |plain| ({gworst}; tolerance "
          f"{GNN_GRAD_TOL}); the plain run differentiates the kernel run's "
          f"relu pattern, where {pattern.flips} of {pattern.entries:,} "
          f"pre-activations took the other sign (the nearest to 0 "
          f"{pattern.nearest:.3e}, the runs' largest difference "
          f"{pattern.gap:.3e}) | {smi}")
    gather_recs = [
        b4_gather_check(torch.randn(gdims["n"], gcfg.d_hidden, generator=gen,
                                    device=dev), first_gb["dst"],
                        "layer 2 (d = 128), the path's", smi),
        b4_gather_check(torch.randn(gdims["n"], gcfg.d_in, generator=gen,
                                    device=dev), first_gb["dst"],
                        "at d = 602", smi)]
    print(f"[train] GraphSAGE peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; glm4's "
          f"{peak_lm:.2f} GiB | {smi}")
    del gmodel, gstate, first_gb, gb
    torch.cuda.empty_cache()

    exact = restart_check(TRAIN_ARCH, dev, smi)
    restart_check(GNN_ARCH, dev, smi)
    print(f"[train] phase {time.perf_counter() - t_phase:.1f}s | {smi}")
    csrc = "src/repro_torch/kernels/csrc/"
    gmain = gather_recs[0]
    bmain = b5g["grad dB of ffn.wi (x^T @ dC)"]
    return {
        "b5": b5 - b5_grad + counts[2] - counts[3], "b6": b6,
        "b4": counts[0], "restart_exact": exact,
        "records": [
            {"name": "matmul (gradient)", "route": "cuda",
             "source": csrc + "matmul.cu",
             "replaces": "src/repro/kernels/segment_matmul.py:52",
             "launches": b5_grad + counts[3],
             "max_abs_err": max(r["max_abs_err"] for r in b5g.values()),
             "ms": bmain["ms"], "plain_ms": bmain["plain_ms"],
             "bound_ms": bmain["bound_ms"], "bound_by": bmain["bound_by"],
             "library_ms": bmain["library_ms"]},
            {"name": "flash_attention_bwd", "route": "cuda",
             "source": csrc + "flash_attention_bwd.cu",
             "replaces": "src/repro/kernels/flash_attention.py:96",
             "launches": b6_bwd, **b6_rec},
            {"name": "segment_gather", "route": "cuda",
             "source": csrc + "segment_sum.cu",
             "replaces": "src/repro/kernels/segment_matmul.py:104",
             "launches": counts[1],
             "max_abs_err": max(r["max_abs_err"] for r in gather_recs),
             **{k: gmain[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}]}


#: the [mgn] phase: meshgraphnet at its published width and depth (15
#: layers, hidden 128, 2-layer MLPs), drawn on the card from MGN_SEED.
#: (a) full_graph_sm at its full dims (2,708 nodes, 10,556 undirected
#: edges doubled and padded to 21,504, 1,433 features; nothing cut):
#: MGN_SERVES timed forwards after a counted one, then MGN_STEPS
#: make_train_step steps on launch.train's batches. (b) ogb_products'
#: shape for serving only, its n and e divided by MGN_OGB_CUT (the full
#: graph's edge state alone is 123.7M x 128 x 4 B = 63 GB, its message
#: input 190 GB), at ogb_products' average degree and feature width.
MGN_ARCH = "meshgraphnet"
MGN_SEED = 29
MGN_SERVES = 4
MGN_STEPS = 3
MGN_OGB_CUT = 16
#: f32 throughout: the kernels' outputs within this share of max|out| of
#: the plain versions', every gradient leaf within this share of its
#: largest |plain| (GNN_GRAD_TOL's rule)
MGN_TOL = 1e-4
#: (B5, B4, B4's gather) launches of one serve step and one train step
#: (tests/test_torch_double_backward.py's GNN_CALLS holds the same on the
#: CPU)
GNN_LAUNCHES = {
    "meshgraphnet": {"serve": (99, 15, 0), "train": (295, 45, 15)},
    "nequip": {"serve": (33, 16, 0), "forces": (62, 30, 14),
               "train": (207, 56, 42)},
    "mace": {"serve": (27, 7, 0), "forces": (51, 12, 7),
             "train": (171, 22, 19)},
}


#: B4 plans built by one serve step, one energy-and-forces pass and one
#: train step: one per id vector summed by (dst; graph_id), one for src
#: where a gradient can flow, every backward reusing them
#: (tests/test_torch_segment_plan.py's GNN_PLANS holds the same on the CPU)
GNN_PLANS = {
    "graphsage-reddit": {"serve": 1, "train": 2},
    "meshgraphnet": {"serve": 1, "train": 2},
    "nequip": {"serve": 2, "forces": 3, "train": 3},
    "mace": {"serve": 2, "forces": 3, "train": 3},
}


def reset_b4_b5() -> None:
    from repro_torch.kernels import segment_matmul as sm
    sm.reset_counts()
    sm.segment_sum.launches = sm.segment_gather.launches = 0
    sm.segment_plan.builds = 0


def b4_b5_launches(want: tuple, what: str, plans: int) -> tuple:
    """(B5, B4, B4's gather, B5's gradient, B4 plans) launches and builds
    since :func:`reset_b4_b5`; raises unless the first three are ``want``,
    the plans ``plans`` and every B5 launch took the f32 route."""
    from repro_torch.kernels import segment_matmul as sm
    got = (sm.matmul.launches, sm.segment_sum.launches,
           sm.segment_gather.launches)
    if got != tuple(want):
        raise AssertionError(f"{what} launched (B5, B4, B4 gather) {got}, "
                             f"not {tuple(want)}")
    if sm.segment_plan.builds != plans:
        raise AssertionError(f"{what} built {sm.segment_plan.builds} B4 "
                             f"plans, not {plans}")
    b5_routes(sm, {"f32": got[0]}, what)
    return got + (sm.matmul_grads.launches, plans)


def launch_clause(n: tuple) -> str:
    return (f"B5 {n[0]} (all on the f32 route; {n[3]} of them gradients), "
            f"B4 {n[1]}, B4 gather {n[2]}, B4 plans built {n[4]}")


def mgn_graph(cfg, n: int, e: int, seed: int, dev) -> dict:
    """A MeshGraphNet serve batch on the card: a power-law graph of ``n``
    nodes (``random_powerlaw_graph`` at average degree ceil(2e / n) + 1,
    ``seed``) cut to its first ``e`` undirected pairs, doubled and padded
    to a multiple of 512 with edges at node 0 (``edge_mask`` 0); N(0, 1)
    node and edge features drawn on the card."""
    from repro_torch.data import graph_sampler as gs
    a, b = gs.random_powerlaw_graph(n, -(-2 * e // n) + 1, seed=seed)
    if a.shape[0] // 2 < e:
        raise AssertionError(f"the graph has {a.shape[0] // 2} pairs, "
                             f"fewer than {e}")
    a, b = a[:e], b[:e]                     # the first half: one per pair
    E = -(-2 * e // 512) * 512
    src = np.zeros(E, np.int32)
    dst = np.zeros(E, np.int32)
    src[:2 * e] = np.concatenate([a, b])
    dst[:2 * e] = np.concatenate([b, a])
    mask = np.zeros(E, np.float32)
    mask[:2 * e] = 1.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"node_feat": torch.randn(n, cfg.d_node_in, generator=gen,
                                     device=dev),
            "edge_feat": torch.randn(E, cfg.d_edge_in, generator=gen,
                                     device=dev),
            "src": torch.as_tensor(src, device=dev),
            "dst": torch.as_tensor(dst, device=dev),
            "edge_mask": torch.as_tensor(mask, device=dev)}


def plain_outputs(fn):
    """``fn()`` with the plain versions in the models' kernel calls."""
    with contextlib.ExitStack() as stack:
        for patch in plain_ops():
            stack.enter_context(patch)
        return fn()


def grads_check(spec, cfg, model, batch, what: str, tol: float, smi: str,
                loss_fn=None) -> float:
    """The loss (``loss_fn``, else the cell's) and every gradient with the
    kernels against the plain versions on the card, the plain run replaying
    the kernel run's relu pattern; one line; returns the worst leaf's
    error."""
    pattern = ReluPattern()
    (l_k, g_k), t_k = wall(lambda: loss_and_grads(
        spec, cfg, model, batch, relu=pattern.record, loss_fn=loss_fn))
    (l_p, g_p), t_p = wall(lambda: loss_and_grads(
        spec, cfg, model, batch, plain=True, relu=pattern.replay,
        loss_fn=loss_fn))
    errs = grad_leaf_errs(g_k, g_p)
    worst = max(errs, key=errs.get)
    if not (abs(l_k - l_p) <= tol * abs(l_p) and errs[worst] <= tol):
        raise AssertionError(f"{what}: loss {l_k} against {l_p}, gradient "
                             f"{worst} off by {errs[worst]} of its scale "
                             f"({pattern.flips} relu inputs flipped)")
    print(f"[{spec.id}] {what}: loss {l_k:.7f} with the kernels ({t_k:.3f}s)"
          f", {l_p:.7f} with the plain versions ({t_p:.3f}s); all "
          f"{len(errs)} gradients within {errs[worst]:.3e} of their largest "
          f"|plain| ({worst}; tolerance {tol}); the plain run replays the "
          f"kernel run's relu pattern ({pattern.flips} of "
          f"{pattern.entries:,} inputs took the other sign, the nearest to 0 "
          f"{pattern.nearest:.3e}) | {smi}")
    return errs[worst]


def mgn_phase(dev, smi: str) -> dict:
    """[mgn]: meshgraphnet served and trained on the card at full width and
    depth (full_graph_sm), and served at ogb_products' shape cut by
    MGN_OGB_CUT. Every entry point's launches are counted (set to 0 just
    before, read just after) and held to GNN_LAUNCHES; outputs and every
    gradient against the plain versions on the card; B4 and B5 against
    their plain versions at the large graph's shapes. Returns the launches
    and the largest errors."""
    from repro_torch import configs
    from repro_torch.launch import train as train_cli
    from repro_torch.models import gnn
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain versions' f32
    spec = configs.get(MGN_ARCH)
    dims = spec.shapes["full_graph_sm"]
    cfg = configs.cell_model_cfg(spec, "full_graph_sm")
    want = GNN_LAUNCHES[MGN_ARCH]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(MGN_SEED)
    model = configs.init_params(spec, cfg, gen, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    batch = mgn_graph(cfg, dims["n"], dims["e"], MGN_SEED, dev)
    E = int(batch["src"].shape[0])
    serve = configs.make_serve_step(spec, "full_graph_sm")
    reset_b4_b5()
    out, t_first = wall(lambda: serve(model, batch))
    plans = GNN_PLANS[MGN_ARCH]
    served = b4_b5_launches(want["serve"], "a meshgraphnet serve step",
                            plans["serve"])
    if out.shape != (dims["n"], cfg.d_out) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError("meshgraphnet outputs are not finite "
                             f"({dims['n']}, {cfg.d_out})")
    plain = plain_outputs(lambda: serve(model, batch))
    err_a = rel_err(out, plain)
    if not err_a <= MGN_TOL:
        raise AssertionError(f"meshgraphnet outputs with the kernels differ "
                             f"from the plain versions' by {err_a} of max|out|")
    fwd = sorted(wall(lambda: serve(model, batch))[1]
                 for _ in range(MGN_SERVES))[MGN_SERVES // 2]
    flops = configs.model_flops(spec, "full_graph_sm",
                                dims=dict(dims, kind="serve"))
    print(f"[mgn] {MGN_ARCH} at full width and depth ({cfg.n_layers} layers, "
          f"hidden {cfg.d_hidden}, {cfg.mlp_layers}-layer MLPs; {n_params:,} "
          f"f32 parameters from seed {MGN_SEED}) on full_graph_sm's full dims "
          f"({dims['n']:,} nodes, {dims['e']:,} undirected edges -> {E:,} "
          f"directed, padded; {cfg.d_node_in} features; nothing cut): "
          f"make_serve_step launched {launch_clause(served)} (first forward "
          f"{t_first:.3f}s); outputs within {err_a:.3e} of max|out| of the "
          f"plain versions' (tolerance {MGN_TOL}); forward {fwd * 1e3:.3f} "
          f"ms (median of {MGN_SERVES}) = {dims['n'] / fwd:,.0f} nodes/s; "
          f"model FLOPs {flops:.4e} = {flops / fwd / 67e12:.4f} of the 67 "
          f"TFLOP/s f32 peak | {smi}")
    print(f"[mgn] one forward under torch.profiler: " + profiled(
        lambda: serve(model, batch), {"B4": is_b4, "B5": is_b5}) + f" | {smi}")
    del out, plain

    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    step = configs.make_train_step(spec, cfg, opt_cfg)
    state = adamw.init_state(dict(model.named_parameters()))
    batch_fn = train_cli.make_batch_fn(spec, cfg, dict(dims), dev)
    losses, step_s = [], []
    for i in range(MGN_STEPS):
        b, t_data = wall(lambda: batch_fn(i))
        if i == 0:
            first = b
            reset_b4_b5()
        (_, state, m), t = wall(lambda: step(model, state, b))
        if i == 0:
            trained = b4_b5_launches(want["train"], "a meshgraphnet train "
                                     "step", plans["train"])
        losses.append(float(m["loss"]))
        step_s.append(t)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"meshgraphnet losses are not finite: {losses}")
    ts = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(f"[mgn] train: {MGN_STEPS} make_train_step steps on "
          f"launch.train's batches ({dims['n']:,} nodes, "
          f"{int(first['src'].shape[0]):,} padded edges); the first launched "
          f"{launch_clause(trained)}; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; step {ts:.4f}s after "
          f"the first ({step_s[0]:.3f}s) | {smi}")
    print(f"[mgn] one train step under torch.profiler: " + profiled(
        lambda: step(model, state, first), {"B4": is_b4, "B5": is_b5})
        + f" | {smi}")
    worst_a = grads_check(spec, cfg, model, first, "train step's loss and "
                          "gradients (first batch)", MGN_TOL, smi)
    (_, g1), (_, g2) = (loss_and_grads(spec, cfg, model, first)
                        for _ in range(2))
    apart = sorted(k for k in g1 if not torch.equal(g1[k], g2[k]))
    print(f"[mgn] the train step's gradients evaluated twice on the first "
          f"batch: " + (f"bit-equal in all {len(g1)} leaves" if not apart
                        else f"{len(apart)} of {len(g1)} leaves differ "
                        f"({', '.join(apart[:4])})")
          + f" (reported only: B4 adds in a fixed order, the rest of the "
          f"step is not held to one) | {smi}")
    with torch.inference_mode():
        e_sm = gnn._layernorm(gnn._mlp(model.enc_edge, batch["edge_feat"])
                              ) * batch["edge_mask"][:, None]
    b4_sm = b4_checks({f"full_graph_sm aggregation ({E:,} x {cfg.d_hidden} "
                       f"into {dims['n']:,} rows)": (e_sm, batch["dst"],
                                                     dims["n"])}, tag="mgn")
    del g1, g2, e_sm
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    del model, state, first, b, batch
    torch.cuda.empty_cache()

    # -- (b) ogb_products' shape, cut, served -----------------------------
    torch.cuda.reset_peak_memory_stats()
    odims = spec.shapes["ogb_products"]
    ocfg = configs.cell_model_cfg(spec, "ogb_products")
    n, e = odims["n"] // MGN_OGB_CUT, odims["e"] // MGN_OGB_CUT
    omodel = configs.init_params(spec, ocfg, gen, device=dev)
    obatch, t_graph = wall(lambda: mgn_graph(ocfg, n, e, MGN_SEED + 1, dev))
    E = int(obatch["src"].shape[0])
    oserve = configs.make_serve_step(spec, "ogb_products")
    reset_b4_b5()
    out, t_fwd = wall(lambda: oserve(omodel, obatch))
    served_b = b4_b5_launches(want["serve"], "an ogb_products serve step",
                              plans["serve"])
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    plain, t_plain = wall(lambda: plain_outputs(lambda: oserve(omodel,
                                                               obatch)))
    err_b = rel_err(out, plain)
    if not err_b <= MGN_TOL or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"ogb_products outputs with the kernels differ "
                             f"from the plain versions' by {err_b}")
    oflops = configs.model_flops(spec, "ogb_products",
                                 dims=dict(odims, n=n, e=e, kind="serve"))
    print(f"[mgn] ogb_products' shape for serving, n and e divided by "
          f"{MGN_OGB_CUT} ({odims['n']:,} -> {n:,} nodes, {odims['e']:,} -> "
          f"{e:,} undirected edges -> {E:,} directed, padded; average degree "
          f"{2 * e / n:.2f} as ogb_products' {2 * odims['e'] / odims['n']:.2f}; "
          f"{ocfg.d_node_in} features; power-law graph built in "
          f"{t_graph:.2f}s): launched {launch_clause(served_b)}; forward "
          f"{t_fwd:.3f}s (plain versions {t_plain:.3f}s) = {n / t_fwd:,.0f} "
          f"nodes/s, model FLOPs {oflops:.4e} = "
          f"{oflops / t_fwd / 67e12:.4f} of the f32 peak; peak device "
          f"memory {peak_b:.2f} GiB; outputs within {err_b:.3e} of max|out| "
          f"of the plain versions' (tolerance {MGN_TOL}) | {smi}")
    del out, plain
    torch.cuda.empty_cache()
    with torch.inference_mode():
        x0 = gnn._layernorm(gnn._mlp(omodel.enc_node, obatch["node_feat"]))
        e0 = gnn._layernorm(gnn._mlp(omodel.enc_edge, obatch["edge_feat"])
                            ) * obatch["edge_mask"][:, None]
        msg = torch.cat([e0, x0[obatch["src"]], x0[obatch["dst"]]], dim=-1)
    b4 = b4_checks({f"layer aggregation ({E:,} x {ocfg.d_hidden} into {n:,} "
                    f"rows)": (e0, obatch["dst"], n)}, tag="mgn")
    b5 = kernel_checks({f"edge MLP's first product ({E:,} x "
                        f"{3 * ocfg.d_hidden} @ {3 * ocfg.d_hidden} x "
                        f"{ocfg.d_hidden})":
                        (msg, omodel.layers[0].edge_mlp[0].w)}, {},
                       tag="mgn")
    del x0, e0, msg, omodel, obatch
    torch.cuda.empty_cache()
    print(f"[mgn] peak device memory: full_graph_sm {peak_a:.2f} GiB, "
          f"ogb_products / {MGN_OGB_CUT} {peak_b:.2f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f}s | {smi}")
    return {"b5": served[0] + trained[0] + served_b[0] - trained[3],
            "b5_grad": trained[3], "b4": served[1] + trained[1] + served_b[1],
            "gather": trained[2],
            "b4_err": max(r["max_abs_err"] for r in [*b4.values(),
                                                      *b4_sm.values()]),
            "b5_err": max(r["max_abs_err"] for r in b5.values()),
            "worst_grad": worst_a}


#: the [geo] phase: nequip (5 layers, C 32) and mace (2 layers, C 128,
#: correlation 3) at their published widths and depths on molecule's full
#: dims, nothing cut: 128 molecules of 30 atoms, each in a cube of side
#: GEO_BOX of its own (the cubes GEO_SPACING apart on a grid around the
#: origin), its GEO_PAIRS shortest pairs as 120 directed edges, 1,024
#: padding edges at node 0 (edge_mask 0), one-hot species, targets from
#: the seed; GEO_SERVES timed serve steps, GEO_STEPS train steps.
GEO_ARCHS = ("nequip", "mace")
GEO_SEED = 31
GEO_BOX, GEO_SPACING, GEO_PAIRS = 3.0, 10.0, 60
GEO_SERVES = 4
GEO_STEPS = 3
#: f32: energies, forces and every gradient leaf within this share of the
#: plain versions' largest |value|; a rotated copy's energies (rtol = atol)
#: and forces within the reference's equivariance tolerances
#: (tests/test_models.py)
GEO_TOL = 1e-4
GEO_ROT_E, GEO_ROT_F = 1e-4, 1e-3


def molecule_batch(cfg, dims: dict, rng, dev) -> dict:
    """A molecule batch on the card (see GEO_BOX): positions, the
    GEO_PAIRS shortest pairs of each molecule in both directions, padded
    to molecule's 512-multiple edge count with edges at node 0; one-hot
    species, ``graph_id``, normal energy and force targets."""
    G = dims["graphs"]
    A = dims["n"] // G
    E = -(-2 * dims["e"] // 512) * 512
    grid = np.stack(np.meshgrid(*[np.arange(k) for k in (8, 4, 4)],
                                indexing="ij"), -1).reshape(-1, 3)[:G]
    pos = rng.uniform(0.0, GEO_BOX, (G, A, 3)) + GEO_SPACING * (
        grid - grid.mean(0))[:, None, :]
    iu, ju = np.triu_indices(A, 1)
    d = np.linalg.norm(pos[:, iu] - pos[:, ju], axis=-1)
    pick = np.argsort(d, axis=1)[:, :GEO_PAIRS]
    if not np.take_along_axis(d, pick, 1).max() < cfg.cutoff:
        raise AssertionError("a molecule's edge reaches the cutoff")
    base = (A * np.arange(G))[:, None]
    a, b = (iu[pick] + base).ravel(), (ju[pick] + base).ravel()
    real = 2 * a.shape[0]
    src = np.zeros(E, np.int32)
    dst = np.zeros(E, np.int32)
    src[:real], dst[:real] = np.concatenate([a, b]), np.concatenate([b, a])
    mask = np.zeros(E, np.float32)
    mask[:real] = 1.0
    species = rng.integers(0, cfg.d_species, G * A)
    host = {"node_feat": np.eye(cfg.d_species, dtype=np.float32)[species],
            "pos": pos.reshape(-1, 3).astype(np.float32),
            "src": src, "dst": dst, "edge_mask": mask,
            "graph_id": np.repeat(np.arange(G), A).astype(np.int32),
            "energy_target": rng.normal(size=G).astype(np.float32),
            "force_target": rng.normal(size=(G * A, 3)).astype(np.float32)}
    return {k: torch.as_tensor(v, device=dev) for k, v in host.items()}


def geo_arch(arch: str, dev, smi: str) -> dict:
    """One geometric architecture of [geo]: serving (energies, then forces
    by autograd), the rotated copy, training; see :func:`geo_phase`."""
    from repro_torch import configs
    from repro_torch.models import gnn
    from repro_torch.optim import adamw

    spec = configs.get(arch)
    dims = spec.shapes["molecule"]
    cfg = configs.cell_model_cfg(spec, "molecule")
    want = GNN_LAUNCHES[arch]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(GEO_SEED)
    model = configs.init_params(spec, cfg, gen, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    (batch, t_data) = wall(lambda: molecule_batch(
        cfg, dims, np.random.default_rng(GEO_SEED), dev))
    G, E = dims["graphs"], int(batch["src"].shape[0])
    serve = configs.make_serve_step(spec, "molecule")
    reset_b4_b5()
    (energy, svt), t_first = wall(lambda: serve(model, batch))
    plans = GNN_PLANS[arch]
    served = b4_b5_launches(want["serve"], f"a {arch} serve step",
                            plans["serve"])
    if energy.shape != (G,) or not bool(torch.isfinite(energy).all()):
        raise AssertionError(f"{arch} energies are not finite ({G},)")
    plain_e, _ = plain_outputs(lambda: serve(model, batch))
    err_e = rel_err(energy, plain_e)
    pattern = ReluPattern()
    reset_b4_b5()
    with mock.patch.object(torch, "relu", pattern.record):
        (e_k, f_k), t_forces = wall(lambda: gnn.energy_and_forces(model,
                                                                  batch))
    forced = b4_b5_launches(want["forces"], f"{arch}'s forces",
                            plans["forces"])
    with mock.patch.object(torch, "relu", pattern.replay):
        e_p, f_p = plain_outputs(lambda: gnn.energy_and_forces(model, batch))
    err_f = rel_err(f_k, f_p)
    if not (err_e <= GEO_TOL and err_f <= GEO_TOL
            and bool(torch.isfinite(f_k).all())):
        raise AssertionError(f"{arch}: energies {err_e}, forces {err_f} of "
                             f"max|plain| from the plain versions'")
    th = 0.9
    R = torch.tensor([[np.cos(th), -np.sin(th), 0.0],
                      [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32, device=dev)
    rotated = dict(batch, pos=batch["pos"] @ R.T)

    def rot_shares(e_r, f_r):
        return (float(((e_r - e_k).abs() / (GEO_ROT_E + GEO_ROT_E
                                            * e_k.abs())).max()),
                float(((f_r - f_k @ R.T).abs() / (GEO_ROT_F + GEO_ROT_F
                                                  * f_r.abs())).max()))
    # relu's inputs (radial MLPs, readout) are rotation-invariant, but the
    # rotated positions round differently in f32, so an input within that
    # rounding of 0 can take the other sign and move a force by a whole
    # term: the rotated run replays the first run's relu pattern
    own = rot_shares(*gnn.energy_and_forces(model, rotated))
    rot = ReluPattern()
    rot.inputs = pattern.inputs
    with mock.patch.object(torch, "relu", rot.replay):
        rot_e, rot_f = rot_shares(*gnn.energy_and_forces(model, rotated))
    if not (rot_e <= 1.0 and rot_f <= 1.0):
        raise AssertionError(f"{arch}: a rotated copy's energies reach "
                             f"{rot_e} and forces {rot_f} of their tolerance "
                             f"({rot.flips} relu inputs flipped)")
    fwd = sorted(wall(lambda: serve(model, batch))[1]
                 for _ in range(GEO_SERVES))[GEO_SERVES // 2]
    flops = configs.model_flops(spec, "molecule",
                                dims=dict(dims, kind="serve"))
    print(f"[geo] {arch} at full width and depth ({cfg.n_layers} layers, C "
          f"{cfg.d_hidden}, n_rbf {cfg.n_rbf}, cutoff {cfg.cutoff}"
          + (f", correlation {cfg.correlation_order}"
             if hasattr(cfg, "correlation_order") else "")
          + f"; {n_params:,} f32 parameters from seed {GEO_SEED}) on "
          f"molecule's full dims ({G} molecules x {dims['n'] // G} atoms, "
          f"{E:,} directed edges with {E - int(batch['edge_mask'].sum()):,} "
          f"padding at node 0; batch built in {t_data:.3f}s; nothing cut): "
          f"make_serve_step launched {launch_clause(served)} (first "
          f"{t_first:.3f}s); energies within {err_e:.3e} of max|plain| of "
          f"the plain versions'; forces by autograd ({launch_clause(forced)}; "
          f"{t_forces:.3f}s) within {err_f:.3e} (tolerance {GEO_TOL}; the "
          f"plain run replays the kernel run's relu pattern, "
          f"{pattern.flips} flips); a copy rotated 0.9 rad about z, "
          f"replaying the relu pattern ({rot.flips} of {rot.entries:,} "
          f"inputs flipped): energies at {rot_e:.3f} and forces at "
          f"{rot_f:.3f} of the reference's tolerances ({GEO_ROT_E}, "
          f"{GEO_ROT_F}; on its own pattern {own[0]:.3f} and {own[1]:.3f}); "
          f"max|F| {float(f_k.abs().max()):.3e}; serving "
          f"{fwd * 1e3:.3f} ms a batch (median of {GEO_SERVES}) = "
          f"{G / fwd:,.1f} molecules/s, model FLOPs {flops:.4e} = "
          f"{flops / fwd / 67e12:.4f} of the f32 peak | {smi}")
    print(f"[geo] {arch} serve step under torch.profiler: " + profiled(
        lambda: serve(model, batch), {"B4": is_b4, "B5": is_b5}) + f" | {smi}")
    del svt, energy, plain_e, e_k, f_k, e_p, f_p
    # the messages' shapes and ids, N(0, 1) rows zeroed on the padding
    # edges as the model's edge mask zeroes them
    n, C = dims["n"], cfg.d_hidden
    b4 = b4_checks({f"{arch} {what} ({E:,} x {w} into {n:,} atoms)": (
        torch.randn(E, w, generator=gen, device=dev)
        * batch["edge_mask"][:, None], batch["dst"], n)
        for what, w in (("a_s", C), ("a_v", 3 * C), ("a_t", 9 * C))}
        | {f"{arch} energies ({n:,} x 1 into {G} molecules)": (
            torch.randn(n, 1, generator=gen, device=dev), batch["graph_id"],
            G)}, tag="geo")

    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    step = configs.make_train_step(spec, cfg, opt_cfg)
    state = adamw.init_state(dict(model.named_parameters()))
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for i in range(GEO_STEPS):
        b = batch if i == 0 else molecule_batch(
            cfg, dims, np.random.default_rng(GEO_SEED + i), dev)
        if i == 0:
            reset_b4_b5()
        (_, state, m), t = wall(lambda: step(model, state, b))
        if i == 0:
            trained = b4_b5_launches(want["train"], f"a {arch} train step",
                                     plans["train"])
        losses.append(float(m["loss"]))
        step_s.append(t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch} losses are not finite: {losses}")
    ts = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(f"[geo] {arch} train: {GEO_STEPS} make_train_step steps (energy "
          f"+ 10 x force loss; the forces by autograd with create_graph, so "
          f"the step differentiates them again through B4 and B5); the first "
          f"launched {launch_clause(trained)}; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; step {ts:.4f}s after the "
          f"first ({step_s[0]:.3f}s) = {G / ts:,.1f} molecules/s trained; "
          f"peak device memory {peak:.2f} GiB | {smi}")
    print(f"[geo] {arch} train step under torch.profiler: " + profiled(
        lambda: step(model, state, batch), {"B4": is_b4, "B5": is_b5})
        + f" | {smi}")
    worst = grads_check(spec, cfg, model, batch, "train step's loss and "
                        "every gradient", GEO_TOL, smi)
    worst_f = grads_check(spec, cfg, model, batch, "the force loss's "
                          "gradient alone (10 x f_loss: it exists only "
                          "through the second derivative)", GEO_TOL, smi,
                          loss_fn=lambda mm, bb: 10.0 * gnn.geo_loss_terms(
                              mm, bb)[1])
    del model, state, batch
    torch.cuda.empty_cache()
    return {"b5": served[0] + forced[0] + trained[0] - forced[3]
            - trained[3], "b5_grad": forced[3] + trained[3],
            "b4": served[1] + forced[1] + trained[1],
            "gather": forced[2] + trained[2], "peak": peak,
            "worst_grad": max(worst, worst_f),
            "b4_err": max(r["max_abs_err"] for r in b4.values())}


def geo_phase(dev, smi: str) -> dict:
    """[geo]: nequip and mace served and trained on the card at full width
    and depth on molecule's full dims. Per architecture: the serve step's
    energies (launches counted and held to GNN_LAUNCHES), the forces by
    autograd of their sum (counted), both against the plain versions on
    the card; a rotated copy within the reference's equivariance
    tolerances; GEO_STEPS train steps (the first counted), then the loss
    and every gradient, and the force loss's gradient alone, against the
    plain versions. Returns the launches summed over both."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = [geo_arch(arch, dev, smi) for arch in GEO_ARCHS]
    out = {k: sum(r[k] for r in runs) for k in ("b5", "b5_grad", "b4",
                                                 "gather")}
    out["b4_err"] = max(r["b4_err"] for r in runs)
    print(f"[geo] phase {time.perf_counter() - t_phase:.1f}s; launches over "
          f"both: B5 {out['b5'] + out['b5_grad']} ({out['b5_grad']} "
          f"gradients), B4 {out['b4']}, B4 gather {out['gather']} | {smi}")
    return out


#: the [moe] phase: qwen2-moe-a2.7b at full width and depth (24 layers; 60
#: routed experts of 1,408, top-4, 4 shared), drawn on the card from
#: MOE_SEED: prefill 1 x MOE_SEQ tokens (prefill_32k cut as [lm]'s: batch
#: 32 -> 1, seq 32,768 -> 4,096), decode MOE_DECODE_BATCH sequences over
#: decode_32k's 32,768 slots (batch 128 -> 4: the cache of 16 kv heads is
#: 25.8 GB at 4, 825 GB at 128), MOE_STEPS timed steps, decode against
#: prefill over an MOE_PREFIX-token prefix; dbrx-132b and qwen1.5-110b at
#: full width, n_layer cut to MOE_CUT_LAYERS (their 40 and 80 layers are
#: 263 and 222 GB in bf16), prefill only; the train step on qwen2-moe at
#: full width, n_layer 24 -> MOE_TRAIN_LAYERS, batch 256 -> 1 (one
#: sequence of 4,096), remat, MOE_TRAIN_STEPS steps; the bf16 comparison
#: of the loss and gradients with the plain versions on a 1-layer model of
#: the same width, as [train]'s (bf16 noise grows with depth: on an H100
#: 80GB HBM3 at 700 W the worst leaf was 1.2-1.5e-2 of its scale at 1
#: layer, 2.6-4.0e-2 at 2 and 4.5-5.5e-2 at 4 over five batches, against
#: TRAIN_GRAD_TOL), and at MOE_TRAIN_LAYERS layers the two witnesses of
#: :func:`moe_depth_witness`
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_SEED = 23
MOE_SEQ = 4096
MOE_DECODE_BATCH = 4
MOE_STEPS = 4
MOE_PREFIX = 8
MOE_CUT_ARCHS = ("dbrx-132b", "qwen1.5-110b")
MOE_CUT_LAYERS = 2
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_STEPS = 3
#: the 4-layer witnesses: in f32 each gradient leaf of the kernels within
#: MOE_F32_GRAD_TOL of its largest |plain gradient| (PERF.md section 2's f32
#: bound) and the loss within it of itself; in bf16 the kernels' worst leaf,
#: taken against an f32 plain run, within MOE_BF16_SPREAD times the bf16
#: plain versions' worst leaf against the same run
MOE_F32_GRAD_TOL = 1e-4
MOE_BF16_SPREAD = 2.0


def routed_apart(a: torch.Tensor, b: torch.Tensor, E: int) -> int:
    """Assignments of ``a`` (T, K) expert ids whose expert is not among the
    same token's in ``b``."""
    ha = torch.zeros(a.shape[0], E, device=a.device).scatter_(1, a, 1.0)
    hb = torch.zeros(b.shape[0], E, device=b.device).scatter_(1, b, 1.0)
    return int((ha * (1 - hb)).sum())


class RoutePattern:
    """One run's MoE routing, recorded and replayed on another run. Each
    layer sends a token to its top-K router probabilities. The kernels and
    the plain versions sum the f32 router product and everything before it
    in other orders, so where two probabilities lie within that rounding
    the runs can route a token differently, and then both outputs are
    right but a whole expert's term apart. ``record`` stands in for
    ``transformer.route``: it routes, keeps the indices and the smallest
    top-K margin (the K-th largest probability minus the next one).
    ``replay`` gives the n-th call the n-th kept indices and counts in
    ``flips`` the assignments that the call's own routing would have sent
    elsewhere. ``dispatch`` stands in for ``transformer.dispatch`` and
    keeps each call's dropped assignments. Nothing here reads the card
    until :meth:`summary`."""

    def __init__(self):
        from repro_torch.models import transformer as tfm
        self.tfm = tfm
        self._route, self._dispatch = tfm.route, tfm.dispatch
        self.kept, self.drops, self.margins, self.flips = [], [], [], []
        self.assignments, self._next = 0, 0

    def record(self, probs, k):
        eidx = self._route(probs, k)
        top = torch.topk(probs.detach(), k + 1, dim=-1).values
        self.margins.append((top[:, k - 1] - top[:, k]).min())
        self.kept.append(eidx)
        return eidx

    def replay(self, probs, k):
        eidx = self.kept[self._next]
        self._next += 1
        self.flips.append(routed_apart(self._route(probs, k), eidx,
                                       probs.shape[-1]))
        self.assignments += eidx.numel()
        return eidx

    def dispatch(self, eidx, E, C):
        out = self._dispatch(eidx, E, C)
        self.drops.append((~out[4]).sum())
        return out

    def patches(self, replay: bool = False):
        return [mock.patch.object(self.tfm, "route",
                                  self.replay if replay else self.record),
                mock.patch.object(self.tfm, "dispatch", self.dispatch)]

    def margin(self) -> float:
        return float(torch.stack(self.margins).min())

    def dropped(self) -> int:
        return int(torch.stack(self.drops).sum()) if self.drops else 0


def moe_b5_per_layer(cfg) -> int:
    """B5 launches of one layer's forward: wq, wk, wv, wo; for MoE the
    router (f32), three per expert of ``e_total`` and, with s shared
    experts, two per shared expert and one for ``shared_wo``; for a dense
    layer wi, wg, wo."""
    m = cfg.moe
    if m is None:
        return 7
    return 4 + 1 + 3 * m.e_total + (2 * m.n_shared + 1 if m.n_shared else 0)


def moe_prefill_check(spec, cfg, model, toks, what: str) -> dict:
    """One prefill of ``toks`` through ``make_serve_step(spec,
    "prefill_32k", cfg)``: counted (B5 per layer and the head, the router
    on the f32 route, every other product on wgmma; B6 once a layer on
    the route its plan gives), the routes recorded; then timed; then the
    same forward with the plain versions on the card replaying the
    kernel run's routes, within LM_LOGIT_TOL of max|logit|, and once more
    routing on its own, counting the assignments routed elsewhere.
    Returns the numbers."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm

    L, (B, S) = cfg.n_layer, toks.shape
    prefill = configs.make_serve_step(spec, "prefill_32k", cfg)
    kern = RoutePattern()
    sm.reset_counts()
    fa.reset_counts()
    with contextlib.ExitStack() as stack:
        for patch in kern.patches():
            stack.enter_context(patch)
        logits, t_first = wall(lambda: prefill(model, {"tokens": toks}))
    b5, b6 = sm.matmul.launches, fa.flash_attention.launches
    per = moe_b5_per_layer(cfg)
    if (b5, b6) != (per * L + 1, L):
        raise AssertionError(f"{what} prefill launched B5 {b5} and B6 {b6} "
                             f"times, not {per * L + 1} and {L}")
    f32 = L if cfg.moe is not None else 0
    b5_by = b5_routes(sm, {r: n for r, n in (("wgmma", (per * L + 1) - f32),
                                              ("f32", f32)) if n},
                      f"{what} prefill")
    route6 = fa.plan(B, S, cfg.n_head, cfg.n_kv, S, True, cfg.d_head,
                     cfg.dtype).route
    b6_by = b6_routes(fa, {route6: L}, f"{what} prefill")
    if logits.shape != (B, S, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{what} prefill logits are not finite")
    _, t_pre = wall(lambda: prefill(model, {"tokens": toks}))
    out = dict(b5=b5, b6=b6, b5_by=b5_by, b6_by=b6_by, t_first=t_first,
               t_pre=t_pre)
    with contextlib.ExitStack() as stack:
        for patch in plain_ops() + (kern.patches(replay=True)
                                    if cfg.moe is not None else []):
            stack.enter_context(patch)
        plain, t_plain = wall(lambda: prefill(model, {"tokens": toks}))
    out.update(err=rel_err(logits, plain), agree=top1(logits, plain),
               t_plain=t_plain)
    del plain
    if not out["err"] <= LM_LOGIT_TOL:
        raise AssertionError(f"{what} prefill with the kernels differs from "
                             f"the plain versions by {out['err']} of "
                             f"max|logit|")
    if cfg.moe is not None:
        own = RoutePattern()
        with contextlib.ExitStack() as stack:
            for patch in plain_ops() + own.patches():
                stack.enter_context(patch)
            prefill(model, {"tokens": toks})
        E = cfg.moe.e_total
        out.update(
            margin=kern.margin(), flips=sum(kern.flips),
            assignments=kern.assignments,
            dropped=int(torch.stack(kern.drops[:L]).sum()),
            dropped_replayed=int(torch.stack(kern.drops[L:]).sum()),
            apart=sum(routed_apart(a, b, E)
                      for a, b in zip(own.kept, kern.kept)),
            dropped_own=own.dropped())
        if out["dropped_replayed"] != out["dropped"]:
            raise AssertionError(f"{what}: the replayed plain run dropped "
                                 f"{out['dropped_replayed']} assignments, "
                                 f"the kernel run {out['dropped']}")
    return out


def moe_routing_clause(r: dict, cfg, T: int) -> str:
    """The routing numbers of :func:`moe_prefill_check` as a clause."""
    from repro_torch.models import transformer as tfm
    m, L = cfg.moe, cfg.n_layer
    G, C = tfm.capacity(m, T)
    return (f"routing: C = {C} rows per expert (G = {G}), {r['dropped']:,} "
            f"of {L * T * m.top_k:,} assignments dropped ({r['dropped']:,} in "
            f"the replayed plain run, equal), smallest top-{m.top_k} margin "
            f"{r['margin']:.3e}; the plain run replays the kernel run's "
            f"routes, where its own routing would have sent "
            f"{r['flips']:,} of {r['assignments']:,} assignments elsewhere; "
            f"routing on its own, the plain run sends {r['apart']:,} "
            f"elsewhere and drops {r['dropped_own']:,}")


def moe_depth_witness(spec, cfg, batch, dev, smi: str) -> None:
    """The MoE train step's loss and gradients at MOE_TRAIN_LAYERS layers,
    where bf16 kernels against bf16 plain versions straddle
    TRAIN_GRAD_TOL, held two ways, every run replaying the first run's
    routes. (1) bf16: the kernels' gradients and the plain versions' each
    against the plain versions' in f32 from the same weights; the kernels
    may sit at most MOE_BF16_SPREAD times as far from it as the plain
    versions do. (2) f32: the kernels (B5's and B6's f32 routes, B6's f32
    backward) against the plain versions, each leaf within
    MOE_F32_GRAD_TOL of its scale. Launches here compare kernels with
    their plain versions and are not counted on the main path."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm

    tcfg = dataclasses.replace(cfg, n_layer=MOE_TRAIN_LAYERS)
    f32cfg = dataclasses.replace(tcfg, dtype=torch.float32)
    L, K, seq = tcfg.n_layer, cfg.moe.top_k, batch["tokens"].shape[1]
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    model = configs.init_params(spec, tcfg, gen, device=dev)
    first = RoutePattern()

    def run(model, plain: bool):
        """(loss, gradients, seconds, pattern): the first call records the
        routes, every later one replays them."""
        pattern = first
        if first.kept:
            pattern = RoutePattern()
            pattern.kept = first.kept
        with contextlib.ExitStack() as stack:
            for patch in pattern.patches(replay=pattern is not first):
                stack.enter_context(patch)
            (loss, grads), t = wall(lambda: loss_and_grads(
                spec, model.cfg, model, batch, plain=plain))
        return loss, grads, t, pattern

    loss_k, grads_k, t_k, _ = run(model, False)
    loss_p, grads_p, t_p, rp = run(model, True)
    m32 = configs.init_params(spec, f32cfg, gen, device=dev)
    src = dict(model.named_parameters())
    with torch.no_grad():
        for n, p in m32.named_parameters():
            p.copy_(src[n])
    del src
    del model
    loss_f, grads_f, t_f, rf = run(m32, True)
    kern, plain = (grad_leaf_errs(grads_k, grads_f),
                   grad_leaf_errs(grads_p, grads_f))
    apart = grad_leaf_errs(grads_k, grads_p)
    del grads_k, grads_p
    sm.reset_counts()
    fa.reset_counts()
    fa.reset_bwd_counts()
    loss_fk, grads_fk, t_fk, rk = run(m32, False)
    per = moe_b5_per_layer(tcfg)
    b5_by = b5_routes(sm, {"f32": 4 * per * L + 3}, "the f32 MoE step")
    route6 = fa.plan(1, seq, cfg.n_head, cfg.n_kv, seq, True, cfg.d_head,
                     torch.float32).route
    b6_by = b6_routes(fa, {route6: 2 * L}, "the f32 MoE step")
    bwd6 = fa.bwd_plan(1, seq, cfg.n_head, cfg.n_kv, seq, True, cfg.d_head,
                       torch.float32).route
    if {r: n for r, n in fa.flash_attention_bwd.routes.items() if n} != {
            bwd6: L}:
        raise AssertionError(f"the f32 MoE step's B6 backward: "
                             f"{fa.flash_attention_bwd.routes}")
    f32 = grad_leaf_errs(grads_fk, grads_f)
    del m32, grads_f, grads_fk
    torch.cuda.empty_cache()
    drops = [r.dropped() for r in (first, rp, rf, rk)]
    if len(set(drops)) != 1:
        raise AssertionError(f"the 4-layer runs dropped {drops} assignments")
    worst = {name: max(e, key=e.get) for name, e in
             (("kern", kern), ("plain", plain), ("apart", apart),
              ("f32", f32))}
    w_k, w_p = kern[worst["kern"]], plain[worst["plain"]]
    w_f32 = f32[worst["f32"]]
    if not abs(loss_fk - loss_f) <= MOE_F32_GRAD_TOL * abs(loss_f):
        raise AssertionError(f"f32 MoE loss {loss_fk} with the kernels, "
                             f"{loss_f} with the plain versions")
    if not w_f32 <= MOE_F32_GRAD_TOL:
        raise AssertionError(f"f32 MoE gradient {worst['f32']} differs from "
                             f"the plain version's by {w_f32} of its scale")
    if not w_k <= MOE_BF16_SPREAD * w_p:
        raise AssertionError(f"the bf16 kernels' gradients sit {w_k} from "
                             f"the f32 plain run's ({worst['kern']}), the "
                             f"bf16 plain versions' {w_p} ({worst['plain']})")
    moe_k = max(e for n, e in kern.items() if ".moe." in n)
    moe_p = max(e for n, e in plain.items() if ".moe." in n)
    print(f"[moe] train, {L} layers at full width (remat), the first step's "
          f"sequence of {seq}, every run replaying the first run's routes "
          f"(the plain bf16 run's own routing would have sent "
          f"{sum(rp.flips):,} of {rp.assignments:,} assignments elsewhere, "
          f"the f32 runs' {sum(rf.flips):,} and {sum(rk.flips):,}; smallest "
          f"top-{K} margin {first.margin():.3e}; {drops[0]:,} dropped in "
          f"each run): (1) bf16 against the plain versions in f32 "
          f"({loss_f:.6f}, {t_f:.3f}s): the kernels' worst leaf {w_k:.3e} "
          f"({worst['kern']}; MoE leaves {moe_k:.3e}; loss {loss_k:.6f}, "
          f"{t_k:.3f}s), the plain versions' {w_p:.3e} ({worst['plain']}; "
          f"MoE leaves {moe_p:.3e}; loss {loss_p:.6f}, {t_p:.3f}s): ratio "
          f"{w_k / w_p:.3f} (at most {MOE_BF16_SPREAD}); kernels against "
          f"plain in bf16 {apart[worst['apart']]:.3e} ({worst['apart']}; "
          f"TRAIN_GRAD_TOL {TRAIN_GRAD_TOL} is held at 1 layer); (2) f32, "
          f"the kernels (B5 {b5_by}; B6 {b6_by}, backward {L} on the {bwd6} "
          f"route; {t_fk:.3f}s) against the plain versions: loss "
          f"{loss_fk:.8f} against {loss_f:.8f}, every one of the "
          f"{len(f32)} gradients within {w_f32:.3e} of its largest |plain| "
          f"({worst['f32']}; tolerance {MOE_F32_GRAD_TOL}) | {smi}")


def moe_phase(dev, smi: str) -> dict:
    """[moe]: the MoE LMs on the card through their entry points.

    qwen2-moe-a2.7b (:data:`MOE_ARCH`) at full width and depth: prefill
    and decode through ``make_serve_step``, each counted (B5's launches by
    route and B6's asserted from the design: per layer four attention
    projections, the router on the f32 route, three per expert, two per
    shared expert and one for ``shared_wo``), the prefill's logits against
    the plain versions with the routes replayed, decode against prefill
    with the prefill's routes replayed per token, the layer's pieces timed
    alone, B5 at the expert shapes; dbrx-132b and qwen1.5-110b at full
    width cut in depth, prefill against plain; then the MoE train step
    (launches, the remat recompute's routes equal to the first pass's, a
    repeat from the same state bit-equal), a 1-layer model's loss and
    gradients against the plain versions with the routes replayed, and
    the 4-layer step's two witnesses (:func:`moe_depth_witness`). Returns
    the phase's launches
    of B5 (forward), its gradient, B6 and B6's backward."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    spec = configs.get(MOE_ARCH)
    cfg = spec.model_cfg
    m, L = cfg.moe, cfg.n_layer
    E, K, d, f = m.e_total, m.top_k, cfg.d_model, m.d_ff_expert
    seq, batch, steps, prefix = (MOE_SEQ, MOE_DECODE_BATCH, MOE_STEPS,
                                 MOE_PREFIX)
    slots = spec.shapes["decode_32k"]["seq"]
    pre_dims = dict(spec.shapes["prefill_32k"], batch=1, seq=seq)
    dec_dims = dict(spec.shapes["decode_32k"], batch=batch, seq=slots)
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    torch.cuda.reset_peak_memory_stats()
    model, t_init = wall(lambda: tfm.init_params(cfg, gen, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != cfg.param_count:
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count}")
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    print(f"[moe] {MOE_ARCH} at full width and depth ({L} layers, d_model "
          f"{d}, {cfg.n_head} query heads over {cfg.n_kv} kv heads of "
          f"{cfg.d_head}, {m.n_experts} experts of {f}, top-{K}, "
          f"{m.n_shared} shared, vocab {cfg.vocab}): {n_params:,} parameters "
          f"({cfg.active_param_count:,} active), {gb:.2f} GB in {cfg.dtype}, "
          f"drawn on the card from seed {MOE_SEED} in {t_init:.2f}s | {smi}")

    # -- prefill: the main path, counted; against the plain versions ------
    toks = torch.randint(0, cfg.vocab, (1, seq), generator=gen, device=dev)
    r = moe_prefill_check(spec, cfg, model, toks, MOE_ARCH)
    b5_n, b6_n = r["b5"], r["b6"]
    _, C = tfm.capacity(m, seq)
    flops = configs.model_flops(spec, "prefill_32k", dims=pre_dims)
    kept = L * seq * K - r["dropped"]
    print(f"[moe] prefill 1 x {seq} through make_serve_step(spec, "
          f"'prefill_32k') (reduced: batch "
          f"{spec.shapes['prefill_32k']['batch']} -> 1, seq "
          f"{spec.shapes['prefill_32k']['seq']} -> {seq}): {r['t_pre']:.4f}s = {seq / r['t_pre']:.1f} "
          f"tokens/s (first call {r['t_first']:.4f}s); model FLOPs on the "
          f"active parameters {flops:.4e} = "
          f"{flops / r['t_pre'] / 989e12:.4f} of 989 TFLOP/s; launches B5 "
          f"{b5_n} ({r['b5_by']}: {moe_b5_per_layer(cfg)} a layer + the "
          f"head), B6 {b6_n} ({r['b6_by']}); expert rows executed E*C = "
          f"{E * C:,} a layer against T*K = {seq * K:,} assigned "
          f"({E * C / (seq * K):.3f}x; {kept / L:,.0f} kept a layer: "
          f"{E * C * L / kept:.3f}x the useful expert FLOPs); "
          + moe_routing_clause(r, cfg, seq) + f". Logits against the same "
          f"forward with the plain versions on the card ({r['t_plain']:.4f}s,"
          f" routes replayed): largest |diff| {r['err']:.4e} of max|logit| "
          f"(tolerance {LM_LOGIT_TOL}), top-1 agreement {r['agree']:.4f} | "
          f"{smi}")
    prefill = configs.make_serve_step(spec, "prefill_32k")
    shares = {}
    print(f"[moe] prefill under torch.profiler: " + profiled(
        lambda: prefill(model, {"tokens": toks}),
        {"B5": is_b5, "B6": is_b6, "every kernel": lambda k: True}, shares)
        + f" | {smi}")

    # -- the layer's pieces alone, on layer 0's operands ----------------------
    p0 = model.layers[0]
    pos = torch.arange(seq, dtype=torch.int32, device=dev)[None, :]
    with torch.inference_mode():
        x = model.embed[toks]
        x = x + tfm.attention_block(p0, cfg, tfm.rms_norm(x, p0.ln1), pos,
                                    tfm.partition_of(model))
        h = tfm.rms_norm(x, p0.ln2)[0]
        probs = tfm.router_probs(p0.moe, m, h)
        eidx = tfm.route(probs, K)
        gate = probs.gather(-1, eidx)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
        order, se, _, _, _, dest = tfm.dispatch(eidx, E, C)
        # what the main path's layer (tfm._routed under Whole) runs
        part = tfm.partition_of(model)
        buf = tfm.repeated(h, K)[tfm.source_rows(order, dest, E * C,
                                                 seq * K)]
        ho = tfm.expert_rows(p0.moe, buf.view(1, E, C, -1), part, (E, C))

        def dispatched():
            o, _, _, _, _, dst = tfm.dispatch(tfm.route(probs, K), E, C)
            return tfm.repeated(h, K)[tfm.source_rows(o, dst, E * C,
                                                      seq * K)]

        pieces = {
            "router (B5 f32 + softmax)": lambda: tfm.router_probs(p0.moe, m,
                                                                  h),
            "route + dispatch (two stable sorts, searchsorted, the row "
            "gather)":
                dispatched,
            f"experts ({3 * E} B5 launches)": lambda: tfm.expert_rows(
                p0.moe, buf.view(1, E, C, -1), part, (E, C)),
            "combine (the token slots, K gathers, gate products and bf16 "
            "adds)":
                lambda: tfm.combine(ho, eidx, gate,
                                    tfm.token_slots(order, dest, seq, K)),
            f"shared experts ({2 * m.n_shared + 1} B5 launches)":
                lambda: tfm.shared_experts(p0.moe, m, h, part)}
        times = {name: call_times(fn, iters=10) for name, fn in
                 pieces.items()}
        # route is a stable descending sort (ties to the lower index, as
        # jax.lax.top_k); its earlier form, torch.topk, timed beside it
        route_t = {"route (stable sort)": call_times(
                       lambda: tfm.route(probs, K), iters=10),
                   "torch.topk (the earlier route)": call_times(
                       lambda: torch.topk(probs, K, dim=-1).indices,
                       iters=10)}
        top = probs.topk(K + 1, dim=-1).values
        ties = int((top[:, K - 1] == top[:, K]).sum())
    print(f"[moe] routing alone on layer 0's {seq:,} x {E} probabilities, "
          f"top-{K}: " + show(route_t) + f"; {ties} tokens tie at the "
          f"{K}-th probability, where the sort keeps the lower expert "
          f"index | {smi}")
    layer_ms = sum(t for t, _ in times.values())
    busy = shares.get("busy_s", float("nan"))
    print(f"[moe] one MoE layer's pieces alone on layer 0's prefill operands "
          f"({layer_ms:.4f} ms together; x {L} layers = "
          f"{layer_ms * L / 1e3:.4f}s, {layer_ms * L / 1e3 / busy:.3f} of the "
          f"profiled prefill's device busy {busy:.4f}s): "
          + "; ".join(f"{n} {t:.4f} ms ({t / layer_ms:.3f})"
                      for n, (t, _) in times.items()) + "; " + show(times)
          + f" | {smi}")
    busiest = int(torch.bincount(eidx.flatten(), minlength=E).argmax())
    rows = buf[busiest * C:(busiest + 1) * C]
    with torch.inference_mode():
        act = tfm.silu(tfm.linear(rows, p0.moe.wg[busiest])) * tfm.linear(
            rows, p0.moe.wi[busiest])
    b5_cases = {
        f"prefill expert wg ({C} rows)": (rows, p0.moe.wg[busiest]),
        f"prefill expert wo ({C} rows)": (act, p0.moe.wo[busiest]),
        "decode expert wg (32 rows)": (rows[:32].contiguous(),
                                       p0.moe.wg[busiest]),
        "router (f32)": (h.float(), p0.moe.router)}
    results = kernel_checks(b5_cases, {}, tag="moe")
    del x, h, probs, eidx, gate, order, se, dest, buf, ho, rows, act
    torch.cuda.empty_cache()

    # -- decode: against prefill with its routes replayed per token ----------
    decode = configs.make_serve_step(spec, "decode_32k")
    cache = tfm.init_cache(cfg, batch, slots, device=dev)
    cache["k"].normal_(generator=gen)          # a stand-in cache from the seed
    cache["v"].normal_(generator=gen)
    cache_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    pre_toks = torch.randint(0, cfg.vocab, (batch, prefix), generator=gen,
                             device=dev)
    pre = RoutePattern()
    with contextlib.ExitStack() as stack:
        for patch in pre.patches():
            stack.enter_context(patch)
        want = prefill(model, {"tokens": pre_toks})
    if pre.dropped():
        raise AssertionError(f"the {batch} x {prefix} prefill dropped "
                             f"{pre.dropped()} assignments")
    by_token = [e.view(batch, prefix, K) for e in pre.kept]
    errs, agrees, step_drops = [], [], []
    flips = assigned = 0
    for i in range(prefix):
        layer = iter(by_token)
        dec = RoutePattern()
        dec.kept = [next(layer)[:, i] for _ in range(L)]
        with contextlib.ExitStack() as stack:
            for patch in dec.patches(replay=True):
                stack.enter_context(patch)
            step, cache = decode(model, {"tokens": pre_toks[:, i:i + 1],
                                         "cache": cache, "cache_len": i})
        errs.append(rel_err(step, want[:, i]))
        agrees.append(top1(step, want[:, i]))
        step_drops.append(dec.dropped())
        flips, assigned = flips + sum(dec.flips), assigned + dec.assignments
    del want, step
    if not max(errs) <= LM_LOGIT_TOL or any(step_drops):
        raise AssertionError(f"decode differs from prefill by {max(errs)} "
                             f"of max|logit| (drops {step_drops})")
    print(f"[moe] decode against prefill: {batch} sequences of {prefix} "
          f"tokens decoded one by one into the {slots}-slot cache (the other "
          f"slots random, masked), each step replaying the {batch} x {prefix} "
          f"prefill's routes of its tokens (the prefill at C = "
          f"{tfm.capacity(m, batch * prefix)[1]} and every step at C = "
          f"{tfm.capacity(m, batch)[1]} dropped nothing): largest |diff| "
          f"{max(errs):.4e} of max|logit| (tolerance {LM_LOGIT_TOL}; per step "
          f"{' '.join(f'{e:.2e}' for e in errs)}), top-1 agreement "
          f"{sum(agrees) / len(agrees):.4f}; decode's own routing would have "
          f"sent {flips} of {assigned} assignments elsewhere | {smi}")

    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, device=dev)
    sm.reset_counts()
    fa.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        out, cache = decode(model, {"tokens": tok, "cache": cache,
                                    "cache_len": slots - steps + i})
        tok = out.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / steps
    per = moe_b5_per_layer(cfg)
    b5_dec, b6_dec = sm.matmul.launches, fa.flash_attention.launches
    if (b5_dec, b6_dec) != (steps * (per * L + 1), steps * L):
        raise AssertionError(f"decode launched B5 {b5_dec} and B6 {b6_dec} "
                             f"times")
    dec_b5 = b5_routes(sm, {"skinny": steps * ((per - 1) * L + 1),
                            "f32": steps * L}, "MoE decode")
    dec_b6 = b6_routes(fa, {"split": steps * L}, "MoE decode")
    if out.shape != (batch, cfg.vocab) or not bool(torch.isfinite(out).all()):
        raise AssertionError("MoE decode logits are not finite (B, vocab)")
    b5_n, b6_n = b5_n + b5_dec, b6_n + b6_dec
    flops_dec = configs.model_flops(spec, "decode_32k", dims=dec_dims)
    print(f"[moe] decode {batch} x 1 tokens over the {slots}-slot cache "
          f"({cache_gb:.2f} GB) through make_serve_step(spec, 'decode_32k') "
          f"(reduced: batch {spec.shapes['decode_32k']['batch']} -> {batch}), "
          f"{steps} greedy steps at cache_len {slots - steps}..{slots - 1}: "
          f"{t_dec * 1e3:.3f} ms per step = {batch / t_dec:.1f} tokens/s; "
          f"model FLOPs on the active parameters {flops_dec:.4e} per step = "
          f"{flops_dec / t_dec / 989e12:.6f} of 989 TFLOP/s; launches B5 "
          f"{b5_dec} ({dec_b5}; {per * L + 1} a step, the experts at C = "
          f"{tfm.capacity(m, batch)[1]} rows), B6 {b6_dec} ({dec_b6}); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB | {smi}")
    print(f"[moe] one decode step under torch.profiler: " + profiled(
        lambda: decode(model, {"tokens": tok, "cache": cache,
                               "cache_len": slots - 1}),
        {"B5": is_b5, "B6": is_b6, "every kernel": lambda k: True})
        + f" | {smi}")
    peak_serve = torch.cuda.max_memory_allocated() / 2**30
    del model, cache, out, tok
    torch.cuda.empty_cache()

    # -- dbrx-132b and qwen1.5-110b at full width, cut in depth --------------
    for arch in MOE_CUT_ARCHS:
        aspec = configs.get(arch)
        full = aspec.model_cfg
        acfg = dataclasses.replace(full, n_layer=MOE_CUT_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        agen = torch.Generator(device=dev).manual_seed(MOE_SEED)
        amodel, t_ainit = wall(lambda: tfm.init_params(acfg, agen,
                                                       device=dev))
        an = sum(p.numel() for p in amodel.parameters())
        if an != acfg.param_count:
            raise AssertionError(f"{arch}: {an} parameters, the config "
                                 f"counts {acfg.param_count}")
        atoks = torch.randint(0, acfg.vocab, (1, seq), generator=agen,
                              device=dev)
        ar = moe_prefill_check(aspec, acfg, amodel, atoks, arch)
        b5_n, b6_n = b5_n + ar["b5"], b6_n + ar["b6"]
        aflops = configs.model_flops(aspec, "prefill_32k", dims=pre_dims,
                                     model_cfg=acfg)
        what = (moe_routing_clause(ar, acfg, seq) + "; " if acfg.moe
                else "dense; ")
        print(f"[moe] {arch} at full width (d_model {acfg.d_model}, "
              f"{acfg.n_head} query heads over {acfg.n_kv} kv heads, "
              + (f"{acfg.moe.n_experts} experts of {acfg.moe.d_ff_expert}, "
                 f"top-{acfg.moe.top_k}" if acfg.moe else
                 f"d_ff {acfg.d_ff}") + f", vocab {acfg.vocab}), cut in "
              f"depth: reduced n_layer {full.n_layer} -> {MOE_CUT_LAYERS} "
              f"({an:,} parameters, "
              f"{sum(p.numel() * p.element_size() for p in amodel.parameters()) / 1e9:.2f}"
              f" GB, drawn in {t_ainit:.2f}s); prefill 1 x {seq}: "
              f"{ar['t_pre']:.4f}s = {seq / ar['t_pre']:.1f} tokens/s, model "
              f"FLOPs {aflops:.4e} = {aflops / ar['t_pre'] / 989e12:.4f} of "
              f"989 TFLOP/s; launches B5 {ar['b5']} ({ar['b5_by']}), B6 "
              f"{ar['b6']} ({ar['b6_by']}); " + what + f"logits against the "
              f"plain versions ({ar['t_plain']:.4f}s) largest |diff| "
              f"{ar['err']:.4e} of max|logit| (tolerance {LM_LOGIT_TOL}), "
              f"top-1 {ar['agree']:.4f}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")
        del amodel, atoks
        torch.cuda.empty_cache()

    # -- the MoE train step ---------------------------------------------------
    tcfg = dataclasses.replace(cfg, n_layer=MOE_TRAIN_LAYERS)
    TL = tcfg.n_layer
    tdims = dict(spec.shapes["train_4k"], batch=1, seq=seq)
    torch.cuda.reset_peak_memory_stats()
    tgen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    tmodel = configs.init_params(spec, tcfg, tgen, device=dev)
    tn = sum(p.numel() for p in tmodel.parameters())
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    step = configs.make_train_step(spec, tcfg, opt_cfg)
    batch_fn = train_cli.make_batch_fn(spec, tcfg, tdims, dev)
    params = dict(tmodel.named_parameters())
    state = adamw.init_state(params)
    b0 = batch_fn(0)
    start = {n: p.detach().clone() for n, p in params.items()}
    rec = RoutePattern()
    sm.reset_counts()
    fa.reset_counts()
    fa.reset_bwd_counts()
    with contextlib.ExitStack() as stack:
        for patch in rec.patches():
            stack.enter_context(patch)
        (_, state, m0), t_first = wall(lambda: step(tmodel, state, b0))
    b5, b5_grad = sm.matmul.launches, sm.matmul_grads.launches
    b6, b6_bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    fwd = per * TL + 1
    want = (4 * per * TL + 3, 2 * fwd, 2 * TL, TL)
    if (b5, b5_grad, b6, b6_bwd) != want:
        raise AssertionError(f"a MoE train step launched B5 {b5} (gradients "
                             f"{b5_grad}), B6 {b6} and its backward {b6_bwd} "
                             f"times, not {want}")
    t_b5 = b5_routes(sm, {"wgmma": want[0] - 4 * TL, "f32": 4 * TL},
                     "a MoE train step")
    t_b6 = b6_routes(fa, {"wgmma": 2 * TL}, "a MoE train step")
    bwd_route = fa.bwd_plan(1, seq, cfg.n_head, cfg.n_kv, seq, True,
                            cfg.d_head, cfg.dtype).route
    if fa.flash_attention_bwd.routes[bwd_route] != TL:
        raise AssertionError(f"B6's backward: {fa.flash_attention_bwd.routes}")
    if len(rec.kept) != 2 * TL:
        raise AssertionError(f"{len(rec.kept)} routings in a remat step, "
                             f"not {2 * TL}")
    same = sum(int((a == b).all(dim=-1).sum()) * K for a, b in
               zip(rec.kept[:TL], rec.kept[TL:][::-1]))
    if same != TL * seq * K:
        raise AssertionError(f"the remat recompute routed {same} of "
                             f"{TL * seq * K} assignments as the first pass")
    loss0 = float(m0["loss"])
    after = {n: p.detach().clone() for n, p in params.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(start[n])
    state = adamw.init_state(params)
    (_, state, m1), _ = wall(lambda: step(tmodel, state, b0))
    repeat = float(m1["loss"]) == loss0 and all(
        torch.equal(p, after[n]) for n, p in params.items())
    if not repeat:
        raise AssertionError("two MoE train steps from the same state differ")
    del start, after
    losses, t_steps = [loss0], []
    for i in range(1, MOE_TRAIN_STEPS + 1):
        bi = batch_fn(i)
        (_, state, mi), t = wall(lambda: step(tmodel, state, bi))
        losses.append(float(mi["loss"]))
        t_steps.append(t)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"MoE train losses are not finite: {losses}")
    t_step = sorted(t_steps)[len(t_steps) // 2]
    tflops = configs.model_flops(spec, "train_4k", dims=tdims,
                                 model_cfg=tcfg)
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    print(f"[moe] train: {MOE_ARCH} at full width cut in depth: reduced "
          f"n_layer {L} -> {TL}, batch {spec.shapes['train_4k']['batch']} -> "
          f"1 (seq {seq}); remat {tcfg.remat}; {tn:,} parameters; one step "
          f"of make_train_step counted: B5 {b5} ({t_b5}: {fwd} forward, "
          f"{fwd - 1} recomputed by remat, {b5_grad} gradient products), B6 "
          f"forward {b6} ({t_b6}), backward {b6_bwd} (all on the {bwd_route} "
          f"route); the remat recompute routed all {same:,} assignments as "
          f"the first pass; the step repeated from the same state: loss and "
          f"every parameter bit-equal; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)} (ln {cfg.vocab} = "
          f"{np.log(cfg.vocab):.4f}); step {t_step:.4f}s (median of "
          f"{len(t_steps)}; first {t_first:.4f}s) = {seq / t_step:.1f} "
          f"tokens/s; model FLOPs on the active parameters {tflops:.4e} = "
          f"{tflops / t_step / 989e12:.4f} of 989 TFLOP/s; peak device "
          f"memory {peak_train:.2f} GiB | {smi}")
    del tmodel, state, params
    torch.cuda.empty_cache()

    # -- a 1-layer full-width model: kernels against the plain versions ----
    one = dataclasses.replace(cfg, n_layer=1)
    m1 = configs.init_params(spec, one,
                             torch.Generator(device=dev).manual_seed(MOE_SEED),
                             device=dev)
    kr = RoutePattern()
    with contextlib.ExitStack() as stack:
        for patch in kr.patches():
            stack.enter_context(patch)
        (loss_k, grads_k), t_k = wall(lambda: loss_and_grads(spec, one, m1,
                                                             b0))
    with contextlib.ExitStack() as stack:
        for patch in kr.patches(replay=True):
            stack.enter_context(patch)
        (loss_p, grads_p), t_p = wall(lambda: loss_and_grads(
            spec, one, m1, b0, plain=True))
    errs = grad_leaf_errs(grads_k, grads_p)
    worst = max(errs, key=errs.get)
    if not abs(loss_k - loss_p) <= TRAIN_LOSS_TOL * abs(loss_p):
        raise AssertionError(f"MoE loss {loss_k} with the kernels, {loss_p} "
                             f"with the plain versions")
    if not errs[worst] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"MoE gradient {worst} differs from the plain "
                             f"version's by {errs[worst]} of its scale")
    moe_leaves = {n: e for n, e in errs.items() if ".moe." in n}
    print(f"[moe] train: a 1-layer full-width {MOE_ARCH} (remat), the first "
          f"step's sequence of {seq}: loss {loss_k:.6f} with the kernels "
          f"({t_k:.3f}s), {loss_p:.6f} with the plain versions on the card "
          f"({t_p:.3f}s), routes replayed (the plain run's own routing would "
          f"have sent {sum(kr.flips):,} of {kr.assignments:,} assignments "
          f"elsewhere; smallest top-{K} margin {kr.margin():.3e}; dropped "
          f"{kr.dropped():,} over the pass and the recompute); every one of "
          f"the {len(errs)} gradients within {errs[worst]:.3e} of its "
          f"largest |plain| at most ({worst}; tolerance {TRAIN_GRAD_TOL}); "
          f"the MoE leaves at most {max(moe_leaves.values()):.3e} "
          f"({max(moe_leaves, key=moe_leaves.get)}) | {smi}")
    del m1, grads_k, grads_p
    torch.cuda.empty_cache()
    moe_depth_witness(spec, cfg, b0, dev, smi)
    print(f"[moe] phase {time.perf_counter() - t_phase:.1f}s; peak device "
          f"memory serving {peak_serve:.2f} GiB, training {peak_train:.2f} "
          f"GiB | {smi}")
    return {"b5": b5_n + b5 - b5_grad, "b5_grad": b5_grad, "b6": b6_n + b6,
            "b6_bwd": b6_bwd,
            "max_abs_err": max(x["max_abs_err"] for x in results.values())}


def sweep_split(g, ks, dev) -> dict:
    """The card build's steps one at a time, each timed: the pair CSR and
    the t_uv rows on the host, their upload, the stratum sweep (CUDA
    events around its launches), the rows' download, and the host's
    delta compression and stratification. Returns the times, the rows
    (a (|K|, t_max + 1, n) card tensor), the per-stratum counts and the
    sweep's operands of the first block."""
    from repro_torch.core import core_time as ct
    from repro_torch.kernels import segmented_select as ss

    inf = g.t_max + 1
    t0 = time.perf_counter()
    csr = ct._pair_csr(g)
    t_csr = time.perf_counter() - t0
    blocks = [(lo, min(lo + ct.TUV_BLOCK, g.t_max + 1))
              for lo in range(1, g.t_max + 1, ct.TUV_BLOCK)]
    t0 = time.perf_counter()
    tuv_np = [np.ascontiguousarray(ct._tuv_rows(csr, lo, hi, g.t_max))
              for lo, hi in blocks]
    t_tuv = time.perf_counter() - t0
    t0 = time.perf_counter()
    ops = [torch.as_tensor(a, device=dev) for a in (
        csr.src, csr.vptr.astype(np.int32), csr.dst,
        np.asarray(ks, np.int32))]
    tuv = [torch.as_tensor(a, device=dev) for a in tuv_np]
    rows = torch.full((len(ks), g.t_max + 1, g.n), inf, dtype=torch.int32,
                      device=dev)
    carry = torch.zeros((len(ks), g.n), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    counts = 0
    start.record()
    for (lo, hi), t in zip(blocks, tuv):
        counts = counts + ss.stratum_sweep(t, *ops[:3], ops[3], carry, inf,
                                           out=rows[:, lo:hi])[1]
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end)
    host_rows, t_down = wall(lambda: rows.cpu().numpy())
    t0 = time.perf_counter()
    ct.StratifiedCoreTable.from_tables(
        g, ks, [ct._compress(g, v) for v in host_rows])
    t_compress = time.perf_counter() - t0
    return dict(t_csr=t_csr, t_tuv=t_tuv, t_up=t_up, kernel_ms=kernel_ms,
                t_down=t_down, t_compress=t_compress, rows=rows,
                counts=counts.cpu().numpy(), host_rows=host_rows,
                ops=[tuv[0], *ops[:3]], blocks=blocks)


def construct_phase(dev):
    """``[construct]``: the CollegeMsg-scale strata built on the card (the
    main path of the stratum sweep, counted) and on the host, every field
    equal; the build's split, idle share, bound and serial chain; the
    kernel against its plain version on the card. Returns ``(g, ks,
    strata, t_dev, t_host, b2_launches, record)``."""
    from repro_torch.core import core_time as ct
    from repro_torch.core.temporal_graph import gen_temporal_graph
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented_select as ss

    from repro_torch.core import kcore
    from repro_torch.kernels import kcore_peel

    g = gen_temporal_graph(**COLLEGEMSG)
    f0 = kcore_peel.kcore_fixpoint.launches
    ks, t_ks = wall(lambda: ct.default_ks(g, device=dev))
    fix = kcore_peel.kcore_fixpoint.launches - f0
    if ks != ct.default_ks(g) or fix != kmax_probes(ks[-1]):
        raise AssertionError(f"the card's k range {ks[0]}..{ks[-1]} ({fix} "
                             f"kcore_fixpoint launches) differs from "
                             f"numpy's or from one launch per k_max probe")
    print(f"[construct] k range on the card: default_ks = {ks[0]}.."
          f"{ks[-1]} through kcore.k_max (kcore_fixpoint launches {fix}, one "
          f"per probe; equal to numpy's k_max {kcore.k_max(g)}) in "
          f"{t_ks:.4f}s")
    inf = g.t_max + 1
    host_strata, t_host = wall(lambda: ct.stratified_core_times(
        g, ks, device="cpu"))
    stats: dict = {}
    ss.reset_sweep_counts()
    ss.segmented_count_le.launches = 0
    strata, t_dev = wall(lambda: ct.stratified_core_times(
        g, ks, engine="device", device=dev, stats=stats))
    launches = ss.stratum_sweep.launches
    routes = dict(ss.stratum_sweep.routes)
    b2_launches = ss.segmented_count_le.launches
    blocks = -(-g.t_max // ct.TUV_BLOCK)
    route = ss.sweep_route(g.n)
    if launches <= 0:
        raise AssertionError("the device build launched the stratum sweep "
                             "no time")
    if launches != blocks or routes[route] != blocks:
        raise AssertionError(f"the build made {launches} sweep launches "
                             f"({routes}), expected {blocks} on the {route} "
                             "route, one per t_uv block")
    if b2_launches:
        raise AssertionError(f"B2 launched {b2_launches} times during the "
                             "build (it is off the build path)")
    for f in dataclasses.fields(strata):
        a, b = getattr(strata, f.name), getattr(host_strata, f.name)
        if not (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b):
            raise AssertionError(f"card-built strata differ from the "
                                 f"host's in {f.name}")
    same = sum(np.array_equal(strata.table_for(k).vertex_ct,
                              host_strata.table_for(k).vertex_ct)
               for k in ks)
    if same != len(ks):
        raise AssertionError(f"only {same} of {len(ks)} strata equal")
    per = stats["strata"]
    if stats["iterations"] - stats["climbs"] != g.t_max * len(ks):
        raise AssertionError("every (k, ts) must end on a passing probe")
    E = int(ct._pair_csr(g).src.shape[0])
    print(f"[construct] n={g.n} m={g.m} t_max={g.t_max} E={E} slots "
          f"|K|={len(ks)} (k={ks[0]}..{ks[-1]}): {same}/{len(ks)} card-built "
          f"strata array-equal to the host's (every field; tolerance 0: "
          f"integer tables); card build {t_dev:.2f}s, host fused sweep "
          f"{t_host:.2f}s; stratum_sweep launches {launches} "
          f"(ceil(t_max / {ct.TUV_BLOCK}) = {blocks}; routes {routes}), B2 "
          f"launches {b2_launches} during the build; probes "
          f"{stats['iterations']}, climbs {stats['climbs']} (strata run "
          f"independently)")

    # the build's split: the same steps one at a time
    sp = sweep_split(g, ks, dev)
    if not np.array_equal(sp["counts"], per):
        raise AssertionError("the split run's counts differ from the build's")
    for i, k in enumerate(ks):
        if not np.array_equal(sp["host_rows"][i],
                              strata.table_for(k).vertex_ct):
            raise AssertionError(f"the split run's stratum k={k} differs")
    chain = int(per[:, 0].max())
    bound = sum(ss.sweep_bound_ms(len(ks), hi - lo, E, g.n)
                for lo, hi in sp["blocks"])
    t_parts = (sp["t_csr"] + sp["t_tuv"] + sp["t_up"] + sp["kernel_ms"] / 1e3
               + sp["t_down"] + sp["t_compress"])
    print(f"[construct] build split: pair CSR {sp['t_csr']:.4f}s, _tuv_rows "
          f"{sp['t_tuv']:.4f}s, upload {sp['t_up']:.4f}s, stratum_sweep "
          f"{sp['kernel_ms']:.3f} ms (CUDA events, {len(sp['blocks'])} "
          f"launch(es)), download {sp['t_down']:.4f}s, host _compress + "
          f"stratify {sp['t_compress']:.4f}s; sum {t_parts:.2f}s. Kernel "
          f"bound {bound:.6f} ms (bytes: t_uv block read once, rows written "
          f"once, CSR, ks, carry and counts moved once, at 3.35 TB/s); "
          f"serial chain: the longest stratum's {chain} probes (k="
          f"{ks[int(per[:, 0].argmax())]}), "
          f"{sp['kernel_ms'] * 1e3 / chain:.2f} us per probe; per-stratum "
          f"probes {int(per[:, 0].min())}..{chain}, climbs "
          f"{int(per[:, 1].min())}..{int(per[:, 1].max())}")

    # the whole card build under the profiler: the device's idle share
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_prof = wall(lambda: ct.stratified_core_times(
            g, ks, engine="device", device=dev))
    rows = device_rows(prof)
    busy_us = sum(t for _, t, _ in rows)
    sweep_us = sum(t for key, t, _ in rows if "stratum_sweep" in key)
    print(f"[construct] card build under torch.profiler: wall {t_prof:.2f}s; "
          + (f"device busy {busy_us / 1e6:.4f}s (idle share "
             f"{1 - busy_us / 1e6 / t_prof:.4f}), stratum_sweep "
             f"{sweep_us / 1e3:.3f} ms; top kernels: " + top_rows(rows)
             if busy_us else "device busy not measured (no device events)"))
    del prof

    # the kernel against its plain version on the card, the same operands:
    # stratum k0 alone (the old path's cost: a host loop of small launches
    # and a flag read per probe), then every stratum
    tuv, seg, vptr, dst = sp["ops"]
    if len(sp["blocks"]) != 1:
        raise AssertionError("the plain comparison sweeps one t_uv block")
    k0 = ks[0]
    kt0 = torch.tensor([k0], dtype=torch.int32, device=dev)
    c_p = torch.zeros((1, g.n), dtype=torch.int32, device=dev)
    out_p = torch.empty((1, g.t_max, g.n), dtype=torch.int32, device=dev)
    st_p, t_plain0 = wall(lambda: ref.stratum_sweep(tuv, seg, vptr, dst, kt0,
                                                    c_p, inf, out_p))
    c_k = torch.zeros_like(c_p)
    (out_k, st_k), t_kern0 = wall(lambda: ss.stratum_sweep(
        tuv, seg, vptr, dst, kt0, c_k, inf))
    err = max(check_equal(f"stratum k={k0} rows", out_k, out_p),
              check_equal(f"stratum k={k0} carry", c_k, c_p),
              check_equal(f"stratum k={k0} counts", st_k, st_p),
              check_equal(f"stratum k={k0} rows vs the build", out_k[0],
                          sp["rows"][0, 1:]))
    if not np.array_equal(st_k.cpu().numpy()[0], per[0]):
        raise AssertionError(f"stratum k={k0}'s counts differ from the "
                             "build's")
    kt = torch.as_tensor(np.asarray(ks, np.int32), device=dev)
    c_all = torch.zeros((len(ks), g.n), dtype=torch.int32, device=dev)
    out_all = torch.empty((len(ks), g.t_max, g.n), dtype=torch.int32,
                          device=dev)
    st_all, t_plain = wall(lambda: ref.stratum_sweep(
        tuv, seg, vptr, dst, kt, c_all, inf, out_all))
    err = max(err, check_equal("every stratum's rows", sp["rows"][:, 1:],
                               out_all))
    if not np.array_equal(st_all.cpu().numpy(), per):
        raise AssertionError("the plain version's counts differ from the "
                             "kernel's")
    carry = torch.zeros_like(c_all)

    def launch():
        carry.zero_()
        ss.stratum_sweep(tuv, seg, vptr, dst, kt, carry, inf)

    ms = cuda_ms(launch, iters=5, warmup=1)
    print(f"[construct] stratum_sweep against ref.stratum_sweep on the card, "
          f"same operands (R={g.t_max}, E={E}, n={g.n}): stratum k={k0} alone "
          f"rows, carry and counts {st_k.tolist()[0]} equal (tolerance 0), "
          f"kernel {t_kern0 * 1e3:.3f} ms wall, plain {t_plain0:.3f}s wall "
          f"(the old path's cost: a host loop, a flag read per probe); all "
          f"{len(ks)} strata equal, kernel {ms:.3f} ms per launch (CUDA "
          f"events, 5 launches), plain {t_plain:.3f}s wall; bound "
          f"{bound:.6f} ms; library: none (no PyTorch call computes the "
          f"sweep)")
    record = {"name": "stratum_sweep", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/stratum_sweep.cu",
              "replaces": "src/repro/kernels/segmented_select.py:117, "
                          "src/repro/core/core_time.py:346",
              "launches": launches, "max_abs_err": err, "ms": ms,
              "plain_ms": t_plain * 1e3, "bound_ms": bound,
              "bound_by": "bytes", "library_ms": None}
    return g, ks, strata, t_dev, t_host, b2_launches, record


def distinct_pairs(g, dev):
    """The graph's distinct pairs (min, max) as int32 on the card, sorted,
    and the index of each edge's pair: (us, ud, inv)."""
    from repro_torch.core import kcore

    us, ud, inv = kcore.distinct_pairs(g.src, g.dst, g.n)
    return (torch.as_tensor(us.astype(np.int32), device=dev),
            torch.as_tensor(ud.astype(np.int32), device=dev), inv)


def device_times(calls, sleep_ms: float):
    """Device ms of each of ``calls`` (functions of no argument) by CUDA
    events between them, the card asleep for ``sleep_ms`` + 10 ms first so
    that the host enqueues ahead of it; run again, three times at most,
    while the host fell behind all the same (the first event had
    completed by the time the last call was enqueued). Returns (ms per
    call, whether the host stayed ahead, the calls' results)."""
    for _ in range(3):
        evs = [torch.cuda.Event(enable_timing=True)
               for _ in range(len(calls) + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(int((sleep_ms + 10.0) * 2e6))  # ~2 GHz cycles
        evs[0].record()
        outs = []
        for call, ev in zip(calls, evs[1:]):
            outs.append(call())
            ev.record()
        ahead = not evs[0].query()
        torch.cuda.synchronize()
        if ahead:
            break
    return ([a.elapsed_time(b) for a, b in zip(evs, evs[1:])], ahead,
            outs)


def old_fixpoint(us, ud, n: int, k: int):
    """The peel as it ran before the fixpoint kernel: B3a then B3b per
    round, one read of the change flag per round. (mask, rounds)."""
    from repro_torch.kernels import kcore_peel

    alive = torch.ones(us.shape[0], dtype=torch.bool, device=us.device)
    changed = torch.zeros(1, dtype=torch.int32, device=us.device)
    rounds = 0
    while True:
        changed.zero_()
        new = kcore_peel.peel_round(us, ud, alive, n, k, changed=changed)
        rounds += 1
        if not int(changed.item()):
            return new, rounds
        alive = new


def peel_graph(label: str, g, us, ud, inv, peel_ks, host_ks) -> dict:
    """``[peel]`` on one graph: ``ops.kcore_fixpoint`` over its distinct
    pairs for every k of ``peel_ks`` (the main path, counted: one launch
    per fixpoint, no B3a/B3b launch); every mask and round count against
    the plain version on the card, in the counted run and in the timed
    one, the ks of ``host_ks`` against the host's k-core; the wall of all
    fixpoints, the device time of each by CUDA events, the serial chain
    and the bound; the old path (B3a + B3b and a flag read per round) on
    the same operands."""
    from repro_torch.core import kcore
    from repro_torch.kernels import kcore_peel, ref
    from repro_torch.kernels import ops as kernel_ops

    dev, n, m, F = us.device, g.n, int(us.shape[0]), len(peel_ks)
    rounds = torch.zeros(F, dtype=torch.int32, device=dev)
    # one call outside the counted run: the kernel's module loads at its
    # first launch
    kcore_peel.kcore_fixpoint(us, ud, n, peel_ks[0])
    torch.cuda.synchronize()
    kcore_peel.kcore_fixpoint.launches = 0
    kcore_peel.degree_count.launches = 0
    kcore_peel.peel_threshold.launches = 0
    masks, t_peel = wall(lambda: [
        kernel_ops.kcore_fixpoint(us, ud, n, k, rounds=rounds[i:i + 1])
        for i, k in enumerate(peel_ks)])
    launches = kcore_peel.kcore_fixpoint.launches
    b3 = (kcore_peel.degree_count.launches,
          kcore_peel.peel_threshold.launches)
    if launches <= 0:
        raise AssertionError(f"the {label} peel launched kcore_fixpoint no "
                             "time")
    if launches != F:
        raise AssertionError(f"the {label} peel made {launches} kcore_fixpoint"
                             f" launches, expected {F}, one per fixpoint")
    if b3 != (0, 0):
        raise AssertionError(f"B3a/B3b launched {b3} times during the "
                             f"{label} peel (they are off the fixpoint path)")

    # every mask and round count against the plain version on the card
    plain_rounds = torch.zeros_like(rounds)
    plain, t_plain = wall(lambda: [
        ref.kcore_fixpoint(us, ud, n, k, rounds=plain_rounds[i:i + 1])
        for i, k in enumerate(peel_ks)])
    err = max(check_equal(f"{label} {k}-core", a, b)
              for k, a, b in zip(peel_ks, masks, plain))
    err = max(err, check_equal(f"{label} rounds", rounds, plain_rounds))
    per = rounds.cpu().tolist()

    # the old path on the same operands
    old, t_old = wall(lambda: [old_fixpoint(us, ud, n, k) for k in peel_ks])
    for k, a, (b, r_old), r in zip(peel_ks, masks, old, per):
        check_equal(f"{label} {k}-core by the old path", b, a)
        if r_old != r:
            raise AssertionError(f"{label} k={k}: the old path ran {r_old} "
                                 f"rounds, the kernel {r}")

    # the listed ks against the host's k-core
    t0 = time.perf_counter()
    for k in host_ks:
        want = kcore.distinct_kcore_edge_mask(g.src, g.dst, n, k)
        if not np.array_equal(masks[peel_ks.index(k)].cpu().numpy()[inv],
                              want):
            raise AssertionError(f"the card's {label} {k}-core differs from "
                                 "the host's")
    t_host = time.perf_counter() - t0
    sizes = torch.stack(masks).sum(1).cpu().tolist() if m else [0] * F
    if sizes[-1] != 0 or sizes[-2] == 0:
        raise AssertionError(f"{label}: k_max's core must be non-empty, "
                             "k_max + 1's empty")

    # device time of each fixpoint, its masks and rounds held to the
    # counted run's
    timed_rounds = torch.zeros_like(rounds)
    dev_ms, ahead, timed = device_times(
        [functools.partial(kcore_peel.kcore_fixpoint, us, ud, n, k,
                           rounds=timed_rounds[i:i + 1])
         for i, k in enumerate(peel_ks)], 2 * t_peel * 1e3)
    for k, a, b in zip(peel_ks, timed, masks):
        check_equal(f"{label} {k}-core of the timed run", a, b)
    check_equal(f"{label} rounds of the timed run", timed_rounds, rounds)
    host = host_ms(lambda: kcore_peel.kcore_fixpoint(us, ud, n,
                                                     peel_ks[F // 2]))
    longest = int(np.argmax(per))
    bound = kcore_peel.fixpoint_bound_ms(m)
    print(f"[peel] {label}: ops.kcore_fixpoint on the card over {m} distinct "
          f"pairs (n={n}) for k={peel_ks[0]}..{peel_ks[-1]} ({F} fixpoints):"
          f" kcore_fixpoint launches {launches} (one per fixpoint, "
          f"{kcore_peel.grid_blocks(m, n)} co-resident blocks of 1,024 "
          f"threads), B3a launches {b3[0]}, B3b {b3[1]}; every mask "
          f"bit-equal to ref.kcore_fixpoint on the card and every round "
          f"count equal, in the counted and the timed run (max abs err "
          f"{err}, tolerance 0: bool masks and integer counts), {sum(per)} "
          f"rounds; k in {list(host_ks)} equal to "
          f"kcore.distinct_kcore_edge_mask on the host ({t_host:.3f}s); "
          f"core sizes (pairs) {sizes[0]}..{sizes[-2]}, then {sizes[-1]}")
    print(f"[peel] {label}: wall of all {F} fixpoints {t_peel:.6f}s "
          f"({t_peel / F * 1e3:.6f} ms each, host and card); device time by "
          f"CUDA events {sum(dev_ms):.6f} ms ("
          f"{'host ahead' if ahead else 'the host fell behind: back to back'}"
          f"), {sum(dev_ms) / F:.6f} ms per fixpoint (min "
          f"{min(dev_ms):.6f}, max {max(dev_ms):.6f}); host {host:.6f} ms per "
          f"call; serial chain: the longest fixpoint's {per[longest]} rounds "
          f"(k={peel_ks[longest]}) in {dev_ms[longest]:.6f} ms, "
          f"{dev_ms[longest] * 1e3 / per[longest]:.3f} us per round; bound "
          f"{bound:.6f} ms per fixpoint (bytes: 9*m + 4 at 3.35 TB/s), "
          f"{bound * F:.6f} ms in all, {bound * F / sum(dev_ms):.6f} of the "
          f"device time. The old path on the same operands (B3a + B3b per "
          f"round, one flag read each; {sum(r for _, r in old)} rounds, masks "
          f"equal): {t_old:.6f}s wall, {t_old / t_peel:.1f}x the kernel's; "
          f"the plain version on the card {t_plain:.6f}s wall; library: none "
          f"(no PyTorch call computes a k-core fixpoint)")
    return dict(launches=launches, b3=b3, err=err, ms=sum(dev_ms) / F,
                plain_ms=t_plain / F * 1e3, bound_ms=bound)


def peel_phase(g, us, ud, inv, ks) -> tuple[dict, tuple[int, int]]:
    """``[peel]`` on the CollegeMsg-scale graph (``ks``: every k of the
    index and k_max + 1, each also against the host) and on an
    sx-superuser-scale graph (k = 2..k_max + 1; SX_HOST_KS against the
    host). Returns the kcore_fixpoint record (launches over both graphs,
    times and bound from the CollegeMsg run, per fixpoint) and the B3a
    and B3b launches of both peels."""
    from repro_torch.core import kcore
    from repro_torch.core.temporal_graph import gen_temporal_graph

    cm = peel_graph("CollegeMsg", g, us, ud, inv, ks, ks)
    t0 = time.perf_counter()
    sx = gen_temporal_graph(**SX_SUPERUSER)
    sx_us, sx_ud, sx_inv = distinct_pairs(sx, us.device)
    sx_kmax = kcore.k_max(sx)
    print(f"[peel] sx-superuser scale: n={sx.n} m={sx.m} t_max={sx.t_max}, "
          f"{int(sx_us.shape[0])} distinct pairs, k_max {sx_kmax} on the "
          f"host, made in {time.perf_counter() - t0:.2f}s")
    sx_ks = list(range(2, sx_kmax + 2))
    host_ks = sorted({max(2, int(f * sx_kmax)) for f in SX_HOST_KS}
                     | {sx_kmax + 1})
    sxr = peel_graph("sx-superuser", sx, sx_us, sx_ud, sx_inv, sx_ks,
                     host_ks)
    return {"name": "kcore_fixpoint", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kcore_fixpoint.cu",
            "replaces": "src/repro/kernels/kcore_peel.py:62, :117 (iterated "
                        "by src/repro/kernels/ref.py:33)",
            "launches": cm["launches"] + sxr["launches"],
            "max_abs_err": max(cm["err"], sxr["err"]), "ms": cm["ms"],
            "plain_ms": cm["plain_ms"], "bound_ms": cm["bound_ms"],
            "bound_by": "bytes", "library_ms": None}, tuple(
                a + b for a, b in zip(cm["b3"], sxr["b3"]))


#: [baselines]: the shares of k_max bench_paper.py's bench_vary_k sweeps
#: around the default k (benchmarks/common.py default_k: 0.7), its query
#: count, and the queries also held to the brute-force oracle on the card
BASELINE_FRACS = (0.5, 0.7, 0.9)
BASELINE_QUERIES = 1000
BASELINE_ORACLE = 64
#: the reference package's counts on the COLLEGEMSG graph per k (its
#: core_time, pecb_index, ctmsf_index and ef_index): versions, PECB,
#: CT-MSF and EF bytes, EF chain forests, distinct cores and enumerated
#: core edges; the port must reproduce them exactly
BASELINE_COUNTS = {
    19: (595532, 784468, 349896, 2852600, 158, 12459, 206178150),
    27: (669785, 406768, 179944, 1776640, 104, 5628, 117414963),
    34: (455461, 144532, 62044, 715640, 43, 1058, 27749364)}


def kmax_probes(km: int) -> int:
    """Fixpoints ``kcore.k_max`` runs to find ``km``: the doubling's
    probes (the last one empty), then the bisection's."""
    probes, lo, hi = 0, 1, 1
    while hi <= km:
        probes += 1
        lo, hi = hi, hi * 2
    probes += 1
    while lo + 1 < hi:
        probes += 1
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if mid <= km else (lo, mid)
    return probes


def boruvka_check(g, tab, ef, dev) -> dict:
    """Borůvka on the card (torch ops) at every start time with active
    versions, each mask array-equal to the host's Kruskal and to the
    forest EF stores for that start time."""
    from repro_torch.core import ctmsf
    from repro_torch.core.ecb_forest import active_versions

    stats: dict = {}
    t_card = t_host = 0.0
    edges = 0
    for ts in range(1, g.t_max + 1):
        e_ids, cts = active_versions(tab, ts)
        if not e_ids.size:
            continue
        u, v = g.src[e_ids], g.dst[e_ids]
        ops_ = [torch.as_tensor(a, device=dev) for a in (u, v, cts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ctmsf.boruvka_msf(*ops_, g.n, stats=stats).cpu().numpy()
        t_card += time.perf_counter() - t0
        want, t = wall(lambda: ctmsf.kruskal_msf(u, v, cts, g.n))
        t_host += t
        if not np.array_equal(got, want):
            raise AssertionError(f"Borůvka on the card differs from Kruskal "
                                 f"at ts={ts}")
        f = ef.forests[int(ef.ts_to_forest[ts])]
        if not (np.array_equal(f.node_u, u[got]) and np.array_equal(
                f.node_v, v[got]) and np.array_equal(f.node_ct, cts[got])):
            raise AssertionError(f"Borůvka's forest differs from EF's at "
                                 f"ts={ts}")
        edges += int(got.sum())
    r = stats["rounds"]
    return dict(checked=len(r), rounds=r, card_s=t_card, host_s=t_host,
                edges=edges)


def baselines_phase(g, dev, smi: str) -> tuple[int, int, int]:
    """``[baselines]``: the paper's comparison (Figures 4-6) at CollegeMsg
    scale through the port's entry points. k_max on the card (one
    kcore_fixpoint launch per probe) equal to numpy's; at 0.5, 0.7 and 0.9
    of it the core-time table on the card (equal to the host engine's) and
    PECB, CT-MSF and EF built from it, each one's bytes and build seconds,
    EF's forests, distinct cores and enumerated core edges, all equal to
    BASELINE_COUNTS; at the default k Borůvka on the card against Kruskal
    at every start time; 1,000 random_queries at each k through the three
    host answerers and the PECB's device batch on B1, all equal, 64 of
    them against the oracle on the card (one fixpoint launch per window
    and oracle) and every answer mode of EF and CT-MSF. Returns the
    phase's (kcore_fixpoint, B1, stratum_sweep) launches."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core import kcore
    from repro_torch.core.ctmsf_index import CTMSFIndex
    from repro_torch.core.ef_index import EFIndex
    from repro_torch.core.pecb_index import build_pecb_index
    from repro_torch.core.query_api import ResultMode, TCCSQuery
    from repro_torch.core.temporal_graph import random_queries
    from repro_torch.kernels import kcore_peel, label_prop
    from repro_torch.kernels import segmented_select as ss

    tag = f"({smi})"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    kcore_peel.kcore_fixpoint.launches = 0
    label_prop.label_prop_round.launches = 0
    ss.reset_sweep_counts()

    km, t_km = wall(lambda: kcore.k_max(g, device=dev))
    probes = kcore_peel.kcore_fixpoint.launches
    km_np, t_km_np = wall(lambda: kcore.k_max(g))
    if km != km_np:
        raise AssertionError(f"k_max on the card {km} != numpy's {km_np}")
    if probes != kmax_probes(km):
        raise AssertionError(f"k_max made {probes} kcore_fixpoint launches, "
                             f"expected {kmax_probes(km)} (one per probe)")
    ks = [max(2, int(round(f * km))) for f in BASELINE_FRACS]
    k_def = ks[BASELINE_FRACS.index(0.7)]
    print(f"[baselines] {tag} k_max {km} on the card (equal to numpy's "
          f"{km_np}): kcore_fixpoint launches {probes} (one per probe of "
          f"the doubling and the bisection, one upload), {t_km:.4f}s, numpy "
          f"{t_km_np:.4f}s; default k max(2, round(0.7 * k_max)) = {k_def}; "
          f"ks {ks} (0.5, 0.7, 0.9 of k_max)")

    built = {}
    for k in ks:
        tab, t_tab = wall(lambda: ct.edge_core_times(g, k, device=dev))
        host_tab, t_tab_host = wall(lambda: ct.edge_core_times(
            g, k, device="cpu"))
        for f in ("edge_id", "ts_from", "ts_to", "ct", "vertex_ct"):
            if not np.array_equal(getattr(tab, f), getattr(host_tab, f)):
                raise AssertionError(f"k={k}: the card's core-time table "
                                     f"differs from the host's in {f}")
        pecb, t_pecb = wall(lambda: build_pecb_index(g, k, tab))
        cm, t_cm = wall(lambda: CTMSFIndex(g, k, tab))
        ef, t_ef = wall(lambda: EFIndex(g, k, tab))
        counts = (tab.num_versions, pecb.nbytes(), cm.nbytes(), ef.nbytes(),
                  len(ef.forests), ef.num_distinct_cores,
                  ef.enumerated_core_edges)
        if counts != BASELINE_COUNTS.get(k):
            raise AssertionError(f"k={k}: counts {counts} differ from the "
                                 f"reference's {BASELINE_COUNTS.get(k)}")
        built[k] = tab, pecb, cm, ef
        print(f"[baselines] {tag} k={k}: core-time table on the card "
              f"{t_tab:.4f}s (host engine {t_tab_host:.4f}s, every field "
              f"equal), {counts[0]} versions. Bytes (Figure 4): PECB "
              f"{counts[1]}, CT-MSF {counts[2]}, EF {counts[3]} (EF / PECB "
              f"{counts[3] / counts[1]:.3f}, CT-MSF / PECB "
              f"{counts[2] / counts[1]:.3f}). Build s from the table (Figure "
              f"5, host): PECB {t_pecb:.4f}, CT-MSF {t_cm:.4f}, EF "
              f"{t_ef:.4f} (EF / PECB {t_ef / t_pecb:.2f}x); EF "
              f"{counts[4]} chain forests, {counts[5]} distinct cores, "
              f"{counts[6]} enumerated core edges; all equal to the "
              f"reference's counts")

    tab, pecb, cm, ef = built[k_def]
    bo = boruvka_check(g, tab, ef, dev)
    r = bo["rounds"]
    print(f"[baselines] {tag} Borůvka at k={k_def} on the card (torch "
          f"ops): {bo['checked']} start times with active versions, every "
          f"mask array-equal to Kruskal on the host and to EF's stored "
          f"forest ({bo['edges']} forest edges in all); rounds "
          f"{min(r)}..{max(r)}, {sum(r)} in all; card "
          f"{bo['card_s'] / bo['checked'] * 1e3:.3f} ms per start time "
          f"(upload, rounds with one flag read each, download), host "
          f"Kruskal {bo['host_s'] / bo['checked'] * 1e3:.3f} ms")

    qs = random_queries(g, BASELINE_QUERIES)
    modes = (ResultMode.VERTICES, ResultMode.EDGES, ResultMode.SUBGRAPH,
             ResultMode.COUNT)
    oracle_fix = 0
    for k in ks:
        tab, pecb, cm, ef = built[k]
        answers, us_q = {}, {}
        for name, idx in (("PECB", pecb), ("CT-MSF", cm), ("EF", ef)):
            answers[name], t = wall(lambda: [
                idx._component_vertices(u, ts, te) for (u, ts, te) in qs])
            us_q[name] = t / len(qs) * 1e6
        dix = bq.to_device(pecb, dev)
        b0 = label_prop.label_prop_round.launches
        stats: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = []
        for i in range(0, len(qs), BUCKET):
            cols = bq._query_columns(qs[i:i + BUCKET], (0, 1, 2), dev)
            mask = bq.batch_query(dix, *cols, stats=stats).cpu().numpy()
            got += [set(np.flatnonzero(row).tolist()) for row in mask]
        t_b1 = time.perf_counter() - t0
        b1 = label_prop.label_prop_round.launches - b0
        if b1 <= 0 or b1 != sum(stats["rounds"]):
            raise AssertionError(f"k={k}: B1 launches {b1} != rounds "
                                 f"{stats['rounds']}")
        answers["PECB on B1"] = got
        bad = sum(len({frozenset(a[i]) for a in answers.values()}) != 1
                  for i in range(len(qs)))
        if bad:
            raise AssertionError(f"k={k}: the four answerers disagree on "
                                 f"{bad} of {len(qs)} queries")
        f0 = kcore_peel.kcore_fixpoint.launches
        windows = 0
        for i, (u, ts, te) in enumerate(qs[:BASELINE_ORACLE]):
            want_v = frozenset(kcore.tccs_oracle(g, k, u, ts, te,
                                                 device=dev))
            want_e = frozenset(kcore.tccs_oracle_edges(g, k, u, ts, te,
                                                       device=dev))
            windows += 2 * int(g.project(ts, te)[0].size > 0)
            if frozenset(answers["PECB"][i]) != want_v:
                raise AssertionError(f"k={k}: query {i} differs from the "
                                     "oracle on the card")
            for idx in (cm, ef):
                res = {md: idx.answer(TCCSQuery(u, ts, te, k, md))
                       for md in modes}
                e_ids = res[ResultMode.EDGES].edges.edge_ids()
                if not (res[ResultMode.VERTICES].vertices == want_v
                        and res[ResultMode.EDGES].vertices == want_v
                        and e_ids == want_e
                        and res[ResultMode.SUBGRAPH].subgraph.m == len(want_e)
                        and res[ResultMode.COUNT].num_vertices == len(want_v)):
                    raise AssertionError(f"k={k}: {idx.backend_name}'s "
                                         f"answer modes differ from the "
                                         f"oracle on query {i}")
        fix = kcore_peel.kcore_fixpoint.launches - f0
        if fix != windows or fix <= 0:
            raise AssertionError(f"k={k}: the oracle made {fix} "
                                 f"kcore_fixpoint launches, expected "
                                 f"{windows} (one per window with edges)")
        oracle_fix += fix
        sizes = [len(a) for a in answers["EF"]]
        print(f"[baselines] {tag} k={k}: {len(qs)} random_queries, PECB, "
              f"CT-MSF, EF and the PECB's device batch on B1 agree on all "
              f"(0 mismatches; {sum(1 for s in sizes if s)} non-empty, "
              f"largest {max(sizes)} vertices). Host us per query (Figure "
              f"6): PECB {us_q['PECB']:.2f}, CT-MSF {us_q['CT-MSF']:.2f}, "
              f"EF {us_q['EF']:.2f}. B1 batches of {BUCKET}: "
              f"{len(qs) / t_b1:.1f} q/s ({t_b1:.4f}s with uploads and "
              f"downloads), B1 launches {b1} = rounds {stats['rounds']}. "
              f"{BASELINE_ORACLE} held to tccs_oracle and tccs_oracle_edges "
              f"on the card (kcore_fixpoint launches {fix}, one per window "
              f"and oracle) and to EF's and CT-MSF's VERTICES, EDGES, "
              f"SUBGRAPH and COUNT answers: 0 mismatches")

    fix = kcore_peel.kcore_fixpoint.launches
    if fix != probes + oracle_fix:
        raise AssertionError(f"kcore_fixpoint launches {fix} != the phase's "
                             f"fixpoints {probes + oracle_fix}")
    b1 = label_prop.label_prop_round.launches
    sweeps = ss.stratum_sweep.launches
    if sweeps != len(ks) * -(-g.t_max // ct.TUV_BLOCK):
        raise AssertionError(f"stratum_sweep launches {sweeps}, expected one "
                             f"per t_uv block of each table")
    print(f"[baselines] {tag} phase: {time.perf_counter() - t_phase:.2f}s, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"kcore_fixpoint launches {fix} (= fixpoints run: {probes} k_max "
          f"probes + {oracle_fix} oracle windows), B1 launches {b1}, "
          f"stratum_sweep launches {sweeps} (the {len(ks)} tables)")
    return fix, b1, sweeps


#: the [epoch] phase's ingest split and trim cut, from the reference's
#: benchmarks: bench_streaming.py's frac = 0.98 (epoch 0 ends on day
#: int(193 * 0.98) = 189; the days 190..193 follow as one epoch each) and
#: bench_retention.py's frac = 0.5 (t_cut = 96)
EPOCH_FRAC = 0.98
TRIM_FRAC = 0.5
#: queries of each served batch held to Algorithm 1 (kcore.tccs_oracle)
EPOCH_VERIFY = 32
#: the host engine (the reference's frontier fixpoint), timed on the last
#: daily epoch for comparison, starts no stratum after this many seconds
HOST_EXTEND_CAP_S = 30.0


@contextlib.contextmanager
def epoch_stages(times: dict):
    """Time the steps of the epoch-plane entry point called inside the
    block, summed over calls into ``times``: ``sweep_s`` (the wall of
    core_time's ``_sweep_device_stratified``: pair CSR, t_uv rows,
    uploads, launches and download), ``kernel_ms`` (CUDA events around
    each stratum_sweep launch), ``download_s`` (from the synchronize after
    the last launch to the rows on the host), ``launches`` (the wrapper's
    own count), ``rows_s`` (the host engine's rows,
    ``_extend_rows_host``), ``expand_s`` (``StratifiedCoreTable.table_for``:
    a stratum's dense rows re-expanded from its runs), ``records_s``
    (``_compress`` or the interval recompress ``_extend_records``),
    ``stratify_s`` (``StratifiedCoreTable.from_tables``) and ``layout_s``
    (``batch_query._host_layout``)."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.kernels import segmented_select as ss

    sweep_fn, kernel_fn = ct._sweep_device_stratified, ct.stratum_sweep
    events, synced = [], []
    for key in ("sweep_s", "kernel_ms", "download_s", "launches", "rows_s",
                "expand_s", "records_s", "stratify_s", "layout_s"):
        times.setdefault(key, 0)
    before = ss.stratum_sweep.launches

    def timed(key, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times[key] += time.perf_counter() - t0
            return out
        return call

    def kernel(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = kernel_fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        events.append((start, end))
        synced.append(time.perf_counter())
        return out

    def sweep(*args, **kw):
        t0 = time.perf_counter()
        out = sweep_fn(*args, **kw)
        t1 = time.perf_counter()
        times["sweep_s"] += t1 - t0
        if synced:
            times["download_s"] += t1 - synced[-1]
            synced.clear()
        return out

    table = ct.StratifiedCoreTable
    with contextlib.ExitStack() as stack:
        for owner, name, fn in (
                (ct, "_sweep_device_stratified", sweep),
                (ct, "stratum_sweep", kernel),
                (ct, "_extend_rows_host", timed("rows_s",
                                                ct._extend_rows_host)),
                (ct, "_compress", timed("records_s", ct._compress)),
                (ct, "_extend_records", timed("records_s",
                                              ct._extend_records)),
                (table, "table_for", timed("expand_s", table.table_for)),
                (table, "from_tables", staticmethod(
                    timed("stratify_s", table.from_tables))),
                (bq, "_host_layout", timed("layout_s", bq._host_layout))):
            stack.enter_context(mock.patch.object(owner, name, fn))
        yield times
    times["kernel_ms"] += sum(s.elapsed_time(e) for s, e in events)
    times["launches"] += ss.stratum_sweep.launches - before


def staged(fn):
    """``(result, seconds, step times)`` of ``fn`` under
    :func:`epoch_stages`, the card synchronised after it."""
    times: dict = {}
    with epoch_stages(times):
        out, t = wall(fn)
    return out, t, times


def cold_build(g, dev):
    """A cold card build of ``g``'s k-stratified index through the entry
    points, its stages timed: ``(strata, sx, dix, stages)``."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core.pecb_index import build_stratified_index

    strata, t_core, core = staged(lambda: ct.stratified_core_times(
        g, engine="device", device=dev))
    sx, t_forest, forest = staged(lambda: build_stratified_index(
        g, strata=strata, device=dev))
    dix, t_up, up = staged(lambda: bq.to_device(sx, dev))
    return strata, sx, dix, dict(core=(t_core, core),
                                 forest=(t_forest, forest), up=(t_up, up))


def core_line(t_core: float, t: dict) -> str:
    """The core-time stage: the card sweep and the host steps after it."""
    line = (f"core times {t_core:.4f}s = sweep {t['sweep_s']:.4f}s "
            f"(stratum_sweep {t['kernel_ms']:.3f} ms by CUDA events, "
            f"{t['launches']} launch(es); download {t['download_s']:.4f}s)"
            f" + {'re' if t['expand_s'] else ''}compress + stratify "
            f"{t_core - t['sweep_s']:.4f}s")
    parts = [f"re-expand {t['expand_s']:.4f}s" if t["expand_s"] else "",
             f"{'interval recompress' if t['expand_s'] else 'compress'} "
             f"{t['records_s']:.4f}s",
             f"stratify (from_tables) {t['stratify_s']:.4f}s"]
    return line + f" ({', '.join(p for p in parts if p)})"


def refresh_line(t_ref: float, t: dict, rs: dict) -> str:
    return (f"refresh {t_ref:.4f}s (host layouts {t['layout_s']:.4f}s; "
            f"reused {rs['reused']}, suffix {rs['suffix']}, full "
            f"{rs['full']} arrays; reused {rs['reused_bytes'] / 1e6:.1f} MB, "
            f"uploaded {rs['uploaded_bytes'] / 1e6:.1f} MB, freed "
            f"{rs['freed_bytes'] / 1e6:.1f} MB)")


def cold_line(c: dict) -> str:
    (t_core, core), (t_forest, forest), (t_up, up) = (c["core"],
                                                      c["forest"], c["up"])
    return (f"{core_line(t_core, core)}, forest build {t_forest:.4f}s "
            f"(re-expand {forest['expand_s']:.4f}s), upload {t_up:.4f}s "
            f"(host layout {up['layout_s']:.4f}s); total "
            f"{t_core + t_forest + t_up:.4f}s")


def assert_index_equal(got, want, what: str) -> int:
    """Raise unless two indexes (or tables) are equal in every dataclass
    field, arrays by dtype and value (tolerance 0); returns the number of
    fields compared."""
    n = 0
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(b):
            n += assert_index_equal(a, b, f"{what}.{f.name}")
            continue
        same = (a.dtype == b.dtype and np.array_equal(a, b)
                if isinstance(b, np.ndarray) else a == b)
        if not same:
            raise AssertionError(f"{what}: field {f.name} differs")
        n += 1
    return n


def assert_mirror_equal(got, want, what: str) -> int:
    """Raise unless two device mirrors are equal array for array (dtype,
    device, values) and in every meta field; returns the arrays compared."""
    from repro_torch.core import batch_query as bq

    for f in bq._ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype != b.dtype or a.device != b.device or not torch.equal(a,
                                                                         b):
            raise AssertionError(f"{what}: mirror array {f} differs from "
                                 "a fresh upload's")
    for f in bq._META_FIELDS:
        if getattr(got, f) != getattr(want, f):
            raise AssertionError(f"{what}: mirror meta {f} differs")
    return len(bq._ARRAY_FIELDS)


def epoch_batch(g, sx, dix, dev, rng) -> dict:
    """One batch of BUCKET mixed-k vertex queries through
    ``batch_query_full_mixed`` on B1, every fourth window ending on the
    newest day; the first EPOCH_VERIFY held to Algorithm 1
    (``kcore.tccs_oracle``). Returns q/s, B1 launches, rounds, answers."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import kcore
    from repro_torch.kernels import label_prop

    u = rng.integers(0, g.n, BUCKET)
    k = rng.choice(np.asarray(sx.supported_ks), BUCKET)
    ts = rng.integers(1, g.t_max + 1, BUCKET)
    te = rng.integers(ts, g.t_max + 1)
    te[::4] = g.t_max
    slot = bq.mixed_slots(sx, list(zip(u.tolist(), k.tolist())))
    cols = [torch.as_tensor(np.asarray(a, np.int32), device=dev)
            for a in (slot, ts, te, k)]
    before = label_prop.label_prop_round.launches
    stats: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vmask, _ = bq.batch_query_full_mixed(dix, *cols, stats=stats)
    masks = vmask.cpu().numpy()
    t_batch = time.perf_counter() - t0
    launches = label_prop.label_prop_round.launches - before
    if launches <= 0 or launches != sum(stats["rounds"]):
        raise AssertionError(f"the batch made {launches} B1 launches for "
                             f"{stats['rounds']} rounds")
    bad = [i for i in range(EPOCH_VERIFY)
           if set(np.flatnonzero(masks[i]).tolist()) != kcore.tccs_oracle(
               g, int(k[i]), int(u[i]), int(ts[i]), int(te[i]))]
    if bad:
        raise AssertionError(f"{len(bad)} of {EPOCH_VERIFY} answers differ "
                             f"from Algorithm 1 (queries {bad[:5]})")
    newest = masks[te == g.t_max].any(axis=1)
    return dict(qps=BUCKET / t_batch, t=t_batch, launches=launches,
                rounds=stats["rounds"][0], newest=int(newest.size),
                newest_nonempty=int(newest.sum()),
                nonempty=int(masks.any(axis=1).sum()))


def batch_line(b: dict) -> str:
    return (f"batch of {BUCKET} mixed-k queries: "
            f"{b['qps']:.1f} q/s ({b['t']:.4f}s), B1 launches "
            f"{b['launches']} ({b['rounds']} rounds), {b['nonempty']} "
            f"non-empty answers, {b['newest']} windows end on the newest day "
            f"({b['newest_nonempty']} non-empty); {EPOCH_VERIFY} checked "
            f"against Algorithm 1, 0 mismatches")


def host_extend(g1, prev, want, cap: float) -> tuple[list, float, dict]:
    """The host engine (the reference's suffix sweep and frontier
    fixpoint) on one epoch, stratum by stratum in ascending k until
    ``cap`` seconds have passed; each stratum equal to ``want``'s (the
    device engine's). Returns the strata covered, the seconds and the
    step times (:func:`epoch_stages`)."""
    from repro_torch.core import core_time as ct

    done, times = [], {}
    t0 = time.perf_counter()
    with epoch_stages(times):
        for k in want.ks:
            if k not in prev.ks or time.perf_counter() - t0 > cap:
                continue
            got = ct.extend_core_times(g1, k, prev.table_for(k),
                                       engine="host")
            assert_index_equal(got, want.table_for(k), f"host engine k={k}")
            done.append(k)
    return done, time.perf_counter() - t0, times


def epoch_phase(g, sx, dix, dev) -> tuple[int, int]:
    """``[epoch]``: the epoch planes at CollegeMsg scale, driven through
    the entry points a user calls. Epoch 0 is ``g.split_at(189)``, built
    cold on the card; each of the days 190..193 is one suffix epoch
    (``extend``, ``extend_stratified_core_times(engine="device")`` with
    one stratum_sweep launch, ``extend_stratified_index``,
    ``refresh_device``), followed by one served batch on B1; the day-193
    index must equal ``sx`` (the cold build of ``g``) in every field and
    its mirror ``dix`` array for array. Then one trim
    (``expire_before(96)``, the shrinks, ``refresh_device``), equal to a
    cold card build of the trimmed graph, and one more batch. Returns the
    phase's stratum_sweep and B1 launches."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core import streaming as st
    from repro_torch.kernels import label_prop
    from repro_torch.kernels import segmented_select as ss

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(19)
    ss.reset_sweep_counts()
    label_prop.label_prop_round.launches = 0

    t_old = max(1, int(g.t_max * EPOCH_FRAC))
    cur, suffix = g.split_at(t_old)
    tab, sx_cur, dix_cur, cold = cold_build(cur, dev)
    print(f"[epoch] epoch 0 = g.split_at({t_old}): m={cur.m} t_max="
          f"{cur.t_max} |K|={len(sx_cur.ks)} N={sx_cur.num_nodes}; cold card "
          f"build: {cold_line(cold)}; after the upload, "
          + batch_line(epoch_batch(cur, sx_cur, dix_cur, dev, rng)))
    n_cold = cold["core"][1]["launches"]
    sweeps = n_cold
    for day in range(t_old + 1, g.t_max + 1):
        edges = [tuple(e) for e in suffix[suffix[:, 2] == day].tolist()]
        g1 = cur.extend(edges)
        ks = ct.default_ks(g1, device=dev)
        tab1, t_core, core = staged(
            lambda: ct.extend_stratified_core_times(g1, tab, ks,
                                                    engine="device",
                                                    device=dev))
        blocks = -(-g1.t_max // ct.TUV_BLOCK)
        if core["launches"] != blocks:
            raise AssertionError(f"day {day}'s extend made "
                                 f"{core['launches']} stratum_sweep "
                                 f"launches, expected {blocks}")
        sweeps += core["launches"]
        sx1, t_forest, forest = staged(lambda: st.extend_stratified_index(
            g1, sx_cur, ks, strata=tab1, device=dev))
        (dix1, rs), t_ref, ref_t = staged(lambda: bq.refresh_device(
            sx_cur, dix_cur, sx1))
        print(f"[epoch] day {day}: appended {g1.m - cur.m} edges (m "
              f"{cur.m} -> {g1.m}), |K| {len(tab.ks)} -> {len(ks)}, N "
              f"{sx_cur.num_nodes} -> {sx1.num_nodes}; "
              f"{core_line(t_core, core)}, forest extend {t_forest:.4f}s "
              f"(re-expand {forest['expand_s']:.4f}s), "
              f"{refresh_line(t_ref, ref_t, rs)}; epoch "
              f"{t_core + t_forest + t_ref:.4f}s; after the refresh, "
              + batch_line(epoch_batch(g1, sx1, dix1, dev, rng)))
        if day == g.t_max:
            done, t_host, host = host_extend(g1, tab, tab1,
                                             HOST_EXTEND_CAP_S)
            print(f"[epoch] day {day} on the host engine (the reference's "
                  f"suffix sweep and frontier fixpoint), capped at "
                  f"{HOST_EXTEND_CAP_S:.0f}s: {len(done)} of the "
                  f"{len(tab.ks)} strata the epoch extends (k={done[0]}.."
                  f"{done[-1]}) in {t_host:.4f}s, each equal to the device "
                  f"engine's: rows {host['rows_s']:.4f}s "
                  f"({host['rows_s'] / len(done):.4f}s per stratum), "
                  f"re-expand {host['expand_s']:.4f}s, interval recompress "
                  f"{host['records_s']:.4f}s; the device engine's rows (its "
                  f"sweep of all {len(ks)} strata) took "
                  f"{core['sweep_s']:.4f}s"
                  if done else f"[epoch] day {day}: no stratum on the host "
                  "engine within the cap")
        cur, tab, sx_cur, dix_cur = g1, tab1, sx1, dix1
    n_f = assert_index_equal(sx_cur, sx, "the day-193 index")
    n_a = assert_mirror_equal(dix_cur, dix, "the day-193 mirror")
    print(f"[epoch] day {g.t_max}: the extended index equals the cold build "
          f"of g in all {n_f} fields (tolerance 0) and its refreshed mirror "
          f"a fresh upload in all {n_a} arrays")

    t_cut = max(2, int(g.t_max * TRIM_FRAC))
    g2 = cur.expire_before(t_cut)
    ks2 = tuple(k for k in ct.default_ks(g2, device=dev) if k in tab.ks)
    tab2, t_core, core = staged(lambda: ct.shrink_stratified_core_times(
        g2, tab, ks2))
    sx2, t_forest, forest = staged(lambda: st.shrink_stratified_index(
        g2, sx_cur, ks2, strata=tab2, device=dev))
    (dix2, rs), t_ref, ref_t = staged(lambda: bq.refresh_device(
        sx_cur, dix_cur, sx2))
    if rs["freed_bytes"] <= 0:
        raise AssertionError("the trim freed no device memory")
    _, csx, cdix, cold2 = cold_build(g2, dev)
    n_cold += cold2["core"][1]["launches"]
    sweeps += cold2["core"][1]["launches"]
    n_f = assert_index_equal(sx2, csx, "the trimmed index")
    n_a = assert_mirror_equal(dix2, cdix, "the trimmed mirror")
    print(f"[epoch] trim expire_before({t_cut}): expired {cur.m - g2.m} edges "
          f"(m {cur.m} -> {g2.m}, t_max {cur.t_max} -> {g2.t_max}), |K| "
          f"{len(tab.ks)} -> {len(ks2)}, N {sx_cur.num_nodes} -> "
          f"{sx2.num_nodes}; core times {t_core:.4f}s (re-expand "
          f"{core['expand_s']:.4f}s, stratify {core['stratify_s']:.4f}s), "
          f"forest shrink {t_forest:.4f}s (re-expand "
          f"{forest['expand_s']:.4f}s), {refresh_line(t_ref, ref_t, rs)}; "
          f"trim {t_core + t_forest + t_ref:.4f}s; equal to the cold card "
          f"build of the trimmed graph in all {n_f} fields and {n_a} mirror "
          f"arrays; that build: {cold_line(cold2)}; after the refresh, "
          + batch_line(epoch_batch(g2, sx2, dix2, dev, rng)))
    if ss.stratum_sweep.launches != sweeps:
        raise AssertionError("stratum_sweep launches outside the timed "
                             "builds and extends")
    b1 = label_prop.label_prop_round.launches
    print(f"[epoch] phase: stratum_sweep launches {sweeps} (cold builds "
          f"{n_cold}, extends {sweeps - n_cold}), B1 launches {b1}; "
          f"{time.perf_counter() - t_phase:.2f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the "
          f"batches' (256, V) version masks)")
    return sweeps, b1


#: the [engine] phase: bench_engine.py's engine settings and traffic
ENGINE_QUERIES = 2048
ENGINE_CHUNK = 256
ENGINE_THREADS = 4
ENGINE_LOADS = (250.0, 1000.0)
ENGINE_VERIFY = 256
ENGINE_STRAGGLERS = 32
ENGINE_EDGES = 16
#: queries per submission of the thread that serves during the ingests
INGEST_CHUNK = 64


def pct(xs, q) -> float:
    """The q-th percentile of a list of seconds, in ms (0 when empty)."""
    return float(np.percentile(np.asarray(xs), q)) * 1e3 if xs else 0.0


def submit_all(eng, name, specs, threads: int = 1,
               chunk: int = ENGINE_CHUNK) -> tuple[list, float]:
    """``specs`` through ``submit_specs`` in chunks, chunk i from caller
    thread i % threads, then one flush: the results in order and the
    seconds from the first submission to the last answer."""
    chunks = [specs[i:i + chunk] for i in range(0, len(specs), chunk)]
    futs = [None] * len(chunks)

    def caller(t):
        for i in range(t, len(chunks), threads):
            futs[i] = eng.submit_specs(name, chunks[i])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        for f in [pool.submit(caller, t) for t in range(threads)]:
            f.result()
    eng.flush()
    results = [f.result(timeout=300) for fs in futs for f in fs]
    return results, time.perf_counter() - t0


def paced(eng, name, specs, load: float) -> tuple[list, float]:
    """``specs`` one at a time at ``load`` queries/s, as
    ``benchmarks/bench_engine.py`` paces an offered load."""
    t0 = time.perf_counter()
    period = 1.0 / load
    futures = []
    for i, q in enumerate(specs):
        delay = t0 + i * period - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futures.append(eng.submit_spec(name, q))
    eng.flush()
    results = [f.result(timeout=300) for f in futures]
    return results, time.perf_counter() - t0


def check_alg1(pecb, specs, results, what: str, n: int = ENGINE_VERIFY
               ) -> int:
    """``n`` answers spread over the stream against Algorithm 1 on the
    host (``pecb.answer``); raises on a mismatch. Edge modes compare the
    member edge ids too."""
    idx = np.linspace(0, len(specs) - 1, min(n, len(specs))).astype(int)
    bad = []
    for i in idx.tolist():
        want, got = pecb.answer(specs[i]), results[i]
        same = (got.vertices == want.vertices
                and got.num_vertices == want.num_vertices)
        if want.edges is not None:
            same = same and got.edges.edge_ids() == want.edges.edge_ids()
        if not same:
            bad.append(i)
    if bad:
        raise AssertionError(f"[engine] {what}: {len(bad)} of {len(idx)} "
                             f"answers differ from Algorithm 1 ({bad[:5]})")
    return len(idx)


def traffic_line(eng, results, t: float, rounds: list) -> str:
    """q/s, e2e percentiles and route counts of one replay, read from the
    engine's metrics, which are then reset; the replay's propagation
    rounds are added to ``rounds`` first."""
    snap = eng.metrics.snapshot(include_sources=False)
    c, e2e = snap["counters"], snap["latency"].get("e2e", {})
    rounds.append(c.get("propagation_rounds", 0))
    eng.metrics.reset()
    routes = dict(collections.Counter(r.provenance.route for r in results))
    return (f"{len(results) / t:.1f} q/s ({len(results)} in {t:.4f}s); e2e "
            f"p50 {e2e.get('p50_ms', 0):.3f} p95 {e2e.get('p95_ms', 0):.3f} "
            f"p99 {e2e.get('p99_ms', 0):.3f} ms; device batches "
            f"{c.get('device_batches', 0)}, host batches "
            f"{c.get('host_batches', 0)}, padded slots "
            f"{c.get('device_padded_slots', 0)}; B1 rounds "
            f"{c.get('propagation_rounds', 0)}; routes {routes}")


def serve_during_ingest(eng, name, ks, t_last: int, seed: int):
    """One caller thread submitting INGEST_CHUNK mixed-k vertex specs at a
    time (windows ending on ``t_last``, the newest day to come) until
    ``stop`` is set, each chunk awaited. Returns (thread, stop event,
    records [(t_submit, t_done, spec, result)])."""
    from repro_torch.core.query_api import TCCSQuery

    stop = threading.Event()
    records = []
    rng = np.random.default_rng(seed)
    n = eng.registry.resolve_graph(name).n

    def run():
        while not stop.is_set():
            specs = [TCCSQuery(int(rng.integers(0, n)),
                               int(rng.integers(1, t_last - 4)), t_last,
                               int(rng.choice(ks)))
                     for _ in range(INGEST_CHUNK)]
            t0 = time.perf_counter()
            futs = eng.submit_specs(name, specs)
            eng.flush()
            for q, f in zip(specs, futs):
                r = f.result(timeout=300)
                records.append((t0, time.perf_counter(), q, r))

    th = threading.Thread(target=run, name="ingest-traffic")
    th.start()
    return th, stop, records


def engine_setup(g):
    """``[engine]``'s workload and settings, shared by ``[multi]``: the
    name, epoch 0's last day ``t_old``, ``g.split_at(t_old)`` (epoch 0 and
    the later days' edges) and the engine's config."""
    from repro_torch.serving import EngineConfig

    t_old = max(1, int(g.t_max * EPOCH_FRAC))
    g0, suffix = g.split_at(t_old)
    cfg = EngineConfig(max_batch=256, flush_ms=2.0, cache_capacity=0)
    return "collegemsg", t_old, g0, suffix, cfg


def engine_phase(g, sx, dev, smi: str) -> tuple[int, int]:
    """``[engine]``: the port's serving engine on the card at CollegeMsg
    scale, through the entry points a user calls. Epoch 0 =
    ``g.split_at(189)``, registered by name; ``warmup`` runs the registry's
    cold build on the card; then open-loop traffic from four caller
    threads, paced offered loads, stragglers on the host route, a cached
    replay, a window sweep, an edges-mode batch, the days 190..193 ingested
    one at a time while a caller thread keeps serving, and one trim. Every
    stream's sampled answers are held to Algorithm 1, the day-193 handle to
    ``sx`` (the cold build of ``g``) and the trimmed one to a cold card
    build. Returns the phase's B1 and stratum_sweep launches, each checked
    against the rounds and builds the engine ran."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core.query_api import ResultMode, TCCSQuery, WindowSweep
    from repro_torch.core.temporal_graph import random_queries
    from repro_torch.kernels import kcore_peel, label_prop
    from repro_torch.kernels import segmented_select as ss
    from repro_torch.launch import serve
    from repro_torch.serving import EngineConfig, ServingEngine

    tag = f"({smi})"
    t_phase = time.perf_counter()
    ss.reset_sweep_counts()
    label_prop.label_prop_round.launches = 0
    fix0 = kcore_peel.kcore_fixpoint.launches
    rounds: list = []
    name, t_old, g0, suffix, cfg = engine_setup(g)
    with ServingEngine(cfg, device=dev) as eng:
        eng.register_graph(name, g0)
        h, t_warm = wall(lambda: eng.warmup(name))
        builds = ss.stratum_sweep.launches
        print(f"[engine] {tag} cold build through warmup: epoch 0 = "
              f"g.split_at({t_old}), m={g0.m}, |K|={len(h.supported_ks)}, "
              f"N={h.pecb.num_nodes}; {h.build_seconds:.4f}s (stages "
              + ", ".join(f"{s} {v:.4f}s" for s, v in h.build_stages.items())
              + f"), warmup {t_warm:.4f}s with the buckets 8..256; "
              f"stratum_sweep launches {builds}; kernel builds "
              f"{eng.metrics.counter('kernel_builds')} (B1's library was "
              f"loaded in [build])")
        rounds.append(eng.metrics.counter("propagation_rounds"))
        eng.metrics.reset()

        rng = np.random.default_rng(10)
        specs = [TCCSQuery(u, ts, te, int(rng.choice(h.supported_ks)))
                 for (u, ts, te) in random_queries(g0, ENGINE_QUERIES,
                                                   seed=9)]
        res, t = submit_all(eng, name, specs, threads=ENGINE_THREADS)
        n_ok = check_alg1(h.pecb, specs, res, "open loop")
        first = res
        print(f"[engine] {tag} open loop, {ENGINE_QUERIES} mixed-k specs in "
              f"chunks of {ENGINE_CHUNK} from {ENGINE_THREADS} threads: "
              + traffic_line(eng, res, t, rounds)
              + f"; {n_ok} checked against Algorithm 1, 0 mismatches")
        for load in ENGINE_LOADS:
            res, t = paced(eng, name, specs, load)
            n_ok = check_alg1(h.pecb, specs, res, f"offered {load:g} q/s")
            print(f"[engine] {tag} offered load {load:g} q/s: "
                  + traffic_line(eng, res, t, rounds)
                  + f"; {n_ok} checked, 0 mismatches")

        strag = [specs[i:i + 3] for i in range(0, 3 * ENGINE_STRAGGLERS, 3)]
        res = []
        t0 = time.perf_counter()
        for batch in strag:
            futs = eng.submit_specs(name, batch)
            eng.flush()
            res += [f.result(timeout=300) for f in futs]
        t = time.perf_counter() - t0
        flat = [q for b in strag for q in b]
        c = eng.metrics.snapshot(include_sources=False)["counters"]
        if (c.get("host_batches"), c.get("device_batches", 0)) != (
                ENGINE_STRAGGLERS, 0):
            raise AssertionError(f"[engine] stragglers: routes {c}")
        check_alg1(h.pecb, flat, res, "stragglers")
        # the engine's executor: its rounds count in the engine's metrics
        dev_masks = eng.executor.run(
            h.device, bq.mixed_slots(h.pecb, [(q.u, q.k) for q in flat]),
            [q.ts for q in flat], [q.te for q in flat],
            eng.executor.final_bucket(len(flat), 8, 256))
        if any(frozenset(np.flatnonzero(m).tolist()) != r.vertices
               for m, r in zip(dev_masks, res)):
            raise AssertionError("[engine] stragglers: the host route "
                                 "disagrees with a device batch")
        print(f"[engine] {tag} stragglers, {ENGINE_STRAGGLERS} submissions "
              f"of 3 flushed one at a time: " + traffic_line(eng, res, t,
                                                            rounds)
              + "; every answer equal to Algorithm 1 and to one device "
              "batch of the same specs (its B1 rounds are those above)")

        ccfg = EngineConfig(max_batch=256, flush_ms=2.0, cache_capacity=4096)
        with ServingEngine(ccfg, registry=eng.registry, device=dev) as ce:
            res1, t1 = submit_all(ce, name, specs)
            line1 = traffic_line(ce, res1, t1, rounds)
            res2, t2 = submit_all(ce, name, specs)
            share = sum(r.provenance.route == "cache" for r in res2) / len(
                res2)
            if any(a.vertices != b.vertices for a, b in zip(res2, res1)) or \
                    any(a.vertices != b.vertices for a, b in zip(res1, first)):
                raise AssertionError("[engine] cached answers differ")
            print(f"[engine] {tag} cache (4,096 entries), the open-loop "
                  f"stream twice: first pass {line1}; second pass "
                  + traffic_line(ce, res2, t2, rounds)
                  + f"; cache share {share:.4f}, answers equal the first "
                  "pass's and the open loop's")

        k_sweep = h.supported_ks[len(h.supported_ks) // 4]
        windows = [(d, min(d + 40, g.t_max)) for d in range(1, 65)]
        (sw, t_sw) = wall(lambda: eng.sweep(name, WindowSweep(
            u=0, k=k_sweep, windows=windows)))
        direct = serve.serve_sweep(h.pecb, h.device, 0, k_sweep, windows)
        rounds.append(sum(direct["rounds"]))
        c = eng.metrics.snapshot(include_sources=False)["counters"]
        rounds.append(c.get("propagation_rounds", 0))
        eng.metrics.reset()
        if [r.vertices for r in sw] != direct["answers"]:
            raise AssertionError("[engine] sweep differs from serve_sweep")
        print(f"[engine] {tag} sweep u=0 k={k_sweep}, {len(windows)} "
              f"windows: {t_sw:.4f}s, {c.get('sweep_launches', 0)} device "
              f"batch(es), equal to serve.serve_sweep's answers (each "
              f"checked against Algorithm 1, 0 mismatches)")

        torch.cuda.reset_peak_memory_stats()
        ecfg = EngineConfig(max_batch=ENGINE_EDGES, flush_ms=2.0,
                            cache_capacity=0)
        # the busiest vertices at the three lowest k over long windows:
        # components with many member edges to check
        deg = np.bincount(np.concatenate([g0.src, g0.dst]), minlength=g0.n)
        modes = (ResultMode.EDGES, ResultMode.SUBGRAPH)
        especs = [TCCSQuery(int(u), 1 + 20 * (i % 4), g0.t_max,
                            h.supported_ks[i % 3], modes[i % 2])
                  for i, u in enumerate(np.argsort(deg)[-ENGINE_EDGES:])]
        with ServingEngine(ecfg, registry=eng.registry, device=dev) as ee:
            res, t = submit_all(ee, name, especs, chunk=ENGINE_EDGES)
            check_alg1(h.pecb, especs, res, "edges")
            line = traffic_line(ee, res, t, rounds)
        if min(r.num_edges for r in res) == 0:
            raise AssertionError("[engine] edges: an empty component")
        print(f"[engine] {tag} edges: {ENGINE_EDGES} EDGES and SUBGRAPH "
              f"specs at max_batch {ENGINE_EDGES}: {line}; "
              f"{sum(r.num_edges for r in res)} member edges (each answer "
              f"{min(r.num_edges for r in res)}.."
              f"{max(r.num_edges for r in res)}), every edge set equal to "
              f"Algorithm 1's; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the "
              f"({ENGINE_EDGES}, V) version masks, V = "
              f"{h.device.num_versions:,})")

        # -- ingest while serving ------------------------------------------
        th, stop, recs = serve_during_ingest(eng, name, h.supported_ks,
                                             g.t_max, seed=12)
        time.sleep(1.0)                       # the baseline before any ingest
        spans, handles = [], {t_old: h}
        cur = g0
        for day in range(t_old + 1, g.t_max + 1):
            edges = [tuple(e) for e in suffix[suffix[:, 2] == day].tolist()]
            t0 = time.perf_counter()
            fut = eng.ingest(name, edges)[name]
            hd = fut.result(timeout=300)
            t1 = time.perf_counter()
            cur = cur.extend(edges)
            handles[day] = hd
            spans.append((day, t0, t1, hd))
            time.sleep(0.5)                   # serve the new epoch a while
        stop.set()
        th.join(timeout=300)
        if th.is_alive():
            raise AssertionError("[engine] the serving thread is stuck")
        eng.drain(timeout=300)
        base = [b - a for a, b, _, _ in recs if b < spans[0][1]]
        during = [b - a for a, b, _, _ in recs
                  if any(t0 <= a < t1 for _, t0, t1, _ in spans)]
        for day, t0, t1, hd in spans:
            old = sum(1 for a, _, _, r in recs
                      if t0 <= a < t1 and r.query.te == day - 1)
            print(f"[engine] {tag} ingest day {day}: refresh "
                  f"{hd.build_seconds:.4f}s (" + ", ".join(
                      f"{s} {v:.4f}s" for s, v in hd.build_stages.items())
                  + f"), ingest to swap {t1 - t0:.4f}s; {old} answers "
                  f"served from epoch {day - 1 - t_old} while it ran")
        by_epoch = collections.defaultdict(list)
        for _, _, q, r in recs:
            by_epoch[r.query.te].append((q, r))
        n_ok = 0
        for te, pairs in sorted(by_epoch.items()):
            qs, rs = zip(*pairs)
            n_ok += check_alg1(handles[te].pecb, list(qs), list(rs),
                               f"ingest, epoch ending {te}",
                               n=ENGINE_VERIFY // len(by_epoch) + 1)
        print(f"[engine] {tag} served during the ingests: {len(recs)} "
              f"queries in chunks of {INGEST_CHUNK}; p99 before any ingest "
              f"{pct(base, 99):.3f} ms (p50 {pct(base, 50):.3f}, "
              f"{len(base)} queries), p99 while a refresh was in flight "
              f"{pct(during, 99):.3f} ms (p50 {pct(during, 50):.3f}, "
              f"{len(during)} queries); {n_ok} checked against Algorithm 1 "
              f"on their own epoch, 0 mismatches")
        c = eng.metrics.snapshot(include_sources=False)["counters"]
        rounds.append(c.get("propagation_rounds", 0))
        eng.metrics.reset()
        hd = eng.registry.get_nowait(name)
        n_f = assert_index_equal(hd.pecb, sx, "the day-193 handle")
        rng = np.random.default_rng(13)
        vspecs = [TCCSQuery(u, ts, te, int(rng.choice(hd.supported_ks)))
                  for (u, ts, te) in random_queries(g, ENGINE_VERIFY,
                                                    seed=14)]
        res, t = submit_all(eng, name, vspecs)
        check_alg1(hd.pecb, vspecs, res, "day 193")
        print(f"[engine] {tag} day {g.t_max}: the handle equals the cold "
              f"build of g in all {n_f} fields (tolerance 0); "
              f"{len(vspecs)} queries: " + traffic_line(eng, res, t, rounds)
              + ", 0 mismatches against Algorithm 1")

        # -- trim --------------------------------------------------------
        t_cut = max(2, int(g.t_max * TRIM_FRAC))
        (futs, t_trim) = wall(lambda: eng.retain(name, t_cut, wait=True,
                                                 timeout=300))
        ht = futs[name].result()
        freed = eng.metrics.counter("retention_freed_bytes")
        g2 = cur.expire_before(t_cut)
        _, csx, cdix, _ = cold_build(g2, dev)
        n_f = assert_index_equal(ht.pecb, csx, "the trimmed handle")
        n_a = assert_mirror_equal(ht.device, cdix, "the trimmed mirror")
        tspecs = [TCCSQuery(u, ts, te, int(rng.choice(ht.supported_ks)))
                  for (u, ts, te) in random_queries(g2, ENGINE_VERIFY,
                                                    seed=15)]
        res, t = submit_all(eng, name, tspecs)
        check_alg1(ht.pecb, tspecs, res, "after the trim")
        print(f"[engine] {tag} trim retain({t_cut}): {t_trim:.4f}s, "
              f"{freed / 1e6:.1f} MB freed, the handle equal to the cold card "
              f"build of the trimmed graph in all {n_f} fields and {n_a} "
              f"mirror arrays; {len(tspecs)} queries: "
              + traffic_line(eng, res, t, rounds) + ", 0 mismatches")

        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "engine_trace.json"
            eng.export_trace(str(path))
            doc = json.loads(path.read_text())
        names = collections.Counter(e["name"] for e in doc["traceEvents"]
                                    if e["ph"] == "X")
        print(f"[engine] {tag} trace: {len(doc['traceEvents'])} events load "
              f"as JSON ({doc['otherData']['dropped_spans']} spans dropped "
              f"by the ring), spans by name {dict(names)}")

    b1 = label_prop.label_prop_round.launches
    sweeps = ss.stratum_sweep.launches
    if b1 <= 0 or b1 != sum(rounds):
        raise AssertionError(f"[engine] B1 launches {b1} != rounds run "
                             f"{sum(rounds)}")
    # one launch per t_uv block of each card sweep: the cold build of
    # epoch 0, each ingest's extend, the trimmed graph's cold build
    want = sum(-(-t // ct.TUV_BLOCK)
               for t in [t_old, *range(t_old + 1, g.t_max + 1), g2.t_max])
    if sweeps != want:
        raise AssertionError(f"[engine] stratum_sweep launches {sweeps}, "
                             f"expected {want}")
    print(f"[engine] {tag} phase: B1 launches {b1} (= the rounds the "
          f"engines' executors and serve_sweep ran, counted exactly across "
          f"the batcher worker threads), "
          f"stratum_sweep launches {sweeps} (cold build, 4 ingests, the "
          f"trimmed graph's cold build), kcore_fixpoint launches "
          f"{kcore_peel.kcore_fixpoint.launches - fix0}; "
          f"{time.perf_counter() - t_phase:.2f}s")
    return b1, sweeps


#: the [multi] phase: the [serve] phase's stream (four batches of 256
#: mixed-k vertex specs), the answers checked against Algorithm 1, the
#: trim's cut, and the seed of the second card's B5/B6 inputs
MULTI_SPECS = 4 * BUCKET
MULTI_VERIFY = 64
MULTI_SEED = 43


def multi_devices() -> list:
    """Every visible card once, or ``cuda:0`` twice on a one-card machine:
    two shards, each with its own replica, on one card."""
    count = torch.cuda.device_count()
    if count > 1:
        return [torch.device("cuda", i) for i in range(count)]
    return [torch.device("cuda", 0)] * 2


def shard_line(eng, results, t: float, rounds: list) -> str:
    """:func:`traffic_line` with the batch latency (``device_exec``) and
    the rounds of each shard, which must add up to the engine's
    ``propagation_rounds``."""
    snap = eng.metrics.snapshot(include_sources=False)
    c, ex = snap["counters"], snap["latency"].get("device_exec", {})
    d = eng.executor.num_devices
    per = ([c.get(f"propagation_rounds_shard{i}", 0) for i in range(d)]
           if d > 1 else [c.get("propagation_rounds", 0)])
    if sum(per) != c.get("propagation_rounds", 0):
        raise AssertionError(f"[multi] rounds by shard {per} do not add up "
                             f"to {c.get('propagation_rounds', 0)}")
    return (f"batch latency (device_exec) p50 {ex.get('p50_ms', 0):.3f} "
            f"p99 {ex.get('p99_ms', 0):.3f} ms over {ex.get('count', 0)} "
            f"batches; rounds by shard {per}; "
            + traffic_line(eng, results, t, rounds))


def assert_replicas(h, what: str) -> int:
    """Every replica of ``h`` equal, array for array, to ``to_device`` of
    its index on the replica's card; returns the arrays checked."""
    from repro_torch.core import batch_query as bq

    n = 0
    for i, r in enumerate(h.replicas):
        n += assert_mirror_equal(r, bq.to_device(h.pecb, r.device),
                                 f"{what}, replica {i} on {r.device}")
    return n


def second_card_check(smi: str) -> str:
    """B5 on its ``wgmma`` route, B6 on its ``wgmma`` route and B6's
    backward on its ``wgmma`` route, launched on ``cuda:0`` and then on
    ``cuda:1`` in this process, each held against its plain version: the
    shared-memory opt-in is made per device. Returns the line's clause.
    These launches compare kernels and count on no path."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_matmul as sm

    M = N = K = 1024
    B, S, H, dh = 1, 1024, 4, 128
    routes = (sm.plan(M, N, K, torch.bfloat16).route,
              fa.plan(B, S, H, H, S, True, dh, torch.bfloat16).route,
              fa.bwd_plan(B, S, H, H, S, True, dh, torch.bfloat16).route)
    if routes != ("wgmma",) * 3:
        raise AssertionError(f"[multi] the second card's shapes take the "
                             f"routes {routes}, not wgmma")
    worst = {"B5": 0.0, "B6": 0.0, "B6 backward": 0.0}
    for i in (0, 1):
        dev = torch.device("cuda", i)
        gen = torch.Generator(device=dev).manual_seed(MULTI_SEED)
        a, b = (torch.randn(M, K, generator=gen, device=dev).bfloat16(),
                torch.randn(K, N, generator=gen, device=dev).bfloat16())
        got, want = sm.matmul(a, b), ref.matmul(a, b)
        tol = B5_RTOL * want.abs() + B5_ATOL_PER_K * K
        worst["B5"] = max(worst["B5"], float(((got - want).abs() / tol)
                                             .max()))
        q, k, v, do = (torch.randn(B, S, H, dh, generator=gen, device=dev)
                       .bfloat16() for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        want = ref.flash_attention(q, k, v, causal=True)
        worst["B6"] = max(worst["B6"], float(
            ((o.float() - want.float()).abs() / fa.error_bound(want)).max()))
        got = fa.flash_attention_bwd(q, k, v, o, do, causal=True, lse=lse)
        want = ref.flash_attention_bwd(q, k, v, o, do, causal=True)
        scales = ref.flash_attention_bwd_scales(q, k, v, o, do, causal=True)
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            bound = fa.bwd_error_bound(w, *scales[name])
            worst["B6 backward"] = max(worst["B6 backward"], float(
                ((x.float() - w.float()).abs() / bound).max()))
        torch.cuda.synchronize(dev)
    sm.reset_counts()
    fa.reset_counts()
    fa.reset_bwd_counts()
    if not max(worst.values()) <= 1:
        raise AssertionError(f"[multi] a kernel on the second card disagrees "
                             f"with its plain version: {worst} of the bounds")
    return ("B5 (1024 x 1024) @ (1024 x 1024) bf16, B6 causal (1, 1024, 4, "
            "128) bf16 and its backward, all on their wgmma routes, on "
            "cuda:0 then cuda:1 in this process: " + ", ".join(
                f"{k} at {v:.3f}" for k, v in worst.items())
            + " of their bounds at most (B5 "
            f"{B5_RTOL} relative + {B5_ATOL_PER_K} x K, B6 error_bound, "
            f"the backward bwd_error_bound) | {smi}")


def multi_phase(g, smi: str) -> tuple[int, int]:
    """``[multi]``: ``ServingEngine(devices=...)`` over every visible card
    (``cuda:0`` twice on a one-card machine), on ``[engine]``'s epoch 0
    and settings. A one-shard engine and the sharded engine each build the
    index cold through ``warmup``; the sharded handle's every replica must
    equal ``to_device`` on its card. Both serve ``[serve]``'s stream in
    batches of 256; every sharded answer must equal the one-shard
    engine's and a sample Algorithm 1. The sharded engine then ingests one
    day and runs one trim, each new handle's replicas equal to
    ``to_device`` of its index, and serves once more. B1's launches must
    equal the rounds of every shard of both engines. On two cards or more,
    :func:`second_card_check` runs too. Returns the phase's B1 and
    stratum_sweep launches."""
    from repro_torch.core import core_time as ct
    from repro_torch.core.query_api import TCCSQuery
    from repro_torch.core.temporal_graph import random_queries
    from repro_torch.kernels import label_prop
    from repro_torch.kernels import segmented_select as ss
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    tag = f"({smi})"
    t_phase = time.perf_counter()
    devices = multi_devices()
    d = len(devices)
    if torch.cuda.device_count() == 1:
        print(f"[multi] {tag} one card is visible: cuda:0 stood in for two "
              f"shards, each with its own replica, so no card-to-card copy "
              f"was exercised")
    ss.reset_sweep_counts()
    label_prop.label_prop_round.launches = 0
    rounds: list = []
    name, t_old, g0, suffix, cfg = engine_setup(g)
    with ServingEngine(cfg, devices=devices[:1]) as one:
        one.register_graph(name, g0)
        h1, t_cold1 = wall(lambda: one.warmup(name))
        rounds.append(one.metrics.counter("propagation_rounds"))
        one.metrics.reset()
        specs = serve.mixed_specs(g0, h1.supported_ks, MULTI_SPECS, seed=0)
        want, t = submit_all(one, name, specs)
        print(f"[multi] {tag} 1 shard ({devices[0]}): cold build through "
              f"warmup {t_cold1:.4f}s; [serve]'s stream, {len(specs)} "
              f"mixed-k specs in batches of {ENGINE_CHUNK}: "
              + shard_line(one, want, t, rounds))
    with ServingEngine(cfg, devices=devices) as eng:
        if eng.executor.num_devices != d or eng.stats()["devices"] != d:
            raise AssertionError(f"[multi] the engine has "
                                 f"{eng.executor.num_devices} shards, not {d}")
        eng.register_graph(name, g0)
        h, t_cold = wall(lambda: eng.warmup(name))
        n_arr = assert_replicas(h, "the cold build")
        rounds.append(eng.metrics.counter("propagation_rounds"))
        eng.metrics.reset()
        got, t = submit_all(eng, name, specs)
        line = shard_line(eng, got, t, rounds)
        bad = [i for i, (a, b) in enumerate(zip(got, want))
               if a.vertices != b.vertices or a.num_vertices != b.num_vertices]
        if bad:
            raise AssertionError(f"[multi] {len(bad)} sharded answers differ "
                                 f"from the one-shard engine's ({bad[:5]})")
        n_ok = check_alg1(h.pecb, specs, got, "multi", n=MULTI_VERIFY)
        print(f"[multi] {tag} {d} shards ({', '.join(map(str, devices))}): "
              f"cold build through warmup {t_cold:.4f}s (stages "
              + ", ".join(f"{s} {v:.4f}s" for s, v in h.build_stages.items())
              + f"), {d} replicas of {h.device.nbytes() / 1e6:.1f} MB, each "
              f"equal to to_device on its card ({n_arr} arrays); the same "
              f"stream: " + line + f"; all {len(got)} answers bit-equal to "
              f"the one-shard engine's, {n_ok} equal to Algorithm 1")

        day = t_old + 1
        edges = [tuple(e) for e in suffix[suffix[:, 2] == day].tolist()]
        (futs, t_ing) = wall(lambda: eng.ingest(name, edges, wait=True,
                                                timeout=300))
        hd = futs[name].result()
        n_ing = assert_replicas(hd, f"the day-{day} handle")
        c = eng.metrics.snapshot(include_sources=False)["counters"]
        moved = (f"uploaded {c.get('refresh_upload_bytes', 0) / 1e6:.1f} MB, "
                 f"copied from the first replica "
                 f"{c.get('refresh_replicated_bytes', 0) / 1e6:.1f} MB")
        t_cut = max(2, int(g.t_max * TRIM_FRAC))
        (futs, t_trim) = wall(lambda: eng.retain(name, t_cut, wait=True,
                                                 timeout=300))
        ht = futs[name].result()
        n_trim = assert_replicas(ht, "the trimmed handle")
        freed = eng.metrics.counter("retention_freed_bytes")
        rounds.append(eng.metrics.counter("propagation_rounds"))
        eng.metrics.reset()
        rng = np.random.default_rng(16)
        tspecs = [TCCSQuery(u, ts, te, int(rng.choice(ht.supported_ks)))
                  for (u, ts, te) in random_queries(ht.graph, BUCKET,
                                                    seed=17)]
        res, t = submit_all(eng, name, tspecs)
        check_alg1(ht.pecb, tspecs, res, "multi, after the trim",
                   n=MULTI_VERIFY)
        print(f"[multi] {tag} ingest of day {day} ({len(edges)} edges): "
              f"{t_ing:.4f}s to the swap ({moved}), every replica of epoch 1 "
              f"equal to to_device ({n_ing} arrays); trim retain({t_cut}): "
              f"{t_trim:.4f}s, {freed / 1e6:.1f} MB freed over the "
              f"replicas, every replica equal to to_device ({n_trim} "
              f"arrays); {len(tspecs)} queries after the trim: "
              + shard_line(eng, res, t, rounds)
              + f", {MULTI_VERIFY} checked against Algorithm 1, 0 "
              "mismatches")
    b1 = label_prop.label_prop_round.launches
    if b1 <= 0 or b1 != sum(rounds):
        raise AssertionError(f"[multi] B1 launches {b1} != the rounds of "
                             f"every shard {sum(rounds)}")
    sweeps = ss.stratum_sweep.launches
    want_sweeps = sum(-(-t // ct.TUV_BLOCK) for t in (t_old, t_old, day))
    if sweeps != want_sweeps:
        raise AssertionError(f"[multi] stratum_sweep launches {sweeps}, "
                             f"expected {want_sweeps}")
    if torch.cuda.device_count() > 1:
        print(f"[multi] {tag} opt-in per device: " + second_card_check(smi))
    else:
        print(f"[multi] {tag} B5 and B6 on a second card: not checked, this "
              f"check needs two cards and one is visible")
    print(f"[multi] {tag} phase: B1 launches {b1} (= the rounds of every "
          f"shard of both engines), stratum_sweep launches {sweeps} (two "
          f"cold builds, one ingest); {time.perf_counter() - t_phase:.2f}s")
    return b1, sweeps


#: the [store] phase: the ingest feed's engine settings, no cache (every
#: answer must show the index's own provenance), and the CLI's workload
STORE_VERIFY = 256
STORE_CLI = ("--workload", "fb_like", "--queries", "256", "--batch", "64")


def store_commits(store, before: dict, what: str) -> dict:
    """The one commit ``store`` made since its stats read ``before``: its
    mode and bytes, and the ``store_commit`` span's seconds."""
    st = store.stats()
    modes = [m for m in ("full", "delta", "noop")
             if st[f"commits_{m}"] > before[f"commits_{m}"]]
    if st["commits"] + st["commits_noop"] != before["commits"] + before[
            "commits_noop"] + 1 or len(modes) != 1:
        raise AssertionError(f"[store] {what}: expected one commit, stats "
                             f"{before} -> {st}")
    span = store.tracer.spans("store_commit")[-1]
    return dict(mode=modes[0], seconds=span.duration_s,
                bytes=st["bytes_written"] - before["bytes_written"])


def commit_line(c: dict) -> str:
    return (f"{c['mode']} commit {c['bytes'] / 1e6:.3f} MB in "
            f"{c['seconds']:.4f}s")


def dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def store_phase(g, dev, smi: str) -> tuple[int, int]:
    """``[store]``: the disk tier (A6) at CollegeMsg scale, through the
    entry points a user calls. An engine with ``store_dir`` builds epoch
    0 = ``g.split_at(189)`` cold on the card and writes it through, ingests
    the days 190..193 (one delta commit each), trims with retain(96) and
    closes. A second engine on the same directory adopts the graph and
    promotes the stored index to the card with no build: equal to a cold
    card build of the trimmed graph in every field and mirror array; 256
    mixed-k answers through B1 with provenance ``disk`` equal to
    Algorithm 1, 16 EDGES specs at max_batch 16; one more day ingested
    onto the promoted handle as a delta commit, equal to a cold build.
    Then a corrupted newest segment (the previous epoch recovered and
    promoted), every manifest deleted (a cold build, the asserted
    outcome), the serving CLI twice on one store (the second run
    promoted), and graphsage-reddit's parameters checkpointed from the
    card and restored onto it bit-equal. Returns the phase's B1 and
    stratum_sweep launches, each checked against the rounds and builds the
    engines ran."""
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import core_time as ct
    from repro_torch.core.query_api import ResultMode, TCCSQuery
    from repro_torch.core.temporal_graph import random_queries
    from repro_torch.kernels import label_prop
    from repro_torch.kernels import segmented_select as ss
    from repro_torch.models import gnn
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.store import segment as seg
    from repro_torch.store.index_store import key_dirname

    tag = f"({smi})"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ss.reset_sweep_counts()
    label_prop.label_prop_round.launches = 0
    name = "collegemsg"
    root = tempfile.mkdtemp(prefix="store-")
    keydir = Path(root) / key_dirname(name)
    cfg = EngineConfig(store_dir=root, max_batch=256, flush_ms=2.0,
                       cache_capacity=0)
    t_old = max(1, int(g.t_max * EPOCH_FRAC))
    g0, suffix = g.split_at(t_old)
    stores, registries, rounds = [], [], []

    def engine(**kw):
        eng = ServingEngine(kw.pop("config", cfg), device=dev, **kw)
        if eng.store is not None:
            stores.append(eng.store)
            registries.append(eng.registry)
        return eng

    def sweeps_since(before: int, want: int, what: str) -> int:
        got = ss.stratum_sweep.launches - before
        if got != want:
            raise AssertionError(f"[store] {what}: stratum_sweep launches "
                                 f"{got}, expected {want}")
        return got

    try:
        # -- 1. the first process: cold build, ingests, trim ----------------
        with engine() as eng:
            eng.register_graph(name, g0)
            st0 = eng.store.stats()
            h0 = eng.warmup(name)
            c = store_commits(eng.store, st0, "epoch 0")
            if (h0.source, c["mode"]) != ("build", "full"):
                raise AssertionError(f"[store] epoch 0: {h0.source}, {c}")
            t_cold = h0.build_seconds
            print(f"[store] {tag} epoch 0 = g.split_at({t_old}), m={g0.m}: "
                  f"cold card build {t_cold:.4f}s (" + ", ".join(
                      f"{s} {v:.4f}s" for s, v in h0.build_stages.items())
                  + f"); write-through {commit_line(c)}")
            cur = g0
            for day in range(t_old + 1, g.t_max + 1):
                edges = [tuple(e) for e in suffix[suffix[:, 2] == day].tolist()]
                st0, s0 = eng.store.stats(), ss.stratum_sweep.launches
                hd = eng.ingest(name, edges)[name].result(timeout=300)
                cur = cur.extend(edges)
                sweeps_since(s0, 1, f"ingest of day {day}")
                c = store_commits(eng.store, st0, f"day {day}")
                print(f"[store] {tag} ingest day {day} ({len(edges)} edges, "
                      f"epoch {hd.epoch}): refresh {hd.build_seconds:.4f}s, "
                      f"1 stratum_sweep launch; {commit_line(c)}")
            t_cut = max(2, int(g.t_max * TRIM_FRAC))
            st0 = eng.store.stats()
            ht = eng.retain(name, t_cut, wait=True, timeout=300)[name].result()
            c = store_commits(eng.store, st0, "trim")
            g_trim = cur.expire_before(t_cut)
            print(f"[store] {tag} trim retain({t_cut}) (epoch {ht.epoch}): "
                  f"shrink {ht.build_seconds:.4f}s; {commit_line(c)}; "
                  f"{dir_bytes(root) / 1e6:.1f} MB on disk; the engine "
                  "closes")
            rounds.append(eng.metrics.counter("propagation_rounds"))

        # -- 2. warm restart: adopt the graph, promote, no build ------------
        s0 = ss.stratum_sweep.launches
        with engine() as eng:
            hp, t_warm = wall(lambda: eng.warmup(name))
            sweeps_since(s0, 0, "warm restart")
            st = eng.registry.stats()
            if (hp.source, st["promotions"], st["builds"], hp.epoch) != (
                    "disk", 1, 0, ht.epoch):
                raise AssertionError(f"[store] warm restart: source "
                                     f"{hp.source}, registry {st}")
            if hp.device.device != dev:
                raise AssertionError("[store] the promoted mirror is not on "
                                     "the card")
            stages = hp.build_stages
            print(f"[store] {tag} warm restart: warmup {t_warm:.4f}s, "
                  f"source disk, promotions 1, builds 0, stratum_sweep "
                  f"launches 0; promotion {hp.build_seconds:.4f}s = "
                  f"open_latest with crc32 verification "
                  f"{stages['open']:.4f}s + from_parts "
                  f"{stages['assemble']:.4f}s + upload to the card "
                  f"{stages['device']:.4f}s ({hp.device.nbytes() / 1e6:.1f} "
                  f"MB), against the cold build's {t_cold:.4f}s "
                  f"({t_cold / hp.build_seconds:.1f}x); "
                  f"{eng.store.stats()['load_bytes'] / 1e6:.1f} MB loaded")
            s0 = ss.stratum_sweep.launches
            _, csx, cdix, _ = cold_build(g_trim, dev)
            sweeps_since(s0, 1, "the trimmed graph's cold build")
            n_f = assert_index_equal(hp.pecb, csx, "the promoted handle")
            n_a = assert_mirror_equal(hp.device, cdix, "the promoted mirror")
            print(f"[store] {tag} the promoted handle equals a cold card "
                  f"build of the trimmed graph in all {n_f} fields and its "
                  f"mirror in all {n_a} arrays (tolerance 0)")

            # -- 3. serve from it ---------------------------------------
            rng = np.random.default_rng(10)
            specs = [TCCSQuery(u, ts, te, int(rng.choice(hp.supported_ks)))
                     for (u, ts, te) in random_queries(g_trim, STORE_VERIFY,
                                                       seed=9)]
            res, t = submit_all(eng, name, specs)
            routes = collections.Counter(r.provenance.route for r in res)
            if routes != {"disk": len(specs)}:
                raise AssertionError(f"[store] routes {dict(routes)}")
            n_ok = check_alg1(hp.pecb, specs, res, "promoted",
                              n=STORE_VERIFY)
            c = eng.metrics.snapshot(include_sources=False)["counters"]
            print(f"[store] {tag} {len(specs)} mixed-k specs from the "
                  f"promoted handle: {len(specs) / t:.1f} q/s, device "
                  f"batches {c.get('device_batches', 0)}, B1 rounds "
                  f"{c.get('propagation_rounds', 0)}; routes "
                  f"{dict(routes)}; {n_ok} checked against Algorithm 1, 0 "
                  "mismatches")
            ecfg = EngineConfig(max_batch=ENGINE_EDGES, flush_ms=2.0,
                                cache_capacity=0)
            deg = np.bincount(np.concatenate([g_trim.src, g_trim.dst]),
                              minlength=g_trim.n)
            modes = (ResultMode.EDGES, ResultMode.SUBGRAPH)
            especs = [TCCSQuery(int(u), 1 + 10 * (i % 4), g_trim.t_max,
                                hp.supported_ks[i % 3], modes[i % 2])
                      for i, u in enumerate(np.argsort(deg)[-ENGINE_EDGES:])]
            with engine(config=ecfg, registry=eng.registry) as ee:
                eres, _ = submit_all(ee, name, especs, chunk=ENGINE_EDGES)
                check_alg1(hp.pecb, especs, eres, "promoted edges")
                rounds.append(ee.metrics.counter("propagation_rounds"))
            if {r.provenance.route for r in eres} != {"disk"}:
                raise AssertionError("[store] edges: a route other than disk")
            print(f"[store] {tag} {ENGINE_EDGES} EDGES and SUBGRAPH specs at "
                  f"max_batch {ENGINE_EDGES}: route disk, "
                  f"{sum(r.num_edges for r in eres)} member edges, every "
                  "edge set equal to Algorithm 1's")

            # -- 4. ingest onto the promoted handle -------------------------
            day = g_trim.t_max
            edges = [(int(u), int(v), day + 1) for u, v, t in zip(
                g_trim.src, g_trim.dst, g_trim.t) if t == day]
            st0, s0 = eng.store.stats(), ss.stratum_sweep.launches
            hi = eng.ingest(name, edges)[name].result(timeout=300)
            sweeps_since(s0, 1, "the ingest after promotion")
            c = store_commits(eng.store, st0, "ingest after promotion")
            if c["mode"] != "delta":
                raise AssertionError(f"[store] the ingest after promotion "
                                     f"made a {c['mode']} commit")
            g_grown = g_trim.extend(edges)
            s0 = ss.stratum_sweep.launches
            _, gsx, gdix, _ = cold_build(g_grown, dev)
            sweeps_since(s0, 1, "the grown graph's cold build")
            n_f = assert_index_equal(hi.pecb, gsx, "the ingested handle")
            n_a = assert_mirror_equal(hi.device, gdix, "the ingested mirror")
            print(f"[store] {tag} ingest after promotion: day {day} "
                  f"re-appended as day {day + 1} ({len(edges)} edges, epoch "
                  f"{hi.epoch}), refresh {hi.build_seconds:.4f}s from the "
                  f"mmap-backed arrays; {commit_line(c)} onto the promoted "
                  f"chain; equal to a cold card build of the grown graph in "
                  f"all {n_f} fields and {n_a} mirror arrays")
            rounds.append(eng.metrics.counter("propagation_rounds"))
        del gsx, gdix

        # -- 5. recovery -------------------------------------------------
        newest, prev = [json.loads((keydir / n).read_text()) for _, n in
                        seg.list_manifests(str(keydir))[:2]]
        part = next(p for ent in newest["arrays"].values()
                    for p in ent["parts"]
                    if p["segment"] not in prev["segments"])
        with open(keydir / part["segment"], "r+b") as f:
            f.seek(part["offset"])
            byte = f.read(1)
            f.seek(part["offset"])
            f.write(bytes([byte[0] ^ 0xFF]))
        s0 = ss.stratum_sweep.launches
        with engine() as eng:
            eng.register_graph(name, g_trim)   # the last good commit's graph
            hr = eng.warmup(name)
            sweeps_since(s0, 0, "recovery")
            st = eng.store.stats()
            opened = eng.store.tracer.spans("store_open")[-1].attrs
            if hr.source != "disk" or opened["epoch"] != prev["epoch"] or \
                    st["recovered_commits"] < 1:
                raise AssertionError(f"[store] recovery: {hr.source}, "
                                     f"{opened}, {st}")
            n_f = assert_index_equal(hr.pecb, csx, "the recovered handle")
            n_a = assert_mirror_equal(hr.device, cdix, "the recovered mirror")
            rounds.append(eng.metrics.counter("propagation_rounds"))
        print(f"[store] {tag} recovery: one byte of {part['segment']} "
              f"flipped (epoch {newest['epoch']}'s delta); the reopened store "
              f"skipped {st['recovered_commits']} commit(s) and promoted "
              f"epoch {opened['epoch']} in {hr.build_seconds:.4f}s, equal to its "
              f"cold card build in all {n_f} fields and {n_a} mirror arrays")
        del csx, cdix
        for man in keydir.glob("manifest_*.json"):
            man.unlink()
        s0 = ss.stratum_sweep.launches
        with engine() as eng:
            eng.register_graph(name, g_trim)
            hb = eng.warmup(name)
            sweeps_since(s0, 1, "the cold build after total loss")
            if hb.source != "build" or eng.registry.stats()["builds"] != 1:
                raise AssertionError(f"[store] total loss: source "
                                     f"{hb.source}")
            rounds.append(eng.metrics.counter("propagation_rounds"))
        print(f"[store] {tag} every manifest deleted: warmup fell back to a "
              f"cold card build (source build, {hb.build_seconds:.4f}s), the "
              "one case in which a rebuild is the asserted outcome")

        # -- 6. the CLI on one store, twice --------------------------------
        cli_root = tempfile.mkdtemp(prefix="store-cli-")
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        outs = []
        for extra in ((), ("--expect-warm",)):
            cmd = [sys.executable, "-m", "repro_torch.launch.serve",
                   *STORE_CLI, "--store-dir", cli_root, *extra]
            (p, t) = wall(lambda: subprocess.run(
                cmd, capture_output=True, text=True, timeout=300, env=env))
            if p.returncode:
                raise AssertionError(f"[store] CLI {extra} exited "
                                     f"{p.returncode}:\n{p.stdout[-3000:]}"
                                     f"\n{p.stderr[-3000:]}")
            lines = p.stdout.splitlines()
            warm = next(x for x in lines if x.startswith("[warmup]"))
            verify = next(x for x in lines if x.startswith("[verify]"))
            store_line = next(x for x in lines if x.startswith("[store]"))
            if not verify.endswith(" 0 mismatches"):
                raise AssertionError(f"[store] CLI: {verify}")
            outs.append((warm, store_line, verify, t))
        if "index built" not in outs[0][0] or \
                "index promoted from store" not in outs[1][0]:
            raise AssertionError(f"[store] CLI: {outs}")
        for (warm, store_line, verify, t), what in zip(outs, (
                "first run", "second run, --expect-warm")):
            print(f"[store] {tag} CLI {' '.join(STORE_CLI)} --store-dir "
                  f"({what}, {t:.2f}s): {warm} | "
                  f"{store_line.split(' ', 2)[2]} | {verify}")
        shutil.rmtree(cli_root, ignore_errors=True)

        # -- 7. the checkpoint manager on the card -------------------------
        spec = configs.get(GNN_ARCH)
        mcfg = configs.cell_model_cfg(spec, GNN_SHAPE)
        model = gnn.init_params(mcfg, torch.Generator(device=dev).manual_seed(
            GNN_SEED), device=dev)
        sd = model.state_dict()
        n_params = sum(v.numel() for v in sd.values())
        mgr = CheckpointManager(tempfile.mkdtemp(prefix="ckpt-"))
        _, t_save = wall(lambda: mgr.save(1, sd, {"arch": GNN_ARCH}))
        _, t_async = wall(lambda: mgr.save_async(2, sd))
        _, t_wait = wall(mgr.wait)
        for step in (1, 2):
            (got_step, got, _), t_rest = wall(lambda: mgr.restore(
                step, device=dev))
            if got_step != step or list(got) != list(sd) or not all(
                    v.device == dev
                    and v.dtype == sd[k].dtype and torch.equal(v, sd[k])
                    for k, v in got.items()):
                raise AssertionError(f"[store] checkpoint step {step} is not "
                                     f"bit-equal on {dev}")
        shutil.rmtree(mgr.dir, ignore_errors=True)
        print(f"[store] {tag} checkpoint of {GNN_ARCH}'s {n_params:,} f32 "
              f"parameters from the card: save {t_save:.4f}s, save_async "
              f"{t_async:.4f}s + wait {t_wait:.4f}s, restore onto {dev} "
              f"{t_rest:.4f}s; both steps bit-equal")

        # -- 8. the phase's totals -----------------------------------------
        totals = collections.Counter()
        for s in stores:
            totals.update({k: v for k, v in s.stats().items()
                           if k != "root"})
        fails = collections.Counter()
        for r in registries:
            st = r.stats()
            fails.update(load=st["store_load_failures"],
                         commit=st["store_commit_failures"])
        if fails["load"] or fails["commit"]:
            raise AssertionError(f"[store] store failures {dict(fails)}")
        on_disk = dir_bytes(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    b1 = label_prop.label_prop_round.launches
    sweeps = ss.stratum_sweep.launches
    if b1 <= 0 or b1 != sum(rounds):
        raise AssertionError(f"[store] B1 launches {b1} != rounds run "
                             f"{sum(rounds)}")
    want = sum(-(-t // ct.TUV_BLOCK) for t in (
        t_old, *range(t_old + 1, g.t_max + 1), g_trim.t_max,
        g_trim.t_max + 1, g_trim.t_max + 1, g_trim.t_max))
    if sweeps != want:
        raise AssertionError(f"[store] stratum_sweep launches {sweeps}, "
                             f"expected {want}")
    print(f"[store] {tag} phase: {on_disk / 1e6:.1f} MB on disk at the end; "
          f"commits full {totals['commits_full']}, delta "
          f"{totals['commits_delta']}, noop {totals['commits_noop']} "
          f"({totals['bytes_written'] / 1e6:.1f} MB written); loads "
          f"{totals['loads']} ({totals['load_bytes'] / 1e6:.1f} MB), "
          f"recovered commits {totals['recovered_commits']}; "
          f"store_load_failures 0, store_commit_failures 0; B1 launches "
          f"{b1} (= the engines' rounds), stratum_sweep launches {sweeps} (5 "
          f"builds and ingests of the first process, 2 cold builds to "
          f"compare, 1 ingest after promotion, 1 cold build after total "
          f"loss; 0 for each promotion); "
          f"{time.perf_counter() - t_phase:.2f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return b1, sweeps


#: the [recsys] phase: mind at the reference's full width and depth
#: (n_items 8,388,608 x 64, 4 interests, 3 routing iterations, histories
#: of 50; f32, drawn on the card from MIND_SEED) on RECSYS_SHAPES, nothing
#: cut: serve_p99 (512 users x 100 candidates, MIND_SERVES timed calls),
#: serve_bulk (262,144 x 100), retrieval_cand (1 user x 1,000,000) and
#: train_batch (65,536 users from launch.train's InteractionStream,
#: MIND_STEPS steps). Serving histories and candidates are drawn by
#: :func:`mind_requests`, a vectorised draw of the stream's form.
MIND_ARCH = "mind"
MIND_SEED = 37
MIND_SERVES = 60
MIND_STEPS = 3
#: f32 throughout: scores within this share of max|score| of the plain
#: versions', the loss and each gradient leaf within this share of its
#: scale
MIND_TOL = 1e-4
#: (B5, of them B5's gradient products, B4, B4 plans) of one serve call,
#: one retrieval call and one train step (tests/test_torch_cuda.py's
#: MIND_CALLS holds the same at the smoke config): serving's one product
#: is emb @ S, retrieval's second the candidates' scores; a train step's
#: forward runs emb @ S and the in-batch logits, its backward their four
#: gradient products and one B4 (the item table's gradient over the one
#: lookup of the history and the targets), with one plan
MIND_LAUNCHES = {"serve": (1, 0, 0, 0), "retrieval": (2, 0, 0, 0),
                 "train": (6, 4, 1, 1)}


def mind_requests(cfg, B: int, C: int, seed: int, dev) -> dict:
    """A serving batch of ``B`` users: histories of ``cfg.hist_len`` items
    (all real, mask 1) and ``C`` candidates each, in the form of
    ``data.recsys_data.InteractionStream`` (its 32 cluster bases at seed
    0; each user mixes 1-3 clusters; an item is its cluster's base plus a
    Zipf(1.8) draw, mod n_items), drawn for all users at once with numpy
    from ``seed``; on ``dev``. ``C`` candidates of one user (``B`` = 1)
    are drawn uniformly over the table: a retrieval slab."""
    from repro_torch.data.recsys_data import InteractionStream
    base = InteractionStream(cfg.n_items, cfg.hist_len, seed=0).cluster_base
    rng = np.random.default_rng(seed)
    cs = rng.integers(0, len(base), (B, 3))
    k = rng.integers(1, 4, (B, 1))

    def items(n):
        pick = np.take_along_axis(cs, rng.integers(0, 2**20, (B, n)) % k,
                                  axis=1)
        return ((base[pick] + rng.zipf(1.8, (B, n))) % cfg.n_items).astype(
            np.int32)

    hist = items(cfg.hist_len)
    cand = (items(C) if B > 1 else
            rng.integers(0, cfg.n_items, C, dtype=np.int32))
    return {"hist_ids": torch.as_tensor(hist, device=dev),
            "hist_mask": torch.ones(hist.shape, dtype=torch.float32,
                                    device=dev),
            "cand_ids": torch.as_tensor(cand, device=dev)}


def mind_counted(want: tuple, what: str) -> tuple:
    """The counts since :func:`reset_b4_b5`; raises unless they are
    ``want`` (B5, B5's gradient products, B4, B4 plans), with no B4 gather
    and every B5 launch on the f32 route."""
    from repro_torch.kernels import segment_matmul as sm
    got = (sm.matmul.launches, sm.matmul_grads.launches,
           sm.segment_sum.launches, sm.segment_plan.builds)
    if got != tuple(want) or sm.segment_gather.launches:
        raise AssertionError(f"{what} launched (B5, B5 grad, B4, plans) "
                             f"{got}, B4 gather {sm.segment_gather.launches}"
                             f", not {tuple(want)}, 0")
    b5_routes(sm, {"f32": got[0]}, what)
    return got


def mind_clause(n: tuple) -> str:
    return (f"B5 {n[0]} (all on the f32 route; {n[1]} of them gradients), "
            f"B4 {n[2]}, B4 plans built {n[3]}")


def mind_scores_check(serve, model, batch, what: str) -> float:
    """The serve step's scores with the kernels against the plain versions
    on the card: NaN where the plain run has NaN, else within MIND_TOL of
    max|score|; returns the error."""
    got = serve(model, batch)
    want = plain_outputs(lambda: serve(model, batch))
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"{what}: NaN scores differ from the plain "
                             "run's")
    ok = ~torch.isnan(want)
    err = rel_err(got[ok], want[ok])
    if not err <= MIND_TOL:
        raise AssertionError(f"{what}: scores with the kernels differ from "
                             f"the plain versions' by {err} of max|score|")
    return err


def mind_step_split(model, batch, opt_cfg, state) -> dict:
    """One train step taken apart, the card synchronised between the
    parts: the lookup (one ``take`` of the history and the targets), the
    routing (``interests_of``: emb @ S on B5 and the capsule routing),
    the loss (label-aware attention, the in-batch logits on B5 and the
    softmax), the backward (B5's gradients, B4 for the table's) and
    AdamW. Returns the seconds of each."""
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    hist, mask = batch["hist_ids"], batch["hist_mask"]
    B, H = hist.shape
    t = {}
    ids = torch.cat([hist, batch["target_id"][:, None]], dim=1)
    rows, t["lookup"] = wall(lambda: recsys.take(model.item_embed, ids))
    interests, t["routing"] = wall(lambda: recsys.interests_of(
        model, rows[:, :H], mask))
    loss, t["loss"] = wall(lambda: recsys.in_batch_softmax_loss(
        recsys.label_aware_attention(model.cfg, interests, rows[:, H]),
        rows[:, H]))
    grads, t["backward"] = wall(lambda: dict(zip(params, torch.autograd.grad(
        loss, list(params.values())))))
    del interests, loss, rows
    _, t["AdamW"] = wall(lambda: adamw.apply_updates(opt_cfg, params, grads,
                                                     state))
    return t


def recsys_phase(dev, smi: str) -> dict:
    """[recsys]: mind served and trained on the card at full width through
    its entry points (``configs.make_serve_step``, ``make_train_step``,
    ``launch.train``). Every entry point's launches are counted (set to 0
    just before, read just after) and held to MIND_LAUNCHES; scores, the
    loss and every gradient against the plain versions on the card (TF32
    off); two identical gradient evaluations bit-equal; the training CLI
    with an injected failure replayed bit-equal; B4 at the table
    gradient's shape and B5 at the S gradient's and the in-batch shapes
    against their plain versions, timed beside their bounds and library
    calls. Returns the launches and the largest errors."""
    from repro_torch import configs
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain versions' f32
    spec = configs.get(MIND_ARCH)
    cfg = configs.cell_model_cfg(spec, "train_batch")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(MIND_SEED)
    model, t_init = wall(lambda: configs.init_params(spec, cfg, gen,
                                                     device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[recsys] {MIND_ARCH} at full width ({cfg.n_items:,} items x "
          f"{cfg.embed_dim}, {cfg.n_interests} interests, "
          f"{cfg.capsule_iters} routing iterations, histories of "
          f"{cfg.hist_len}; {n_params:,} f32 parameters, "
          f"{n_params * 4 / 2**30:.2f} GiB, drawn from seed {MIND_SEED} in "
          f"{t_init:.2f}s) | {smi}")
    errs = []
    launched = collections.Counter()

    def tally(n: tuple) -> None:
        launched.update(dict(zip(("b5", "b5_grad", "b4", "plans"), n)))

    # -- serve_p99 -----------------------------------------------------
    dims = spec.shapes["serve_p99"]
    serve = configs.make_serve_step(spec, "serve_p99")
    batch = mind_requests(cfg, dims["batch"], dims["cands"], MIND_SEED, dev)
    reset_b4_b5()
    out, t_first = wall(lambda: serve(model, batch))
    n = mind_counted(MIND_LAUNCHES["serve"], "a serve_p99 call")
    tally(n)
    if out.shape != (dims["batch"], dims["cands"]) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError("serve_p99 scores are not finite "
                             f"({dims['batch']}, {dims['cands']})")
    errs.append(mind_scores_check(serve, model, batch, "serve_p99"))
    calls = sorted(wall(lambda: serve(model, batch))[1]
                   for _ in range(MIND_SERVES))
    p50, p99 = (float(np.percentile(calls, q)) for q in (50, 99))
    host = host_ms(lambda: serve(model, batch))
    print(f"[recsys] serve_p99 ({dims['batch']} users x {dims['cands']} "
          f"candidates) through make_serve_step: launched "
          f"{mind_clause(n)} (first call {t_first * 1e3:.3f} ms); scores "
          f"within {errs[-1]:.3e} of max|score| of the plain versions' "
          f"(tolerance {MIND_TOL}); over {MIND_SERVES} calls p50 "
          f"{p50 * 1e3:.4f} ms, p99 {p99 * 1e3:.4f} ms per batch = "
          f"{dims['batch'] / p50:,.0f} users/s at p50; host "
          f"{host:.4f} ms per call (enqueued back to back) | {smi}")
    print(f"[recsys] one serve_p99 call under torch.profiler: " + profiled(
        lambda: serve(model, batch), {"B5": is_b5}) + f" | {smi}")
    del out, batch

    # -- serve_bulk ----------------------------------------------------
    dims = spec.shapes["serve_bulk"]
    bulk = configs.make_serve_step(spec, "serve_bulk")
    batch, t_draw = wall(lambda: mind_requests(
        cfg, dims["batch"], dims["cands"], MIND_SEED + 1, dev))
    torch.cuda.reset_peak_memory_stats()
    reset_b4_b5()
    out, t_first = wall(lambda: bulk(model, batch))
    n = mind_counted(MIND_LAUNCHES["serve"], "a serve_bulk call")
    tally(n)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("serve_bulk scores are not finite")
    del out
    errs.append(mind_scores_check(bulk, model, batch, "serve_bulk"))
    t_bulk = sorted(wall(lambda: bulk(model, batch))[1] for _ in range(3))[1]
    print(f"[recsys] serve_bulk ({dims['batch']:,} users x {dims['cands']} "
          f"candidates; drawn in {t_draw:.2f}s): launched {mind_clause(n)}; "
          f"scores within {errs[-1]:.3e} of max|score| of the plain "
          f"versions'; {t_bulk:.4f} s per batch (median of 3; first "
          f"{t_first:.4f} s) = {dims['batch'] / t_bulk:,.0f} users/s; peak "
          f"device memory {peak:.2f} GiB | {smi}")
    del batch
    torch.cuda.empty_cache()

    # -- retrieval_cand --------------------------------------------------
    dims = spec.shapes["retrieval_cand"]
    retrieve = configs.make_serve_step(spec, "retrieval_cand")
    batch = mind_requests(cfg, 1, dims["cands"], MIND_SEED + 2, dev)
    torch.cuda.reset_peak_memory_stats()
    reset_b4_b5()
    out, t_first = wall(lambda: retrieve(model, batch))
    n = mind_counted(MIND_LAUNCHES["retrieval"], "a retrieval_cand call")
    tally(n)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if out.shape != (dims["cands"],) or not bool(torch.isfinite(out).all()):
        raise AssertionError("retrieval scores are not finite "
                             f"({dims['cands']},)")
    del out
    errs.append(mind_scores_check(retrieve, model, batch, "retrieval_cand"))
    t_ret = sorted(wall(lambda: retrieve(model, batch))[1]
                   for _ in range(20))[10]
    print(f"[recsys] retrieval_cand (1 user x {dims['cands']:,} "
          f"candidates): launched {mind_clause(n)}; scores within "
          f"{errs[-1]:.3e} of max|score| of the plain versions'; "
          f"{t_ret * 1e3:.4f} ms per query (median of 20; first "
          f"{t_first * 1e3:.3f} ms); peak device memory {peak:.2f} GiB | "
          f"{smi}")
    del batch

    # -- train_batch -----------------------------------------------------
    dims = dict(spec.shapes["train_batch"])
    B, H, d = dims["batch"], cfg.hist_len, cfg.embed_dim
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    step = configs.make_train_step(spec, cfg, opt_cfg)
    state = adamw.init_state(dict(model.named_parameters()))
    batch_fn = train_cli.make_batch_fn(spec, cfg, dims, dev)
    losses, step_s, data_s = [], [], []
    for i in range(MIND_STEPS):
        b, t_data = wall(lambda: batch_fn(i))
        data_s.append(t_data)
        if i == 0:
            first = b
            reset_b4_b5()
        (_, state, m), t = wall(lambda: step(model, state, b))
        if i == 0:
            n = mind_counted(MIND_LAUNCHES["train"], "a train step")
            tally(n)
        losses.append(float(m["loss"]))
        step_s.append(t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"mind losses are not finite: {losses}")
    ts = sorted(step_s[1:])[len(step_s[1:]) // 2]
    flops = configs.model_flops(spec, "train_batch")
    print(f"[recsys] train_batch ({B:,} users, launch.train's "
          f"InteractionStream, nothing cut): {MIND_STEPS} make_train_step "
          f"steps, the first launched {mind_clause(n)}; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)} (ln {B:,} = "
          f"{np.log(B):.4f}); step {ts:.4f}s after the first "
          f"({step_s[0]:.3f}s) = {B / ts:,.0f} users/s; model FLOPs "
          f"{flops:.4e} = {flops / ts / 67e12:.4f} of the 67 TFLOP/s f32 "
          f"peak; peak device memory {peak:.2f} GiB; host data "
          f"{' '.join(f'{x:.2f}' for x in data_s)} s a batch outside the "
          f"step | {smi}")
    split = mind_step_split(model, first, opt_cfg, state)
    print(f"[recsys] one train step taken apart (synchronised between the "
          f"parts): " + ", ".join(f"{k} {v:.4f}s" for k, v in split.items())
          + f" (sum {sum(split.values()):.4f}s) | {smi}")
    print(f"[recsys] one train step under torch.profiler: " + profiled(
        lambda: step(model, state, first), {"B4": is_b4, "B5": is_b5})
        + f" | {smi}")
    (l_k, g_k), t_k = wall(lambda: loss_and_grads(spec, cfg, model, first))
    (_, g_2) = loss_and_grads(spec, cfg, model, first)
    apart = sorted(k for k in g_k if not torch.equal(g_k[k], g_2[k]))
    if apart:
        raise AssertionError(f"two identical gradient evaluations differ in "
                             f"{apart}")
    del g_2
    (l_p, g_p), t_p = wall(lambda: loss_and_grads(spec, cfg, model, first,
                                                  plain=True))
    gerr = grad_leaf_errs(g_k, g_p)
    worst = max(gerr, key=gerr.get)
    if not (abs(l_k - l_p) <= MIND_TOL * abs(l_p) and gerr[worst] <= MIND_TOL):
        raise AssertionError(f"mind: loss {l_k} against {l_p}, gradient "
                             f"{worst} off by {gerr[worst]} of its scale")
    errs.append(gerr[worst])
    print(f"[recsys] train step's loss and gradients (first batch): loss "
          f"{l_k:.7f} with the kernels ({t_k:.3f}s), {l_p:.7f} with the "
          f"plain versions ({t_p:.3f}s); "
          + ", ".join(f"{k} within {v:.3e}" for k, v in gerr.items())
          + f" of its largest |plain| (tolerance {MIND_TOL}); two "
          f"evaluations bit-equal in all {len(g_k)} leaves | {smi}")
    del g_k, g_p
    torch.cuda.empty_cache()
    exact = restart_check(MIND_ARCH, dev, smi)

    # -- the kernels at the path's shapes ---------------------------------
    ids = torch.cat([first["hist_ids"], first["target_id"][:, None]],
                    dim=1).reshape(-1)
    E = int(ids.shape[0])
    rows = int(torch.unique(ids).numel())
    hub = int(torch.bincount(ids).max())
    ints = torch.randint(-4, 5, (E, d), generator=gen, device=dev).float()
    b4 = b4_checks({f"item table gradient ({E:,} x {d} rows of small "
                    f"integers at the step's ids, {rows:,} distinct, the "
                    f"largest hub {hub:,} rows, into {cfg.n_items:,} "
                    f"rows)": (ints, ids, cfg.n_items)}, tag="recsys")
    del ints
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(MIND_SEED + 3)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    cases = {"S gradient emb^T @ d(emb S)": ((d, B * H), (B * H, d)),
             "emb @ S": ((B * H, d), (d, d)),
             "in-batch logits user @ tgt^T": ((B, d), (d, B)),
             "d user = dlogits @ tgt": ((B, B), (B, d)),
             "d tgt^T = user^T @ dlogits": ((d, B), (B, B)),
             "retrieval cand @ interests^T": ((
                 spec.shapes["retrieval_cand"]["cands"], d),
                 (d, cfg.n_interests))}
    b5 = {}
    for name, (sa, sb) in cases.items():
        b5.update(kernel_checks({name: (randn(*sa), randn(*sb))}, {},
                                tag="recsys"))
        torch.cuda.empty_cache()
    ds = b5["S gradient emb^T @ d(emb S)"]
    from repro_torch.kernels import segment_matmul as sm
    p = sm.plan(d, d, B * H, torch.float32)
    if p.splits < 2:
        raise AssertionError(f"the S gradient's product runs on one block "
                             f"({p})")
    a, bb = randn(d, B * H), randn(B * H, d)
    if not torch.equal(sm.matmul(a, bb), sm.matmul(a, bb)):
        raise AssertionError("B5's split S gradient differs between two "
                             "calls")
    del a, bb
    print(f"[recsys] B5 at the S gradient's shape: {p.splits} K splits of "
          f"{p.k_split:,} ({p.splits} blocks), bit-equal on a second call; "
          f"{ds['ms']:.4f} ms = {ds['ms'] / ds['library_ms']:.3f}x "
          f"torch.matmul's {ds['library_ms']:.4f} ms (TF32 off; the limit "
          f"is 2x) and {ds['bound_ms'] / ds['ms']:.3f} of its bound | {smi}")
    total = launched["b5"] + launched["b4"]
    print(f"[recsys] phase {time.perf_counter() - t_phase:.1f}s; launches "
          f"on the main path: B5 {launched['b5']} ({launched['b5_grad']} "
          f"gradients), B4 {launched['b4']}, B4 plans {launched['plans']} "
          f"({total} kernel launches); restart replay "
          f"{'bit-equal' if exact else 'not bit-equal'}; largest error "
          f"{max(errs):.3e} of scale | {smi}")
    del model, state, first, b
    torch.cuda.empty_cache()
    return {"b5": launched["b5"] - launched["b5_grad"],
            "b5_grad": launched["b5_grad"], "b4": launched["b4"],
            "b4_err": max(r["max_abs_err"] for r in b4.values()),
            "b5_err": max(r["max_abs_err"] for r in b5.values())}


RUNTIME_MOE_SEQ = 4096
#: the a2a MoE against its plain versions with the routes replayed, and
#: the prefill with the hooks and the a2a against today's: bf16 logits
#: within this share of max|logit| (LM_LOGIT_TOL)
RUNTIME_MOE_TOL = 5e-2
#: the MoE train step whose gradients the compressed mean takes: full
#: width, this many layers, one sequence of this many tokens
RUNTIME_GRAD_LAYERS = 2
RUNTIME_GRAD_SEQ = 1024
#: seconds after which the dry run starts no more cells (once it has traced
#: a cell of each family; all 35 take ~140 s of host time)
RUNTIME_DRYRUN_S = 20.0
#: B4's time at the mind train step's table gradient in PR 28 (H100 80GB
#: HBM3 at 700 W; PERF.md kernel table), printed beside this run's
PR28_B4_MS = 1.0886


def runtime_phase(dev, smi: str) -> dict:
    """[runtime]: the runtime and launch modules on the card's one-rank
    NCCL mesh (``launch.mesh.make_smoke_mesh("cuda")``).

    mind at full width through the vocab-parallel lookup
    (``runtime.sharding.make_vp_take``): serve_p99's scores, one train
    batch's loss and both gradients and retrieval_cand's scores bit-equal
    to the default ``ops.take`` path, each counted; rows for the ids n, -1
    and -n-1 zero; one ``make_train_step`` step through it; B4 at the
    lookup's table gradient timed. qwen2-moe-a2.7b at full width: layer
    0's MoE on the prefill operands through ``make_a2a_moe`` against its
    plain versions with the routes replayed (the cell's capacity) and
    against ``moe_ffn`` at a capacity that does not bind; the full prefill
    with ``set_moe_impl(a2a)`` and the LM hooks set against today's
    prefill. The compressed mean (``optim.compression``) over a MoE train
    step's gradients. ``remesh`` of a restored mind checkpoint. The dry run
    (``launch.dryrun``) on the card's mesh, one cell of each family first,
    then more within RUNTIME_DRYRUN_S, with the report's tables. Returns
    the phase's B5 and B4 launches and the largest B5 error."""
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.launch import dryrun, report
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime import elastic
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.moe_a2a import a2a_capacity, make_a2a_moe

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_smoke_mesh("cuda")
    dp = shd.dp_axes(mesh)
    print(f"[runtime] mesh {mesh} over a one-rank {torch.distributed.get_backend()} "
          f"group | {smi}")
    launched = collections.Counter()

    def tally(n: tuple) -> None:
        launched.update(dict(zip(("b5", "b5_grad", "b4", "plans"), n)))

    # -- mind through the vp take -----------------------------------------
    spec = configs.get(MIND_ARCH)
    cfg = configs.cell_model_cfg(spec, "train_batch")
    gen = torch.Generator(device=dev).manual_seed(MIND_SEED)
    model = configs.init_params(spec, cfg, gen, device=dev)
    vp = shd.make_vp_take(mesh, leading=dp)
    n = cfg.n_items
    bad = torch.tensor([n, -1, -n - 1], dtype=torch.int32, device=dev)
    with torch.no_grad():
        rows = vp(model.item_embed, bad)
    if rows.shape != (3, cfg.embed_dim) or bool(rows.any()):
        raise AssertionError("the vp take's rows for ids n, -1, -n-1 are "
                             "not zero")
    dims = spec.shapes["serve_p99"]
    batch = mind_requests(cfg, dims["batch"], dims["cands"], MIND_SEED, dev)
    want = configs.make_serve_step(spec, "serve_p99")(model, batch)
    step = configs.make_serve_step(spec, "serve_p99", take_fn=vp,
                                   cand_take_fn=vp)
    shd.reset_collectives()
    reset_b4_b5()
    got = step(model, batch)
    tally(mind_counted(MIND_LAUNCHES["serve"], "serve_p99 through the vp "
                                               "take"))
    coll_serve = shd.collective_counts()
    if not torch.equal(got, want):
        raise AssertionError("serve_p99 through the vp take differs from "
                             "the default lookup")
    t_serve = {"vp take": call_times(lambda: step(model, batch), iters=10),
               "ops.take": call_times(lambda: configs.make_serve_step(
                   spec, "serve_p99")(model, batch), iters=10)}
    dims = spec.shapes["retrieval_cand"]
    rb = mind_requests(cfg, 1, dims["cands"], MIND_SEED + 2, dev)
    want = configs.make_serve_step(spec, "retrieval_cand")(model, rb)
    reset_b4_b5()
    got = configs.make_serve_step(
        spec, "retrieval_cand", take_fn=shd.make_vp_take(mesh, leading=None),
        cand_take_fn=vp)(model, rb)
    tally(mind_counted(MIND_LAUNCHES["retrieval"], "retrieval_cand through "
                                                   "the vp take"))
    if not torch.equal(got, want):
        raise AssertionError("retrieval_cand through the vp take differs "
                             "from the default lookup")
    del got, want, rb
    tdims = dict(spec.shapes["train_batch"])
    tb = train_cli.make_batch_fn(spec, cfg, tdims, dev)(0)

    def loss_grads(take_fn):
        return loss_and_grads(spec, cfg, model, tb,
                              loss_fn=configs.loss_for(spec, cfg,
                                                       take_fn=take_fn))

    l_d, g_d = loss_grads(None)
    shd.reset_collectives()
    reset_b4_b5()
    l_v, g_v = loss_grads(vp)
    tally(mind_counted(MIND_LAUNCHES["train"], "the train batch's loss and "
                                               "gradients through the vp "
                                               "take"))
    coll_train = shd.collective_counts()
    apart = [k for k in g_d if not torch.equal(g_d[k], g_v[k])]
    if l_d != l_v or apart:
        raise AssertionError(f"the train batch through the vp take: loss "
                             f"{l_v} against {l_d}, gradients differ in "
                             f"{apart}")
    del g_d, g_v
    torch.cuda.empty_cache()
    B, H = tb["hist_ids"].shape
    ids = torch.cat([tb["hist_ids"], tb["target_id"][:, None]],
                    dim=1).reshape(-1)
    plan = sm.segment_plan(ids, n)
    vals = torch.randn(ids.shape[0], cfg.embed_dim, generator=gen,
                       device=dev)
    b4_ms, b4_times = call_times(lambda: sm.segment_sum(vals, plan, n))
    b4_bound = sm.segment_sum_bound_ms(ids.shape[0], cfg.embed_dim, n)
    del vals, plan
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    state = adamw.init_state(dict(model.named_parameters()))
    train_step = configs.make_train_step(spec, cfg, opt_cfg, take_fn=vp)
    reset_b4_b5()
    (_, state, m), t_step = wall(lambda: train_step(model, state, tb))
    tally(mind_counted(MIND_LAUNCHES["train"], "a train step through the "
                                               "vp take"))
    if not bool(torch.isfinite(m["loss"])):
        raise AssertionError("the train step through the vp take gave a "
                             "non-finite loss")

    def coll(c):
        return ", ".join(f"{k} {v['calls']} ({v['bytes'] / 1e6:.1f} MB)"
                         for k, v in c.items())
    print(f"[runtime] mind at full width ({n:,} x {cfg.embed_dim}) through "
          f"make_vp_take(mesh, leading={dp}): serve_p99 scores, the train "
          f"batch's loss ({l_v:.7f}) and both gradients and "
          f"retrieval_cand's scores bit-equal to the default ops.take path; "
          f"rows for ids n, -1, -n-1 zero; launches as the default path's "
          f"(serve {MIND_LAUNCHES['serve']}, retrieval "
          f"{MIND_LAUNCHES['retrieval']}, loss and gradients "
          f"{MIND_LAUNCHES['train']}: B5, its gradients, B4, plans); "
          f"collectives of a serve call: {coll(coll_serve)}; of the loss and "
          f"gradients: {coll(coll_train)}; serve_p99 {show(t_serve)}; one "
          f"make_train_step step through the vp take {t_step:.4f}s, loss "
          f"{float(m['loss']):.4f} | {smi}")
    print(f"[runtime] B4 at the vp take's table gradient ({B * (H + 1):,} "
          f"rows x {cfg.embed_dim} into {n:,}, one launch): {b4_times}; "
          f"bound {b4_bound:.4f} ms (PR 28: {PR28_B4_MS} ms at the same ids "
          f"concatenated in another order) | {smi}")
    del state, m, tb

    # -- remesh: a mind checkpoint restored onto the card's mesh ------------
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        host = {k: v.detach() for k, v in model.state_dict().items()}
        _, t_save = wall(lambda: mgr.save(1, host))
        (_, restored, _), t_restore = wall(lambda: mgr.restore(device="cpu"))
        specs = configs.param_specs(spec, host, mesh)
        placed, t_remesh = wall(lambda: elastic.remesh(restored, specs, mesh))
        for k, v in host.items():
            if not (placed[k].device_mesh == mesh and torch.equal(
                    placed[k].full_tensor(), v)):
                raise AssertionError(f"remesh of {k} differs from the saved "
                                     "tensor")
        print(f"[runtime] remesh: mind's {len(host)} tensors "
              f"({sum(v.numel() * 4 for v in host.values()) / 2**30:.2f} "
              f"GiB) saved ({t_save:.2f}s), restored on the host "
              f"({t_restore:.2f}s) and remeshed onto the card's mesh under "
              f"{ {k: tuple(s) for k, s in specs.items()} } "
              f"({t_remesh:.2f}s): bit-equal | {smi}")
    del model, host, restored, placed
    torch.cuda.empty_cache()

    # -- the a2a MoE on qwen2-moe's layer 0 ----------------------------------
    spec = configs.get(MOE_ARCH)
    cfg = spec.model_cfg
    mc, L = cfg.moe, cfg.n_layer
    E, K = mc.e_total, mc.top_k
    seq = RUNTIME_MOE_SEQ
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
    model, t_init = wall(lambda: tfm.init_params(cfg, gen, device=dev))
    toks = torch.randint(0, cfg.vocab, (1, seq), generator=gen, device=dev)
    p0 = model.layers[0]
    pos = torch.arange(seq, dtype=torch.int32, device=dev)[None, :]
    with torch.inference_mode():
        x = model.embed[toks]
        x = x + tfm.attention_block(p0, cfg, tfm.rms_norm(x, p0.ln1), pos,
                                    tfm.partition_of(model))
        h = tfm.rms_norm(x, p0.ln2)
    a2a = make_a2a_moe(mesh, dp)
    C8 = a2a_capacity(mc, seq)
    kern = RoutePattern()
    sm.reset_counts()
    shd.reset_collectives()
    with contextlib.ExitStack() as stack, torch.inference_mode():
        for patch in kern.patches():
            stack.enter_context(patch)
        got, aux = a2a(p0.moe, cfg, h)
    b5_layer = sm.matmul.launches
    want_b5 = 1 + 3 * E + (2 * mc.n_shared + 1 if mc.n_shared else 0)
    if b5_layer != want_b5:
        raise AssertionError(f"the a2a layer launched B5 {b5_layer} times, "
                             f"not {want_b5}")
    launched["b5"] += b5_layer
    coll_a2a = shd.collective_counts()
    with contextlib.ExitStack() as stack, torch.inference_mode():
        for patch in plain_ops() + kern.patches(replay=True):
            stack.enter_context(patch)
        want, want_aux = a2a(p0.moe, cfg, h)
    err_plain = rel_err(got, want)
    if not (err_plain <= RUNTIME_MOE_TOL and abs(float(aux) - float(
            want_aux)) <= 1e-4 * abs(float(want_aux))):
        raise AssertionError(f"the a2a layer against its plain versions: "
                             f"{err_plain} of max|out|, aux {float(aux)} "
                             f"against {float(want_aux)}")
    dropped = [int(d) for d in kern.drops]
    _, C32 = tfm.capacity(mc, seq)
    t_a2a = {"a2a": call_times(lambda: a2a(p0.moe, cfg, h), iters=5),
             "moe_ffn": call_times(lambda: tfm.moe_ffn(p0.moe, cfg, h),
                                   iters=5)}
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        mc, capacity_factor=8.0))
    sm.reset_counts()
    with torch.inference_mode():
        w_a2a, _ = a2a(p0.moe, wide, h)
        w_ffn, _ = tfm.moe_ffn(p0.moe, wide, h)
    launched["b5"] += sm.matmul.launches
    err_wide = rel_err(w_a2a, w_ffn)
    if not err_wide <= RUNTIME_MOE_TOL:
        raise AssertionError(f"the a2a layer at capacity 8.0 against "
                             f"moe_ffn: {err_wide} of max|out|")
    print(f"[runtime] {MOE_ARCH} layer 0's MoE on the prefill operands "
          f"(1 x {seq}) through make_a2a_moe on the card's mesh: B5 "
          f"{b5_layer} launches (router 1, experts {3 * E}, shared "
          f"{2 * mc.n_shared + 1}; moe_ffn's experts {3 * E}), collectives "
          f"{coll(coll_a2a)}; capacity C = {C8} (multiple of 8; moe_ffn's "
          f"{C32}, multiple of 32), {dropped[0]:,} of {seq * K:,} "
          f"assignments dropped ({dropped[1]:,} in the replayed plain run); "
          f"against its plain versions with the routes replayed "
          f"{err_plain:.3e} of max|out| (tolerance {RUNTIME_MOE_TOL}), aux "
          f"{float(aux):.6f} against {float(want_aux):.6f}; at "
          f"capacity_factor 8.0 (nothing dropped) against moe_ffn "
          f"{err_wide:.3e} of max|out|; one layer {show(t_a2a)} | {smi}")
    del got, want, w_a2a, w_ffn, x, h

    # -- the full prefill with the hooks and the a2a -------------------------
    prefill = configs.make_serve_step(spec, "prefill_32k", wide)
    model.cfg = wide
    sm.reset_counts()
    today, t_today = wall(lambda: prefill(model, {"tokens": toks}))
    b5_today = sm.matmul.launches
    tfm.set_moe_impl(a2a)
    tfm.set_activation_sharding(shd.named(mesh, shd.P(dp, None, None)))
    tfm.set_moe_sharding((shd.named(mesh, shd.P(None, dp, None)),
                          shd.named(mesh, shd.P(None, dp, "model"))))
    tfm.set_weight_use_sharding({
        "attn.wq": shd.named(mesh, shd.P(None, "model")),
        "moe.wi": shd.named(mesh, shd.P(None, None, "model"))})
    try:
        sm.reset_counts()
        shd.reset_collectives()
        hooked, t_hooked = wall(lambda: prefill(model, {"tokens": toks}))
        b5_hooked = sm.matmul.launches
        coll_pre = shd.collective_counts()
    finally:
        tfm.set_moe_impl(None)
        tfm.set_activation_sharding(None)
        tfm.set_moe_sharding(None)
        tfm.set_weight_use_sharding(None)
        model.cfg = cfg
    launched["b5"] += b5_today + b5_hooked
    err_pre = rel_err(hooked, today)
    if not (err_pre <= RUNTIME_MOE_TOL and bool(torch.isfinite(hooked).all())):
        raise AssertionError(f"the prefill with the a2a and the hooks: "
                             f"{err_pre} of max|logit| from today's")
    print(f"[runtime] prefill 1 x {seq} of {MOE_ARCH} ({L} layers, "
          f"capacity_factor 8.0 in both: the a2a rounds C to 8 and moe_ffn "
          f"to 32, so at 1.25 they would drop different assignments) with "
          f"set_moe_impl(a2a) and the activation, MoE and weight hooks set "
          f"on the card's mesh: logits within {err_pre:.3e} of max|logit| "
          f"of today's prefill (tolerance {RUNTIME_MOE_TOL}), top-1 "
          f"agreement {top1(hooked, today):.4f}; B5 {b5_hooked} launches "
          f"({(b5_hooked - 1) // L} a layer) against today's {b5_today} "
          f"({(b5_today - 1) // L} a layer; the experts' {3 * E} in both); "
          f"collectives {coll(coll_pre)}; {t_hooked:.3f}s against "
          f"{t_today:.3f}s | {smi}")
    del today, hooked, model
    torch.cuda.empty_cache()

    # -- the compressed mean over a MoE train step's gradients ----------------
    cut = dataclasses.replace(cfg, n_layer=RUNTIME_GRAD_LAYERS)
    small = tfm.init_params(cut, gen, device=dev)
    tt = torch.randint(0, cut.vocab, (1, RUNTIME_GRAD_SEQ + 1),
                       generator=gen, device=dev)
    sm.reset_counts()
    _, grads = loss_and_grads(spec, cut, small, {
        "tokens": tt[:, :-1].contiguous(), "labels": tt[:, 1:].contiguous()})
    launched["b5"] += sm.matmul.launches
    launched["b5_grad"] += sm.matmul_grads.launches
    errors = compression.init_error_state(grads)
    reduce = compression.make_compressed_grad_allreduce(mesh, axis="data")
    shd.reset_collectives()
    means, new_errors = reduce(grads, errors)
    coll_comp = shd.collective_counts()
    worst = 0.0
    for k, g in grads.items():
        q, s, e = compression.compress_update(g, errors[k])
        if not (torch.equal(new_errors[k], e)
                and torch.equal(means[k], compression.dequantize(q, s))):
            raise AssertionError(f"the compressed mean of {k} differs from "
                                 "compress_update's")
        off = float((means[k] - g.float()).abs().max() / s)
        if not off <= 0.51:
            raise AssertionError(f"the compressed mean of {k} is {off} "
                                 f"scales from its gradient")
        worst = max(worst, off)
    t_comp = call_times(lambda: reduce(grads, errors), iters=5)
    n_el = sum(g.numel() for g in grads.values())
    print(f"[runtime] compressed mean over the data axis of a {MOE_ARCH} "
          f"train step's gradients ({RUNTIME_GRAD_LAYERS} layers at full "
          f"width, 1 x {RUNTIME_GRAD_SEQ} tokens: {len(grads)} tensors, "
          f"{n_el:,} values): q, scale and the new error equal "
          f"compress_update's, every mean within {worst:.4f} scales of its "
          f"gradient (bound 0.51); collectives {coll(coll_comp)}; "
          f"{t_comp[1]} for all {len(grads)} tensors | {smi}")
    del small, grads, means, new_errors, errors
    torch.cuda.empty_cache()

    # -- the dry run on the card's mesh ----------------------------------------
    cells = list(configs.all_cells())
    firsts = {}                    # a serving cell of each family, if any
    for aid, shape in cells:
        fam = configs.get(aid).family
        serving = configs.get(aid).shapes[shape]["kind"] != "train"
        if fam not in firsts or (serving and configs.get(
                firsts[fam][0]).shapes[firsts[fam][1]]["kind"] == "train"):
            firsts[fam] = (aid, shape)
    firsts = list(firsts.values())
    rest = [c for c in cells if c not in firsts]
    order = firsts + sorted(rest, key=lambda c: configs.get(c[0]).shapes[
        c[1]]["kind"] == "train")  # serving cells trace faster
    reset_b4_b5()
    recs, t0 = [], time.perf_counter()
    for aid, shape in order:
        if len(recs) >= len(firsts) and \
                time.perf_counter() - t0 > RUNTIME_DRYRUN_S:
            break
        recs.append(dryrun.run_cell(aid, shape, mesh=mesh, verbose=False))
    t_dry = time.perf_counter() - t0
    if (sm.matmul.launches, sm.segment_sum.launches) != (0, 0):
        raise AssertionError("the dry run's meta trace launched a kernel")
    print(f"[runtime] dry run on the card's mesh (meta tensors, the NCCL "
          f"group): {len(recs)} of {len(cells)} cells in {t_dry:.1f}s (a "
          f"serving cell of each family first, then more while under "
          f"{RUNTIME_DRYRUN_S:.0f}s; python -m repro_torch.launch.dryrun "
          f"--all runs every cell) | {smi}")
    print(report.dryrun_table(recs))
    print(report.roofline_table(recs, "1x1"))
    print(report.production_table(recs))
    print(f"[runtime] phase {time.perf_counter() - t_phase:.1f}s | {smi}")
    return {"b5": launched["b5"], "b5_grad": launched["b5_grad"],
            "b4": launched["b4"], "b5_err": err_plain}

#: [contracts]: the seed of the armed main path's queries, and the pairs of
#: calls (one of each variant) in the disarmed host-cost timing and how many
#: calls run between two synchronisations
CONTRACTS_SEED = 41
CONTRACTS_CALLS = 1000
CONTRACTS_BLOCK = 100
#: the host time the disarmed wrapper (one environment read) may add to a
#: call, in us
CONTRACTS_HOST_US = 2.0
#: the full-width operands: glm4-9b's d_model and decode cache slots,
#: minibatch_lg's padded nodes and edges
CONTRACTS_D_MODEL = 4096
CONTRACTS_CACHE = 32_768
CONTRACTS_GNN = (169_984, 337_920)


def disarmed_host_us(decorated, wrapped) -> dict:
    """Host us of one call of a decorated wrapper and of its undecorated
    ``__wrapped__``, disarmed: CONTRACTS_CALLS pairs of calls, one of each
    back to back, the decorated one first in even pairs and second in odd
    ones, each call timed alone on the host clock; the card synchronised
    (untimed) every CONTRACTS_BLOCK calls, so the launch queue never fills
    and each time is the host's. The wrapper's cost is the median of the
    pairs' differences: the two calls of a pair share the host's load,
    which the difference cancels, and the alternating order cancels what
    the first call of a pair pays for the second. The median of each and
    of the differences, with the 10th and 90th percentiles beside them."""
    per = {"decorated": [], "wrapped": [], "added": []}
    clock = time.perf_counter_ns
    decorated(), wrapped()
    for i in range(CONTRACTS_CALLS):
        if i % (CONTRACTS_BLOCK // 2) == 0:
            torch.cuda.synchronize()
        pair = (("decorated", decorated), ("wrapped", wrapped))
        took = {}
        for name, fn in pair[::-1] if i % 2 else pair:
            t0 = clock()
            fn()
            took[name] = (clock() - t0) / 1e3
            per[name].append(took[name])
        per["added"].append(took["decorated"] - took["wrapped"])
    torch.cuda.synchronize()
    return {k: tuple(float(x) for x in np.percentile(v, (50, 10, 90)))
            for k, v in per.items()}


def contracts_phase(g, dev, smi: str) -> dict:
    """[contracts]: the kernel-contract witness (and the lock witness)
    armed over the TCCS main path and every kernel.

    With ``REPRO_KERNEL_WITNESS=1`` and ``REPRO_LOCK_WITNESS=1`` set for
    the phase: the card build of ``g`` (``stratified_core_times`` on the
    device engine: the sweep and the fixpoints of the k range;
    ``build_stratified_index``), ``to_device`` (the layout checked on
    upload) and one batch of BUCKET mixed-k queries through
    ``serving/executor.py`` (``launch.serve.answer_batch``: B1 rounds to
    the fixpoint), counted, every answer equal to Algorithm 1; then every
    other contract once at full-width operands the earlier phases use
    (B2 and its bisection on the sweep's first operands, B3a/B3b on the
    graph's edges, B5 at glm4's prefill, decode and GraphSAGE's head on
    the wgmma, skinny and f32 routes, B6 at glm4's prefill and decode on
    wgmma and split, B6's backward at the prefill, B4 and its gather at
    minibatch_lg's dims, both probes). Requires no witness problem, a
    clean layout, every contract recorded and no lock-hierarchy problem;
    prints calls and the largest declared shared memory per contract.
    Then, disarmed, the host us per call of ``matmul`` at glm4's decode
    shape (skinny) and of ``label_prop_round`` at the batch's (B, N)
    against their undecorated ``__wrapped__``: the wrapper may add at most
    CONTRACTS_HOST_US."""
    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core.pecb_index import build_stratified_index
    from repro_torch.core.query_api import ResultMode, TCCSQuery
    from repro_torch.core.temporal_graph import random_queries
    from repro_torch.kernels import (contracts, flash_attention, kcore_peel,
                                     label_prop, segment_matmul,
                                     segmented_select)
    from repro_torch.launch import serve
    from repro_torch.obs import locks

    t_start = time.perf_counter()
    flags = ("REPRO_KERNEL_WITNESS", "REPRO_LOCK_WITNESS")
    saved = {k: os.environ.get(k) for k in flags}
    os.environ.update(dict.fromkeys(flags, "1"))
    contracts.WITNESS.reset()
    locks.WITNESS.reset()
    try:
        # -- the main path, armed and counted ------------------------------
        label_prop.label_prop_round.launches = 0
        segmented_select.reset_sweep_counts()
        kcore_peel.kcore_fixpoint.launches = 0
        t0 = time.perf_counter()
        strata = ct.stratified_core_times(g, engine="device", device=dev)
        sx = build_stratified_index(g, strata=strata, device=dev)
        dix = bq.to_device(sx, dev)
        t_build = time.perf_counter() - t0
        layout = contracts.check_layout(bq._host_layout(sx)[1])
        rng = np.random.default_rng(CONTRACTS_SEED)
        ks = rng.choice(np.asarray(sx.supported_ks), BUCKET).tolist()
        specs = [TCCSQuery(u, ts, te, k, ResultMode.VERTICES)
                 for (u, ts, te), k in zip(
                     random_queries(g, BUCKET, seed=CONTRACTS_SEED), ks)]
        stats: dict = {}
        t0 = time.perf_counter()
        results = serve.answer_batch(sx, dix, specs, max_batch=BUCKET,
                                     stats=stats)
        t_batch = time.perf_counter() - t0
        launches = {"stratum_sweep": segmented_select.stratum_sweep.launches,
                    "kcore_fixpoint": kcore_peel.kcore_fixpoint.launches,
                    "label_prop_round": label_prop.label_prop_round.launches}
        sweeps = -(-g.t_max // ct.TUV_BLOCK)
        if launches["stratum_sweep"] != sweeps:
            raise AssertionError(f"[contracts] the card build made "
                                 f"{launches['stratum_sweep']} stratum_sweep "
                                 f"launches, expected {sweeps}")
        if launches["kcore_fixpoint"] <= 0:
            raise AssertionError("[contracts] the card build peeled no k "
                                 "range on the card")
        rounds = stats.get("rounds", [])
        if launches["label_prop_round"] <= 0 \
                or launches["label_prop_round"] != sum(rounds):
            raise AssertionError(f"[contracts] the batch made "
                                 f"{launches['label_prop_round']} B1 "
                                 f"launches for the rounds {rounds}")
        bad = [i for i, (q, r) in enumerate(zip(specs, results))
               if not serve._matches(sx, q, r)]
        if bad:
            raise AssertionError(f"[contracts] {len(bad)} of {BUCKET} "
                                 f"answers differ from Algorithm 1 "
                                 f"({bad[:5]})")
        print(f"[contracts] main path armed: the card build ({t_build:.2f}s:"
              f" stratum_sweep launches {launches['stratum_sweep']}, "
              f"kcore_fixpoint launches {launches['kcore_fixpoint']}), "
              f"to_device, {BUCKET} mixed-k queries (k in {min(ks)}.."
              f"{max(ks)}) through serving/executor.py in {t_batch:.3f}s, "
              f"B1 launches {launches['label_prop_round']} = rounds "
              f"{rounds}; all {BUCKET} answers equal to Algorithm 1, 0 "
              f"mismatches; layout check "
              f"{'clean' if not layout else layout} "
              f"({len(contracts.LAYOUT_CONTRACTS)} arrays)")

        # -- every other contract, at the earlier phases' operands ----------
        gen = torch.Generator(device=dev).manual_seed(CONTRACTS_SEED)

        def randn(*shape, dtype=torch.bfloat16):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        csr = ct._pair_csr(g)
        n = g.n
        seg = torch.as_tensor(csr.src, device=dev)
        tuv1 = torch.as_tensor(np.ascontiguousarray(
            ct._tuv_rows(csr, 1, 2, g.t_max)[0]), device=dev)
        c0 = torch.zeros(n, dtype=torch.int32, device=dev)
        w1 = torch.maximum(tuv1, c0[torch.as_tensor(csr.dst, device=dev)
                                    .long()])
        segmented_select.segmented_count_le(w1, seg, c0, n)
        segmented_select.kth_smallest(w1, seg, n, int(sx.ks[0]),
                                      g.t_max + 1)
        src_e = torch.as_tensor(g.src, device=dev)
        dst_e = torch.as_tensor(g.dst, device=dev)
        alive_e = torch.as_tensor(rng.random(g.m) < 0.7, device=dev)
        deg = kcore_peel.degree_count(src_e, dst_e, alive_e, n)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        kcore_peel.peel_threshold(src_e, dst_e, alive_e, deg, int(sx.ks[0]),
                                  changed=flag)
        d_model = CONTRACTS_D_MODEL
        w_q = randn(d_model, d_model)
        x_decode = randn(LM_DECODE_BATCH, d_model)
        for a, b in ((randn(256, d_model), w_q), (x_decode, w_q),
                     (randn(1024, 128, dtype=torch.float32),
                      randn(128, 41, dtype=torch.float32))):
            segment_matmul.matmul(a, b)
        q = randn(1, LM_SEQ, 32, 128)
        kv = randn(1, LM_SEQ, 2, 128)
        o, lse = flash_attention.flash_attention(q, kv, kv, causal=True,
                                                 return_lse=True)
        flash_attention.flash_attention_bwd(q, kv, kv, o, torch.ones_like(o),
                                            causal=True, lse=lse)
        cache = randn(LM_DECODE_BATCH, CONTRACTS_CACHE, 2, 128)
        flash_attention.flash_attention(randn(LM_DECODE_BATCH, 1, 32, 128),
                                        cache, cache, t_real=LM_SEQ + 8)
        del q, kv, o, lse, cache
        gnn_n, gnn_e = CONTRACTS_GNN
        vals = randn(gnn_e, 128, dtype=torch.float32)
        ids = torch.randint(-1, gnn_n + 8, (gnn_e,), generator=gen,
                            device=dev, dtype=torch.int32)
        sums = segment_matmul.segment_sum(vals, ids, gnn_n)
        segment_matmul.segment_gather(sums, ids)
        segment_matmul.wgmma_probe(randn(64, 16), randn(16, 128))
        flash_attention.rs_probe(randn(64, 128), randn(128, 128),
                                 randn(128, 128))
        torch.cuda.synchronize()
        del vals, sums
        rep = contracts.WITNESS.report()
        lock_rep = locks.WITNESS.report()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rep["problems"]:
        raise contracts.KernelContractViolation(
            f"[contracts] the armed witness found {len(rep['problems'])} "
            f"problem(s): {json.dumps(rep['problems'])[:2000]}")
    missing = sorted(set(contracts.CONTRACTS) - set(rep["kernels"]))
    if missing:
        raise AssertionError(f"[contracts] contracts never called: "
                             f"{missing}")
    if layout:
        raise AssertionError(f"[contracts] layout problems: {layout}")
    if lock_rep["problems"]:
        raise AssertionError(f"[contracts] lock hierarchy problems: "
                             f"{lock_rep['problems']}")
    for route, fn in (("wgmma", segment_matmul.matmul),
                      ("skinny", segment_matmul.matmul),
                      ("f32", segment_matmul.matmul),
                      ("wgmma", flash_attention.flash_attention),
                      ("split", flash_attention.flash_attention),
                      ("wgmma", flash_attention.flash_attention_bwd)):
        if fn.routes[route] <= 0:
            raise AssertionError(f"[contracts] {fn.__name__} never took its "
                                 f"{route} route")
    calls = {k: v["calls"] for k, v in rep["kernels"].items()}
    smem = {k: v["max_smem"] for k, v in rep["kernels"].items()}
    print(f"[contracts] witness armed: {rep['calls']} calls, "
          f"{len(rep['kernels'])} of {len(contracts.CONTRACTS)} contracts "
          f"recorded, 0 problems; calls per contract {calls}")
    print(f"[contracts] largest declared dynamic shared memory per block "
          f"(bytes; None: not known to the wrapper), limit "
          f"{contracts.SMEM_PER_BLOCK}: {smem}")
    print(f"[contracts] lock witness armed: {len(lock_rep['edges'])} "
          f"acquisition edges observed, 0 problems")

    # -- disarmed: the wrapper's host cost ----------------------------------
    mm = segment_matmul.matmul
    b1 = label_prop.label_prop_round
    ts_t = torch.as_tensor([q.ts for q in specs], dtype=torch.int32,
                           device=dev)
    te_t = torch.as_tensor([q.te for q in specs], dtype=torch.int32,
                           device=dev)
    ops = bq._resolve_links(dix, ts_t, te_t)
    N = ops[3].shape[1]
    lab0 = torch.where(ops[3], torch.arange(N, dtype=torch.int32,
                                            device=dev)[None, :], N)
    cost = {
        f"matmul ({LM_DECODE_BATCH}, {d_model}) @ ({d_model}, {d_model}) "
        f"bf16, {segment_matmul.plan(LM_DECODE_BATCH, d_model, d_model).route}":
        disarmed_host_us(lambda: mm(x_decode, w_q),
                         lambda: mm.__wrapped__(x_decode, w_q)),
        f"label_prop_round ({BUCKET}, {N})": disarmed_host_us(
            lambda: b1(lab0, *ops, changed=flag),
            lambda: b1.__wrapped__(lab0, *ops, changed=flag)),
    }
    parts = []
    for what, c in cost.items():
        parts.append(f"{what}: decorated {c['decorated'][0]:.2f} us "
                     f"(p10 {c['decorated'][1]:.2f}, p90 "
                     f"{c['decorated'][2]:.2f}), __wrapped__ "
                     f"{c['wrapped'][0]:.2f} us (p10 {c['wrapped'][1]:.2f}, "
                     f"p90 {c['wrapped'][2]:.2f}), added "
                     f"{c['added'][0]:.2f} us (p10 {c['added'][1]:.2f}, "
                     f"p90 {c['added'][2]:.2f})")
    print(f"[contracts] disarmed host time per call, {CONTRACTS_CALLS} "
          f"pairs of calls, the order alternating, the card synchronised "
          f"every {CONTRACTS_BLOCK} calls (medians; added: of the pairs' "
          f"differences): " + "; ".join(parts) + f" ({smi})")
    worst = max(c["added"][0] for c in cost.values())
    if worst > CONTRACTS_HOST_US:
        raise AssertionError(f"[contracts] the disarmed wrapper adds "
                             f"{worst:.2f} us a call, above "
                             f"{CONTRACTS_HOST_US} us")
    t_phase = time.perf_counter() - t_start
    print(f"[contracts] phase {t_phase:.1f}s")
    return {"seconds": t_phase, "cost": cost, "calls": calls, "smem": smem}


# ======================================================================
# [mesh]: the dense LM step under the (data, model) mesh
# ======================================================================

MESH_ARCH = "glm4-9b"
MESH_MOE_ARCH = "qwen2-moe-a2.7b"
#: qwen2-moe's experts cut 60 -> 58 for expert TP on four model ranks (2
#: and 4 divide 60, so no four-card mesh runs its experts under TP)
MESH_TP_EXPERTS = 58
MESH_SEED = 47
MESH_SEQ = 4096
#: the sharded-against-one-card checks on several cards: bf16 losses,
#: gradients and parameters, each leaf within this share of its largest
#: |one-card value| (PERF.md section 2's bf16 bound; the key bias takes its
#: wk's scale, as grad_leaf_errs does)
MESH_TOL = TRAIN_GRAD_TOL
#: (data, model) meshes by world size: the 8-layer steps' (the world is
#: every card, 4 at most; two or three cards run a 2-rank world)
MESH_SHAPES = {4: [(2, 2), (1, 4), (4, 1)], 2: [(1, 2), (2, 1)]}
#: the full-depth train step's mesh and the serving mesh (four cards)
MESH_FULL_TRAIN, MESH_FULL_SERVE = (2, 2), (1, 4)
MESH_TRAIN_STEPS = 2
#: the standard deviation of the keys and values in the cache slots past
#: those written at the end-of-cache decode: a read past t_real meets a key
#: whose score dwarfs the written ones'
MESH_SENTINEL = 16.0
#: seconds the rank processes of --multi may take, the build excluded
MESH_RANKS_TIMEOUT_S = 1500
#: the parts of --multi, each run in rank processes of its own (dbrx on
#: four ranks only), the most recently changed first: a part shares
#: nothing with another, so the order changes no result
MESH_PARTS = ("mind", "gnn", "dense", "moe", "dbrx")
#: the ranks' device type: "cuda" (NCCL, rank r on cuda:r); "cpu" (gloo)
#: rehearses them
MESH_DEVICE = "cuda"


_RANK_MESHES: dict = {}


def rank_mesh(shape: tuple, store, rank: int):
    """The ``(data, model)`` mesh of ``shape`` for this rank process, made
    once: every mesh holds its own NCCL communicators (hundreds of MB of
    buffers on each card), and dbrx-132b at full depth on (1, 4) leaves
    only a few GiB beside its weights."""
    from repro_torch.launch.mesh import make_mesh
    if shape not in _RANK_MESHES:
        _RANK_MESHES[shape] = make_mesh(shape, ("data", "model"),
                                        device=MESH_DEVICE, store=store,
                                        rank=rank)
    return _RANK_MESHES[shape]


def mesh_tokens(vocab: int, rows: int, seq: int, seed: int, dev) -> dict:
    """A global batch of ``rows`` sequences from a numpy seed, the same in
    every process (TokenStream's seeds follow PYTHONHASHSEED)."""
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1))
    toks = torch.as_tensor(toks.astype(np.int32), device=dev)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def mesh_counts_line(counts: dict) -> str:
    return ", ".join(f"{kind} {c['calls']} calls {c['bytes'] / 2**30:.3f} GiB"
                     for kind, c in sorted(counts.items())) or "none"


def mesh_phase(dev, smi: str) -> dict:
    """[mesh]: glm4-9b at full width, MESH_LAYERS layers, through the
    partitioner on the card's one-rank NCCL mesh: one prefill of 1 x
    MESH_SEQ and one train step (make_serve_step / make_train_step with
    ``mesh``), counted, each bit-equal to the unsharded one's (logits,
    loss, norm, lr, every parameter and both moments); the collectives per
    step; B5 and B6 at the local shapes the partitioned path gives them on
    2 and 4 model ranks (the ragged N of ffn.wi among them) against their
    plain versions, timed. Returns the launches and the kernel results."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd

    t_phase = time.perf_counter()
    spec = configs.get(MESH_ARCH)
    cfg = dataclasses.replace(spec.model_cfg, n_layer=TRAIN_LAYERS)
    L = cfg.n_layer
    batch = mesh_tokens(cfg.vocab, 1, MESH_SEQ, MESH_SEED, dev)
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    torch.cuda.reset_peak_memory_stats()

    # -- the unsharded step and prefill ------------------------------------
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    model = configs.init_params(spec, cfg, gen, device=dev)
    want_logits = configs.make_serve_step(spec, "prefill_32k", cfg)(
        model, {"tokens": batch["tokens"]})
    state = adamw.init_state(dict(model.named_parameters()))
    _, state, want = configs.make_train_step(spec, cfg, opt_cfg)(
        model, state, batch)
    want_moments = {k: {n: t.cpu() for n, t in state[k].items()}
                    for k in ("mu", "nu")}
    del state
    torch.cuda.empty_cache()

    # -- the same through the partitioner, counted ---------------------------
    mesh = make_smoke_mesh("cuda")
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    placed = configs.init_params(spec, cfg, gen, device=dev, mesh=mesh)
    prefill = configs.make_serve_step(spec, "prefill_32k", cfg, mesh=mesh)
    step = configs.make_train_step(spec, cfg, opt_cfg, mesh=mesh)
    state = adamw.init_state(dict(placed.named_parameters()))
    sm.reset_counts()
    fa.reset_counts()
    fa.reset_bwd_counts()
    shd.reset_collectives()
    t0 = time.perf_counter()
    logits = prefill(placed, {"tokens": batch["tokens"]})
    pre_counts = shd.collective_counts()
    shd.reset_collectives()
    _, state, got = step(placed, state, batch)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    step_counts = shd.collective_counts()
    b5, b5_grad = sm.matmul.launches, sm.matmul_grads.launches
    b6, b6_bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    want_b5 = (7 * L + 1) + (28 * L + 3)
    if (b5, b5_grad, b6, b6_bwd) != (want_b5, 14 * L + 2, 3 * L, L):
        raise AssertionError(
            f"[mesh] the partitioned prefill and step launched B5 {b5} "
            f"(gradients {b5_grad}), B6 {b6} and its backward {b6_bwd} "
            f"times, not {(want_b5, 14 * L + 2, 3 * L, L)}")
    if not torch.equal(logits, want_logits):
        raise AssertionError("[mesh] the one-rank partitioned prefill is "
                             "not bit-equal to the unsharded one")
    for k in ("loss", "grad_norm", "lr"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"[mesh] the one-rank step's {k} "
                                 f"{float(got[k])} != {float(want[k])}")
    whole = dict(model.named_parameters())
    for n, p in placed.named_parameters():
        if not torch.equal(p, whole[n]):
            raise AssertionError(f"[mesh] parameter {n} after the one-rank "
                                 "step is not bit-equal to the unsharded")
    for k, moments in want_moments.items():
        for n, t in moments.items():
            if not torch.equal(state[k][n], t.to(dev)):
                raise AssertionError(f"[mesh] moment {k} {n} after the "
                                     "one-rank step is not bit-equal")
    n_params = sum(p.numel() for p in placed.parameters())
    print(f"[mesh] {MESH_ARCH} at full width cut to {L} layers "
          f"({n_params:,} parameters, bf16, drawn leaf by leaf from seed "
          f"{MESH_SEED} and placed as drawn) on the card's one-rank NCCL "
          f"mesh {shd.axis_sizes(mesh)} through the partitioner: prefill 1 x "
          f"{MESH_SEQ} (make_serve_step(mesh=)) bit-equal to the unsharded "
          f"prefill's logits; one train step (make_train_step(mesh=)) "
          f"bit-equal in loss {float(got['loss']):.6f}, grad_norm "
          f"{float(got['grad_norm']):.6f}, lr {float(got['lr']):.3e}, every "
          f"parameter and both moments; launches B5 {b5} ({7 * L + 1} "
          f"prefill + {28 * L + 3} step), its gradient {b5_grad}, B6 {b6}, "
          f"its backward {b6_bwd}; {t_run:.2f}s for both | {smi}")
    print(f"[mesh] collectives on the one-rank mesh (calls, result bytes; "
          f"the partitioner makes none over an axis of one rank): prefill "
          f"{mesh_counts_line(pre_counts)}; train step "
          f"{mesh_counts_line(step_counts)}. One card is visible: no exchange "
          f"between ranks was exercised (python3 chip_smoke.py --multi on "
          f"four cards runs it) | {smi}")
    del model, placed, state, logits, want_logits, want_moments, whole
    torch.cuda.empty_cache()

    # -- B5 and B6 at the partitioned path's local shapes --------------------
    g = torch.Generator(device=dev).manual_seed(MESH_SEED + 1)
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.d_head

    def rand(*shape):
        return (torch.randn(shape, generator=g, device=dev) *
                shape[0] ** -0.5).to(torch.bfloat16)

    h = rand(MESH_SEQ, d)
    b5_cases = {}
    for m in (2, 4):
        b5_cases[f"mesh wq N = {cfg.n_head * dh // m} (model {m})"] = (
            h, rand(d, cfg.n_head * dh // m))
        b5_cases[f"mesh ffn.wi ragged N = {f // m} (model {m})"] = (
            h, rand(d, f // m))
        b5_cases[f"mesh ffn.wo ragged K = {f // m} (model {m})"] = (
            rand(MESH_SEQ, f // m), rand(f // m, d))
    b5_cases["mesh wk N = 256 gathered (model 4)"] = (h, rand(d, 256))
    b5_cases[f"mesh head N = {cfg.vocab // 4} (model 4)"] = (
        h, rand(d, cfg.vocab // 4))
    q = torch.randn(1, MESH_SEQ, cfg.n_head // 2, dh, generator=g,
                    device=dev).to(torch.bfloat16)
    k, v = (torch.randn(1, MESH_SEQ, 1, dh, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    b6_cases = {f"mesh causal {cfg.n_head // 2} heads over 1 (model 2)":
                (q, k, v, True, MESH_SEQ),
                f"mesh causal {cfg.n_head // 4} heads over 1 (model 4)":
                (q[:, :, :cfg.n_head // 4].contiguous(), k, v, True,
                 MESH_SEQ)}
    results = kernel_checks(b5_cases, b6_cases, tag="mesh")
    del h, q, k, v, b5_cases, b6_cases
    torch.cuda.empty_cache()
    moe = mesh_moe_phase(dev, smi)
    mind = mesh_mind_phase(dev, smi)
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f}s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
          f"{smi}")
    return {"b5": b5 - b5_grad + moe["b5"] + mind["b5"],
            "b5_grad": b5_grad + moe["b5_grad"] + mind["b5_grad"],
            "b6": b6 + moe["b6"], "b6_bwd": b6_bwd + moe["b6_bwd"],
            "b4": mind["b4"], "b4_err": mind["b4_err"],
            "b5_err": max([r["max_abs_err"] for r in results.values()
                           if r["b5"]] + [moe["b5_err"], mind["b5_err"]])}


#: the four-card meshes whose local MIND shapes [mesh] times on one card:
#: (data, model)
MESH_MIND_LOCAL = ((4, 1), (2, 2), (1, 4))


def mesh_mind_phase(dev, smi: str) -> dict:
    """[mesh]'s MIND: mind at full width (the 2 GiB table) through its
    partition (``models.recsys.Partition``) on the card's one-rank NCCL
    mesh: one train step of train_batch (launch.train's batch) and one
    serve_p99 call (make_train_step / make_serve_step with ``mesh``),
    counted (MIND_LAUNCHES), each bit-equal to the unsharded one's (loss,
    norm, lr, scores, S, item_embed and both moments), with no
    collective; then B4 and B5 at the local shapes of the four-card meshes
    (MESH_MIND_LOCAL: the table gradient over a rank's (B / data)(H + 1)
    ids into n / model rows, the ids outside the shard -1; emb @ S, the
    logits and their two gradient products, S's gradient and retrieval's
    scores on B / data users) against their plain versions, bounds and
    the PyTorch calls. Returns the launches and the largest errors."""
    from repro_torch import configs
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd

    torch.backends.cuda.matmul.allow_tf32 = False    # the plain versions' f32
    spec = configs.get(MIND_ARCH)
    cfg = configs.cell_model_cfg(spec, "train_batch")
    dims = spec.shapes["train_batch"]
    B, H, d = dims["batch"], cfg.hist_len, cfg.embed_dim
    batch = train_cli.make_batch_fn(spec, cfg, dims, dev)(0)
    sdims = spec.shapes["serve_p99"]
    req = mind_requests(cfg, sdims["batch"], sdims["cands"], MESH_SEED, dev)
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    torch.cuda.empty_cache()

    # -- the unsharded serve call and step --------------------------------
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    model = configs.init_params(spec, cfg, gen, device=dev)
    want_scores = configs.make_serve_step(spec, "serve_p99")(model, req)
    state = adamw.init_state(dict(model.named_parameters()))
    _, state, want = configs.make_train_step(spec, cfg, opt_cfg)(
        model, state, batch)

    # -- the same through the partition, counted -----------------------------
    mesh = make_smoke_mesh("cuda")
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    placed = configs.init_params(spec, cfg, gen, device=dev, mesh=mesh)
    pstate = adamw.init_state(dict(placed.named_parameters()))
    reset_b4_b5()
    shd.reset_collectives()
    (scores, t_serve) = wall(lambda: configs.make_serve_step(
        spec, "serve_p99", mesh=mesh)(placed, req))
    n_serve = mind_counted(MIND_LAUNCHES["serve"], "[mesh] mind serve_p99")
    serve_counts = shd.collective_counts()
    reset_b4_b5()
    shd.reset_collectives()
    (_, pstate, got), t_step = wall(lambda: configs.make_train_step(
        spec, cfg, opt_cfg, mesh=mesh)(placed, pstate, batch))
    n_step = mind_counted(MIND_LAUNCHES["train"], "[mesh] mind train step")
    step_counts = shd.collective_counts()
    apart = [k for k in ("loss", "grad_norm", "lr")
             if not torch.equal(got[k], want[k])]
    if not torch.equal(scores, want_scores):
        apart.append("serve_p99 scores")
    whole = dict(model.named_parameters())
    apart += [n for n, p in placed.named_parameters()
              if not torch.equal(p, whole[n])]
    apart += [f"{k} {n}" for k in ("mu", "nu") for n in state[k]
              if not torch.equal(pstate[k][n], state[k][n])]
    if apart or serve_counts or step_counts:
        raise AssertionError(f"[mesh] mind on the one-rank mesh: not "
                             f"bit-equal in {apart}; collectives "
                             f"{serve_counts}, {step_counts}")
    print(f"[mesh] {MIND_ARCH} at full width ({cfg.n_items:,} items x {d}, "
          f"f32) placed on the card's one-rank NCCL mesh "
          f"{shd.axis_sizes(mesh)} through its partition: serve_p99 "
          f"({sdims['batch']} x {sdims['cands']}; make_serve_step(mesh=)) "
          f"bit-equal to the unsharded scores, {t_serve * 1e3:.3f} ms, "
          f"launched {mind_clause(n_serve)}; one train step of {B:,} users "
          f"(make_train_step(mesh=)) bit-equal in loss "
          f"{float(got['loss']):.6f}, grad_norm "
          f"{float(got['grad_norm']):.6e}, lr {float(got['lr']):.3e}, S, "
          f"item_embed and both moments, {t_step:.4f}s (the first), "
          f"launched {mind_clause(n_step)}; collectives: none (the "
          f"partition exchanges nothing over an axis of one rank) | {smi}")
    del model, placed, state, pstate, whole, scores, want_scores
    torch.cuda.empty_cache()

    # -- B4 and B5 at the four-card meshes' local shapes ---------------------
    g = torch.Generator(device=dev).manual_seed(MESH_SEED + 2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    ids = torch.cat([batch["hist_ids"], batch["target_id"][:, None]], dim=1)
    C = spec.shapes["retrieval_cand"]["cands"]
    b4_cases, b5 = {}, {}
    for D, M in MESH_MIND_LOCAL:
        rows = cfg.n_items // M
        loc = ids[:B // D].reshape(-1).long()
        loc = torch.where(loc < rows, loc, -1)
        b4_cases[f"item table gradient on ({D}, {M}): a rank's "
                 f"{loc.numel():,} ids ({B // D:,} users x {H + 1}), "
                 f"{int((loc >= 0).sum()):,} in its {rows:,} rows"] = (
            torch.randint(-4, 5, (loc.numel(), d), generator=g,
                          device=dev).float(), loc, rows)
    b4 = b4_checks(b4_cases, tag="mesh")
    del b4_cases
    torch.cuda.empty_cache()
    for D in sorted({D for D, _ in MESH_MIND_LOCAL if D > 1}):
        u = B // D
        for name, (sa, sb) in {
                f"mind emb @ S ({u:,} users, data {D})": ((u * H, d), (d, d)),
                f"mind logits user @ tgt^T (data {D})": ((u, d), (d, B)),
                f"mind d user = dlogits @ tgt (data {D})": ((u, B), (B, d)),
                f"mind d tgt^T = user^T @ dlogits (data {D})": ((d, u),
                                                               (u, B)),
                f"mind S gradient (data {D})": ((d, u * H), (u * H, d)),
                f"mind retrieval cand @ interests^T (data {D})": (
                    (C // D, d), (d, cfg.n_interests))}.items():
            b5.update(kernel_checks({name: (randn(*sa), randn(*sb))}, {},
                                    tag="mesh"))
            torch.cuda.empty_cache()
    return {"b5": n_serve[0] + n_step[0] - n_step[1], "b5_grad": n_step[1],
            "b4": n_step[2],
            "b4_err": max(r["max_abs_err"] for r in b4.values()),
            "b5_err": max(r["max_abs_err"] for r in b5.values())}


def mesh_moe_phase(dev, smi: str) -> dict:
    """[mesh]'s MoE layer: qwen2-moe-a2.7b at full width, MOE_TRAIN_LAYERS
    layers, through the partitioner on the card's one-rank NCCL mesh: one
    prefill of 1 x MESH_SEQ and one train step, counted, each bit-equal to
    the unsharded one's (logits, loss, norm, lr, every parameter and both
    moments), with no collective; B5 at the local expert shapes of the
    four-card runs (EP with C over 2 data ranks, expert TP on 4 model
    ranks) against its plain version, its bound and torch.matmul. Returns
    the launches and B5's largest error."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd

    t0 = time.perf_counter()
    spec = configs.get(MESH_MOE_ARCH)
    cfg = dataclasses.replace(spec.model_cfg, n_layer=MOE_TRAIN_LAYERS)
    m, L = cfg.moe, cfg.n_layer
    batch = mesh_tokens(cfg.vocab, 1, MESH_SEQ, MESH_SEED, dev)
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)

    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    model = configs.init_params(spec, cfg, gen, device=dev)
    want_logits = configs.make_serve_step(spec, "prefill_32k", cfg)(
        model, {"tokens": batch["tokens"]}).cpu()
    state = adamw.init_state(dict(model.named_parameters()))
    _, state, want = configs.make_train_step(spec, cfg, opt_cfg)(
        model, state, batch)
    want_moments = {k: {n: t.cpu() for n, t in state[k].items()}
                    for k in ("mu", "nu")}
    del state
    torch.cuda.empty_cache()

    mesh = make_smoke_mesh("cuda")
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    placed = configs.init_params(spec, cfg, gen, device=dev, mesh=mesh)
    prefill = configs.make_serve_step(spec, "prefill_32k", cfg, mesh=mesh)
    step = configs.make_train_step(spec, cfg, opt_cfg, mesh=mesh)
    state = adamw.init_state(dict(placed.named_parameters()))
    sm.reset_counts()
    fa.reset_counts()
    fa.reset_bwd_counts()
    shd.reset_collectives()
    t_run = time.perf_counter()
    logits = prefill(placed, {"tokens": batch["tokens"]})
    counts = shd.collective_counts()
    _, state, got = step(placed, state, batch)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t_run
    counts.update(shd.collective_counts())
    b5, b5_grad = sm.matmul.launches, sm.matmul_grads.launches
    b6, b6_bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    per = moe_b5_per_layer(cfg)
    want_n = ((per * L + 1) + (4 * per * L + 3), 2 * (per * L + 1), 3 * L, L)
    if (b5, b5_grad, b6, b6_bwd) != want_n:
        raise AssertionError(
            f"[mesh] the partitioned MoE prefill and step launched B5 {b5} "
            f"(gradients {b5_grad}), B6 {b6} and its backward {b6_bwd} "
            f"times, not {want_n}")
    if counts:
        raise AssertionError(f"[mesh] the one-rank MoE prefill and step made "
                             f"collectives: {counts}")
    if not torch.equal(logits.cpu(), want_logits):
        raise AssertionError("[mesh] the one-rank partitioned MoE prefill is "
                             "not bit-equal to the unsharded one")
    for k in ("loss", "grad_norm", "lr"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"[mesh] the one-rank MoE step's {k} "
                                 f"{float(got[k])} != {float(want[k])}")
    whole = dict(model.named_parameters())
    for n, p in placed.named_parameters():
        if not torch.equal(p, whole[n]):
            raise AssertionError(f"[mesh] MoE parameter {n} after the "
                                 "one-rank step is not bit-equal")
    for k, moments in want_moments.items():
        for n, t in moments.items():
            if not torch.equal(state[k][n].cpu(), t):
                raise AssertionError(f"[mesh] MoE moment {k} {n} after the "
                                     "one-rank step is not bit-equal")
    G, C = tfm.capacity(m, MESH_SEQ)
    print(f"[mesh] {MESH_MOE_ARCH} at full width cut to {L} layers "
          f"({sum(p.numel() for p in placed.parameters()):,} parameters, "
          f"bf16, {m.n_experts} experts of {m.d_ff_expert}, top-{m.top_k}, "
          f"{m.n_shared} shared; C = {C} rows an expert at 1 x {MESH_SEQ}) on "
          f"the card's one-rank NCCL mesh {shd.axis_sizes(mesh)} through the "
          f"partitioner's MoE layer (EP: every expert on the one model rank, "
          f"all C rows on the one data rank): prefill 1 x {MESH_SEQ} "
          f"(make_serve_step(mesh=)) bit-equal to the unsharded prefill's "
          f"logits; one train step (make_train_step(mesh=)) bit-equal in "
          f"loss {float(got['loss']):.6f}, grad_norm "
          f"{float(got['grad_norm']):.6f}, lr {float(got['lr']):.3e}, every "
          f"parameter and both moments; collectives: none; launches B5 {b5} "
          f"({per * L + 1} prefill + {4 * per * L + 3} step; {per} a layer), "
          f"its gradient {b5_grad}, B6 {b6}, its backward {b6_bwd}; "
          f"{t_run:.2f}s for both | {smi}")
    del model, placed, state, logits, want_logits, want_moments, whole
    torch.cuda.empty_cache()

    # -- B5 at the four-card runs' local expert shapes ------------------------
    g = torch.Generator(device=dev).manual_seed(MESH_SEED + 3)
    d, f = cfg.d_model, m.d_ff_expert

    def rand(*shape):
        return (torch.randn(shape, generator=g, device=dev) *
                shape[0] ** -0.5).to(torch.bfloat16)

    # EP on (2, 2): C at 2 x MESH_SEQ tokens, split over the 2 data ranks;
    # expert TP on (1, 4): MESH_TP_EXPERTS experts, f split 4 ways, all C
    ep_rows = tfm.capacity(m, 2 * MESH_SEQ)[1] // 2
    tp_rows = tfm.capacity(dataclasses.replace(
        m, n_experts=MESH_TP_EXPERTS), 2 * MESH_SEQ)[1]
    b5_cases = {
        f"mesh EP expert wg ({ep_rows} rows: C over 2 data ranks)": (
            rand(ep_rows, d), rand(d, f)),
        f"mesh EP expert wo ({ep_rows} rows)": (rand(ep_rows, f),
                                               rand(f, d)),
        f"mesh expert TP wg N = {f // 4} ({tp_rows} rows, model 4)": (
            rand(tp_rows, d), rand(d, f // 4)),
        f"mesh expert TP wo K = {f // 4} ({tp_rows} rows, model 4)": (
            rand(tp_rows, f // 4), rand(f // 4, d))}
    results = kernel_checks(b5_cases, {}, tag="mesh")
    print(f"[mesh] the MoE part {time.perf_counter() - t0:.1f}s | {smi}")
    return {"b5": b5 - b5_grad, "b5_grad": b5_grad, "b6": b6,
            "b6_bwd": b6_bwd,
            "b5_err": max(r["max_abs_err"] for r in results.values())}


def mesh_multi_phase(smi: str) -> None:
    """[mesh] across cards (``--multi``): one rank process per card (four
    at most; two where two or three are visible), NCCL over a FileStore in
    a temporary directory, rank r on cuda:r. Each part of
    :data:`MESH_PARTS` (:func:`mesh_rank`; dbrx on four ranks only) runs
    in processes of its own, given its name as an argument, so that no
    part's memory or communicators outlive it (dbrx-132b at full depth
    leaves a card a few GiB beside its weights).
    The ranks run under one hard timeout; if one fails or the time runs
    out every rank is killed and the phase raises. Rank 0 prints the
    lines."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[mesh] --multi: one card is visible, no mesh of several "
              f"ranks to run | {smi}")
        return
    world = 4 if cards >= 4 else 2
    # expandable segments: dbrx-132b at full depth on (1, 4) draws its
    # 3.9 GiB f32 leaves one after another beside 61 GiB of shards, which
    # fixed-size segments fragment
    env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
           **os.environ, "MESH_SMI": smi,
           "PYTHONHASHSEED": os.environ.get("PYTHONHASHSEED", "0")}
    # what [multi] left cached on the cards goes back before the ranks start
    # (meshgraphnet at ogb_products / 4 holds ~35 GiB of a card)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for part in [p for p in MESH_PARTS if world == 4 or p != "dbrx"]:
        tmp = tempfile.mkdtemp(prefix="mesh_")
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
             str(r), str(world), tmp, part], env=env)
            for r in range(world)]
        try:
            while True:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    break
                bad = [(r, c) for r, c in enumerate(codes)
                       if c not in (None, 0)]
                if bad:
                    raise AssertionError(f"[mesh] {part}: ranks failed {bad}")
                if time.perf_counter() - t0 > MESH_RANKS_TIMEOUT_S:
                    raise AssertionError(f"[mesh] the ranks outlived "
                                         f"{MESH_RANKS_TIMEOUT_S}s")
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"[mesh] --multi: {world} ranks passed in "
          f"{time.perf_counter() - t0:.1f}s | {smi}")


def mesh_leaf_errs(got_of, want: dict, mesh, specs: dict) -> dict:
    """Each leaf's largest |gathered - want| over the largest |want| of
    its scale leaf (grad_leaf_errs's rule), gathering one leaf at a
    time."""
    from repro_torch.runtime import sharding as shd
    out = {}
    for name, local in got_of.items():
        full = shd.unshard_params({name: local}, {name: specs[name]},
                                  mesh)[name]
        scale_of = name.replace(".bk", ".wk") if name.endswith(".bk") \
            else name
        scale = float(want[scale_of].float().abs().max())
        out[name] = float((full.float() - want[name].float()).abs().max()) \
            / max(scale, 1e-30)
        del full
    return out


def mesh_one_card(spec, cfg, batch, opt_cfg, dev, routes=None) -> dict:
    """One card's step on ``batch`` from MESH_SEED's model: loss, norm, the
    gradients and the updated parameters (the loss and gradients, then
    AdamW on them: make_train_step's arithmetic without a second forward,
    to keep the peak under the card's memory at 4 sequences); a MoE
    model's routes recorded in ``routes`` (a :class:`RoutePattern`)."""
    from repro_torch import configs
    from repro_torch.optim import adamw
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    model = configs.init_params(spec, cfg, gen, device=dev)
    def run():
        return loss_and_grads(spec, cfg, model, batch)
    loss, grads = routed(routes, run) if routes is not None else run()
    params = dict(model.named_parameters())
    state = adamw.init_state(params)
    with torch.no_grad():
        _, state, m = adamw.apply_updates(opt_cfg, params, grads, state)
    m["loss"] = torch.tensor(loss)
    del state
    params = {n: p.detach() for n, p in model.named_parameters()}
    torch.cuda.empty_cache()
    return {"loss": loss, "m": {k: float(v) for k, v in m.items()},
            "grads": grads, "params": params}


def mesh_rank(rank: int, world: int, tmp: str, part: str) -> None:
    """One rank of one part of ``--multi``'s [mesh] (:data:`MESH_PARTS`).
    ``dense``: the 8-layer steps on each mesh of MESH_SHAPES[world] against
    one card's (computed on every rank, the same bits everywhere), then on
    four ranks glm4-9b at full depth: two train steps on MESH_FULL_TRAIN
    and serving on MESH_FULL_SERVE against one card's prefill and decode.
    ``moe``: :func:`mesh_moe_rank`. ``dbrx``: :func:`mesh_dbrx_rank`.
    ``gnn``: :func:`mesh_gnn_rank`."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd

    smi = os.environ.get("MESH_SMI", "")
    say = print if rank == 0 else (lambda *a, **k: None)
    dev = (torch.device("cuda", rank) if MESH_DEVICE == "cuda"
           else torch.device(MESH_DEVICE))
    if dev.type == "cuda":
        # the kernels launch on the current device's stream: a part that
        # computes before its first mesh (which sets it) must be on cuda:r
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    spec = configs.get(MESH_ARCH)
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)

    def worst(x: float, mesh) -> float:
        return float(shd.all_reduce(torch.tensor([x], device=dev), mesh,
                                    shd.axis_names(mesh), op="max"))

    if part != "dense":
        {"moe": lambda: mesh_moe_rank(rank, world, store, dev, smi),
         "dbrx": lambda: mesh_dbrx_rank(rank, store, dev, smi),
         "gnn": lambda: mesh_gnn_rank(rank, world, store, dev, smi),
         "mind": lambda: mesh_mind_rank(rank, world, store, dev, smi)}[
             part]()
        dist.destroy_process_group()
        return

    # -- 8 layers on every mesh of the world, against one card -------------
    cfg = dataclasses.replace(spec.model_cfg, n_layer=TRAIN_LAYERS)
    refs = {}
    for shape in MESH_SHAPES[world]:
        rows = max(shape[0], 2)                 # at most 2 per data rank
        if rows not in refs:
            # the last reference's gradients and parameters go first (the
            # loop's names hold them too: 11.5 GB at 8 layers)
            refs.clear()
            batch = ref_run = None
            torch.cuda.empty_cache()
            batch = mesh_tokens(cfg.vocab, rows, MESH_SEQ, MESH_SEED, dev)
            refs[rows] = (batch, mesh_one_card(spec, cfg, batch, opt_cfg,
                                               dev))
        batch, ref_run = refs[rows]
        mesh = rank_mesh(shape, store, rank)
        specs = shd.lm_param_spec_tree(tfm.abstract_params(cfg), mesh)
        gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
        model = configs.init_params(spec, cfg, gen, device=dev, mesh=mesh)
        local = {k: shd.local_shard(v, mesh, shd.P("data", None)).contiguous()
                 for k, v in batch.items()}
        loss, grads = loss_and_grads(spec, cfg, model, local)
        g_err = mesh_leaf_errs(grads, ref_run["grads"], mesh, specs)
        del grads
        state = adamw.init_state(dict(model.named_parameters()))
        step = configs.make_train_step(spec, cfg, opt_cfg, mesh=mesh)
        sm.reset_counts()
        fa.reset_counts()
        fa.reset_bwd_counts()
        shd.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, m = step(model, state, batch)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        counts = shd.collective_counts()
        launches = (sm.matmul.launches, sm.matmul_grads.launches,
                    fa.flash_attention.launches,
                    fa.flash_attention_bwd.launches)
        del state
        # the q/k/v biases are zero before the step, and AdamW's first step
        # moves each entry by lr with its gradient's sign, which for entries
        # whose bf16 gradient is mostly rounding goes either way: they are
        # held by their gradients above, every other leaf by its value too
        biases = ("bq", "bk", "bv")
        p_err = mesh_leaf_errs(
            {n: p for n, p in model.named_parameters()
             if n.rsplit(".", 1)[-1] not in biases},
            ref_run["params"], mesh, specs)
        g_worst, p_worst = (worst(max(e.values()), mesh)
                            for e in (g_err, p_err))
        loss_err = abs(loss - ref_run["loss"]) / abs(ref_run["loss"])
        m_err = {k: abs(float(m[k]) - ref_run["m"][k]) / abs(ref_run["m"][k])
                 for k in ("loss", "grad_norm", "lr")}
        if not (max(m_err.values()) <= MESH_TOL and loss_err <= MESH_TOL
                and g_worst <= MESH_TOL and p_worst <= MESH_TOL):
            raise AssertionError(
                f"[mesh] {shape}: against one card's step, metrics {m_err}, "
                f"gradients {g_worst} (largest: "
                f"{max(g_err, key=g_err.get)}), parameters {p_worst} "
                f"(largest: {max(p_err, key=p_err.get)})")
        say(f"[mesh] {MESH_ARCH} {TRAIN_LAYERS} layers on {shape} "
            f"(data, model), {rows} x {MESH_SEQ} global batch, one train step "
            f"(make_train_step(mesh=)) against one card's on the same seed "
            f"and batch: loss {float(m['loss']):.6f} (one card "
            f"{ref_run['m']['loss']:.6f}), grad_norm "
            f"{float(m['grad_norm']):.6f} ({ref_run['m']['grad_norm']:.6f}), "
            f"lr equal; every gathered gradient within {g_worst:.3e} of its "
            f"leaf's scale, every updated parameter but the q/k/v biases "
            f"(zero before the step, then +-lr by their gradients' signs) "
            f"within {p_worst:.3e} (tolerance {MESH_TOL}); step "
            f"{t_step:.4f}s; launches B5 "
            f"{launches[0]}, its gradient {launches[1]}, B6 {launches[2]}, "
            f"its backward {launches[3]} per rank; collectives per step "
            f"(rank 0): {mesh_counts_line(counts)} | {smi}")
        del model
        torch.cuda.empty_cache()
    del refs, batch, ref_run
    torch.cuda.empty_cache()
    if world < 4:
        say(f"[mesh] {world} ranks (fewer than four cards): glm4-9b at 40 "
            f"layers on (2, 2) and serving on (1, 4) need four | {smi}")
        dist.destroy_process_group()
        return

    # -- glm4-9b at full depth: two train steps on (2, 2) ---------------------
    full = spec.model_cfg
    mesh = rank_mesh(MESH_FULL_TRAIN, store, rank)
    rows = MESH_FULL_TRAIN[0]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    model, t_init = wall(lambda: (configs.init_params(
        spec, full, gen, device=dev, mesh=mesh), torch.cuda.synchronize())[0])
    local_params = sum(p.numel() for p in model.parameters())
    state = adamw.init_state(dict(model.named_parameters()))
    step = configs.make_train_step(spec, full, opt_cfg, mesh=mesh)
    losses, times, counts = [], [], {}
    for i in range(MESH_TRAIN_STEPS):
        batch = mesh_tokens(full.vocab, rows, MESH_SEQ, MESH_SEED + 1 + i,
                            dev)
        shd.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = shd.collective_counts()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[mesh] 40-layer losses {losses}")
    peak = worst(torch.cuda.max_memory_allocated() / 2**30, mesh)
    hbm = torch.cuda.get_device_properties(dev).total_memory / 2**30
    if not peak < hbm:
        raise AssertionError(f"[mesh] peak {peak} GiB of {hbm}")
    dims = dict(spec.shapes["train_4k"], batch=rows, seq=MESH_SEQ)
    flops = configs.model_flops(spec, "train_4k", dims=dims, model_cfg=full)
    t = times[-1]
    say(f"[mesh] {MESH_ARCH} at full width and depth ({full.n_layer} layers, "
        f"{full.param_count:,} parameters, {local_params:,} on each rank) "
        f"trained on {MESH_FULL_TRAIN} (data, model), {rows} x {MESH_SEQ} "
        f"global batch (one sequence per data rank), remat, AdamW f32 "
        f"moments; drawn and placed in {t_init:.2f}s; {MESH_TRAIN_STEPS} "
        f"steps, losses {' '.join(f'{x:.4f}' for x in losses)}; step "
        f"{t:.4f}s (first {times[0]:.4f}s) = {rows * MESH_SEQ / t:.1f} "
        f"tokens/s; model FLOPs {flops:.4e} per step = "
        f"{flops / t / (4 * 989e12):.4f} of 4 x 989 TFLOP/s; peak device "
        f"memory {peak:.2f} GiB per card (the largest rank; {hbm:.1f} GiB "
        f"each); collectives per step (rank 0): {mesh_counts_line(counts)} "
        f"| {smi}")
    del model, state
    torch.cuda.empty_cache()

    # -- serving at full depth on (1, 4) against one card ---------------------
    slots = spec.shapes["decode_32k"]["seq"]
    B, steps = LM_DECODE_BATCH, LM_STEPS
    toks = mesh_tokens(full.vocab, 1, MESH_SEQ, MESH_SEED + 9, dev)["tokens"]
    head_at, tail_at = 0, slots - steps
    kinds = {"B5": is_b5, "B6": is_b6, "NCCL": lambda k: "nccl" in k.lower()}

    def decode(model, mesh, at: int):
        """``steps`` decode steps from slot ``at``, each timed."""
        dec = configs.make_serve_step(spec, "decode_32k", full, mesh=mesh)
        outs, t = [], 0.0
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, _ = dec(model, {"tokens": dec_toks[i], "cache": cache,
                                 "cache_len": at + i})
            torch.cuda.synchronize()
            t += time.perf_counter() - t0
            outs.append(out)
        return outs, t / steps

    def prefill(model, mesh):
        """The prefill's logits and its second call's seconds."""
        pre = configs.make_serve_step(spec, "prefill_32k", full, mesh=mesh)
        logits = pre(model, {"tokens": toks})
        torch.cuda.synchronize()
        _, t_pre = wall(lambda: (pre(model, {"tokens": toks}),
                                 torch.cuda.synchronize()))
        return logits, t_pre

    def restore():
        """The cache as one card's head decode left it: its first ``steps``
        slots (the keys and values the model wrote) repeated up to the
        last ``steps``, which hold the unwritten slots' sentinels."""
        for name, t in cache.items():
            t[:, :, :steps] = head_kv[name]
            t[:, :, tail_at:] = sentinel[name]

    def profile_step(model, mesh) -> str:
        restore()
        dec = configs.make_serve_step(spec, "decode_32k", full, mesh=mesh)
        return profiled(lambda: (dec(model, {
            "tokens": dec_toks[0], "cache": cache, "cache_len": tail_at}),
            torch.cuda.synchronize()), kinds)

    # one card: the head of the cache, then its end over 32,760 slots of the
    # keys and values the head decode wrote; the unwritten slots past each
    # step hold sentinels that would swamp attention if read
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 2)
    one = configs.init_params(spec, full, gen, device=dev)
    cache = tfm.init_cache(full, B, slots, device=dev)
    sentinel = {name: torch.randn(t[:, :, tail_at:].shape, generator=gen,
                                  device=dev).mul_(MESH_SENTINEL).to(t.dtype)
                for name, t in cache.items()}
    for name, t in cache.items():
        t[:, :, tail_at:] = sentinel[name]
    dec_toks = [torch.randint(0, full.vocab, (B, 1), generator=gen,
                              device=dev) for _ in range(steps)]
    want_pre, t_pre1 = prefill(one, None)
    want_head, _ = decode(one, None, head_at)
    head_kv = {name: t[:, :, :steps].clone() for name, t in cache.items()}
    for t in cache.values():
        w = steps
        while w < tail_at:                  # the written slots, doubled
            n = min(w, tail_at - w)
            t[:, :, w:w + n] = t[:, :, :n]
            w += n
    restore()
    want_tail, t_dec1 = decode(one, None, tail_at)
    # one card's own spread there: its kernels against its plain versions,
    # the two valid evaluations of the same bf16 model
    restore()
    with contextlib.ExitStack() as stack:
        for patch in plain_ops():
            stack.enter_context(patch)
        plain_tail, _ = decode(one, None, tail_at)
    floor = [rel_err(k, p) for k, p in zip(want_tail, plain_tail)]
    prof1 = profile_step(one, None)
    del one, plain_tail
    torch.cuda.empty_cache()

    # (1, 4): the same cache (the batch over one data rank, the 2 kv heads
    # replicated over the 4 model ranks: this rank's shard is all of it)
    mesh = rank_mesh(MESH_FULL_SERVE, store, rank)
    local = shd.shard_shape(tuple(cache["k"].shape),
                            shd.lm_cache_spec(mesh, full.n_kv)["k"], mesh)
    if local != tuple(cache["k"].shape):
        raise AssertionError(f"[mesh] a cache shard of {local} on "
                             f"{MESH_FULL_SERVE}")
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 2)
    placed = configs.init_params(spec, full, gen, device=dev, mesh=mesh)
    sm.reset_counts()
    fa.reset_counts()
    shd.reset_collectives()
    got_pre, t_pre = prefill(placed, mesh)
    got_head, _ = decode(placed, mesh, head_at)
    restore()
    got_tail, t_dec = decode(placed, mesh, tail_at)
    counts = shd.collective_counts()
    launches = (sm.matmul.launches, fa.flash_attention.launches)
    # planted faults the end-of-cache check must see: every rank attending
    # with the other kv head, or reading one slot past the written ones
    attend = tfm._attend_one_kv
    planted = {
        "the other kv head": lambda q, ck, cv, lo, t_real: attend(
            q, ck, cv, (lo + 1) % ck.shape[2], t_real),
        "one slot past t_real": lambda q, ck, cv, lo, t_real: attend(
            q, ck, cv, lo, min(t_real + 1, ck.shape[1]))}
    wrong = {}
    for what, fn in planted.items():
        restore()
        with mock.patch.object(tfm, "_attend_one_kv", fn):
            wrong[what], _ = decode(placed, mesh, tail_at)
    prof4 = profile_step(placed, mesh)
    vl = full.vocab // MESH_FULL_SERVE[1]
    lo = shd.axis_index(mesh, "model") * vl

    def err(got, want):
        return worst(float((got - want[..., lo:lo + vl]).abs().max()),
                     mesh) / float(want.abs().max())

    e_pre = err(got_pre, want_pre)
    e_head = [err(g, w) for g, w in zip(got_head, want_head)]
    e_tail = [err(g, w) for g, w in zip(got_tail, want_tail)]
    e_wrong = {what: [err(g, w) for g, w in zip(outs, want_tail)]
               for what, outs in wrong.items()}
    if not (e_pre <= MESH_TOL and max(e_head) <= MESH_TOL
            and max(e_tail) <= MESH_TOL):
        raise AssertionError(f"[mesh] serving on {MESH_FULL_SERVE}: prefill "
                             f"{e_pre}, decode at the head {e_head} and at "
                             f"the end {e_tail} of max|logit|")
    blind = {what: e for what, e in e_wrong.items() if max(e) <= MESH_TOL}
    if blind:
        raise AssertionError(f"[mesh] the end-of-cache check cannot see "
                             f"{blind} (tolerance {MESH_TOL})")
    say(f"[mesh] {MESH_ARCH} serving at full width and depth on "
        f"{MESH_FULL_SERVE} (data, model; the 2 kv heads replicated over the "
        f"4 model ranks, each attending with its query heads' one): prefill "
        f"1 x {MESH_SEQ} {t_pre:.4f}s (one card {t_pre1:.4f}s), logits within "
        f"{e_pre:.3e} of max|logit| of one card's; decode, batch {B} over "
        f"{slots} slots, {steps} steps at the head of the cache, each step's "
        f"logits within {max(e_head):.3e} of one card's (tolerance "
        f"{MESH_TOL}; per step {' '.join(f'{e:.2e}' for e in e_head)}); "
        f"{steps} steps at its end, over one card's head keys and values "
        f"repeated to slot {tail_at} (the unwritten slots past each step "
        f"hold N(0, {MESH_SENTINEL:g}^2) sentinels), "
        f"{t_dec * 1e3:.3f} ms per step (one card {t_dec1 * 1e3:.3f} ms), "
        f"logits within {max(e_tail):.3e} of one card's (per step "
        f"{' '.join(f'{e:.2e}' for e in e_tail)}), where one card's own "
        f"kernels and plain versions differ by "
        f"{' '.join(f'{e:.2e}' for e in floor)}; planted faults seen: "
        + "; ".join(f"{what} {min(e):.3e}..{max(e):.3e}"
                    for what, e in e_wrong.items())
        + f"; launches B5 {launches[0]}, B6 {launches[1]} per rank for the "
        f"two prefills and {2 * steps} steps; collectives (rank 0): "
        f"{mesh_counts_line(counts)} | {smi}")
    say(f"[mesh] one decode step at slot {tail_at} under torch.profiler, "
        f"one card: {prof1} | {smi}")
    say(f"[mesh] one decode step at slot {tail_at} under torch.profiler, "
        f"{MESH_FULL_SERVE} rank 0: {prof4} | {smi}")
    del placed, cache, sentinel, head_kv, wrong, got_pre, got_head, got_tail
    del want_pre, want_head, want_tail
    torch.cuda.empty_cache()
    dist.destroy_process_group()


class RankRoutes(RoutePattern):
    """:class:`RoutePattern`'s replay on a rank of a mesh: the n-th call of
    ``transformer.route`` gets this rank's rows (the ``d_index``-th block
    over the data axes) of one card's n-th kept ids, over the global
    tokens, and counts the assignments its own routing would send
    elsewhere."""

    def __init__(self, kept: list, d_index: int):
        super().__init__()
        self.kept, self.d_index = kept, d_index

    def replay(self, probs, k):
        n = probs.shape[0]
        eidx = self.kept[self._next][self.d_index * n:(self.d_index + 1) * n]
        self._next += 1
        self.flips.append(routed_apart(self._route(probs, k), eidx,
                                       probs.shape[-1]))
        self.assignments += eidx.numel()
        return eidx


def routed(pattern: RoutePattern, fn, replay: bool = False):
    """``fn()`` with ``pattern`` standing in for the routing."""
    with contextlib.ExitStack() as stack:
        for patch in pattern.patches(replay=replay):
            stack.enter_context(patch)
        return fn()


def mesh_moe_rank(rank: int, world: int, store, dev, smi: str) -> None:
    """One rank of ``--multi``'s MoE models. qwen2-moe-a2.7b at full width,
    MOE_TRAIN_LAYERS layers, one train step on each mesh of
    MESH_SHAPES[world] and, on four ranks, its experts cut to
    MESH_TP_EXPERTS (expert TP) at MOE_CUT_LAYERS layers on (1, 4): each
    against one card's step on the same batch (computed on every rank),
    one card's routes replayed on the ranks, the flips their own routing
    would make counted. Then, on four ranks: qwen2-moe at full depth, two
    train steps on MESH_FULL_TRAIN."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd

    say = print if rank == 0 else (lambda *a, **k: None)
    spec = configs.get(MESH_MOE_ARCH)
    full = spec.model_cfg
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)

    def mesh_of(shape):
        return rank_mesh(shape, store, rank)

    def total(x: float, mesh, op: str = "sum") -> float:
        return float(shd.all_reduce(torch.tensor([x], device=dev), mesh,
                                    shd.axis_names(mesh), op=op))

    def d_index(mesh) -> int:
        return shd._combined_index(mesh, shd.dp_axes(mesh))[0]

    # -- one train step on each mesh against one card's -----------------------
    runs = [(dataclasses.replace(full, n_layer=MOE_TRAIN_LAYERS), shape)
            for shape in MESH_SHAPES[world]]
    if world == 4:
        runs.append((dataclasses.replace(
            full, n_layer=MOE_CUT_LAYERS, moe=dataclasses.replace(
                full.moe, n_experts=MESH_TP_EXPERTS)), MESH_FULL_SERVE))
    refs = {}
    for cfg, shape in runs:
        rows = max(shape[0], 2)                 # at most 2 per data rank
        key = (cfg, rows)
        if key not in refs:
            refs.clear()
            batch = rec = ref = None        # the last reference goes first
            torch.cuda.empty_cache()
            batch = mesh_tokens(cfg.vocab, rows, MESH_SEQ, MESH_SEED, dev)
            rec = RoutePattern()
            refs[key] = (batch, rec, mesh_one_card(spec, cfg, batch,
                                                   opt_cfg, dev, rec))
        batch, rec, ref = refs[key]
        mesh = mesh_of(shape)
        part_d = d_index(mesh)
        specs = shd.lm_param_spec_tree(tfm.abstract_params(cfg), mesh)
        gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
        model = configs.init_params(spec, cfg, gen, device=dev, mesh=mesh)
        local = {k: shd.local_shard(v, mesh, shd.P("data", None)).contiguous()
                 for k, v in batch.items()}
        grads_routes = RankRoutes(rec.kept, part_d)
        loss, grads = routed(grads_routes, lambda: loss_and_grads(
            spec, cfg, model, local), replay=True)
        g_err = mesh_leaf_errs(grads, ref["grads"], mesh, specs)
        del grads
        state = adamw.init_state(dict(model.named_parameters()))
        step = configs.make_train_step(spec, cfg, opt_cfg, mesh=mesh)
        step_routes = RankRoutes(rec.kept, part_d)
        sm.reset_counts()
        fa.reset_counts()
        fa.reset_bwd_counts()
        shd.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, m = routed(step_routes, lambda: step(model, state, batch),
                             replay=True)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t0
        counts = shd.collective_counts()
        launches = (sm.matmul.launches, sm.matmul_grads.launches,
                    fa.flash_attention.launches,
                    fa.flash_attention_bwd.launches)
        del state
        # the q/k/v biases are zero before the step: AdamW's first step
        # moves them by lr with their gradients' signs (mesh_rank's rule)
        biases = ("bq", "bk", "bv")
        p_err = mesh_leaf_errs(
            {n: p for n, p in model.named_parameters()
             if n.rsplit(".", 1)[-1] not in biases},
            ref["params"], mesh, specs)
        g_worst, p_worst = (total(max(e.values()), mesh, "max")
                            for e in (g_err, p_err))
        flips = total(sum(grads_routes.flips) + sum(step_routes.flips), mesh)
        assigned = total(grads_routes.assignments
                         + step_routes.assignments, mesh)
        loss_err = abs(loss - ref["loss"]) / abs(ref["loss"])
        m_err = {k: abs(float(m[k]) - ref["m"][k]) / abs(ref["m"][k])
                 for k in ("loss", "grad_norm", "lr")}
        if not (max(m_err.values()) <= MESH_TOL and loss_err <= MESH_TOL
                and g_worst <= MESH_TOL and p_worst <= MESH_TOL):
            raise AssertionError(
                f"[mesh] {MESH_MOE_ARCH} on {shape}: against one card's step,"
                f" metrics {m_err}, gradients {g_worst} (largest: "
                f"{max(g_err, key=g_err.get)}), parameters {p_worst} "
                f"(largest: {max(p_err, key=p_err.get)})")
        E, L = cfg.moe.e_total, cfg.n_layer
        G, C = tfm.capacity(cfg.moe, rows * MESH_SEQ)
        el = E // shape[1] if E % shape[1] == 0 else E
        layout = (f"EP, {el} experts a model rank" if E % shape[1] == 0 else
                  f"expert TP, f {cfg.moe.d_ff_expert // shape[1]} of "
                  f"{cfg.moe.d_ff_expert} a model rank")
        say(f"[mesh] {MESH_MOE_ARCH} {L} layers"
            + (f", experts cut {full.moe.n_experts} -> {E}" if E !=
               full.moe.n_experts else "")
            + f", on {shape} (data, model; {layout}; C = {C} rows an expert, "
            f"{C // shape[0]} a data rank), {rows} x {MESH_SEQ} global batch, "
            f"one train step (make_train_step(mesh=)) against one card's on "
            f"the same seed and batch, one card's routes replayed on the "
            f"ranks (their own routing would send {flips:,.0f} of "
            f"{assigned:,.0f} assignments elsewhere; one card's smallest top-"
            f"{cfg.moe.top_k} margin {rec.margin():.3e}, {rec.dropped():,} "
            f"dropped over its pass and recompute): loss "
            f"{float(m['loss']):.6f} (one card {ref['m']['loss']:.6f}), "
            f"grad_norm {float(m['grad_norm']):.6f} "
            f"({ref['m']['grad_norm']:.6f}), lr equal; every gathered gradient "
            f"within {g_worst:.3e} of its leaf's scale, every updated "
            f"parameter but the q/k/v biases within {p_worst:.3e} (tolerance "
            f"{MESH_TOL}); step {t_step:.4f}s; launches B5 {launches[0]}, its "
            f"gradient {launches[1]}, B6 {launches[2]}, its backward "
            f"{launches[3]} per rank; collectives per step (rank 0): "
            f"{mesh_counts_line(counts)} | {smi}")
        del model
        torch.cuda.empty_cache()
    del refs, batch, rec, ref
    torch.cuda.empty_cache()
    if world < 4:
        say(f"[mesh] {world} ranks (fewer than four cards): qwen2-moe at "
            f"{full.n_layer} layers, expert TP and dbrx-132b need four | "
            f"{smi}")
        return

    # -- qwen2-moe-a2.7b at full depth: two train steps on (2, 2) -------------
    mesh = mesh_of(MESH_FULL_TRAIN)
    rows = MESH_FULL_TRAIN[0]
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    model, t_init = wall(lambda: configs.init_params(
        spec, full, gen, device=dev, mesh=mesh))
    local_params = sum(p.numel() for p in model.parameters())
    state = adamw.init_state(dict(model.named_parameters()))
    step = configs.make_train_step(spec, full, opt_cfg, mesh=mesh)
    losses, times, counts = [], [], {}
    for i in range(MESH_TRAIN_STEPS):
        batch = mesh_tokens(full.vocab, rows, MESH_SEQ, MESH_SEED + 1 + i,
                            dev)
        shd.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:                  # the drops of the first step's pass
            rec = RoutePattern()
            _, state, m = routed(rec, lambda: step(model, state, batch))
            drops = int(torch.stack(rec.drops[:full.n_layer]).sum())
        else:
            _, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = shd.collective_counts()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[mesh] qwen2-moe 24-layer losses {losses}")
    peak = total(torch.cuda.max_memory_allocated() / 2**30, mesh, "max")
    hbm = torch.cuda.get_device_properties(dev).total_memory / 2**30
    if not peak < hbm:
        raise AssertionError(f"[mesh] peak {peak} GiB of {hbm}")
    dims = dict(spec.shapes["train_4k"], batch=rows, seq=MESH_SEQ)
    flops = configs.model_flops(spec, "train_4k", dims=dims, model_cfg=full)
    fm, T = full.moe, rows * MESH_SEQ
    G, C = tfm.capacity(fm, T)
    t = times[-1]
    say(f"[mesh] {MESH_MOE_ARCH} at full width and depth ({full.n_layer} "
        f"layers, {full.param_count:,} parameters, "
        f"{full.active_param_count:,} active, {local_params:,} on each rank) "
        f"trained on {MESH_FULL_TRAIN} (data, model; EP, "
        f"{fm.n_experts // MESH_FULL_TRAIN[1]} experts a model rank, C over "
        f"the data ranks), {rows} x {MESH_SEQ} global batch, remat, AdamW "
        f"f32 moments; drawn and placed in {t_init:.2f}s; "
        f"{MESH_TRAIN_STEPS} steps, losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; step {t:.4f}s (first "
        f"{times[0]:.4f}s) = {T / t:.1f} tokens/s; model FLOPs on the active "
        f"parameters {flops:.4e} per step = {flops / t / (4 * 989e12):.4f} "
        f"of 4 x 989 TFLOP/s; expert rows executed E*C = "
        f"{fm.e_total * C:,} a layer (C = {C}, G = {G}) against T*K = "
        f"{T * fm.top_k:,} assigned ({fm.e_total * C / (T * fm.top_k):.3f}x); "
        f"dropped assignments over the {full.n_layer} layers of the first "
        f"step {drops:,} of {full.n_layer * T * fm.top_k:,}; peak device "
        f"memory "
        f"{peak:.2f} GiB per card (the largest rank; {hbm:.1f} GiB each); "
        f"collectives per step (rank 0): {mesh_counts_line(counts)} | {smi}")
    del model, state
    torch.cuda.empty_cache()


def mesh_dbrx_rank(rank: int, store, dev, smi: str) -> None:
    """dbrx-132b on MESH_FULL_SERVE (four ranks): at MOE_CUT_LAYERS layers
    a prefill of 1 x MESH_SEQ against one card's, its routes replayed, and
    MOE_DECODE_BATCH sequences of MOE_PREFIX tokens decoded one by one at
    the head of the cache against a prefill of the same tokens (its routes
    replayed per token) within MESH_TOL; at full depth a prefill of 1 x
    MESH_SEQ (timed), the same head-of-cache decode within MESH_TOL with
    B6's kernels and with its plain version, and MOE_STEPS decode steps at
    the end of the 32,768-slot cache (timed)."""
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding as shd

    say = print if rank == 0 else (lambda *a, **k: None)
    aspec = configs.get("dbrx-132b")
    full = aspec.model_cfg
    mesh = rank_mesh(MESH_FULL_SERVE, store, rank)
    vl = full.vocab // MESH_FULL_SERVE[1]
    lo = shd.axis_index(mesh, "model") * vl

    def err(got, want) -> float:
        """Largest |got - want| over the ranks' vocab columns (``want``
        whole or this rank's columns), over the largest |want|."""
        if want.shape[-1] != got.shape[-1]:
            want = want[..., lo:lo + vl]
        e = torch.stack([(got - want).abs().max(), want.abs().max()])
        e = shd.all_reduce(e.float()[None], mesh, shd.axis_names(mesh),
                           op="max")[0]
        return float(e[0] / e[1])

    def total(x: float) -> float:
        return float(shd.all_reduce(torch.tensor([x], device=dev), mesh,
                                    shd.axis_names(mesh)))

    toks = mesh_tokens(full.vocab, 1, MESH_SEQ, MESH_SEED + 11,
                       dev)["tokens"]
    B, n, slots = MOE_DECODE_BATCH, MOE_PREFIX, aspec.shapes[
        "decode_32k"]["seq"]
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED + 12)
    ptoks = torch.randint(0, full.vocab, (B, n), generator=gen, device=dev)

    def head(cfg, placed, patches: list):
        """The prefill of ptoks (routes recorded), then each token decoded
        into the head of a fresh cache with its routes replayed, under
        ``patches``: each step's error against the prefill, the flips,
        the prefill's drops."""
        pre = configs.make_serve_step(aspec, "prefill_32k", cfg, mesh=mesh)
        dec = configs.make_serve_step(aspec, "decode_32k", cfg, mesh=mesh)
        cache = tfm.init_cache(cfg, B, slots, device=dev, mesh=mesh)
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            rec = RoutePattern()
            want = routed(rec, lambda: pre(placed, {"tokens": ptoks}))
            by_token = [e.view(B, n, -1) for e in rec.kept]
            errs, flips = [], 0
            for i in range(n):
                step_routes = RankRoutes([e[:, i] for e in by_token], 0)
                out, cache = routed(step_routes, lambda: dec(placed, {
                    "tokens": ptoks[:, i:i + 1], "cache": cache,
                    "cache_len": i}), replay=True)
                errs.append(err(out, want[:, i]))
                flips += sum(step_routes.flips)
        return errs, flips, rec.dropped()
    # -- MOE_CUT_LAYERS layers against one card -------------------------------
    cut = dataclasses.replace(full, n_layer=MOE_CUT_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    one = configs.init_params(aspec, cut, gen, device=dev)
    rec = RoutePattern()
    pre1 = configs.make_serve_step(aspec, "prefill_32k", cut)
    want = routed(rec, lambda: pre1(one, {"tokens": toks}))
    del one
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    placed = configs.init_params(aspec, cut, gen, device=dev, mesh=mesh)
    pre = configs.make_serve_step(aspec, "prefill_32k", cut, mesh=mesh)
    rep = RankRoutes(rec.kept, 0)
    got = routed(rep, lambda: pre(placed, {"tokens": toks}), replay=True)
    e_cut = err(got, want)
    flips_cut = total(sum(rep.flips))
    del want, got
    if not e_cut <= MESH_TOL:
        raise AssertionError(f"[mesh] dbrx {MOE_CUT_LAYERS} layers on "
                             f"{MESH_FULL_SERVE}: prefill {e_cut} of "
                             f"max|logit| from one card's")
    # the head-of-cache decode with the kernels, against the prefill
    errs_cut, flips_head, drop_head = head(cut, placed, [])
    if not max(errs_cut) <= MESH_TOL or drop_head:
        raise AssertionError(f"[mesh] dbrx {MOE_CUT_LAYERS} layers, decode at "
                             f"the head of the cache {errs_cut} of "
                             f"max|logit| from the prefill's (drops "
                             f"{drop_head})")
    say(f"[mesh] dbrx-132b at full width, {MOE_CUT_LAYERS} of "
        f"{full.n_layer} layers, on {MESH_FULL_SERVE} (data, model; EP, "
        f"{full.moe.n_experts // MESH_FULL_SERVE[1]} experts a model rank; "
        f"{full.n_kv} kv heads, {full.n_kv // MESH_FULL_SERVE[1]} a rank): "
        f"prefill 1 x {MESH_SEQ} within {e_cut:.3e} of max|logit| of one "
        f"card's (tolerance {MESH_TOL}), one card's routes replayed (the "
        f"ranks' own routing would send {flips_cut:,.0f} of "
        f"{total(rep.assignments):,.0f} assignments elsewhere; smallest "
        f"top-{full.moe.top_k} margin {rec.margin():.3e}; "
        f"{rec.dropped():,} dropped); decode at the head of the cache "
        f"against a prefill of the same {B} x {n} tokens with the kernels, "
        f"routes replayed (the steps' own routing would send "
        f"{total(flips_head):,.0f} assignments elsewhere), each step's "
        f"largest |diff| over max|logit| "
        f"{' '.join(f'{e:.2e}' for e in errs_cut)} (tolerance {MESH_TOL}) "
        f"| {smi}")
    del placed
    torch.cuda.empty_cache()

    # -- dbrx-132b at full depth ----------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    placed, t_init = wall(lambda: configs.init_params(
        aspec, full, gen, device=dev, mesh=mesh))
    gib = sum(p.numel() * p.element_size()
              for p in placed.parameters()) / 2**30
    pre = configs.make_serve_step(aspec, "prefill_32k", full, mesh=mesh)
    dec = configs.make_serve_step(aspec, "decode_32k", full, mesh=mesh)
    sm.reset_counts()
    fa.reset_counts()
    shd.reset_collectives()
    logits, t_first = wall(lambda: pre(placed, {"tokens": toks}))
    pre_counts = shd.collective_counts()
    pre_launches = (sm.matmul.launches, fa.flash_attention.launches)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("[mesh] dbrx 40-layer prefill logits")
    del logits
    _, t_pre = wall(lambda: pre(placed, {"tokens": toks}))
    # the head of the cache against a prefill of the same tokens, with
    # the kernels and with B6's plain version
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels import ref
    errs, flips, dropped = head(full, placed, [])
    errs_b6, _, _ = head(full, placed, [mock.patch.object(
        kernel_ops, "flash_attention", ref.flash_attention)])
    say(f"[mesh] dbrx-132b at full depth on {MESH_FULL_SERVE}, decode at "
        f"the head of the cache against a prefill of the same {B} x {n} "
        f"tokens, routes replayed, each step's largest |diff| over "
        f"max|logit|: the kernels {' '.join(f'{e:.2e}' for e in errs)}; "
        f"B6 plain {' '.join(f'{e:.2e}' for e in errs_b6)} | {smi}")
    # the partitioned decode (the sharded cache, the kv heads split over
    # model, the MoE dispatch of the decode batch) must give the prefill's
    # logits, with B6's kernels and with its plain version: the
    # row-parallel sums add the ranks' partials in rank order whatever the
    # message's size, and B6's decode rows equal the prefill's where the
    # keys fit one block, so 40 layers have nothing to carry
    for what, e in (("the kernels", errs), ("B6 plain", errs_b6)):
        if not max(e) <= MESH_TOL or dropped:
            raise AssertionError(f"[mesh] dbrx decode at the head of the "
                                 f"cache with {what}: {e} of max|logit| from "
                                 f"the prefill's (drops {dropped})")
    # decode at the end of the cache, timed
    cache = tfm.init_cache(full, B, slots, device=dev, mesh=mesh)
    cache_gib = 2 * cache["k"].numel() * cache["k"].element_size() / 2**30
    tok = ptoks[:, :1]
    sm.reset_counts()
    fa.reset_counts()
    shd.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MOE_STEPS):
        out, cache = dec(placed, {"tokens": tok, "cache": cache,
                                  "cache_len": slots - MOE_STEPS + i})
        tok = ptoks[:, (i + 1) % n:(i + 1) % n + 1]
    torch.cuda.synchronize()
    t_dec = (time.perf_counter() - t0) / MOE_STEPS
    dec_counts = shd.collective_counts()
    dec_launches = (sm.matmul.launches, fa.flash_attention.launches)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("[mesh] dbrx 40-layer decode logits")
    peak = float(shd.all_reduce(torch.tensor(
        [torch.cuda.max_memory_allocated() / 2**30], device=dev), mesh,
        shd.axis_names(mesh), op="max"))
    hbm = torch.cuda.get_device_properties(dev).total_memory / 2**30
    pre_dims = dict(aspec.shapes["prefill_32k"], batch=1, seq=MESH_SEQ)
    dec_dims = dict(aspec.shapes["decode_32k"], batch=B, seq=slots)
    pflops = configs.model_flops(aspec, "prefill_32k", dims=pre_dims)
    dflops = configs.model_flops(aspec, "decode_32k", dims=dec_dims)
    _, C = tfm.capacity(full.moe, MESH_SEQ)
    say(f"[mesh] dbrx-132b at full width and depth ({full.n_layer} layers, "
        f"{full.param_count:,} parameters, {full.active_param_count:,} "
        f"active) served on {MESH_FULL_SERVE} (data, model; EP, "
        f"{full.moe.n_experts // MESH_FULL_SERVE[1]} experts a model rank; "
        f"{gib:.2f} GiB of weights a card, drawn and placed in "
        f"{t_init:.2f}s): prefill 1 x {MESH_SEQ} {t_pre:.4f}s (first "
        f"{t_first:.4f}s) = {MESH_SEQ / t_pre:.1f} tokens/s, model FLOPs "
        f"{pflops:.4e} = {pflops / t_pre / (4 * 989e12):.4f} of 4 x 989 "
        f"TFLOP/s (C = {C}); decode at batch {B} (reduced: batch "
        f"{aspec.shapes['decode_32k']['batch']} -> {B}, the cache of "
        f"{cache_gib:.2f} GiB a card) over {slots} slots: {n} steps at the "
        f"head of the cache against a prefill of the same {B} x {n} tokens, "
        f"the prefill's routes replayed per token (the steps' own routing "
        f"would send {total(flips):,.0f} assignments elsewhere): with B6's "
        f"plain version within {max(errs_b6):.3e} of max|logit|, with the "
        f"kernels within {max(errs):.3e} (tolerance {MESH_TOL}, both held); "
        f"{MOE_STEPS} steps at "
        f"its end {t_dec * 1e3:.3f} ms a step = {B / t_dec:.1f} tokens/s, "
        f"model FLOPs {dflops / t_dec / (4 * 989e12):.6f} of 4 x 989 "
        f"TFLOP/s; launches B5 {pre_launches[0]}, B6 {pre_launches[1]} the "
        f"first prefill and B5 {dec_launches[0]}, B6 {dec_launches[1]} the "
        f"{MOE_STEPS} steps per rank; collectives (rank 0): prefill "
        f"{mesh_counts_line(pre_counts)}; decode "
        f"{mesh_counts_line(dec_counts)}; peak device memory {peak:.2f} GiB "
        f"per card ({hbm:.1f} GiB each) | {smi}")
    del placed, cache, out
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# --multi's gnn part: the four GNNs edge-parallel under the mesh
# ----------------------------------------------------------------------

MESH_MIND_STEPS = 2


def mesh_mind_rank(rank: int, world: int, store, dev, smi: str) -> None:
    """One rank of ``--multi``'s MIND at its published config (8,388,608
    items x 64, f32; TF32 off). One card's run from MESH_SEED's model,
    computed on every rank (the same bits everywhere): MESH_MIND_STEPS
    train steps of train_batch (launch.train's batches) and the scores of
    serve_p99, serve_bulk and retrieval_cand, timed. Then on each mesh of
    MESH_SHAPES[world], the model drawn from the same seed and placed
    (``init_params(mesh=)``): a per-rank softmax (each data rank's users
    against its own targets, the ranks' means averaged) planted in place
    of the global one must give a loss outside MIND_TOL of one card's (on
    a mesh of more than one data rank); the steps (``make_train_step(
    mesh=)``), each loss and grad_norm within MIND_TOL of one card's,
    then S and the gathered item_embed within MIND_TOL of their scale;
    the three serve cells (``make_serve_step(mesh=)``, before the steps),
    the scores gathered over the data axes within MIND_TOL of max|score|.
    Rank 0
    prints each mesh's step s and users/s, serve_p99 p50 and p99 ms,
    serve_bulk users/s, ms per retrieval, peak GiB a card (the largest
    rank's), the collectives and launches of a step, beside one card's."""
    from unittest import mock as umock

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd

    say = print if rank == 0 else (lambda *a, **k: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = configs.get(MIND_ARCH)
    cfg = configs.cell_model_cfg(spec, "train_batch")
    dims = spec.shapes["train_batch"]
    B = dims["batch"]
    opt_cfg = adamw.AdamWConfig(total_steps=10, warmup_steps=2)
    batch_fn = train_cli.make_batch_fn(spec, cfg, dims, dev)
    batches = [batch_fn(i) for i in range(MESH_MIND_STEPS)]
    cells = {}
    for i, name in enumerate(("serve_p99", "serve_bulk", "retrieval_cand")):
        c = spec.shapes[name]
        cells[name] = mind_requests(cfg, 1 if c["kind"] == "retrieval"
                                    else c["batch"], c["cands"],
                                    MESH_SEED + i, dev)

    def worst(x: float, mesh) -> float:
        return float(shd.all_reduce(torch.tensor([x], device=dev), mesh,
                                    shd.axis_names(mesh), op="max"))

    def serve_times(serve, model, batch, name) -> str:
        if name == "serve_p99":
            calls = sorted(wall(lambda: serve(model, batch))[1]
                           for _ in range(MIND_SERVES))
            p50, p99 = (float(np.percentile(calls, q)) for q in (50, 99))
            return (f"p50 {p50 * 1e3:.4f} ms, p99 {p99 * 1e3:.4f} ms a batch "
                    f"({len(batch['hist_ids']) / p50:,.0f} users/s at p50)")
        if name == "serve_bulk":
            t = sorted(wall(lambda: serve(model, batch))[1]
                       for _ in range(3))[1]
            return (f"{t:.4f} s a batch ({len(batch['hist_ids']) / t:,.0f} "
                    "users/s)")
        t = sorted(wall(lambda: serve(model, batch))[1] for _ in range(20))[10]
        return f"{t * 1e3:.4f} ms a query"

    # -- one card ----------------------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    one = configs.init_params(spec, cfg, gen, device=dev)
    state = adamw.init_state(dict(one.named_parameters()))
    step = configs.make_train_step(spec, cfg, opt_cfg)
    ref, times = [], []
    for b in batches:
        (_, state, m), t = wall(lambda: step(one, state, b))
        ref.append({k: float(v) for k, v in m.items()})
        times.append(t)
    want_S, want_table = one.S.detach().clone(), one.item_embed.detach()
    del state
    torch.cuda.empty_cache()
    want_scores, one_line = {}, {}
    gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
    fresh = configs.init_params(spec, cfg, gen, device=dev)
    for name, req in cells.items():
        serve = configs.make_serve_step(spec, name)
        want_scores[name] = serve(fresh, req)
        one_line[name] = serve_times(serve, fresh, req, name)
    del fresh, one
    torch.cuda.empty_cache()
    one_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    say(f"[mesh] {MIND_ARCH} at its published config ({cfg.n_items:,} items "
        f"x {cfg.embed_dim}, f32: a "
        f"{cfg.n_items * cfg.embed_dim * 4 / 2**30:.2f} GiB table, twice "
        f"that in AdamW's moments), one card: "
        f"{MESH_MIND_STEPS} train steps of {B:,} users (launch.train's "
        f"batches), losses {' '.join(f'{r['loss']:.6f}' for r in ref)}, "
        f"step {times[-1]:.4f} s after the first ({times[0]:.4f} s) = "
        f"{B / times[-1]:,.0f} users/s; "
        + "; ".join(f"{k} {v}" for k, v in one_line.items())
        + f"; peak {one_peak:.2f} GiB | {smi}")

    def per_rank(user, tgt, part=None):
        loss = recsys._InBatchSoftmax.apply(
            ops.matmul(user, tgt.t().contiguous()), None)
        if part is None or not part.dp:
            return loss
        sizes = shd.axis_sizes(part.mesh)
        return part.total(loss) / math.prod(sizes[a] for a in part.dp)

    for shape in MESH_SHAPES[world]:
        mesh = rank_mesh(shape, store, rank)
        D = shape[0]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
        placed = configs.init_params(spec, cfg, gen, device=dev, mesh=mesh)
        planted = ""
        if D > 1:
            specs = shd.mind_batch_specs(batches[0], mesh)
            local = {k: shd.local_shard(v, mesh, specs[k]).contiguous()
                     for k, v in batches[0].items()}
            with torch.no_grad(), umock.patch.object(
                    recsys, "in_batch_softmax_loss", per_rank):
                lp = float(recsys.mind_loss(placed, local))
            gap = abs(lp - ref[0]["loss"]) / abs(ref[0]["loss"])
            if not gap > 10 * MIND_TOL:
                raise AssertionError(f"[mesh] mind on {shape}: a per-rank "
                                     f"softmax's loss {lp} is within {gap} "
                                     "of one card's")
            planted = (f"; a per-rank softmax planted: loss {lp:.6f}, "
                       f"{gap:.3e} off one card's (caught)")
            del local
        errs, scored = {}, []
        for name, req in cells.items():
            serve = configs.make_serve_step(spec, name, mesh=mesh)
            out = serve(placed, req)
            whole = shd.gather_over(out, mesh, ("data",) if D > 1 else ())
            errs[name] = rel_err(whole, want_scores[name])
            del out, whole
            scored.append(f"{name} {serve_times(serve, placed, req, name)}")
        pstate = adamw.init_state(dict(placed.named_parameters()))
        pstep = configs.make_train_step(spec, cfg, opt_cfg, mesh=mesh)
        got, ptimes = [], []
        for i, b in enumerate(batches):
            reset_b4_b5()
            shd.reset_collectives()
            (_, pstate, m), t = wall(lambda: pstep(placed, pstate, b))
            if i == 0:
                counts = shd.collective_counts()
                n = mind_counted(MIND_LAUNCHES["train"], f"mind on {shape}")
            got.append({k: float(v) for k, v in m.items()})
            ptimes.append(t)
        for i, (g_, r_) in enumerate(zip(got, ref)):
            for k in ("loss", "grad_norm"):
                errs[f"{k} {i + 1}"] = abs(g_[k] - r_[k]) / abs(r_[k])
        errs["S"] = rel_err(placed.S.detach(), want_S)
        table = shd.unshard_params({"item_embed": placed.item_embed},
                                   shd.mind_param_specs(placed),
                                   mesh)["item_embed"]
        errs["item_embed"] = rel_err(table, want_table)
        del table, pstate
        errs = {k: worst(v, mesh) for k, v in errs.items()}
        bad = {k: v for k, v in errs.items() if not v <= MIND_TOL}
        if bad:
            raise AssertionError(f"[mesh] mind on {shape} against one card: "
                                 f"{bad}")
        peak = worst(torch.cuda.max_memory_allocated(dev) / 2**30, mesh)
        say(f"[mesh] {MIND_ARCH} on {shape} (data, model; the table's rows "
            f"over model, {B // D:,} users a data rank, the in-batch "
            f"softmax over all {B:,} targets): {MESH_MIND_STEPS} train "
            f"steps, " + ", ".join(f"{k} within {v:.3e}" for k, v in
                                   errs.items())
            + f" of one card's (tolerance {MIND_TOL}){planted}; step "
            f"{ptimes[-1]:.4f} s after the first ({ptimes[0]:.4f} s) = "
            f"{B / ptimes[-1]:,.0f} users/s (one card {times[-1]:.4f} s); "
            f"a step launched {mind_clause(n)} per rank, collectives (rank "
            f"0) {mesh_counts_line(counts)}; " + "; ".join(scored)
            + f"; peak {peak:.2f} GiB a card | {smi}")
        del placed
        torch.cuda.empty_cache()


MESH_GNN_SEED = 53
#: MeshGraphNet served at ogb_products with n and e divided by this on
#: four cards (7.73M directed edges a rank, 34.9 GiB a card). At / 2 a
#: card peaks at 69.7 GiB allocated and 77.2 reserved, the allocator
#: retries a dozen times a forward and each layer's 23.8 GB message input
#: is mapped anew (bench_mesh_gnn.py); the whole graph's alone would be
#: 47.5 GB a rank
MESH_MGN_SERVE_CUT = 4
#: GraphSAGE's train steps on the whole ogb_products graph, and the share
#: of its nodes that are seeds (ogbn-products' train split, 196,615 of
#: 2,449,029)
MESH_GNN_STEPS = 2
MESH_SAGE_SEEDS = 196_615 / 2_449_029


def powerlaw_graph_on_card(n: int, e: int, seed: int, dev) -> dict:
    """``e`` undirected pairs over ``n`` nodes drawn on the card from
    ``seed``, both ends by the popularity ``random_powerlaw_graph`` draws
    from (node i with weight (i + 1) ** -0.8; inverse CDF in f64), in both
    directions, padded to a multiple of 512 with edges at node 0; the
    padding and the self-pairs get ``edge_mask`` 0. Every rank drawing from
    the same seed holds the same graph."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cdf = torch.cumsum(torch.arange(1, n + 1, device=dev,
                                    dtype=torch.float64) ** -0.8, 0)
    cdf /= cdf[-1].clone()

    def ends():
        u = torch.rand(e, generator=gen, device=dev, dtype=torch.float64)
        return torch.searchsorted(cdf, u).clamp_max_(n - 1).to(torch.int32)
    a, b = ends(), ends()
    del cdf
    E = -(-2 * e // 512) * 512
    src = torch.zeros(E, dtype=torch.int32, device=dev)
    dst = torch.zeros_like(src)
    src[:e], src[e:2 * e] = a, b
    dst[:e], dst[e:2 * e] = b, a
    mask = torch.zeros(E, device=dev)
    mask[:2 * e] = (src[:2 * e] != dst[:2 * e]).float()
    return {"src": src, "dst": dst, "edge_mask": mask}


def sage_graph_batch(cfg, n: int, e: int, seed: int, dev) -> dict:
    """GraphSAGE's batch over a whole graph (:func:`powerlaw_graph_on_card`):
    N(0, 1) features, labels of ``cfg.n_classes`` and seeds at
    ogbn-products' train share, all drawn on the card from ``seed``."""
    batch = powerlaw_graph_on_card(n, e, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    batch["node_feat"] = torch.randn(n, cfg.d_in, generator=gen, device=dev)
    batch["labels"] = torch.randint(0, cfg.n_classes, (n,), generator=gen,
                                    device=dev, dtype=torch.int32)
    batch["seed_mask"] = torch.rand(n, generator=gen,
                                    device=dev) < MESH_SAGE_SEEDS
    return batch


class RankRelu(ReluPattern):
    """:class:`ReluPattern`'s replay on one rank of an edge-parallel mesh:
    a kept call over the ``E`` rows of the whole graph's edges is replayed
    on this rank's rows ``[lo, hi)`` of them; a call over node rows whole,
    or, node-sharded (``nodes``: the node count and this rank's padded
    rows ``(n, lo, hi)``), on this rank's node rows, its padding rows
    masked. One card's run and the mesh's then differentiate the same
    piece of the function, whose relu kinks the two sums' rounding could
    otherwise put on either side."""

    def __init__(self, kept: list, E: int, lo: int, hi: int, nodes=None):
        super().__init__()
        self.inputs, self.E, self.lo, self.hi = list(kept), E, lo, hi
        self.nodes = nodes

    def replay(self, x: torch.Tensor) -> torch.Tensor:
        kept = self.inputs[self._next]
        if kept.shape[0] == self.E and x.shape[0] == self.hi - self.lo:
            self.inputs[self._next] = kept[self.lo:self.hi]
        elif self.nodes is not None and kept.shape[0] == self.nodes[0]:
            n, lo, hi = self.nodes
            rows = kept[lo:hi]
            if rows.shape[0] < hi - lo:
                rows = torch.cat([rows, rows.new_zeros(
                    (hi - lo - rows.shape[0], *rows.shape[1:]))])
            self.inputs[self._next] = rows
        return super().replay(x)


def gnn_b4_b5(what: str) -> tuple:
    """(B5, B4, B4's gather, B5's gradient, B4 plans) since
    :func:`reset_b4_b5`, as :func:`launch_clause` reads them; raises unless
    every B5 launch took the f32 route."""
    from repro_torch.kernels import segment_matmul as sm
    b5_routes(sm, {"f32": sm.matmul.launches} if sm.matmul.launches
              else {}, what)
    return (sm.matmul.launches, sm.segment_sum.launches,
            sm.segment_gather.launches, sm.matmul_grads.launches,
            sm.segment_plan.builds)


def mesh_gnn_rank(rank: int, world: int, store, dev, smi: str) -> None:
    """One rank of ``--multi``'s GNNs, edge-parallel (``models.gnn.
    EdgeShard``: each rank's E / world edges, node state and parameters
    whole) and node-sharded (``models.gnn.NodeShard``, the hook at
    ``P(all_axes)``: the edges as before, each rank's n / world node
    rows). On each mesh of MESH_SHAPES[world], in both variants, against
    one card's step on the same batch (computed on every rank; the relu
    pattern of one card's run replayed on the rank's edge rows and, node-
    sharded, its node rows, :class:`RankRelu`): nequip and mace at full
    width and depth on molecule's full dims (loss, forces and every
    gradient within GEO_TOL of their scale), meshgraphnet on full_graph_sm
    (loss and every gradient within MGN_TOL). On four ranks: meshgraphnet
    served at ogb_products / MGN_OGB_CUT against one card's forward and at
    ogb_products / MESH_MGN_SERVE_CUT, then there node-sharded (this
    rank's node rows within MGN_TOL of the edge-parallel rows);
    graphsage-reddit's forward, loss and gradients at ogb_products /
    MGN_OGB_CUT against one card's; then graphsage-reddit at full width on
    the whole ogb_products graph (2,449,029 nodes, 123,718,280 directed
    edges, nothing cut), in both variants: one forward and MESH_GNN_STEPS
    train steps on (2, 2), after each every rank's parameters and AdamW
    moments bit-equal to rank 0's and the loss finite and equal on every
    rank, the node-sharded losses within MGN_TOL of the edge-parallel
    ones; and B4 and B5 at those steps' local shapes (B5 node-sharded too)
    against their plain versions, timed beside their bounds and library
    calls."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.runtime import sharding as shd

    say = print if rank == 0 else (lambda *a, **k: None)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)

    def worst(x: float, mesh) -> float:
        return float(shd.all_reduce(torch.tensor([x], device=dev), mesh,
                                    shd.axis_names(mesh), op="max"))

    def peak_gib(mesh) -> float:
        return worst(torch.cuda.max_memory_allocated(dev) / 2**30, mesh)

    def edge_range(mesh, E: int) -> tuple:
        idx, count = shd._combined_index(mesh, shd.all_axes(mesh))
        return idx * E // count, (idx + 1) * E // count

    def local(batch: dict, mesh) -> dict:
        specs = shd.gnn_batch_specs(batch, mesh)
        return {k: shd.local_shard(v, mesh, specs[k]).contiguous()
                for k, v in batch.items()}

    def node_sharded(mesh):
        """The node-sharding hook as the dry run's ``nodeshard`` sets it,
        reset after."""
        @contextlib.contextmanager
        def hooked():
            gnn.set_node_sharding(shd.named(mesh, shd.P(shd.all_axes(mesh))))
            try:
                yield
            finally:
                gnn.set_node_sharding(None)
        return hooked()

    def node_range(mesh, n: int) -> tuple:
        part = gnn.NodeShard(mesh)
        return (n, *part._span(n))

    def against_one_card(spec, cfg, batch, mesh, tol, what, forces=False,
                         nodeshard=False):
        """Loss, every gradient (and the forces) of the placed model on
        this rank's edges against one card's on the whole batch; with
        ``nodeshard`` under the node-sharding hook (this rank's node
        rows)."""
        gen = torch.Generator(device=dev).manual_seed(MESH_GNN_SEED)
        one = configs.init_params(spec, cfg, gen, device=dev)
        pattern = ReluPattern()
        loss_1, g_1 = loss_and_grads(spec, cfg, one, batch,
                                     relu=pattern.record)
        f_1 = gnn.energy_and_forces(one, batch)[1] if forces else None
        del one
        gen = torch.Generator(device=dev).manual_seed(MESH_GNN_SEED)
        placed = configs.init_params(spec, cfg, gen, device=dev, mesh=mesh)
        lb = local(batch, mesh)
        replay = RankRelu(pattern.inputs, batch["src"].shape[0],
                          *edge_range(mesh, batch["src"].shape[0]),
                          nodes=node_range(mesh, batch["node_feat"].shape[0])
                          if nodeshard else None)
        hook = node_sharded(mesh) if nodeshard else contextlib.nullcontext()
        torch.cuda.reset_peak_memory_stats(dev)
        with hook:
            reset_b4_b5()
            shd.reset_collectives()
            (loss_m, g_m), t_m = wall(lambda: loss_and_grads(
                spec, cfg, placed, lb, relu=replay.replay))
            counts = shd.collective_counts()
            launches = gnn_b4_b5(what)
            f_err = 0.0
            if forces:
                f_m = gnn.energy_and_forces(placed, lb)[1]
                f_err = worst(rel_err(f_m, f_1), mesh)
        peak = worst(torch.cuda.max_memory_allocated(dev) / 2**30, mesh)
        errs = grad_leaf_errs(g_m, g_1)
        g_worst = worst(max(errs.values()), mesh)
        l_err = worst(abs(loss_m - loss_1) / abs(loss_1), mesh)
        flips = worst(float(replay.flips), mesh)
        if not (g_worst <= tol and l_err <= tol and f_err <= tol):
            raise AssertionError(
                f"[mesh] {what}: against one card, loss {l_err}, forces "
                f"{f_err}, gradients {g_worst} (largest "
                f"{max(errs, key=errs.get)})")
        layout = (f"node-sharded: edges over both, E / "
                  f"{shd.mesh_size(mesh)} and n / {shd.mesh_size(mesh)} a "
                  "rank" if nodeshard else
                  f"edges over both, E / {shd.mesh_size(mesh)} a rank")
        say(f"[mesh] {what} on {tuple(shd.axis_sizes(mesh).values())} "
            f"(data, model; {layout}): loss {loss_m:.7f} (one card "
            f"{loss_1:.7f}, within "
            f"{l_err:.3e})"
            + (f", forces within {f_err:.3e} of their largest |value|"
               if forces else "")
            + f", all {len(errs)} gradients within {g_worst:.3e} of their "
            f"scale (tolerance {tol}; one card's relu pattern replayed, "
            f"{flips:.0f} inputs on the other side of the kink); loss and "
            f"gradients {t_m:.4f}s, peak {peak:.2f} GiB a card; launches "
            f"{launch_clause(launches)} per rank; collectives (rank 0) "
            f"{mesh_counts_line(counts)} | {smi}")
        del placed
        torch.cuda.empty_cache()

    # -- meshgraphnet served at ogb_products / MGN_OGB_CUT and
    # / MESH_MGN_SERVE_CUT, first: a card holds ~35 GiB there, before the
    # other meshes' communicators ----------------------------------------
    if world == 4:
        spec = configs.get(MGN_ARCH)
        mesh = rank_mesh(MESH_FULL_TRAIN, store, rank)
        ogb = spec.shapes["ogb_products"]
        for cut in (MGN_OGB_CUT, MESH_MGN_SERVE_CUT):
            n, e = ogb["n"] // cut, ogb["e"] // cut
            cfg = configs.cell_model_cfg(spec, "ogb_products")
            batch = mgn_graph(cfg, n, e, MESH_GNN_SEED, dev)
            serve = configs.make_serve_step(spec, "ogb_products", cfg,
                                            mesh=mesh)
            want = None
            if cut == MGN_OGB_CUT:
                gen = torch.Generator(device=dev).manual_seed(MESH_GNN_SEED)
                one = configs.init_params(spec, cfg, gen, device=dev)
                want = configs.make_serve_step(spec, "ogb_products", cfg)(
                    one, batch)
                del one
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            gen = torch.Generator(device=dev).manual_seed(MESH_GNN_SEED)
            placed = configs.init_params(spec, cfg, gen, device=dev, mesh=mesh)
            reset_b4_b5()
            shd.reset_collectives()
            out, t_first = wall(lambda: serve(placed, batch))
            counts = shd.collective_counts()
            launches = gnn_b4_b5(f"{MGN_ARCH} ogb_products / {cut}")
            del out
            out, t_serve = wall(lambda: serve(placed, batch))
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"[mesh] {MGN_ARCH} ogb_products / "
                                     f"{cut}: "
                                     "outputs not finite")
            err = None
            if want is not None:
                err = worst(rel_err(out, want), mesh)
                if not err <= MGN_TOL:
                    raise AssertionError(f"[mesh] {MGN_ARCH} ogb_products / "
                                         f"{cut}: {err} of max|out| from one "
                                         "card's forward")
            say(f"[mesh] {MGN_ARCH} at full width and depth served at "
                f"ogb_products / {cut} ({n:,} nodes, "
                f"{batch['src'].shape[0]:,} "
                f"directed edges, {batch['src'].shape[0] // 4:,} a rank) on "
                f"{MESH_FULL_TRAIN} (data, model; edges over both): "
                + (f"outputs within {err:.3e} of max|out| of one card's "
                   f"forward "
                   f"(tolerance {MGN_TOL}); " if err is not None else
                   "one card cannot hold it; outputs finite; ")
                + f"forward {t_serve:.4f}s (first {t_first:.4f}s); launches "
                f"{launch_clause(launches)} per rank; collectives (rank 0) "
                f"{mesh_counts_line(counts)}; peak device memory "
                f"{peak_gib(mesh):.2f} GiB per card | {smi}")
            if cut == MESH_MGN_SERVE_CUT:
                lo, hi = gnn.NodeShard(mesh)._span(n)
                edge_rows = out[lo:min(hi, n)].clone()
                del out
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                with node_sharded(mesh):
                    reset_b4_b5()
                    shd.reset_collectives()
                    out, ns_first = wall(lambda: serve(placed, batch))
                    counts = shd.collective_counts()
                    launches = gnn_b4_b5(f"{MGN_ARCH} ogb_products / {cut} "
                                         "node-sharded")
                    del out
                    out, ns_t = wall(lambda: serve(placed, batch))
                err = worst(rel_err(out, edge_rows), mesh)
                if not err <= MGN_TOL:
                    raise AssertionError(f"[mesh] {MGN_ARCH} ogb_products / "
                                         f"{cut} node-sharded: {err} of "
                                         "max|out| from the edge-parallel "
                                         "rows")
                say(f"[mesh] {MGN_ARCH} at ogb_products / {cut} node-sharded "
                    f"on {MESH_FULL_TRAIN} (nodes over both axes too, "
                    f"{hi - lo:,} rows a rank): this rank's rows within "
                    f"{err:.3e} of max|out| of the edge-parallel forward's "
                    f"(tolerance {MGN_TOL}); forward {ns_t:.4f}s (first "
                    f"{ns_first:.4f}s; edge-parallel {t_serve:.4f}s, first "
                    f"{t_first:.4f}s); launches {launch_clause(launches)} per "
                    f"rank; collectives (rank 0) {mesh_counts_line(counts)}; "
                    f"peak device memory {peak_gib(mesh):.2f} GiB per card | "
                    f"{smi}")
                del edge_rows
            del placed, out, want, batch
            torch.cuda.empty_cache()

    # -- nequip, mace and meshgraphnet on every mesh of the world ------------
    rng = np.random.default_rng(MESH_GNN_SEED)
    for arch in GEO_ARCHS:
        spec = configs.get(arch)
        cfg = configs.cell_model_cfg(spec, "molecule")
        batch = molecule_batch(cfg, spec.shapes["molecule"], rng, dev)
        for shape in MESH_SHAPES[world]:
            mesh = rank_mesh(shape, store, rank)
            for nodeshard in (False, True):
                against_one_card(spec, cfg, batch, mesh, GEO_TOL,
                                 f"{arch} at full width and depth, molecule "
                                 f"({batch['node_feat'].shape[0]:,} atoms, "
                                 f"{batch['src'].shape[0]:,} edges)",
                                 forces=True, nodeshard=nodeshard)
    spec = configs.get(MGN_ARCH)
    dims = spec.shapes["full_graph_sm"]
    cfg = configs.cell_model_cfg(spec, "full_graph_sm")
    batch = mgn_graph(cfg, dims["n"], dims["e"], MESH_GNN_SEED, dev)
    batch["target"] = torch.randn(dims["n"], cfg.d_out, device=dev,
                                  generator=torch.Generator(
                                      device=dev).manual_seed(MESH_GNN_SEED))
    for shape in MESH_SHAPES[world]:
        mesh = rank_mesh(shape, store, rank)
        for nodeshard in (False, True):
            against_one_card(spec, cfg, batch, mesh, MGN_TOL,
                             f"{MGN_ARCH} at full width and depth, "
                             f"full_graph_sm ({dims['n']:,} nodes, "
                             f"{batch['src'].shape[0]:,} edges)",
                             nodeshard=nodeshard)
    del batch
    if world < 4:
        say(f"[mesh] {world} ranks (fewer than four cards): the GNNs at "
            f"ogb_products need four | {smi}")
        return

    mesh = rank_mesh(MESH_FULL_TRAIN, store, rank)
    ogb = spec.shapes["ogb_products"]
    # -- graphsage-reddit at ogb_products / MGN_OGB_CUT against one card -----
    sspec = configs.get(GNN_ARCH)
    scfg = configs.cell_model_cfg(sspec, "ogb_products")
    n, e = ogb["n"] // MGN_OGB_CUT, ogb["e"] // MGN_OGB_CUT
    batch = sage_graph_batch(scfg, n, e, MESH_GNN_SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(MESH_GNN_SEED)
    one = configs.init_params(sspec, scfg, gen, device=dev)
    want = configs.make_serve_step(sspec, "ogb_products", scfg)(one, batch)
    del one
    gen = torch.Generator(device=dev).manual_seed(MESH_GNN_SEED)
    placed = configs.init_params(sspec, scfg, gen, device=dev, mesh=mesh)
    got = configs.make_serve_step(sspec, "ogb_products", scfg, mesh=mesh)(
        placed, batch)
    err = worst(rel_err(got, want), mesh)
    if not err <= MGN_TOL:
        raise AssertionError(f"[mesh] {GNN_ARCH} ogb_products / "
                             f"{MGN_OGB_CUT}: logits {err} of max|logit| "
                             "from one card's")
    say(f"[mesh] {GNN_ARCH} at full width ({scfg.d_in} -> {scfg.d_hidden} "
        f"-> {scfg.d_hidden}, {scfg.n_classes} classes) at ogb_products / "
        f"{MGN_OGB_CUT} ({n:,} nodes, {batch['src'].shape[0]:,} directed "
        f"edges) on {MESH_FULL_TRAIN}: logits within {err:.3e} of max|logit| "
        f"of one card's (tolerance {MGN_TOL}) | {smi}")
    del placed, got, want
    against_one_card(sspec, scfg, batch, mesh, MGN_TOL,
                     f"{GNN_ARCH} at ogb_products / {MGN_OGB_CUT}")
    del batch
    torch.cuda.empty_cache()

    # -- graphsage-reddit on the whole ogb_products graph, both variants ------
    torch.cuda.reset_peak_memory_stats(dev)
    batch, t_graph = wall(lambda: sage_graph_batch(
        scfg, ogb["n"], ogb["e"], MESH_GNN_SEED, dev))
    E = batch["src"].shape[0]
    serve = configs.make_serve_step(sspec, "ogb_products", scfg, mesh=mesh)
    step = configs.make_train_step(sspec, scfg, opt_cfg, mesh=mesh)

    def whole_graph(what: str) -> tuple:
        """One forward and MESH_GNN_STEPS train steps of a model drawn from
        MESH_GNN_SEED, every rank's parameters, moments and loss checked
        bit-equal after each step: (forward s, its collectives and
        launches, [(step s, loss, collectives, launches)], peak GiB)."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev).manual_seed(MESH_GNN_SEED)
        placed = configs.init_params(sspec, scfg, gen, device=dev, mesh=mesh)
        reset_b4_b5()
        shd.reset_collectives()
        logits, t_fwd = wall(lambda: serve(placed, batch))
        fwd = (t_fwd, shd.collective_counts(), gnn_b4_b5(f"{what} forward"))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"[mesh] {what}: logits not finite")
        del logits
        params = dict(placed.named_parameters())
        state = adamw.init_state(params)
        steps = []
        for i in range(MESH_GNN_STEPS):
            reset_b4_b5()
            shd.reset_collectives()
            (_, state, m), t = wall(lambda: step(placed, state, batch))
            counts = shd.collective_counts()
            launches = gnn_b4_b5(f"{what} step")
            flat = torch.cat([t_.detach().reshape(-1) for tree in (
                params, state["mu"], state["nu"]) for t_ in tree.values()]
                + [m["loss"].reshape(1)])
            every = shd.all_gather(flat[None], mesh, "model")
            every = shd.all_gather(every, mesh, "data")
            same = bool((every.view(torch.int32)
                         == flat.view(torch.int32)[None]).all())
            loss = float(m["loss"])
            if not (same and math.isfinite(loss)):
                raise AssertionError(f"[mesh] {what}, step {i}: state "
                                     f"bit-equal on every rank {same}, loss "
                                     f"{loss}")
            steps.append((t, loss, counts, launches))
            del every
        del state, placed, params
        return fwd, steps, peak_gib(mesh)

    def whole_line(fwd, steps, peak) -> str:
        return (f"forward {fwd[0]:.4f}s (launches {launch_clause(fwd[2])}; "
                f"collectives {mesh_counts_line(fwd[1])}); "
                + "; ".join(f"train step {i + 1} {t:.4f}s, loss {loss:.6f} "
                            f"equal on every rank, parameters and moments "
                            f"bit-equal on every rank (launches "
                            f"{launch_clause(la)} per rank; collectives "
                            f"(rank 0) {mesh_counts_line(c)})"
                            for i, (t, loss, c, la) in enumerate(steps))
                + f"; peak device memory {peak:.2f} GiB per card")

    fwd, steps, peak = whole_graph(f"{GNN_ARCH} whole ogb_products")
    hbm = torch.cuda.get_device_properties(dev).total_memory / 2**30
    flops = configs.model_flops(sspec, "ogb_products", model_cfg=scfg)
    say(f"[mesh] {GNN_ARCH} at full width ({scfg.param_count:,} parameters) "
        f"on the whole ogb_products graph, nothing cut ({ogb['n']:,} nodes, "
        f"{2 * ogb['e']:,} directed edges padded to {E:,}, {E // 4:,} a rank; "
        f"{scfg.d_in} N(0, 1) features, {int(batch['seed_mask'].sum()):,} "
        f"seeds; drawn on the card in {t_graph:.2f}s) on {MESH_FULL_TRAIN} "
        f"(data, model; edges over both, nodes and parameters whole): "
        + whole_line(fwd, steps, peak)
        + f"; model FLOPs of a step {flops:.4e} = "
        f"{flops / steps[-1][0] / (4 * 67e12):.4f} of 4 x 67 TFLOP/s (f32) "
        f"({hbm:.1f} GiB a card) | {smi}")
    with node_sharded(mesh):
        ns_fwd, ns_steps, ns_peak = whole_graph(
            f"{GNN_ARCH} whole ogb_products node-sharded")
    gaps = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(ns_steps, steps)]
    if not max(gaps) <= MGN_TOL:
        raise AssertionError(f"[mesh] {GNN_ARCH} whole ogb_products: the "
                             f"node-sharded losses are {gaps} off the "
                             "edge-parallel ones")
    say(f"[mesh] {GNN_ARCH} on the whole ogb_products graph node-sharded on "
        f"{MESH_FULL_TRAIN} (edges and nodes over both, "
        f"{-(-ogb['n'] // 4):,} node rows a rank): "
        + whole_line(ns_fwd, ns_steps, ns_peak)
        + f"; losses within {max(gaps):.3e} of the edge-parallel steps' "
        f"(tolerance {MGN_TOL}); edge-parallel in this call: forward "
        f"{fwd[0]:.4f}s, steps " + " ".join(f"{t:.4f}s" for t, *_ in steps)
        + f", {peak:.2f} GiB | {smi}")
    del step, serve

    # -- B4 and B5 at the step's local shapes (rank 0's edges) ---------------
    lb = local(batch, mesh)
    if rank == 0:
        gen = torch.Generator(device=dev).manual_seed(MESH_GNN_SEED)
        n = ogb["n"]
        ids = lb["dst"]
        for d in (scfg.d_in, scfg.d_hidden):
            b4_checks({f"whole ogb_products, a rank's {ids.shape[0]:,} "
                       f"edges, d = {d}": (torch.randn(
                           ids.shape[0], d, generator=gen, device=dev), ids,
                           n)}, tag="mesh", sum_tol=B4_SUM_TOL)
            torch.cuda.empty_cache()
        x = torch.randn(n, scfg.d_in, generator=gen, device=dev)
        h = torch.randn(n, scfg.d_hidden, generator=gen, device=dev)
        w1 = torch.randn(scfg.d_in, scfg.d_hidden, generator=gen, device=dev)
        w2 = torch.randn(scfg.d_hidden, scfg.d_hidden, generator=gen,
                         device=dev)
        per = -(-n // 4)
        rows = -(-(n // MESH_MGN_SERVE_CUT) // 4)
        mcfg = configs.cell_model_cfg(configs.get(MGN_ARCH), "ogb_products")
        kernel_checks({f"whole ogb_products layer 1 ({n:,} nodes)": (x, w1),
                       f"whole ogb_products layer 2 ({n:,} nodes)": (h, w2),
                       f"whole ogb_products layer 1 node-sharded ({per:,} "
                       f"rows a rank)": (x[:per], w1),
                       f"whole ogb_products layer 2 node-sharded ({per:,} "
                       f"rows a rank)": (h[:per], w2),
                       f"{MGN_ARCH} node MLP at ogb_products / "
                       f"{MESH_MGN_SERVE_CUT} node-sharded ({rows:,} rows a "
                       f"rank)": (torch.randn(
                           rows, 2 * mcfg.d_hidden, generator=gen,
                           device=dev), torch.randn(
                           2 * mcfg.d_hidden, mcfg.d_hidden, generator=gen,
                           device=dev))}, {}, tag="mesh")
        del x, h
    del lb, batch
    torch.cuda.empty_cache()


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on an NVIDIA card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  sys.argv[5])
        return 0

    from repro_torch.core import batch_query as bq
    from repro_torch.core import core_time as ct
    from repro_torch.core import ecb_native
    from repro_torch.core.pecb_index import build_stratified_index
    from repro_torch.kernels import (flash_attention, kcore_peel, label_prop,
                                     ref, segment_matmul, segmented_select)
    from repro_torch.launch import serve
    from repro_torch.serving import executor

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)          # the context, outside timed phases

    # -- gpu ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"[gpu] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)}")

    # -- build: every native library at once ------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(10) as pool:
        libs = {name: pool.submit(build) for name, build in (
            ("B1", label_prop.build), ("B2", segmented_select.build),
            ("sweep", segmented_select.build_sweep),
            ("B3", kcore_peel.build),
            ("fixpoint", kcore_peel.build_fixpoint),
            ("B4", segment_matmul.build_segment_sum),
            ("B5", segment_matmul.build), ("B6", flash_attention.build),
            ("B6 backward", flash_attention.build_bwd))}
        host = pool.submit(ecb_native.available)
        libs = {name: f.result() for name, f in libs.items()}
        native = host.result()
    for name, so in libs.items():
        print(f"[build] {name} {so.name}")
        for k in ptxas_kernels(so.with_suffix(".log").read_text()):
            print(f"[build] {name} ptxas {k}")
    print(f"[build] B1, B2, the stratum sweep, B3, the peel fixpoint, B4 "
          f"(and its gradient gather), B5, B6, B6's backward + host "
          f"forest engine "
          f"({'native C' if native else 'Python: no C compiler'}) in "
          f"{time.perf_counter() - t0:.2f}s")
    if sys.argv[1:] == ["--multi"]:
        from repro_torch.core.temporal_graph import gen_temporal_graph
        multi_phase(gen_temporal_graph(**COLLEGEMSG), smi)
        mesh_multi_phase(smi)
        print(f"[done] gpu, build, multi and mesh ({', '.join(MESH_PARTS)}) "
              f"passed in {time.perf_counter() - t_start:.1f}s ({smi})")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    kcore_peel.kcore_fixpoint.launches = 0
    g, ks, strata, t_dev, t_host, b2_launches, sweep_record = \
        construct_phase(dev)
    csr = ct._pair_csr(g)

    # -- index: forests on the host from the card-built strata -------------
    t0 = time.perf_counter()
    sx = build_stratified_index(g, strata=strata, device=dev)
    t_build = time.perf_counter() - t0
    # the k ranges of the card build: construct's default_ks and the
    # index's k_max_graph, one kcore_fixpoint launch per probe each
    fix_builds = kcore_peel.kcore_fixpoint.launches
    if fix_builds != 2 * kmax_probes(sx.k_max_graph):
        raise AssertionError(f"the card build's k ranges made {fix_builds} "
                             f"kcore_fixpoint launches, expected "
                             f"{2 * kmax_probes(sx.k_max_graph)}")
    meta, arrays = bq._host_layout(sx)
    layout_mb = sum(a.nbytes for a in arrays.values()) / 1e6
    N = sx.num_nodes
    print(f"[index] n={g.n} m={g.m} t_max={g.t_max} |K|={len(sx.ks)} "
          f"(k={sx.ks[0]}..{sx.ks[-1]}) N={N} entries={sx.ent_ts.shape[0]} "
          f"vertex_entries={sx.vent_ts.shape[0]} "
          f"versions={meta['num_versions']} index_MB={layout_mb:.1f} "
          f"forests_from_card_strata_s={t_build:.2f} "
          f"(build from graph: {t_dev + t_build:.2f}s with the card's "
          f"strata, {t_host + t_build:.2f}s with the host's); k_max_graph "
          f"{sx.k_max_graph} on the card; kcore_fixpoint launches of the "
          f"build's k ranges {fix_builds}")

    # -- kernel: B1 vs its plain version at (256, N) ------------------------
    rng = np.random.default_rng(11)
    shape = (BUCKET, N)
    labels = torch.as_tensor(rng.integers(0, N + 1, shape, dtype=np.int32),
                             device=dev)
    links = [torch.as_tensor(rng.integers(-1, N, shape, dtype=np.int32),
                             device=dev) for _ in range(3)]
    active = torch.as_tensor(rng.random(shape) < 0.7, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    got = label_prop.label_prop_round(labels, *links, active, changed=flag)
    want = ref.label_prop_round(labels, *links, active)
    torch.cuda.synchronize()
    max_err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want) or got.dtype != torch.int32:
        raise AssertionError(f"B1 disagrees with its plain version "
                             f"(max abs err {max_err})")
    if bool(flag.item()) != bool((want != labels).any()):
        raise AssertionError("B1 change flag disagrees with the outputs")
    _, rand_kern = call_times(lambda: label_prop.label_prop_round(
        labels, *links, active, changed=flag))
    rand_plain_ms = cuda_ms(lambda: ref.label_prop_round(labels, *links,
                                                         active),
                            iters=5, warmup=1)
    n_active = int(active.sum())
    rand_bound = label_prop.bound_ms(*shape, n_active)
    print(f"[kernel] B1 label_prop_round at (B, N)={shape}, random links, "
          f"active share {n_active / active.numel():.4f}: bit-identical to "
          f"the plain version (max abs err {max_err}, tolerance 0: integer "
          f"output must match exactly); kernel {rand_kern}; plain "
          f"{rand_plain_ms:.4f} ms back to back, bound {rand_bound:.4f} ms "
          f"(bytes: 9*B*N + 12*active at 3.35 TB/s)")
    del labels, links, active, got, want

    # -- kernel: B2 on the sweep's operands and on random ids --------------
    count = segmented_select.segmented_count_le
    E, n = int(csr.src.shape[0]), g.n
    seg = torch.as_tensor(csr.src, device=dev)
    dst = torch.as_tensor(csr.dst.astype(np.int64), device=dev)
    tuv1 = torch.as_tensor(np.ascontiguousarray(
        ct._tuv_rows(csr, 1, 2, g.t_max)[0]), device=dev)
    c0 = torch.zeros(n, dtype=torch.int32, device=dev)
    w1 = torch.maximum(tuv1, c0[dst])            # ts = 1, k = ks[0], c = 0
    rand_seg = rng.integers(0, n, E).astype(np.int32)
    rand_seg[rng.random(E) < 0.1] = -1
    cases = {
        "sweep's first operands (ts=1, c=0)": (w1, seg, c0),
        "CSR ids, random thresholds": (
            w1, seg, torch.as_tensor(rng.integers(0, g.t_max + 2, n,
                                                  dtype=np.int32),
                                     device=dev)),
        "random unsorted ids, 10% -1 pads": (
            torch.as_tensor(rng.integers(0, g.t_max + 2, E, dtype=np.int32),
                            device=dev),
            torch.as_tensor(rand_seg, device=dev),
            torch.as_tensor(rng.integers(0, g.t_max + 2, n, dtype=np.int32),
                            device=dev))}
    b2_err = 0
    for what, (w, s, thr) in cases.items():
        b2_err = max(b2_err, check_equal(f"B2 on {what}", count(w, s, thr, n),
                                         ref.segmented_count_le(w, s, thr, n)))
    t = {"kernel": call_times(lambda: count(w1, seg, c0, n)),
         "plain": call_times(lambda: ref.segmented_count_le(w1, seg, c0,
                                                            n))}
    b2_ms, b2_plain = t["kernel"][0], t["plain"][0]
    b2_bound = segmented_select.bound_ms(E, n)
    print(f"[kernel] B2 segmented_count_le at E={E} slots, n={n} segments: "
          f"bit-identical to the plain version on {len(cases)} inputs "
          f"({'; '.join(cases)}; max abs err {b2_err}, tolerance 0). On the "
          f"sweep's first operands: {show(t)}; bound {b2_bound:.6f} ms "
          f"(bytes: 8*E + 8*n at 3.35 TB/s); library: none (no single "
          f"PyTorch call gathers a per-segment threshold, compares and "
          f"counts)")

    # -- kernel: B3a and B3b on the graph's edges, then the peel's operands --
    src_e = torch.as_tensor(g.src, device=dev)
    dst_e = torch.as_tensor(g.dst, device=dev)
    alive_e = torch.as_tensor(rng.random(g.m) < 0.7, device=dev)
    us, ud, inv = distinct_pairs(g, dev)
    alive_p = torch.ones(us.shape[0], dtype=torch.bool, device=dev)
    b3_err = [0, 0]
    degs = []
    for s, d, a in ((src_e, dst_e, alive_e), (us, ud, alive_p)):
        deg = kcore_peel.degree_count(s, d, a, n)
        degs.append(deg)
        b3_err[0] = max(b3_err[0], check_equal(
            "B3a", deg, ref.degree_count(s, d, a, n)))
        for k in (ks[0], ks[len(ks) // 2]):
            flag.zero_()
            got = kcore_peel.peel_threshold(s, d, a, deg, k, changed=flag)
            want = ref.peel_threshold(s, d, a, deg, k)
            b3_err[1] = max(b3_err[1], check_equal("B3b", got, want))
            if int(flag.item()) != int(bool((want != a).any())):
                raise AssertionError("B3b change flag disagrees with the "
                                     "outputs")
    # timed on the peel's first-round operands (all distinct pairs alive)
    m_p = int(us.shape[0])
    deg_e, deg_p = degs
    ends = torch.cat([us[alive_p], ud[alive_p]])      # masking, not timed
    ta = {"kernel": call_times(lambda: kcore_peel.degree_count(
              us, ud, alive_p, n)),
          "plain": call_times(lambda: ref.degree_count(us, ud, alive_p, n)),
          "library (torch.bincount over the alive endpoints, concatenated "
          "and masked outside the timed call)":
          call_times(lambda: torch.bincount(ends, minlength=n))}
    tb = {"kernel": call_times(lambda: kcore_peel.peel_threshold(
              us, ud, alive_p, deg_p, ks[0], changed=flag)),
          "plain": call_times(lambda: ref.peel_threshold(us, ud, alive_p,
                                                         deg_p, ks[0]))}
    (b3a_ms, b3a_plain, b3a_lib), (b3b_ms, b3b_plain) = (
        [v[0] for v in ta.values()], [v[0] for v in tb.values()])
    b3a_bound = kcore_peel.degree_bound_ms(m_p, n)
    b3b_bound = kcore_peel.threshold_bound_ms(m_p, n)
    full_ms = [call_times(lambda: kcore_peel.degree_count(src_e, dst_e,
                                                          alive_e, n))[0],
               call_times(lambda: kcore_peel.peel_threshold(
                   src_e, dst_e, alive_e, deg_e, ks[0], changed=flag))[0]]
    print(f"[kernel] B3a degree_count and B3b peel_threshold on the graph's "
          f"{g.m} edges (random alive, share 0.7) and on the peel's "
          f"{m_p} distinct pairs (all alive), k in ({ks[0]}, "
          f"{ks[len(ks) // 2]}): bit-identical to the plain versions (max "
          f"abs err {b3_err[0]} and {b3_err[1]}, tolerance 0), change flags "
          f"right. On the peel's first-round operands: B3a {show(ta)}; "
          f"bound {b3a_bound:.6f} ms (bytes: 9*m + 4*n). B3b {show(tb)}; "
          f"bound {b3b_bound:.6f} ms (bytes: 10*m + 4*n); library none (no "
          f"single PyTorch call gathers two degrees and thresholds). On all "
          f"{g.m} edges (device time with the host ahead, else back to "
          f"back): B3a {full_ms[0]:.6f} ms, B3b {full_ms[1]:.6f} ms")

    # -- peel: the main path of B3 (the fixpoint kernel), counted ----------
    fix_record, b3_peel = peel_phase(g, us, ud, inv,
                                     list(ks) + [sx.k_max_graph + 1])

    # -- baselines: EF-Index, CT-MSF, Borůvka and the oracle on the card ----
    base_fix, base_b1, base_sweeps = baselines_phase(g, dev, smi)
    sweep_record["launches"] += base_sweeps

    # -- upload ------------------------------------------------------------
    dix, t_up = wall(lambda: bq.device_index(meta, arrays, dev))
    print(f"[upload] {dix.nbytes() / 1e6:.1f} MB to {dix.device} in "
          f"{t_up:.3f}s")

    # -- serve: the main path, counted ---------------------------------------
    torch.cuda.reset_peak_memory_stats()
    label_prop.label_prop_round.launches = 0
    t0 = time.perf_counter()
    vert = serve.serve_graph(g, index=sx, dix=dix, n_queries=4 * BUCKET,
                             batch=BUCKET, mode="vertices", verify=64,
                             seed=0)
    edges = serve.serve_graph(g, index=sx, dix=dix, n_queries=16, batch=16,
                              mode="edges", verify=16, seed=1)
    k_sweep = sx.ks[len(sx.ks) // 4]
    windows = [(d, min(d + 40, g.t_max)) for d in range(1, 65)]
    sweep = serve.serve_sweep(sx, dix, 0, k_sweep, windows)
    if sweep["largest"] == 0:
        raise AssertionError("the sweep answered only empty components")
    launches = label_prop.label_prop_round.launches
    t_serve = time.perf_counter() - t0
    if launches <= 0:
        raise AssertionError("the main path launched B1 no time")
    if sum(vert["rounds"]) + sum(edges["rounds"]) + sum(sweep["rounds"]) \
            != launches:
        raise AssertionError("B1 launches do not match the rounds run")
    print(f"[serve] main path: {vert['checked']} + {edges['checked']} + "
          f"{len(windows)} answers checked, 0 mismatches; B1 launches "
          f"{launches}; vertex mode {vert['qps']:.1f} q/s "
          f"({vert['qps_steady']:.1f} after the first batch), rounds "
          f"{vert['rounds']}; edges batch {edges['batch_s'][0]:.3f}s; "
          f"phase {t_serve:.2f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- plain: the same batch with the plain round on the card --------------
    qs = [r.query for r in vert["results"][:BUCKET]]
    slots, ts, te = executor.pad_queries(
        bq.mixed_slots(sx, [(q.u, q.k) for q in qs]),
        [q.ts for q in qs], [q.te for q in qs], BUCKET)
    qs_t, ts_t, te_t = (torch.as_tensor(a, device=dev)
                        for a in (slots, ts, te))
    (e0_ok, e0c), t_entry = wall(lambda: bq._entry_nodes(
        dix, dix.vrow_ptr[qs_t], dix.vrow_ptr[qs_t + 1], ts_t, te_t))
    ops, t_links = wall(lambda: bq._resolve_links(dix, ts_t, te_t))
    (lab_k, rounds_k), t_prop = wall(lambda: bq._propagate(*ops))
    mask_k, t_members = wall(lambda: bq._members(dix, lab_k, ops[3], e0_ok,
                                                e0c))
    _, t_down = wall(lambda: mask_k.cpu().numpy())

    def plain_round(labels, l, r, p, act, *, changed):
        out = ref.label_prop_round(labels, l, r, p, act)
        if bool((out != labels).any()):
            changed.fill_(1)
        return out

    with mock.patch.object(bq, "label_prop_round", plain_round):
        (lab_p, rounds_p), t_prop_plain = wall(lambda: bq._propagate(*ops))
        mask_p = bq.batch_query(dix, qs_t, ts_t, te_t)
    if not (torch.equal(lab_k, lab_p) and rounds_k == rounds_p
            and torch.equal(mask_k, mask_p)):
        raise AssertionError("batch_query with B1 disagrees with the plain "
                             "round on the card")
    # B1 timed on the main path's own operands: the batch's first round
    active = ops[3]
    n_active = int(active.sum())
    bound = label_prop.bound_ms(BUCKET, N, n_active)
    lab0 = torch.where(active, torch.arange(N, dtype=torch.int32,
                                            device=dev)[None, :], N)
    got = label_prop.label_prop_round(lab0, *ops, changed=flag)
    want = ref.label_prop_round(lab0, *ops)
    torch.cuda.synchronize()
    max_err = max(max_err, int((got.long() - want.long()).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError("B1 disagrees with its plain version on the "
                             "main path's operands")
    ms, b1_kern = call_times(lambda: label_prop.label_prop_round(
        lab0, *ops, changed=flag))
    plain_ms = cuda_ms(lambda: ref.label_prop_round(lab0, *ops),
                       iters=5, warmup=1)
    print(f"[plain] batch of {BUCKET}: labels and masks identical with B1 "
          f"and with the plain round ({rounds_k} rounds each); stage "
          f"seconds: entry {t_entry:.4f}, links+active {t_links:.4f}, "
          f"propagation {t_prop:.4f} (plain round {t_prop_plain:.4f}), "
          f"members {t_members:.4f}, download {t_down:.4f}")
    print(f"[plain] B1 on the batch's first-round operands (active share "
          f"{n_active / active.numel():.4f}, the same in every round): "
          f"bit-identical to the plain version; kernel {b1_kern}; plain "
          f"{plain_ms:.4f} ms back to back, bound {bound:.4f} ms (9*B*N + "
          f"12*active bytes) = {bound / ms:.3f} of bound; "
          f"{label_prop.bound_ms(BUCKET, N, active.numel()) / ms:.3f} of "
          f"the all-active 21*B*N bound; {t_prop / rounds_k * 1e3:.4f} ms "
          f"per round in the loop (kernel + flag read)")

    # -- profile: one served batch under torch.profiler ---------------------
    ex = executor.ShardedExecutor(dev)
    ex.run(dix, slots, ts, te, BUCKET)                  # warm
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, t_batch = wall(lambda: ex.run(dix, slots, ts, te, BUCKET))
    kern = device_rows(prof)
    busy_us = sum(t for _, t, _ in kern)
    b1_us = sum(t for key, t, _ in kern if "label_prop_round" in key)
    busy = (f"device busy {busy_us / 1e6:.4f}s (idle share "
            f"{1 - busy_us / 1e6 / t_batch:.3f}), B1 {b1_us / 1e6:.4f}s"
            if busy_us else "device busy not measured (no device events)")
    print(f"[profile] one batch of {BUCKET}: wall {t_batch:.4f}s, {busy}; "
          f"top kernels: " + top_rows(kern))

    f0 = kcore_peel.kcore_fixpoint.launches
    epoch_sweeps, epoch_b1 = epoch_phase(g, sx, dix, dev)
    sweep_record["launches"] += epoch_sweeps
    engine_b1, engine_sweeps = engine_phase(g, sx, dev, smi)
    sweep_record["launches"] += engine_sweeps
    multi_b1, multi_sweeps = multi_phase(g, smi)
    sweep_record["launches"] += multi_sweeps
    store_b1, store_sweeps = store_phase(g, dev, smi)
    sweep_record["launches"] += store_sweeps
    fix_epochs = kcore_peel.kcore_fixpoint.launches - f0
    if fix_epochs <= 0:
        raise AssertionError("the card builds, ingests and trims of [epoch], "
                             "[engine], [multi] and [store] peeled no k "
                             "range on the card")
    peel_fix = fix_record["launches"]
    fix_record["launches"] = peel_fix + base_fix + fix_builds + fix_epochs
    print(f"[kcore] kcore_fixpoint launches {fix_record['launches']}: [peel] "
          f"{peel_fix}, [baselines] {base_fix}, the k ranges of the card "
          f"builds "
          f"{fix_builds} ([construct] and [index]) + {fix_epochs} (the "
          f"builds, ingests and trims of [epoch], [engine], [multi] and "
          f"[store])")

    lm_records = lm_phase(dev)
    smoke_b5, smoke_b6 = lm_smoke_phase(dev)
    lm_records[0]["launches"] += smoke_b5
    lm_records[1]["launches"] += smoke_b6
    b4_record, b5_gnn_launches, b5_gnn_err = gnn_phase(dev)
    b5_record = lm_records[0]
    b5_record["launches"] += b5_gnn_launches
    b5_record["max_abs_err"] = max(b5_record["max_abs_err"], b5_gnn_err)
    trained = train_phase(dev, smi)
    b5_record["launches"] += trained["b5"]
    lm_records[1]["launches"] += trained["b6"]
    b4_record["launches"] += trained["b4"]
    moe = moe_phase(dev, smi)
    b5_record["launches"] += moe["b5"]
    b5_record["max_abs_err"] = max(b5_record["max_abs_err"],
                                   moe["max_abs_err"])
    lm_records[1]["launches"] += moe["b6"]
    trained["records"][0]["launches"] += moe["b5_grad"]
    trained["records"][1]["launches"] += moe["b6_bwd"]
    mgn = mgn_phase(dev, smi)
    geo = geo_phase(dev, smi)
    for run in (mgn, geo):
        b5_record["launches"] += run["b5"]
        b4_record["launches"] += run["b4"]
        trained["records"][0]["launches"] += run["b5_grad"]
        trained["records"][2]["launches"] += run["gather"]
    recs = recsys_phase(dev, smi)
    b5_record["launches"] += recs["b5"]
    trained["records"][0]["launches"] += recs["b5_grad"]
    b4_record["launches"] += recs["b4"]
    b5_record["max_abs_err"] = max(b5_record["max_abs_err"], mgn["b5_err"],
                                   recs["b5_err"])
    b4_record["max_abs_err"] = max(b4_record["max_abs_err"], mgn["b4_err"],
                                   geo["b4_err"], recs["b4_err"])
    rt = runtime_phase(dev, smi)
    b5_record["launches"] += rt["b5"]
    trained["records"][0]["launches"] += rt["b5_grad"]
    b4_record["launches"] += rt["b4"]
    b5_record["max_abs_err"] = max(b5_record["max_abs_err"], rt["b5_err"])
    contracts_phase(g, dev, smi)
    meshed = mesh_phase(dev, smi)
    b5_record["launches"] += meshed["b5"]
    b5_record["max_abs_err"] = max(b5_record["max_abs_err"],
                                   meshed["b5_err"])
    lm_records[1]["launches"] += meshed["b6"]
    b4_record["launches"] += meshed["b4"]
    b4_record["max_abs_err"] = max(b4_record["max_abs_err"],
                                   meshed["b4_err"])
    trained["records"][0]["launches"] += meshed["b5_grad"]
    trained["records"][1]["launches"] += meshed["b6_bwd"]

    csrc = "src/repro_torch/kernels/csrc/"
    records = [
        {"name": "label_prop_round", "route": "cuda",
         "source": csrc + "label_prop.cu",
         "replaces": "src/repro/kernels/label_prop.py:70",
         "launches": launches + base_b1 + epoch_b1 + engine_b1 + multi_b1
         + store_b1,
         "max_abs_err": max_err, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
         "library_ms": None},
        {"name": "segmented_count_le", "route": "cuda",
         "source": csrc + "segmented_count_le.cu",
         "replaces": "src/repro/kernels/segmented_select.py:117",
         "launches": b2_launches, "max_abs_err": b2_err, "ms": b2_ms,
         "plain_ms": b2_plain, "bound_ms": b2_bound, "bound_by": "bytes",
         "library_ms": None},
        sweep_record,
        {"name": "degree_count", "route": "cuda",
         "source": csrc + "kcore_peel.cu",
         "replaces": "src/repro/kernels/kcore_peel.py:62",
         "launches": b3_peel[0], "max_abs_err": b3_err[0], "ms": b3a_ms,
         "plain_ms": b3a_plain, "bound_ms": b3a_bound, "bound_by": "bytes",
         "library_ms": b3a_lib},
        {"name": "peel_threshold", "route": "cuda",
         "source": csrc + "kcore_peel.cu",
         "replaces": "src/repro/kernels/kcore_peel.py:117",
         "launches": b3_peel[1], "max_abs_err": b3_err[1], "ms": b3b_ms,
         "plain_ms": b3b_plain, "bound_ms": b3b_bound, "bound_by": "bytes",
         "library_ms": None}, fix_record, b4_record] + lm_records + \
        trained["records"]
    print(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}s"
          f" ({smi})")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
