#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error:

1. set-up: the card's name and power limit; every CUDA kernel built from
   ``src/repro_torch/kernels/csrc`` with one ``nvcc`` per source, all at
   once, and ptxas's registers, spills and shared memory for the two
   prefill kernels, both MLA kernels, the fused and the segment-sum
   kernels;
2. retrieval path: a ``growing_network(2_000_000)`` history (the
   generator's analogue of the paper's Dataset 1) indexed by a
   ``GraphManager`` (``L=50_000, k=4, diff_fn="intersection"``, no snapshot
   cache, ``device="cuda"``) whose ``DeltaGraph`` serves this phase and the
   next; 64 timepoints retrieved by
   ``execute_multipoint_torch(land_in_pool=True)`` and 8 by
   ``execute_singlepoint_fused`` with ``degrees()``, checked against the
   ``replay`` oracle.  Launch counts are zeroed just before and read just
   after: each of the path's three kernels must have run, the fused
   kernel once per fused retrieval (``delta_apply_fused_pair``: node and
   edge planes in one launch) and segment-sum twice per ``degrees()``;
3. evolve path, on the same manager: ``dense_intervals(tmax, 8, 32,
   window_frac=0.05)`` (``serve --mode evolve``'s default workload);
   ``GraphManager.evolve`` for masks, degree, PageRank
   (tol 1e-6) and components, incrementally at every point and by the
   recompute engine at every 4th; ``evolve_intervals_torch`` over the
   8 intervals at once; one ``SnapshotBatchLoader`` window (8 points, a label
   horizon).  Checks, at every 4th point: masks equal ``replay``, degrees
   a ``bincount`` of its live edges, components of both engines equal
   and equal to scipy's partition of the replayed snapshot, PageRank of
   the two engines within L1 5e-5 and max 1e-5; the interval sweep's masks
   equal the incremental engine's at every point; the loader's edge and
   label masks, edge counts and raw degrees equal replay's at every point
   of its window.  Launch counts zeroed before and read after each
   sub-phase: the sweep launches the chain kernel; the loader launches the
   fused kernel once per degree pass (two a window: the window and its
   horizon) and segment-sum twice per timepoint of each pass;
4. sharded path, on the same history: a second ``GraphManager`` with 8
   ``word_cyclic`` storage partitions (the reference's 8-device retrieval
   mesh); at the main path's 8 fused timepoints
   ``execute_singlepoint_sharded_torch(partitions=8)``, the ``[8, Wp]``
   word-cyclic rows as the batch of one chain launch per plane (launch
   counts zeroed before and read after: exactly 2 a timepoint, batch 8,
   no other kernel), masks equal to ``replay`` and to the unsharded
   ``execute_singlepoint_torch``; the host lowering timed apart; the chain
   kernel at the largest sharded shape bit for bit against its plain
   version, timed, and each row independent (bits added to one row's adds
   change that row of the output only); the non-aligned branch
   (``mod_hash`` at 4 storage partitions, 8 rows) on a churn history
   against ``replay``; then ``get_snapshots`` at the 8 timepoints through
   the query service unsharded, through 4 in-thread shard workers and
   through 2 ``repro_torch.launch.shardd`` processes with 2 replicas each
   (every child's ``/proc/<pid>/cmdline`` read), one of them SIGKILLed
   before a last query that must still equal ``replay`` and fail over;
   last, the rank-local form: 2 ``gloo`` ranks (processes sharing the
   card) over 8 ``word_cyclic`` partitions of a ``churn_network`` history,
   each lowering and landing its own 4 rows through
   ``execute_singlepoint_sharded_rank`` (one chain launch per plane, batch
   4, counts zeroed before and read after in each rank) at 8 timepoints,
   masks equal to ``replay`` and to the one-launch path on every rank;
5. retrieval kernels: each against its plain PyTorch version on the card,
   at full width (chain W = 2^21 words, K = 16, B = 8; fused W = 2^21,
   K = 16 with weights, ``live`` on and off; segment-sum on the degree
   feeds by source and by destination node, the second with hub buckets)
   and at the largest shape the path gave it (for the fused kernel,
   the largest pair call, and its edge plane alone); bit for bit (degrees
   exactly, and
   segment-sum also on general f32 and against ``index_add_``).  Kernel
   and ``index_add_`` times are device times, a CUDA graph of repeated
   calls replayed between CUDA events, beside the same calls in a host
   loop (``host_loop_ms``: adds the wrapper's host work); plain and bound
   times;
6. churn: a ``churn_network`` history with deletes and transient slots,
   monolithic and streamed (``DeviceStager``) retrieval and fused
   analytics, and ``evolve_intervals_torch`` (monolithic and streamed) and
   a ``SnapshotBatchLoader`` window, against ``replay``;
7. LM serving: gemma3-1b at full width and depth (26 layers, d 1152,
   vocab 262,144, bf16, seeded random weights) through
   ``repro_torch.launch.serve.serve_lm``: batch 8, a 4,096-token prompt,
   32 greedy decode steps (the repo's ``prefill_32k`` / ``decode_32k``
   cut to one card).  Checks: finite logits; ``flash_attention``
   launched 26 times per forward call, every prefill call through the
   wgmma/TMA prefill kernel (``flash_attention_prefill``: 26 per prefill
   forward) and every decode call through the split-K decode kernel
   (``flash_attention_decode``: 26 per decode step); prefill of
   ``prompt[:, :-16]`` and 16 decode steps against the whole prompt's
   prefill (relative error of the last logits): in bf16 within the
   reference's 5e-2 at the first 6 layers, and at full depth within 1.5
   times the drift of the same run with the plain attention in the
   kernel's place (at full depth bf16 drifts past 5e-2 whatever computes
   attention); in f32 at full depth within 1e-3, the f32 path, whose
   prefill calls go to the TF32 kernel (``flash_attention_prefill_f32``:
   26 per prefill forward); a kernel that drops the last key tile must
   fail the bf16 check.  The kernel against its plain version at each
   attention shape the path used (local and global prefill, local and
   global decode at ``q_offset`` 4,100 against the ``max_len`` cache) in
   bf16 within 2e-2 and, element by element, two bf16 ulps plus 1e-5
   (which the plain version with the last key tile dropped must fail),
   and at each of these four shapes in f32 within 3e-5 (the two prefill
   shapes through ``flash_prefill_f32.cu``, by launch count); each shape
   names the kernel that ran and its splits.  Kernel and
   ``scaled_dot_product_attention`` times (over the visible keys) are
   device times, a CUDA graph of repeated calls replayed between CUDA
   events, beside the same calls in a host loop (which the wrapper's host
   work bounds at decode); at the prefill shapes also the old prefill
   kernel (``attention_mma_kernel``, through ``ops._attention_mma``) in
   the same run, and its error; plain and bound times; prefill ms, decode
   ms per step and tokens per second.  Then the two shapes
   ``flash_attention.cu`` served before its kernels were replaced, each
   through its new kernel against the plain version, SDPA and the old
   kernel in the same run: stablelm-12b's prefill (bf16, q [1, 32, 4096,
   160], k/v [1, 8, 4096, 160], causal) through ``flash_prefill.cu`` at
   (192, 192) against ``attention_mma_kernel``, and gemma3-1b's global
   prefill in f32 through ``flash_prefill_f32.cu`` against
   ``attention_simt_kernel``.  Last, stablelm-12b at full width and depth
   (40 layers, d 5120, 32:8 heads of 160, bf16, seeded random weights,
   about 24 GB; batch 1, a 4,096-token prompt, 16 decode steps): the
   tail drift within 1.5 times the plain version's, the decode kernel
   against its plain version at stablelm's decode shape (q [1, 32, 1,
   160] on the ``max_len`` cache; 2e-2 and two ulps), then ``serve_lm``
   timed, every prefill attention call through ``flash_prefill.cu`` (40
   per forward) and none through ``flash_attention.cu``;
8. MLA and MoE serving: deepseek-v3 at full width (d 7168, 128 heads,
   MLA 1536/512/128/64/128, 256 routed experts of 2048 + 1 shared, top-8,
   ``sigmoid_aux_free``, capacity 1.25, vocab 129,280, bf16, seeded random
   weights) cut to 3 layers (1 dense + 2 MoE), ``mtp`` off: batch 8, a
   4,096-token prompt, 32 decode steps; then arctic at full width (d 7168,
   56:8 heads of 128, dense 4,864 ∥ 128 experts of 4,864, top-2) cut to 2
   layers: batch 8, a 2,048-token prompt, 8 decode steps; each model's
   weights freed before the next.  For each, the tail drift (16 steps) on a
   no-drop variant (``capacity_factor = E / K``, batch 1, a 256-token
   prompt): deepseek-v3 within 1.5 times the plain attention's drift in
   the same run on 2 weight x 8 prompt seeds, with its router free (the
   medians: a decode step's routes may flip on any rounding) and with
   every token's routes pinned (each seed), and every MLA call of its
   first decode within the bf16 limit of the plain version; arctic within
   the reference's 5e-2; the published capacity's drift printed.
   ``serve_lm`` timed (prefill ms, decode ms a
   step, peak device memory), launch counts zeroed before and read after:
   every prefill attention call through ``flash_prefill.cu`` (deepseek's
   MLA prefill at its (192, 128) instantiation), every decode call
   through ``flash_mla_wgmma.cu`` (deepseek: 3 a step) or
   ``flash_decode.cu`` (arctic: 2 a step), none through
   ``flash_attention.cu`` or ``flash_mla.cu``.  Then the MLA kernel
   against its plain version at the served decode shape (q [8, 128, 1,
   576], k [8, 1, 4128, 576], v its first 512 columns, q_offset 4,100;
   2e-2 and two bf16 ulps, which the kernel without its last 64-key tile
   must fail), with ``cudaOccupancyMaxActiveClusters`` for clusters of 1
   to 8 blocks (the plan's cluster size), timed beside the first MLA
   kernel (``flash_mla.cu`` through ``ops._mla_mma``, held to the same
   limits), the plain version and SDPA; and the MLA prefill shape (q/k
   [8, 128, 4096, 192]) through ``flash_prefill.cu`` against the plain
   version on 4 of its heads.

9. training (the slice's main path): the prefill kernels' statistics
   output (``attention_stats``) at the LM phase's served shapes and at the
   training step's, bf16 and f32: ``out`` bit for bit against the same
   launch without statistics, ``(out, m, l)`` against the plain version
   (m within 1e-5·(1 + |m|), l within 1e-4), both launches and SDPA
   timed; the attention backward (``attention_bwd``, the reference's
   chunked recompute in torch ops) timed beside SDPA's backward on the
   same inputs; reduced gemma3-1b and deepseek-v3 (``mtp`` on, routes
   pinned) in f32: ``loss_fn``'s gradients on the card within 1e-4 of the
   CPU's, every attention call through the f32 statistics kernel (counts
   zeroed before, read after); then gemma3-1b at full width (26 layers, d
   1152, the tied 262k vocabulary, bf16, AdamW, seeded random weights)
   through ``launch/train.train``: 8 steps of B 2 x 2,048 on one repeated
   batch, launch counts zeroed before and read after (52 statistics
   launches a step: 26 in the forward, 26 when the backward recomputes
   each layer), ms per step, peak device memory, the loss finite and
   falling; a crash after the checkpoint at step 4 (``LogFileKV`` in a
   temporary directory) and the resume, whose losses, parameters and
   optimizer state equal the uninterrupted run's bit for bit; one pass at
   ``accum_steps = 4`` (B 8).
10. GNN and DIN: (a) the temporal GCN of
   ``examples/pt_temporal_gnn_train.py`` (d_in 16, d_hidden 32, 2 layers,
   AdamW at 5e-3) on the main history, through the example's own
   functions: two ``SnapshotBatchLoader`` windows of 4 points of its grid
   feed 8 steps; launch counts zeroed before and read after (2 fused and
   16 segment-sum launches a window, the sweep's chain launches); the
   first window against ``replay``; the first step's loss and gradients
   on the card against the CPU's from the same parameters and batch; a
   checkpoint through ``LogFileKV`` read back bit for bit.  (b) gcn-cora
   at ``full_graph_sm``, gin-tu at ``molecule`` (128 graphs, a readout),
   meshgraphnet and dimenet at ``minibatch_lg`` on a ``sample_blocks``
   block (1,024 seeds, fanouts (15, 10), padded to 169,984 nodes and
   168,960 edge slots; dimenet 675,840 triplets) of the main history's
   last snapshot: published widths, the config adapted to the shape, 4
   AdamW steps on one seeded batch (loss finite and falling), the first
   gradient's global norm in f64 and f32; each reduced config on the card
   against the CPU; meshgraphnet at 32 gather chunks against none, both
   in f64 on the card (so that the comparison sees the chunking, not the
   atomics' order of additions; the decoder, f32 in the model, stays
   f32), loss and gradients within 1e-5 / 1e-4.
   (c)
   DIN at its published config (a 10 M-row goods table): 4 steps through
   ``launch/train`` at B 65,536 (loss finite and falling), the reduced
   config on the card against the CPU, ``din_retrieval`` of one user
   against 1,000,000 candidates against the CPU's (1e-5 relative), and
   ``launch/serve``'s DIN mode at B 512 and 262,144.  Card against CPU:
   the loss within 1e-5 relative, every gradient leaf within 1e-4 of its
   largest CPU magnitude (``index_add_`` adds with float atomics on the
   card; deterministic algorithms are not turned on).  Each part prints
   its wall seconds, ms a step and peak GiB; the three retrieval kernels'
   records gain the launches of (a) (``temporal_gcn_launches``).
11. the dry run (``repro_torch.launch.dryrun``), which needs no card:
   (a) the whole sweep, 40 cells on both production meshes, traced on
   the ``meta`` device: 74 records ok, 6 skipped (``long_500k`` of yi-34b,
   stablelm-12b and arctic-480b), none in error; a line a record (its
   ``collective_s`` from the sharding pass, its bottleneck of the three
   terms, any op the pass has no rule for, which fails the phase), the
   cells by bottleneck on each mesh, and the sweep's seconds.  (b) The eight cells phase 10 runs at their
   registered shapes (gcn-cora × ``full_graph_sm``, gin-tu ×
   ``molecule``, meshgraphnet and dimenet × ``minibatch_lg``, DIN ×
   ``train_batch``, ``serve_p99``, ``serve_bulk``, ``retrieval_cand``):
   each cell's step traced on ``meta`` (its peak live bytes, arguments
   included, and its one-card roofline on the H100's data-sheet peaks),
   then run on the card on seeded arguments of the same shapes: a warm-up
   step, then ``DRYRUN_STEPS`` timed steps, the first after
   ``reset_peak_memory_stats``; the predicted peak held within
   ``PEAK_BAND`` (0.8–1.25) of ``max_memory_allocated()`` less what was
   allocated before the arguments and what the warm-up left behind (a
   workspace a library makes at its first use: at most cuBLAS's, or the
   phase fails), the step's loss or
   scores finite, nothing left allocated after the steps; the roofline's
   time printed beside the measured ms, with the top ops by bytes, and
   one more step under ``torch.profiler`` (device ms: products, the rest,
   the top kernels).  (c)
   Meta traces of gemma3-1b's ``prefill_step`` (B 8 × 4,096) and one
   ``decode_step``, and of deepseek-v3's at phase 8's 3 layers, count the
   kernel routes and calls that phases 7 and 8 launched on the card: 26
   ``flash_prefill`` and 26 ``flash_decode``; 3 ``flash_prefill`` and 3
   ``flash_mla``; the decode counts times the runs' 32 steps equal the
   card's totals exactly (their predicted peaks printed, not held: the
   kernels' workspaces exist on the card only).  The phase's record is printed on
   its own line before the kernels' record.
12. the retrieval examples through their functions, on the card: (a)
   ``examples/pt_quickstart.py`` as written, its lines equal to a host
   run's; (b) ``examples/pt_evolution_analysis.py`` on phase 2's manager
   at 6 epochs (one multipoint retrieval, PageRank of the stacked planes
   on the card by ``index_add_``, within 1e-5 of the host's from the same
   planes; the rank table and the triangle counts on the host); (c)
   ``examples/pt_snapshot_server.py`` on a manager of the main history
   built with the example's index parameters but L = 50,000 and 4
   partitions, 64 requests in batches of 8, the first batch's masks equal
   to ``replay``, p50 / p99 printed.  Wall seconds of each; launch counts
   zeroed before and read after (none of the four kernels runs: retrieval
   through the query service is host work).

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor 32-bit rate (data sheet)
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor rate (data sheet)
TF32_OPS_PER_S = 495e12         # H100 SXM dense TF32 tensor rate (data sheet)
SEED = 0
# the attention kernel against its plain version in bf16, element by
# element: both sum in f32 and round once to bf16, so they differ by at
# most one bf16 ulp (2^-7 of the value at most) plus f32 noise from the
# order of the sums (5e-7 measured in f32 at the global-prefill shape).
# The limit allows two ulps and 1e-5.
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-5
RETRIEVAL_KERNELS = ("delta_apply_chain", "delta_apply_fused",
                     "segment_sum_bucketed")
# LM serving: gemma3-1b at full width and depth.  The repo's LM shapes
# prefill_32k (B = 32) and decode_32k (B = 128) at 32,768 tokens are cut
# to one card: 32k-token caches at B = 128 alone would take 112 GB.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_TAIL = "gemma3-1b", 8, 4096, 32, 16
# the tail-drift checks (lm_phase): the reference's 5e-2 bound at a cut
# depth of 6 layers (five local, one global); at full depth, the kernel's
# bf16 drift against the plain version's on the same prompt
LM_CUT_LAYERS, DRIFT_OVER_PLAIN = 6, 1.5
# stablelm-12b at full width and depth (40 layers, 32:8 heads of 160: the
# bf16 prefill kernel's (192, 192) instantiation), batch 1, uncut
ST_ARCH, ST_BATCH, ST_PROMPT, ST_GEN = "stablelm-12b", 1, 4096, 16
# deepseek-v3 and arctic at full width (their published configs), at a
# depth one card holds: deepseek 1 dense + 2 MoE layers (25.5 G parameters,
# 51 GB in bf16; a third MoE layer would be 73 GB), mtp off (only training
# runs it), batch 8 x a 4,096-token prompt, 32 decode steps; arctic 2
# layers (27.7 G, 55 GB), batch 8 x 2,048, 8 decode steps.  Their tail
# drift on a no-drop variant (capacity_factor E / K): batch 1, a 256-token
# prompt, 16 tail steps.  At the published capacity 1.25 a decode step of
# B = 8 gets C = 1 slot an expert, so prefill and decode drop different
# assignments and the drift there is printed, not held.
DS_ARCH, DS_LAYERS, DS_DENSE = "deepseek-v3-671b", 3, 1
DS_BATCH, DS_PROMPT, DS_GEN = 8, 4096, 32
AR_ARCH, AR_LAYERS, AR_BATCH, AR_PROMPT, AR_GEN = "arctic-480b", 2, 8, 2048, 8
DRIFT_PROMPT = 256
# deepseek-v3's router takes 8 of 256 experts by sigmoid scores whose 8th
# and 9th lie 1e-5 to 1e-2 apart, so decode and prefill route a few tail
# tokens differently in every run, and when the last token's routes differ
# the drift jumps from about 0.013 to about 0.1, through any correct
# attention (the plain version's own on 4 of these 16 seeds; PERF.md).  Its
# drift is held with free routes on the median over these weight x prompt
# seeds, and with every token's routes pinned on each of them.
DRIFT_WEIGHT_SEEDS, DRIFT_PROMPT_SEEDS = (0, 1), 8
# evolve path: serve --mode evolve's default workload, 8 intervals of 32
# points over 5 % of the history each; the recompute engine and the checks
# run at every 4th point.  One loader window of 8 points: its
# bucket_edges runs twice per timepoint and pass, on the card (the
# window's data lies there).
EVOLVE_INTERVALS, EVOLVE_POINTS, CHECK_EVERY, LOADER_BATCH = 8, 32, 4, 8
# sharded path: 8 word_cyclic storage partitions, as the reference's
# 8-device retrieval mesh, laid out as 8 rows of one batched chain launch
SHARD_PARTITIONS = 8
# training: gemma3-1b at full width through launch/train (the slice's main
# path: flash_prefill.cu with its statistics output, the chunked backward,
# AdamW), B 2 x 2,048 a step on one repeated batch; one step at
# B 8 = TRAIN_ACCUM micro-batches of 2; a crash after a checkpoint and the
# resume, held bit for bit to the uninterrupted run
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "gemma3-1b", 2, 2048, 8
TRAIN_LR, TRAIN_ACCUM, TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 1e-3, 4, 4, 5
# reduced models in f32, gradients on the card against the CPU's: every
# leaf within 1e-4 of its largest magnitude (the CPU tests' bound against
# JAX: sums in another order; the card's f32 prefill kernel carries its
# products as three TF32 terms, within 3·2^-22 of f32)
GRAD_ARCHS, GRAD_TOL = ("gemma3-1b", "deepseek-v3-671b"), 1e-4
# the kernels' row statistics against the plain version's: m within
# 1e-5·(1 + |m|) (the log2-domain max times ln 2, a few ulps), l within
# 1e-4 relative (ex2.approx terms summed in another order over up to
# 4,128 keys)
STATS_M_TOL, STATS_L_TOL = 1e-5, 1e-4
# rank-local sharded retrieval: 2 gloo ranks sharing the card, 8
# word_cyclic partitions (4 rows a rank), on a churn history
RANK_WORLD = 2
# GNN and DIN (phase 10): the example's temporal GCN on GCN_WINDOWS loader
# windows of the main history; each GNN architecture at its published
# widths on one batch of a shape of configs/shapes.py (ogb_products, 61.9 M
# edges, is left out: one card cannot hold it), GNN_STEPS AdamW steps at a
# constant GNN_LR (the launcher's default; GIN's loss overshoots at 1e-3
# on some seeds); MeshGraphNet at the reference's 32 gather chunks for
# large graphs against none (in f64); DIN at its published config through
# launch/train (DIN_STEPS steps under its warmup_cosine from DIN_LR) and
# launch/serve.  Card against CPU in f32 within 1e-5 (loss, relative) and
# GRAD_TOL (gradients): aggregation on the card adds with float atomics
GCN_WINDOWS = 2
GNN_CELLS = (("gcn-cora", "full_graph_sm"), ("gin-tu", "molecule"),
             ("meshgraphnet", "minibatch_lg"), ("dimenet", "minibatch_lg"))
GNN_STEPS, GNN_LR, MGN_CHUNKS = 4, 3e-4, 32
DIN_STEPS, DIN_LR = 4, 1e-2

# the dry run (phase 11): the whole sweep on the meta device (74 records
# ok, 6 skipped: long_500k of the three pure-GQA archs); the cells phase 10
# runs at their registered shapes, predicted on meta and run on the card,
# the predicted peak held within PEAK_BAND of the measured one, each step
# timed DRYRUN_STEPS times after a warm-up
DRYRUN_SWEEP = {"ok": 74, "skipped": 6, "error": 0}
DRYRUN_CARD_CELLS = (("gcn-cora", "full_graph_sm"), ("gin-tu", "molecule"),
                     ("meshgraphnet", "minibatch_lg"),
                     ("dimenet", "minibatch_lg"), ("din", "train_batch"),
                     ("din", "serve_p99"), ("din", "serve_bulk"),
                     ("din", "retrieval_cand"))
PEAK_BAND = (0.8, 1.25)
# the retrieval examples (phase 12): the evolution analysis at the
# example's 6 epochs over the main history, its PageRank planes on the card
# within PAGERANK_TOL of the host's, relative to the largest rank (a rank
# sums to 1 over ~600k nodes, so a node's is ~1e-6; index_add_ adds with
# float atomics on the card); the snapshot server on the main history at the example's
# index parameters (k 4, "balanced", 4 partitions) but L 50,000, as the
# main path's manager, SERVER_REQUESTS requests in batches of SERVER_BATCH
EXAMPLE_EPOCHS, PAGERANK_TOL = 6, 1e-5
SERVER_L, SERVER_REQUESTS, SERVER_BATCH = 50_000, 64, 8
# PyTorch's default cuBLAS workspace on sm_90 (CUBLAS_WORKSPACE_CONFIG
# ":4096:8", 8 chunks of 4096 KiB): what a first product may leave held
CUBLAS_WORKSPACE_BYTES = 8 * 4096 * 1024
DRYRUN_STEPS = 3


def fail(msg: str) -> None:
    raise AssertionError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card with no host in the way:
    ``iters`` calls captured in one CUDA graph, replayed ``reps`` times
    between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm-up off the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S
             ) -> tuple[float, str]:
    """Least time for ``nbytes`` moved and ``ops`` done at ``ops_per_s``,
    and its bound."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_abs_err(got, want) -> float:
    """Largest |got - want|: words compared as unsigned 32-bit integers,
    floats as floats; 0 means identical."""
    import torch
    if got.dtype == torch.int32:
        g = got.to(torch.int64) & 0xFFFFFFFF
        w = want.to(torch.int64) & 0xFFFFFFFF
        return float((g - w).abs().max()) if g.numel() else 0.0
    return float((got - want).abs().max()) if got.numel() else 0.0


def over_bf16_limit(got, want) -> float:
    """The largest |got - want| / (BF16_RTOL·|want| + BF16_ATOL) over the
    elements of two bf16 results: at most 1 when each element is within
    one bf16 ulp of ``want`` plus f32 summation noise."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (BF16_RTOL * w.abs() + BF16_ATOL)).max())


@contextlib.contextmanager
def pinned_routes(params: dict, top_k: int):
    """Every token's MoE routes pinned to experts 0..top_k-1 inside the
    block: each ``router_bias`` set to 2 there and 0 elsewhere (sigmoid
    scores lie in (0, 1), so the bias decides), restored after."""
    biases = [g["router_bias"] for g in params.values()
              if isinstance(g, dict) and "router_bias" in g]
    saved = [b.clone() for b in biases]
    for b in biases:
        b.zero_()
        b[..., :top_k] = 2.0
    try:
        yield
    finally:
        for b, b0 in zip(biases, saved):
            b.copy_(b0)


def same_bits(got, want) -> bool:
    import torch
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got, want)


def rand_words(gen, shape, dev):
    import torch
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int32, device=dev)


def visible_span(Sq: int, Sk: int, window, q_offset: int
                 ) -> tuple[int, int, int]:
    """Causal attention of Sq rows from ``q_offset`` over Sk keys: the
    unmasked (query, key) pairs, and the first and one-past-last key any
    row sees."""
    pairs, lo, hi = 0, Sk, 0
    for i in range(Sq):
        qpos = i + q_offset
        a = 0 if window is None else max(0, qpos - window + 1)
        b = min(Sk, qpos + 1)
        if b > a:
            pairs, lo, hi = pairs + b - a, min(lo, a), max(hi, b)
    return pairs, lo, max(hi, lo)


def print_ptxas(log: str, kernel: str) -> None:
    """ptxas's registers, spills and shared memory for each instantiation
    of ``kernel``, from the build's ``-Xptxas -v`` output."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m[1].split(kernel, 1)
            args = (re.findall(r"L[ib](n?\d+)E", mangled[1].split("EEv")[0])
                    if len(mangled) == 2 else None)
            name = None if args is None else (
                f"{kernel}<{', '.join(a.replace('n', '-') for a in args)}>"
                if args else kernel)
        elif name and ("spill" in line or "registers" in line):
            print(f"ptxas {name}: "
                  f"{line.strip().removeprefix('ptxas info    : ')}")


def live_degrees(uni, edge_mask):
    """Degrees (both endpoints of each live edge) by ``bincount``."""
    import numpy as np
    live = np.nonzero(edge_mask)[0]
    N = uni.num_nodes
    return (np.bincount(uni.edge_src[live], minlength=N)
            + np.bincount(uni.edge_dst[live], minlength=N))


def scipy_components(uni, state):
    """Labels as the HashMin fixpoint gives them (each live node's smallest
    live node id in its component, int32 max for dead nodes), from scipy's
    connected components of the live subgraph."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    N = uni.num_nodes
    nm = state.node_mask
    e = np.nonzero(state.edge_mask)[0]
    s, d = uni.edge_src[e], uni.edge_dst[e]
    keep = nm[s] & nm[d]
    graph = coo_matrix((np.ones(int(keep.sum()), np.int8),
                        (s[keep], d[keep])), shape=(N, N))
    n_comp, lab = connected_components(graph, directed=False)
    live = np.nonzero(nm)[0]
    first = np.full(n_comp, N, np.int64)
    np.minimum.at(first, lab[live], live)
    return np.where(nm, first[lab], np.iinfo(np.int32).max)


def loader_window(gm, ev, times, horizon, dev, label):
    """One ``SnapshotBatchLoader`` window at ``times``, checked against
    ``replay``; returns its launch counts, wall seconds and the
    ``bucket_edges`` seconds inside it."""
    import importlib

    import torch

    from repro_torch import kernels
    from repro_torch.core import SnapshotBatchLoader

    ss_ops = importlib.import_module("repro_torch.kernels.segment_sum.ops")
    uni = gm.universe
    bucket = ss_ops.bucket_edges
    spent = []

    def timed_bucket(*args, **kw):
        t0 = time.perf_counter()
        out = bucket(*args, **kw)
        spent.append(time.perf_counter() - t0)
        return out

    loader = SnapshotBatchLoader(gm, times, batch_size=len(times),
                                 label_horizon=horizon)
    ss_ops.bucket_edges = timed_bucket
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        (batch,) = list(loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        ss_ops.bucket_edges = bucket
    T = len(times)
    check(launches["delta_apply_fused"] == 2, f"{label}: loader launched the "
          f"fused kernel {launches['delta_apply_fused']} times for one "
          f"window and its horizon")
    check(launches["segment_sum_bucketed"] == 2 * 2 * T, f"{label}: loader "
          f"launched segment-sum {launches['segment_sum_bucketed']} times "
          f"for 2 degree passes of {T} points")
    check_loader_batch(uni, ev, batch, times, horizon, dev, label)
    return {"launches": launches, "wall_s": wall,
            "bucket_edges_s": sum(spent), "bucket_edges_calls": len(spent)}


def check_loader_batch(uni, ev, batch, times, horizon, dev, label) -> None:
    """A ``SnapshotBatchLoader`` window at ``times`` against ``replay``:
    its tensors on ``dev``, its shapes, edge and label masks, edge counts,
    raw degrees and labels at every point."""
    import numpy as np

    from repro_torch.core import replay

    N, E, T = uni.num_nodes, uni.num_edges, len(times)
    check(all(v.device.type == dev.type for k, v in batch.items()
              if k != "times"), f"{label}: batch tensors off the device")
    check(batch["x"].shape == (T, N, 16) and batch["edge_mask"].shape ==
          (T, 2 * E) and batch["labels"].shape == (T, N), f"{label}: shapes")
    em = batch["edge_mask"].cpu().numpy()
    lm = batch["label_mask"].cpu().numpy()
    x = batch["x"][..., -1].cpu().numpy()
    ne = batch["num_edges"].cpu().numpy()
    labels = batch["labels"].cpu().numpy()
    for j, t in enumerate(times):
        truth = replay(uni, ev, t)
        deg = live_degrees(uni, truth.edge_mask)
        check(np.array_equal(em[j, :E] > 0, truth.edge_mask) and
              np.array_equal(em[j, E:] > 0, truth.edge_mask),
              f"{label}: loader edge_mask t={t}")
        check(np.array_equal(lm[j] > 0, truth.node_mask),
              f"{label}: loader label_mask t={t}")
        check(int(ne[j]) == int(truth.edge_mask.sum()),
              f"{label}: loader num_edges t={t}")
        check(np.array_equal(x[j], deg.astype(np.float32)),
              f"{label}: loader degrees t={t}")
        fut = live_degrees(uni, replay(uni, ev, t + horizon).edge_mask)
        check(np.array_equal(labels[j], (fut > deg).astype(np.int32)),
              f"{label}: loader labels t={t}")


def evolve_phase(gm, ev, dev) -> dict:
    """The evolve path on the main history (phase 3); returns the evolve
    launches of the retrieval kernels, by kernel name."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import replay
    from repro_torch.data.generators import dense_intervals
    from repro_torch.runtime import torch_exec

    t_phase = time.perf_counter()
    uni = gm.universe
    tmax = int(ev.time[-1])
    ivs = dense_intervals(tmax, EVOLVE_INTERVALS, EVOLVE_POINTS,
                          window_frac=0.05, seed=SEED)
    ops = (("masks", {}), ("degree", {}), ("pagerank", {"tol": 1e-6}),
           ("components", {}))
    inc, rec, secs, iters = {}, {}, {}, {}
    for name, kw in ops:
        for incremental in (True, False):
            if not incremental and name not in ("pagerank", "components"):
                continue
            engine = "incremental" if incremental else "recompute"
            pts = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b, iv in enumerate(ivs):
                times = iv if incremental else iv[::CHECK_EVERY]
                res = gm.evolve(times, name, incremental=incremental, **kw)
                (inc if incremental else rec)[name, b] = res
                pts += len(times)
                iters.setdefault((name, engine), []).extend(
                    res.stats["solver_iters"] or [])
            torch.cuda.synchronize()
            secs[name, engine] = (time.perf_counter() - t0) / pts
    pr_l1 = pr_max = 0.0
    n_checked = 0
    t0 = time.perf_counter()
    for b, iv in enumerate(ivs):
        for j, t in enumerate(iv):
            if j % CHECK_EVERY:
                continue
            truth = replay(uni, ev, t)
            nm, em = inc["masks", b].values[j]
            check(np.array_equal(nm, truth.node_mask) and
                  np.array_equal(em, truth.edge_mask),
                  f"evolve masks differ from replay at t={t}")
            check(np.array_equal(inc["degree", b].values[j],
                                 live_degrees(uni, truth.edge_mask)),
                  f"evolve degrees differ from bincount at t={t}")
            c_inc = inc["components", b].values[j]
            c_rec = rec["components", b].values[j // CHECK_EVERY]
            check(np.array_equal(c_inc, c_rec), f"components: incremental "
                  f"and recompute engines differ at t={t}")
            check(np.array_equal(c_inc, scipy_components(uni, truth)),
                  f"components differ from scipy's partition at t={t}")
            d = np.abs(inc["pagerank", b].values[j].astype(np.float64)
                       - rec["pagerank", b].values[j // CHECK_EVERY])
            pr_l1, pr_max = max(pr_l1, float(d.sum())), max(pr_max,
                                                            float(d.max()))
            n_checked += 1
    check(pr_l1 <= 5e-5 and pr_max <= 1e-5, f"PageRank: incremental and "
          f"recompute engines differ by L1 {pr_l1}, max {pr_max}")
    for (name, engine), s in secs.items():
        it = iters.get((name, engine))
        print(f"evolve: {name} {engine} {s:.6f} s/point" + (
            f", solver iterations {sum(it)} over {len(it)} points (first "
            f"{it[0]}, min {min(it)}, max {max(it)})" if it else ""))
    print(f"evolve: {n_checked} checked points: masks = replay, degrees = "
          f"bincount, components = recompute = scipy; PageRank incremental "
          f"vs recompute L1 {pr_l1:.6e} (limit 5e-5), max {pr_max:.6e} "
          f"(limit 1e-5); checks {time.perf_counter() - t0:.3f} s")

    # the batched interval sweep, every interval at once
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    swept = torch_exec.evolve_intervals_torch(gm.dg, ivs, device=dev,
                                              pool=gm.pool,
                                              prefetch=gm.prefetcher)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    sweep_launches = kernels.launch_counts()
    check(sweep_launches["delta_apply_chain"] > 0,
          "evolve_intervals_torch launched no chain kernel")
    for b, iv in enumerate(ivs):
        for j, t in enumerate(iv):
            nm, em = inc["masks", b].values[j]
            check(np.array_equal(swept[b][t][0], nm) and
                  np.array_equal(swept[b][t][1], em),
                  f"evolve_intervals_torch differs from the incremental "
                  f"engine at t={t}")
    print(f"evolve: evolve_intervals_torch over {len(ivs)} x "
          f"{EVOLVE_POINTS} points {t_sweep:.6f} s "
          f"({t_sweep / (len(ivs) * EVOLVE_POINTS):.6f} s/point), equal to "
          f"the incremental engine at every point; launches "
          f"{json.dumps(sweep_launches)}")

    # one loader window with a label horizon of 4 interval steps
    iv = ivs[0]
    horizon = (iv[-1] - iv[0]) // (EVOLVE_POINTS - 1) * 4
    lw = loader_window(gm, ev, iv[:LOADER_BATCH], horizon, dev, "evolve")
    print(f"evolve: SnapshotBatchLoader window of {LOADER_BATCH} points, "
          f"horizon {horizon}: {lw['wall_s']:.6f} s, of which "
          f"bucket_edges {lw['bucket_edges_s']:.6f} s in "
          f"{lw['bucket_edges_calls']} calls; batch = replay; launches "
          f"{json.dumps(lw['launches'])}; phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    return {name: {"evolve_intervals_torch": sweep_launches[name],
                   "loader_window": lw["launches"][name]}
            for name in RETRIEVAL_KERNELS}


def sharded_phase(uni, ev, gm, times, dev) -> dict:
    """Sharded retrieval on the main history (phase 4): the word-cyclic
    ``[P, Wp]`` layout on the card, the non-aligned branch on a churn
    history, and host sharded retrieval through in-thread shard workers and
    ``repro_torch.launch.shardd`` processes.  Returns the chain kernel's
    readings at the sharded shape for the kernels' record."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import DeltaGraph, GraphManager, replay
    from repro_torch.data.generators import churn_network
    from repro_torch.kernels.delta_apply.ref import delta_apply_chain_ref
    from repro_torch.runtime import torch_exec
    from repro_torch.storage.kv import MemKV

    P = SHARD_PARTITIONS
    os.environ["REPRO_SHARDD_POOL"] = "0"    # close() reaps every shardd
    t0 = time.perf_counter()
    gm8 = GraphManager(uni, ev, store=MemKV(), L=50_000, k=4,
                       diff_fn="intersection", num_partitions=P,
                       partition_fn="word_cyclic", cache_bytes=0, device=dev)
    t_index = time.perf_counter() - t0
    truth = {t: replay(uni, ev, t) for t in times}
    flat = {t: torch_exec.execute_singlepoint_torch(gm.dg, t, device=dev)
            for t in times}

    # the device path: one batched chain launch per plane, P rows as the
    # batch; the spy keeps the inputs of the largest call for the kernel
    seen = []
    orig_chain = torch_exec.delta_apply_chain_batched

    def rec_chain(b, a, d):
        seen.append((b, a, d))
        return orig_chain(b, a, d)

    torch_exec.delta_apply_chain_batched = rec_chain
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = {t: torch_exec.execute_singlepoint_sharded_torch(
            gm8.dg, t, partitions=P, device=dev) for t in times}
        torch.cuda.synchronize()
        t_path = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        torch_exec.delta_apply_chain_batched = orig_chain
    check(launches["delta_apply_chain"] == 2 * len(times) == len(seen),
          f"sharded: {launches['delta_apply_chain']} chain launches for "
          f"{len(times)} timepoints (2 expected per timepoint)")
    check(all(a.shape[0] == P for _, a, _ in seen),
          f"sharded: chain batches {[tuple(a.shape) for _, a, _ in seen]}")
    check(sum(launches.values()) == launches["delta_apply_chain"],
          f"sharded: other kernels launched {json.dumps(launches)}")
    for t in times:
        for i, plane in enumerate(("node", "edge")):
            want = (truth[t].node_mask, truth[t].edge_mask)[i]
            check(np.array_equal(got[t][i], want),
                  f"sharded: {plane} mask differs from replay at t={t}")
            check(np.array_equal(got[t][i], flat[t][i]),
                  f"sharded: {plane} mask differs from the unsharded "
                  f"path at t={t}")
    # host lowering alone (plan, per-partition fetches, packing, staging)
    t0 = time.perf_counter()
    for t in times:
        torch_exec.lower_singlepoint_sharded(gm8.dg, t, partitions=P,
                                             device=dev)
    torch.cuda.synchronize()
    t_lower = time.perf_counter() - t0

    # the kernel at the largest shape the path gave it: against its plain
    # version bit for bit, timed, and its rows independent
    base, adds, dels = max(seen, key=lambda x: x[1].numel())
    _, K, Wp = adds.shape
    out = kernels.delta_apply_chain_batched(base, adds, dels)
    want = delta_apply_chain_ref(base, adds, dels)
    torch.cuda.synchronize()
    check(torch.equal(out, want), "sharded: chain kernel differs from its "
          "plain version on the captured inputs")
    rows = [r for r in range(P) if bool((out[r] != -1).any())]
    check(bool(rows), "sharded: every row all ones, nothing to flip")
    for row in rows:
        flipped = adds.clone()
        flipped[row, -1] |= ~out[row]          # add every bit it lacks
        changed = (kernels.delta_apply_chain_batched(base, flipped, dels)
                   != out).any(dim=1)
        check(bool(changed[row]) and int(changed.sum()) == 1,
              f"sharded: flipping row {row} changed rows "
              f"{changed.nonzero().flatten().tolist()}")
    ms = graph_ms(lambda: kernels.delta_apply_chain_batched(base, adds, dels),
                  200)
    loop_ms = cuda_ms(lambda: kernels.delta_apply_chain_batched(
        base, adds, dels), 200)
    plain = cuda_ms(lambda: delta_apply_chain_ref(base, adds, dels), 5)
    nbytes, ops = P * (2 * K + 2) * Wp * 4.0, P * K * Wp * 3.0
    b_ms, b_by = bound_ms(nbytes, ops)
    device = {"launches": launches["delta_apply_chain"],
              "shape": f"B=P={P} K={K} Wp={Wp}", "ms": ms,
              "host_loop_ms": loop_ms, "plain_ms": plain, "bound_ms": b_ms,
              "bound_by": b_by, "max_abs_err": max_abs_err(out, want),
              "rows_checked_independent": len(rows)}
    print(f"sharded: {P} word_cyclic partitions, index {t_index:.3f} s; "
          f"{len(times)} timepoints {t_path:.3f} s wall, host lowering "
          f"{t_lower:.3f} s, {2 * len(times)} chain launches of about "
          f"{ms:.5f} ms device time each; masks equal replay and the "
          f"unsharded path; {json.dumps(device)}")

    # the non-aligned branch: mod_hash storage partitions, P compute rows
    cuni, cev = churn_network(n_initial_edges=2000, n_events=50_000, seed=1)
    cdg = DeltaGraph(cuni, MemKV(), L=2_000, k=2, num_partitions=4,
                     partition_fn="mod_hash").build(cev)
    ctimes = sorted({int(t) for t in np.linspace(0, int(cev.time[-1]) + 3,
                                                 8)})
    kernels.reset_launch_counts()
    for t in ctimes:
        nm, em = torch_exec.execute_singlepoint_sharded_torch(
            cdg, t, partitions=P, device=dev)
        ctruth = replay(cuni, cev, t)
        check(np.array_equal(nm, ctruth.node_mask) and
              np.array_equal(em, ctruth.edge_mask),
              f"sharded: mod_hash P=4 at {P} rows differs from replay at "
              f"t={t}")
    check(kernels.launch_counts()["delta_apply_chain"] == 2 * len(ctimes),
          "sharded: the non-aligned branch missed the chain kernel")

    # host sharded retrieval through the query service
    def query(label):
        t0 = time.perf_counter()
        snaps = gm8.get_snapshots(times)
        wall = time.perf_counter() - t0
        for t in times:
            check(np.array_equal(snaps[t].node_mask, truth[t].node_mask) and
                  np.array_equal(snaps[t].edge_mask, truth[t].edge_mask),
                  f"sharded: {label} get_snapshots differs from replay at "
                  f"t={t}")
        return wall

    try:
        host = {"unsharded_s": query("unsharded")}
        gm8.enable_sharding(4)
        host["thread_s"] = query("thread transport")
        host["thread_shards"] = gm8.sharded.last_stats["shards"]
        # no health probe and no hedge: the query after the kill finds
        # the corpse on its fetch and fails over to the other replica
        sr = gm8.enable_sharding(2, transport="proc", replicas=2,
                                 max_hedges=0, health_interval_s=1e9)
        for name in sr.transport.servers():
            pid = int(sr.transport.health(name)["pid"])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode().split("\0")
            check("repro_torch.launch.shardd" in argv and
                  "repro.launch.shardd" not in argv,
                  f"sharded: shard process {pid} runs {argv}")
        host["proc_s"] = query("proc transport")
        victim = next(iter(sr.assignment(gm8.dg.P)))
        killed = sr.transport.kill(victim)
        host["proc_after_kill_s"] = query("proc transport after a kill")
        host["failovers"] = sr.failovers_total
        check(sr.failovers_total >= 1, "sharded: no failover after the kill")
        check(victim not in sr.alive_workers(), "sharded: the killed shard "
              "still reads alive")
    finally:
        gm8.close()          # stops the shard processes
    print(f"sharded: host get_snapshots of {len(times)} timepoints (s per "
          f"query): {json.dumps(host)}; killed shardd pid {killed}; "
          f"mod_hash P=4 at {P} rows over {len(ctimes)} churn timepoints "
          f"agrees with replay")
    return device


def served_shapes(rand, sdpa_call) -> dict[str, dict]:
    """The two shapes ``flash_attention.cu`` served before its kernels were
    replaced, through ``attention()`` and so through their new kernels:
    stablelm-12b's bf16 prefill (D = 160) through ``flash_prefill.cu`` at
    its (192, 192) instantiation, and gemma3-1b's global prefill in f32
    through ``flash_prefill_f32.cu``.  Each against its plain version
    (bf16: 2e-2 and two ulps; f32: 3e-5), SDPA, and the old kernel it
    replaced on the same inputs (``ops._attention_mma``,
    ``ops._attention_simt``), all timed by CUDA-graph replay in this run."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import attention, attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops

    out = {}
    for (label, counter, old_name, old_fn, dtype, (B, Hq, Hkv, Sq, Sk, D),
         iters, old_iters) in (
            ("stablelm-12b prefill", "flash_attention_prefill",
             "attention_mma_kernel", fa_ops._attention_mma, torch.bfloat16,
             (1, 32, 8, 4096, 4096, 160), 20, 4),
            ("gemma3-1b global prefill, f32", "flash_attention_prefill_f32",
             "attention_simt_kernel", fa_ops._attention_simt, torch.float32,
             (8, 4, 1, 4096, 4096 + LM_GEN, 256), 4, 2)):
        q = rand((B, Hq, Sq, D), dtype)
        k, v = rand((B, Hkv, Sk, D), dtype), rand((B, Hkv, Sk, D), dtype)
        n0 = kernels.launch_counts()
        got = attention(q, k, v)
        n1 = kernels.launch_counts()
        moved = {n: n1[n] - n0[n] for n in n1 if n1[n] != n0[n]}
        check(moved == {"flash_attention": 1, counter: 1},
              f"{label} ran {moved}, not {counter} alone")
        want = attention_ref(q, k, v)
        old = old_fn(q, k, v)
        torch.cuda.synchronize()
        bf16 = dtype == torch.bfloat16
        errs = {}
        for name, res in (("new", got), ("old", old)):
            errs[name] = (max_abs_err(res.float(), want.float()),
                          over_bf16_limit(res, want) if bf16 else None)
            check(errs[name][0] <= (2e-2 if bf16 else 3e-5) and
                  (errs[name][1] or 0) <= 1.0, f"{name} kernel differs from "
                  f"plain at {label}: {errs[name]}")
        del got, want, old
        lib = sdpa_call(q, k, v, None, 0)
        lib_err = max_abs_err(lib().float(), attention_ref(q, k, v).float())
        ms = graph_ms(lambda: attention(q, k, v), iters)
        old_ms = graph_ms(lambda: old_fn(q, k, v), old_iters)
        plain = cuda_ms(lambda: attention_ref(q, k, v), 2, warmup=1)
        lib_ms = graph_ms(lib, iters)
        pairs, lo, hi = visible_span(Sq, Sk, None, 0)
        esize = q.element_size()
        nbytes = esize * (B * Hq * Sq * 2 * D + B * Hkv * (hi - lo) * 2 * D)
        ops = 2.0 * B * Hq * pairs * 2 * D
        # the f32 kernel does its products three times over, on the TF32
        # tensor cores: the rate its instructions run at
        b, by = (bound_ms(nbytes, ops, BF16_OPS_PER_S) if bf16 else
                 bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S))
        rec = {"shape": f"{label}: q {[B, Hq, Sq, D]} k/v {[B, Hkv, Sk, D]} "
                        f"causal {str(dtype).split('.')[-1]}",
               "kernel": ("flash_prefill.cu: attention_prefill_kernel<192, "
                          "192>" if bf16 else "flash_prefill_f32.cu: "
                          "attention_prefill_f32_kernel<256, 256>"),
               "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
               "library_ms": lib_ms, "library_max_abs_err": lib_err,
               "max_abs_err": errs["new"][0],
               "err_over_bf16_limit": errs["new"][1],
               "over_library": ms / lib_ms, "old_kernel":
                   f"flash_attention.cu: {old_name}", "old_ms": old_ms,
               "old_max_abs_err": errs["old"][0],
               "old_err_over_bf16_limit": errs["old"][1],
               "speedup_over_old": old_ms / ms}
        if bf16:    # the work the (192, 192) instantiation does
            rec["padded_bound_ms"] = bound_ms(nbytes, ops * 192 / D,
                                              BF16_OPS_PER_S)[0]
        else:       # the work once, at the CUDA cores' f32 rate
            rec["f32_rate_bound_ms"] = bound_ms(nbytes, ops)[0]
        print(f"served shape: {json.dumps(rec)}")
        out[counter] = rec
        del q, k, v
        torch.cuda.empty_cache()
    return out


def stablelm_pass(dev) -> dict:
    """stablelm-12b at full width and depth: the tail-drift check (kernel
    against the plain version, which also warms the card for the prompt's
    shapes), then ``serve_lm`` timed, with launch counts zeroed before and
    read after each: every prefill attention call through
    ``flash_prefill.cu`` (40 per forward), every decode call through
    ``flash_decode.cu``, none anywhere else.  Last, both kernels against
    the plain version at the shapes ``serve_lm`` gave them (2e-2 and two
    bf16 ulps)."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import attention, attention_ref
    from repro_torch.launch import serve
    from repro_torch.models.transformer import model as tm

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = serve.load_lm(ST_ARCH, device=dev, seed=SEED)
    L = cfg.n_layers
    n_params = sum(w.numel() for v in params.values() for w in (
        v.values() if isinstance(v, dict) else [v]))
    print(f"LM: {ST_ARCH} at full width and depth ({L} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, "
          f"{n_params} parameters), random weights (seed {SEED}); batch "
          f"{ST_BATCH}, prompt {ST_PROMPT}, {ST_GEN} greedy decode steps")
    tokens = serve.prompt_tokens(cfg, ST_BATCH, ST_PROMPT, SEED, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    _, rel = serve.tail_drift(params, cfg, tokens, LM_TAIL)
    torch.cuda.synchronize()
    n = kernels.launch_counts()
    want = {"flash_attention": L * (2 + LM_TAIL),
            "flash_attention_prefill": 2 * L,
            "flash_attention_decode": L * LM_TAIL}
    check({k: v for k, v in n.items() if v} == want, f"{ST_ARCH} tail check "
          f"launched {n}, not {want}")
    orig = tm.attention
    tm.attention = attention_ref
    try:
        _, rel_plain = serve.tail_drift(params, cfg, tokens, LM_TAIL)
    finally:
        tm.attention = orig
    check(rel <= DRIFT_OVER_PLAIN * rel_plain, f"{ST_ARCH} bf16 tail drift "
          f"{rel} through the kernels, {rel_plain} through the plain version")
    del params
    torch.cuda.empty_cache()

    seen = []           # the shapes serve_lm hands the kernels

    def rec_shape(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     kw["window"], kw["q_offset"]))
        return orig(q, k, v, **kw)

    tm.attention = rec_shape
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        res = serve.serve_lm(ST_ARCH, ST_BATCH, ST_PROMPT, ST_GEN,
                             device=dev, seed=SEED)
        torch.cuda.synchronize()
    finally:
        tm.attention = orig
    n = kernels.launch_counts()
    want = {"flash_attention": L * (1 + ST_GEN),
            "flash_attention_prefill": L,
            "flash_attention_decode": L * ST_GEN}
    check({k: v for k, v in n.items() if v} == want, f"{ST_ARCH} serve_lm "
          f"launched {n}, not {want}: every prefill call through "
          f"flash_prefill.cu and none through flash_attention.cu")
    check(bool(torch.isfinite(res["prefill_logits"].float()).all()),
          f"{ST_ARCH} prefill logits not finite")
    check(res["tokens"].shape == (ST_BATCH, ST_GEN) and
          ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all(),
          f"{ST_ARCH} generated tokens out of range")
    # each kernel against its plain version at the path's prefill shape and
    # at a decode shape on the max_len cache, on seeded random inputs
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs = {}
    for label, counter, (qs, ks, vs, window, off) in (
            ("prefill", "flash_attention_prefill",
             next(s for s in seen if s[0][2] > 1)),
            ("decode", "flash_attention_decode",
             next(s for s in seen if s[0][2] == 1 and
                  s[4] == ST_PROMPT + 4))):
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(cfg.dtype)
                   for s in (qs, ks, vs))
        kw = dict(causal=True, window=window, q_offset=off)
        n0 = kernels.launch_counts()
        got = attention(q, k, v, **kw)
        n1 = kernels.launch_counts()
        moved = {m: n1[m] - n0[m] for m in n1 if n1[m] != n0[m]}
        check(moved == {"flash_attention": 1, counter: 1}, f"{ST_ARCH} "
              f"{label} ran {moved}, not {counter} alone")
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        errs[label] = {"shape": f"q {list(qs)} k/v {list(ks)} q_offset {off}",
                       "max_abs_err": max_abs_err(got.float(), want.float()),
                       "err_over_bf16_limit": over_bf16_limit(got, want)}
        check(errs[label]["max_abs_err"] <= 2e-2 and
              errs[label]["err_over_bf16_limit"] <= 1.0, f"{ST_ARCH} {label} "
              f"kernel differs from plain: {errs[label]}")
        del q, k, v, got, want
    rec = {"arch": ST_ARCH, "batch": ST_BATCH, "prompt": ST_PROMPT,
           "decode_steps": ST_GEN, "layers": L,
           "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms_per_step": res["decode_s"] / ST_GEN * 1e3,
           "launches": n, "kernel_vs_plain": errs, "tail_rel_err_bf16": rel,
           "tail_rel_err_bf16_plain_attention": rel_plain,
           "peak_device_memory_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "phase_s": time.perf_counter() - t_phase}
    del res
    torch.cuda.empty_cache()
    print(f"LM serving {ST_ARCH}: {json.dumps(rec)}")
    return rec


def lm_phase(dev) -> list[dict]:
    """LM serving through the port's ``launch/serve.py``; returns the
    records of the attention kernels: prefill, decode, and the old prefill
    design (``flash_attention.cu``) timed beside them."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import attention, attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import visible
    from repro_torch.launch import serve
    from repro_torch.models.transformer import model as tm

    t_phase = time.perf_counter()
    cfg, params = serve.load_lm(LM_ARCH, device=dev, seed=SEED)
    L = cfg.n_layers
    print(f"LM: {LM_ARCH} at full width and depth ({L} layers, d "
          f"{cfg.d_model}, {cfg.n_heads}:{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab}, {cfg.dtype}), random weights "
          f"(seed {SEED}); batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} "
          f"greedy decode steps: the repo's prefill_32k (B=32) and "
          f"decode_32k (B=128) at 32,768 tokens cut to one card")
    tokens = serve.prompt_tokens(cfg, LM_BATCH, LM_PROMPT, SEED, dev)
    serve.generate(params, cfg, tokens[:, :512], 2)      # warm-up

    # the main path: serve_lm, with the shapes it hands the kernel recorded
    seen = []
    orig = tm.attention

    def rec(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     kw["window"], kw["q_offset"]))
        return orig(q, k, v, **kw)

    tm.attention = rec
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = serve.serve_lm(LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, device=dev,
                         seed=SEED)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    tm.attention = orig
    n_fa = launches["flash_attention"]
    n_pre = launches["flash_attention_prefill"]
    n_dec = launches["flash_attention_decode"]
    check(n_fa == L * (1 + LM_GEN) == len(seen),
          f"flash_attention launched {n_fa} times for {1 + LM_GEN} forward "
          f"calls of {L} layers")
    check(n_pre == L == sum(1 for s in seen if s[0][2] > 1),
          f"the prefill kernel launched {n_pre} times for one prefill "
          f"forward of {L} layers")
    check(n_dec == L * LM_GEN, f"the decode kernel launched {n_dec} times "
          f"for {LM_GEN} decode steps of {L} layers")
    check(launches["flash_attention_prefill_f32"] == 0, "the bf16 path "
          "launched the f32 prefill kernel")
    prefill_ms = res["prefill_s"] * 1e3
    step_ms = res["decode_s"] / LM_GEN * 1e3
    tok_s = LM_BATCH * LM_GEN / res["decode_s"]
    whole = res["prefill_logits"].float()
    check(bool(torch.isfinite(whole).all()), "prefill logits not finite")
    check(res["tokens"].shape == (LM_BATCH, LM_GEN) and
          ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all(),
          "generated tokens out of range")

    # prefill of prompt[:, :-16] then 16 decode steps over the last 16
    # prompt tokens against a prefill of the whole prompt (tail drift).
    # bf16 drift grows with depth whatever computes attention: at full
    # depth the plain version in the kernel's place drifts past the
    # reference's 5e-2 as well.  So: the first LM_CUT_LAYERS layers (both
    # window kinds) in bf16 within 5e-2; full depth in bf16 within
    # DRIFT_OVER_PLAIN times the plain version's drift on the same prompt;
    # full depth in f32 within 1e-3.
    def drift(p, c, att=orig):
        tm.attention = att
        try:
            return serve.tail_drift(p, c, tokens, LM_TAIL)
        finally:
            tm.attention = orig

    kernels.reset_launch_counts()
    direct, rel = drift(params, cfg)
    same = float((direct - whole).abs().max())
    check(same <= 1e-3 * float(whole.abs().max()),
          f"serve_lm and a direct prefill disagree by {same}")
    _, rel_plain = drift(params, cfg, attention_ref)
    check(rel <= DRIFT_OVER_PLAIN * rel_plain, f"bf16 tail drift {rel} "
          f"through the kernel, {rel_plain} through the plain version")

    def dropped(q, k, v, **kw):
        # the kernel with the last visible key tile dropped: a wrong kernel
        hi = min(k.shape[2], kw["q_offset"] + q.shape[2])
        return orig(q, k[:, :, :hi - 32], v[:, :, :hi - 32], **kw)

    _, rel_wrong = drift(params, cfg, dropped)
    check(rel_wrong > DRIFT_OVER_PLAIN * rel_plain, f"the bf16 tail check "
          f"passes a kernel that drops the last key tile ({rel_wrong})")
    cut = dataclasses.replace(cfg, n_layers=LM_CUT_LAYERS)
    _, rel_cut = drift({k: ({n: w[:LM_CUT_LAYERS] for n, w in v.items()}
                            if isinstance(v, dict) else v)
                        for k, v in params.items()}, cut)
    check(rel_cut <= 5e-2, f"bf16 tail drift {rel_cut} at {LM_CUT_LAYERS} "
          f"layers")
    # the bf16 checks: two prefill forwards and LM_TAIL decode steps each
    n = kernels.launch_counts()
    want = {"flash_attention": (2 * L + LM_CUT_LAYERS) * (2 + LM_TAIL),
            "flash_attention_prefill": (2 * L + LM_CUT_LAYERS) * 2,
            "flash_attention_decode": (2 * L + LM_CUT_LAYERS) * LM_TAIL}
    check({k: v for k, v in n.items() if v} == want, f"the bf16 tail checks "
          f"launched {n}, not {want}")
    # the f32 path: the same check in f32, every prefill call through the
    # TF32 kernel (L per prefill forward), none through flash_attention.cu
    params32 = serve.cast_params(params, torch.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    _, rel32 = drift(params32, dataclasses.replace(cfg, dtype=torch.float32))
    torch.cuda.synchronize()
    n32 = kernels.launch_counts()
    check(rel32 <= 1e-3, f"f32 tail drift {rel32}")
    want = {"flash_attention": L * (2 + LM_TAIL),
            "flash_attention_prefill_f32": 2 * L,
            "flash_attention_decode": L * LM_TAIL}
    check({k: v for k, v in n32.items() if v} == want, f"the f32 tail check "
          f"launched {n32}, not {want}")
    n_pre32 = n32["flash_attention_prefill_f32"]
    del direct, params32
    torch.cuda.empty_cache()
    print(f"LM serving: prefill {LM_BATCH}x{LM_PROMPT} {prefill_ms:.3f} ms; "
          f"decode {step_ms:.3f} ms/step ({tok_s:.1f} tok/s); "
          f"flash_attention launches {n_fa} on serve_lm ({L} x "
          f"{1 + LM_GEN} forward calls), {n_pre} of them through the prefill "
          f"kernel and {n_dec} through the decode kernel; prefill + "
          f"{LM_TAIL} decode steps "
          f"vs whole-prompt prefill: relative error {rel:.6e} in bf16 "
          f"({rel_plain:.6e} through the plain version, {rel_wrong:.6e} "
          f"with the last key tile dropped), {rel_cut:.6e} in "
          f"bf16 at {LM_CUT_LAYERS} layers, {rel32:.6e} in f32 ({n_pre32} "
          f"launches of the f32 prefill kernel, {L} per prefill forward)")

    # the kernel against its plain version at each shape the path used
    def first(prefill, local, offset=None):
        return next(s for s in seen if (s[0][2] > 1) == prefill and
                    (s[3] is not None) == local and
                    (offset is None or s[4] == offset))

    def count(prefill, local):
        return sum(1 for s in seen if (s[0][2] > 1) == prefill and
                   (s[3] is not None) == local)

    dec_off = LM_PROMPT + 4
    cases = [("local prefill", first(True, True), count(True, True)),
             ("global prefill", first(True, False), count(True, False)),
             ("local decode", first(False, True, dec_off), count(False, True)),
             ("global decode", first(False, False, dec_off),
              count(False, False))]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def sdpa_call(q, k, v, window, off):
        """SDPA over the keys some row sees, in its fastest form for the
        mask that is left: none, ``is_causal``, or an explicit one."""
        Sq = q.shape[2]
        _, lo, hi = visible_span(Sq, k.shape[2], window, off)
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        mask = visible(Sq, hi - lo, causal=True, window=window,
                       q_offset=off - lo, device=q.device)
        kw = {}
        if Sq == hi - lo and torch.equal(mask, torch.ones_like(mask).tril()):
            kw["is_causal"] = True
        elif not bool(mask.all()):
            kw["attn_mask"] = mask
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = []
    for label, (qs, ks, vs, window, off), n in cases:
        q, k, v = (rand(s, cfg.dtype) for s in (qs, ks, vs))
        kw = dict(causal=True, window=window, q_offset=off)
        n0 = kernels.launch_counts()
        got = attention(q, k, v, **kw)
        n1 = kernels.launch_counts()
        decode = n1["flash_attention_decode"] > n0["flash_attention_decode"]
        ran_prefill = (n1["flash_attention_prefill"] >
                       n0["flash_attention_prefill"])
        want = attention_ref(q, k, v, **kw)
        # the plain version with the last 32 visible keys dropped: a kernel
        # that lost its last key tile would give this, and must fail
        hi = visible_span(qs[2], ks[2], window, off)[2]
        wrong = attention_ref(q, k[:, :, :hi - 32], v[:, :, :hi - 32], **kw)
        lib = sdpa_call(q, k, v, window, off)
        lib_err = max_abs_err(lib().float(), want.float())
        torch.cuda.synchronize()
        err = max_abs_err(got.float(), want.float())
        ratio = over_bf16_limit(got, want)
        wrong_ratio = over_bf16_limit(wrong, want)
        check(err <= 2e-2 and ratio <= 1.0, f"flash_attention differs from "
              f"plain at {label}: max abs {err}, {ratio} x the bf16 limit")
        check(wrong_ratio > 1.0, f"the bf16 check at {label} passes a "
              f"result with the last key tile dropped ({wrong_ratio})")
        prefill = qs[2] > 1
        check(decode != prefill and ran_prefill == prefill, f"{label} ran "
              f"the {'decode' if decode else 'prefill'} kernel "
              f"(flash_prefill.cu: {ran_prefill})")
        iters = 4 if prefill else 50
        ms = graph_ms(lambda: attention(q, k, v, **kw), iters)
        old = {}
        if prefill:     # the old design, attention_mma_kernel, same inputs
            mma = fa_ops._attention_mma(q, k, v, **kw)
            torch.cuda.synchronize()
            old = {"mma_ms": graph_ms(
                       lambda: fa_ops._attention_mma(q, k, v, **kw), iters),
                   "mma_max_abs_err": max_abs_err(mma.float(), want.float()),
                   "mma_err_over_bf16_limit": over_bf16_limit(mma, want)}
            old["speedup_over_mma"] = old["mma_ms"] / ms
            check(old["mma_max_abs_err"] <= 2e-2 and
                  old["mma_err_over_bf16_limit"] <= 1.0,
                  f"attention_mma_kernel differs from plain at {label}")
            del mma
        loop_ms = cuda_ms(lambda: attention(q, k, v, **kw), iters)
        plain = cuda_ms(lambda: attention_ref(q, k, v, **kw),
                        3 if prefill else 20)
        lib_ms = graph_ms(lib, iters)
        lib_loop_ms = cuda_ms(lib, iters)
        B, Hq, Sq, D = qs
        Hkv, Sk, Dv = ks[1], ks[2], vs[3]
        n_splits = fa_ops.plan_splits(
            Sq, Sk, causal=True, window=window, q_offset=off,
            blocks=B * Hkv, n_sm=n_sm).n_splits if decode else None
        pairs, lo, hi = visible_span(Sq, Sk, window, off)
        nbytes = 2.0 * (B * Hq * Sq * (D + Dv) + B * Hkv * (hi - lo) * (D + Dv))
        ops = 2.0 * B * Hq * pairs * (D + Dv)
        b, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
        shapes.append({
            "shape": f"{label}: q {list(qs)} k/v {list(ks)} window {window} "
                     f"q_offset {off} bf16", "launches": n,
            "kernel": ("flash_decode.cu: attention_decode_split_kernel + "
                       "attention_decode_combine_kernel" if decode else
                       "flash_prefill.cu: attention_prefill_kernel"),
            "n_splits": n_splits,
            "max_abs_err": err, "err_over_bf16_limit": ratio,
            "dropped_tile_err_over_bf16_limit": wrong_ratio,
            "max_abs_plain": float(want.float().abs().max()), "ms": ms,
            "host_loop_ms": loop_ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib_ms,
            "library_host_loop_ms": lib_loop_ms,
            "library_max_abs_err": lib_err, **old})
        del q, k, v, got, want, wrong
    # f32 at each of those shapes, the f32 path's, held to 3e-5: prefill
    # through the TF32 kernel (the local one through its window's tiles)
    err32 = {}
    for label, (qs, ks, vs, window, off), _ in cases:
        q, k, v = (rand(s, torch.float32) for s in (qs, ks, vs))
        n0 = kernels.launch_counts()
        got = attention(q, k, v, window=window, q_offset=off)
        n1 = kernels.launch_counts()
        counter = ("flash_attention_prefill_f32" if qs[2] > 1 else
                   "flash_attention_decode")
        moved = {n: n1[n] - n0[n] for n in n1 if n1[n] != n0[n]}
        check(moved == {"flash_attention": 1, counter: 1}, f"f32 {label} "
              f"ran {moved}, not {counter} alone")
        err32[label] = max_abs_err(
            got, attention_ref(q, k, v, window=window, q_offset=off))
        torch.cuda.synchronize()
        check(err32[label] <= 3e-5, f"flash_attention differs from plain in "
              f"f32 at {label}: {err32[label]}")
        del q, k, v, got

    served = served_shapes(rand, sdpa_call)

    by_label = {s["shape"].split(":")[0]: s for s in shapes}
    kern_prefill = sum(by_label[f"{w} prefill"]["ms"] * by_label[
        f"{w} prefill"]["launches"] for w in ("local", "global"))
    kern_step = sum(by_label[f"{w} decode"]["ms"] * by_label[
        f"{w} decode"]["launches"] for w in ("local", "global")) / LM_GEN
    print(f"LM serving: the attention kernel at these shapes takes about "
          f"{kern_prefill:.3f} ms of the {prefill_ms:.3f} ms prefill "
          f"({kern_prefill / prefill_ms:.1%}) and {kern_step:.3f} ms of the "
          f"{step_ms:.3f} ms decode step ({kern_step / step_ms:.1%}); f32 "
          f"max_abs_err {json.dumps(err32)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phase "
          f"{time.perf_counter() - t_phase:.3f} s")
    del params, res
    torch.cuda.empty_cache()
    st = stablelm_pass(dev)
    limits = {"bf16": "max abs <= 2e-2, and |kernel - plain| <= "
                      "2^-6 |plain| + 1e-5 per element",
              "f32": "max abs <= 3e-5"}
    replaces = "src/repro/kernels/flash_attention/flash_attention.py:95"
    csrc = "src/repro_torch/kernels/csrc"
    recs = []
    prefill_labels = ("local prefill", "global prefill")
    for name, source, n_launch, top_label, own in (
            ("flash_attention_prefill", f"{csrc}/flash_prefill.cu", n_pre,
             "global prefill", prefill_labels),
            ("flash_attention_decode", f"{csrc}/flash_decode.cu", n_dec,
             "global decode", ("local decode", "global decode")),
            ("flash_attention", f"{csrc}/flash_attention.cu", n_fa,
             "global prefill", prefill_labels)):
        top = by_label[top_label]
        mine = [by_label[lb] for lb in own]
        old = name == "flash_attention"     # attention_mma_kernel's numbers
        err_key = "mma_max_abs_err" if old else "max_abs_err"
        ratio_key = ("mma_err_over_bf16_limit" if old else
                     "err_over_bf16_limit")
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": n_launch,
               "max_abs_err": max(s[err_key] for s in mine),
               "err_over_bf16_limit": max(s[ratio_key] for s in mine),
               "limits": limits, "ms": top["mma_ms" if old else "ms"],
               "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
               "bound_by": top["bound_by"], "library_ms": top["library_ms"],
               "shape": top["shape"],
               f"f32_{top_label.replace(' ', '_')}_max_abs_err":
                   err32[top_label]}
        if old:
            rec["launches_note"] = (
                f"the attention() wrapper's count: every call on the path; "
                f"{n_pre} of them ran flash_prefill.cu, {n_dec} "
                f"flash_decode.cu and none this source, which no route of "
                f"attention() reaches; ms, errors and mma_ms are "
                f"attention_mma_kernel through ops._attention_mma on the "
                f"prefill inputs of this run, simt_ms attention_simt_kernel "
                f"through ops._attention_simt at the f32 served shape")
            rec["mma_ms"] = {s["shape"]: s["mma_ms"] for s in mine}
            rec["simt_ms"] = served["flash_attention_prefill_f32"]["old_ms"]
        else:
            rec["host_loop_ms"] = top["host_loop_ms"]
            rec["shapes"] = mine
        if name == "flash_attention_prefill":
            rec["shapes"] = mine + [served["flash_attention_prefill"]]
            rec["serving"] = {
                "prefill_ms": prefill_ms, "decode_ms_per_step": step_ms,
                "decode_tok_per_s": tok_s,
                "attention_kernel_ms_per_prefill": kern_prefill,
                "attention_kernel_ms_per_decode_step": kern_step,
                "tail_rel_err_bf16": rel,
                "tail_rel_err_bf16_plain_attention": rel_plain,
                "tail_rel_err_bf16_last_tile_dropped": rel_wrong,
                f"tail_rel_err_bf16_{LM_CUT_LAYERS}_layers": rel_cut}
            rec["serving_stablelm"] = st
        print(f"kernel {name}: {json.dumps(rec)}")
        recs.append(rec)
    sf = served["flash_attention_prefill_f32"]
    rec = {"name": "flash_attention_prefill_f32", "route": "cuda",
           "source": f"{csrc}/flash_prefill_f32.cu", "replaces": replaces,
           "launches": n_pre32, "launches_note": (
               f"the f32 path: the f32 tail check at {L} layers (a prefill "
               f"of all but {LM_TAIL} prompt tokens, {LM_TAIL} decode steps, "
               f"a whole prefill), counts zeroed before and read after"),
           "max_abs_err": max(sf["max_abs_err"], err32["local prefill"],
                              err32["global prefill"]),
           "limits": limits, "ms": sf["ms"], "plain_ms": sf["plain_ms"],
           "bound_ms": sf["bound_ms"], "bound_by": sf["bound_by"],
           "library_ms": sf["library_ms"], "shape": sf["shape"],
           "f32_rate_bound_ms": sf["f32_rate_bound_ms"],
           "old_ms": sf["old_ms"],
           "speedup_over_old": sf["speedup_over_old"],
           "library_max_abs_err": sf["library_max_abs_err"],
           "tail_rel_err_f32": rel32}
    print(f"kernel flash_attention_prefill_f32: {json.dumps(rec)}")
    recs.insert(1, rec)
    return recs


def mla_decode_check(q, k, Dv: int, off: int, scale: float) -> dict:
    """The MLA kernel (``flash_mla_wgmma.cu``) at an absorbed-decode shape
    (v the first Dv columns of k, as the model passes it) against the plain
    version: 2e-2 and two bf16 ulps, which the kernel run without its last
    visible 64-key tile must fail; the card's cluster capacity and the
    plan; its device time (CUDA-graph replay) and host loop beside the
    first MLA kernel's (``flash_mla.cu`` through ``ops._mla_mma``, held to
    the same limits) on the same inputs, the plain version's time, SDPA's
    (the KV head broadcast by ``enable_gqa``) where a backend takes
    D = 576 with Dv = 512, the bound and the floor of the kernel's own
    tensor work (P_hi + P_lo)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import attention, attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kw = dict(causal=True, window=None, q_offset=off, scale=scale)
    v = k[..., :Dv]
    n0 = kernels.launch_counts()
    got = attention(q, k, v, **kw)
    n1 = kernels.launch_counts()
    moved = {n: n1[n] - n0[n] for n in n1 if n1[n] != n0[n]}
    check(moved == {"flash_attention": 1, "flash_attention_mla": 1},
          f"MLA decode ran {moved}, not flash_attention_mla alone")
    want = attention_ref(q, k, v, **kw)
    pairs, lo, hi = visible_span(Sq, Sk, None, off)
    tile = fa_ops.MLA_BLOCK_N
    kd = k[:, :, :(hi - 1) // tile * tile]          # the last tile dropped
    wrong = attention(q, kd, kd[..., :Dv], **kw)
    old = fa_ops._mla_mma(q, k, v, **kw)
    torch.cuda.synchronize()
    err, ratio = max_abs_err(got.float(), want.float()), over_bf16_limit(
        got, want)
    wrong_ratio = over_bf16_limit(wrong, want)
    old_err, old_ratio = max_abs_err(old.float(), want.float()), \
        over_bf16_limit(old, want)
    check(err <= 2e-2 and ratio <= 1.0, f"flash_mla_wgmma differs from "
          f"plain: max abs {err}, {ratio} x the bf16 limit")
    check(wrong_ratio > 1.0, f"the MLA check passes the kernel without its "
          f"last key tile ({wrong_ratio})")
    check(old_err <= 2e-2 and old_ratio <= 1.0, f"flash_mla.cu (the "
          f"yardstick) differs from plain: {old_err}, {old_ratio}")
    rows = Hq // Hkv * Sq                       # query rows per KV head
    blocks = B * Hkv * -(-rows // fa_ops.MLA_ROWS)
    slots = {n: fa_ops.mla_cluster_slots(q.device, n)
             for n in range(1, fa_ops.MLA_MAX_CLUSTER + 1)}
    plan = fa_ops.plan_mla_wgmma_splits(
        Sq, Sk, causal=True, window=None, q_offset=off, blocks=blocks,
        block_n=tile, max_clusters=slots.__getitem__)
    print(f"MLA decode: cudaOccupancyMaxActiveClusters for clusters of 1..8 "
          f"blocks {json.dumps(slots)}; {blocks} row blocks; plan "
          f"{plan._asdict()}")
    ms = graph_ms(lambda: attention(q, k, v, **kw), 50)
    loop_ms = cuda_ms(lambda: attention(q, k, v, **kw), 50)
    old_ms = graph_ms(lambda: fa_ops._mla_mma(q, k, v, **kw), 50)
    ms_again = graph_ms(lambda: attention(q, k, v, **kw), 50)
    plain = cuda_ms(lambda: attention_ref(q, k, v, **kw), 5)
    kv, vv = k[:, :, lo:hi], v[:, :, lo:hi]     # every row sees all of them
    lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, kv, vv, scale=scale, enable_gqa=True)
    rec = {}
    try:
        lib_err = max_abs_err(lib().float(), want.float())
        rec = {"library_ms": graph_ms(lib, 50), "library_max_abs_err": lib_err,
               "library_note": "torch.nn.functional.scaled_dot_product_"
               "attention over the visible keys, enable_gqa (the one KV "
               "head broadcast to the query heads)"}
    except RuntimeError as e:       # no SDPA backend takes these dims
        rec = {"library_ms": None, "library_note": f"scaled_dot_product_"
               f"attention refused D={D}, Dv={Dv}: {str(e)[:200]}"}
    nbytes = 2.0 * (B * Hq * Sq * (D + Dv) + B * (hi - lo) * D)
    ops = 2.0 * B * Hq * pairs * (D + Dv)
    b, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
    own_ops = 2.0 * B * Hq * pairs * (D + 2 * Dv)   # S, P_hi·V, P_lo·V
    return {"shape": f"q {list(q.shape)} k {list(k.shape)} v = k[..., :{Dv}] "
                     f"q_offset {off} scale {scale:.6g} bf16",
            "n_splits": plan.n_splits, "tiles_per_split": plan.tiles,
            "block_n": plan.block_n, "max_active_clusters": slots,
            "max_abs_err": err, "err_over_bf16_limit": ratio,
            "dropped_tile_err_over_bf16_limit": wrong_ratio,
            "max_abs_plain": float(want.float().abs().max()), "ms": ms,
            "ms_again": ms_again, "host_loop_ms": loop_ms,
            "old_source": "src/repro_torch/kernels/csrc/flash_mla.cu",
            "old_ms": old_ms, "speedup_over_old": old_ms / ms,
            "old_max_abs_err": old_err,
            "old_err_over_bf16_limit": old_ratio, "plain_ms": plain,
            "bound_ms": b, "bound_by": by,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_bound_ms": ops / BF16_OPS_PER_S * 1e3,
            "own_work_floor_ms": own_ops / BF16_OPS_PER_S * 1e3, **rec}


def moe_serving(arch: str, layers: int, dense: int | None, batch: int,
                prompt: int, gen: int, dev, hold_to_plain: bool
                ) -> tuple[dict, list]:
    """One MoE model at full width and a cut depth: the tail drift on the
    no-drop variant, with its MLA decode calls (if any) held against the
    plain version call by call, and the drift held within 1.5 times the
    plain attention's in the same run over :data:`DRIFT_WEIGHT_SEEDS` x
    :data:`DRIFT_PROMPT_SEEDS` (``hold_to_plain``: the median with the
    router free, each seed with every token's routes pinned) or within
    the reference's 5e-2, with the published capacity's drift printed;
    then ``serve_lm`` timed with launch
    counts zeroed before and read after: every prefill attention call
    through ``flash_prefill.cu``, every decode call through the MLA kernel
    (deepseek-v3) or the split-K decode kernel (arctic), none elsewhere.
    Returns the record and the shapes ``serve_lm`` gave the kernels."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import model as tm

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_arch(arch)[0], n_layers=layers, mtp=False,
                              **({} if dense is None else
                                 {"n_dense_layers": dense}))
    moe = cfg.moe
    mla = cfg.mla is not None
    dec = "flash_attention_mla" if mla else "flash_attention_decode"
    torch.cuda.reset_peak_memory_stats()
    _, params = serve.load_lm(arch, device=dev, seed=SEED, cfg=cfg)
    n_params = sum(w.numel() for v in params.values() for w in (
        v.values() if isinstance(v, dict) else [v]))
    print(f"LM: {arch} at full width, {layers} layers "
          f"({cfg.layer_groups()}), d {cfg.d_model}, {cfg.n_heads}:"
          f"{cfg.n_kv_heads} heads, "
          f"{'MLA ' + str(dataclasses.asdict(cfg.mla)) if mla else ''} "
          f"MoE {dataclasses.asdict(moe)}, vocab {cfg.vocab}, {cfg.dtype}, "
          f"{n_params} parameters, random weights (seed {SEED}); batch "
          f"{batch}, prompt {prompt}, {gen} greedy decode steps; weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tokens = serve.prompt_tokens(cfg, 1, DRIFT_PROMPT, SEED, dev)
    nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k))
    orig = tm.attention
    calls = []                  # (q, k, Dv, kwargs, out): MLA decode calls

    def capture(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        if q.shape[-1] > fa_ops.MAX_HEAD_DIM:
            calls.append((q.clone(), k.clone(), v.shape[-1], kw, out.clone()))
        return out

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tm.attention = capture
    try:
        _, rel = serve.tail_drift(params, nodrop, tokens, LM_TAIL)
    finally:
        tm.attention = orig
    torch.cuda.synchronize()
    n = kernels.launch_counts()
    want = {"flash_attention": layers * (2 + LM_TAIL),
            "flash_attention_prefill": 2 * layers, dec: layers * LM_TAIL}
    check({k: v for k, v in n.items() if v} == want, f"{arch} tail check "
          f"launched {n}, not {want}")
    # every MLA call of that decode (routes free) against the plain version
    check(len(calls) == (layers * LM_TAIL if mla and cfg.mla.kv_lora +
                         cfg.mla.qk_rope > fa_ops.MAX_HEAD_DIM else 0),
          f"{arch} tail check made {len(calls)} MLA decode calls")
    n_calls, call_ratio = len(calls), 0.0
    for q, k, dv, kw, out in calls:
        want_o = attention_ref(q, k, k[..., :dv], **kw)
        err = max_abs_err(out.float(), want_o.float())
        call_ratio = max(call_ratio, over_bf16_limit(out, want_o))
        check(err <= 2e-2 and call_ratio <= 1.0, f"{arch} MLA decode call "
              f"(q_offset {kw['q_offset']}) differs from plain: max abs "
              f"{err}, {call_ratio} x the bf16 limit")
    del calls

    def drift(params, toks, plain=False):
        tm.attention = attention_ref if plain else orig
        try:
            return serve.tail_drift(params, nodrop, toks, LM_TAIL)[1]
        finally:
            tm.attention = orig

    rel_plain = drift(params, tokens, plain=True)
    rows = []

    def drift_seeds(params, w_seed):
        """The no-drop drift through the kernels and the plain version,
        free and pinned, on every prompt seed of one weight seed."""
        for p_seed in range(DRIFT_PROMPT_SEEDS):
            toks = serve.prompt_tokens(cfg, 1, DRIFT_PROMPT, p_seed, dev)
            row = {"weight_seed": w_seed, "prompt_seed": p_seed,
                   "free": drift(params, toks),
                   "free_plain": drift(params, toks, plain=True)}
            with pinned_routes(params, moe.top_k):
                row.update(pinned=drift(params, toks),
                           pinned_plain=drift(params, toks, plain=True))
            print(f"{arch} no-drop bf16 tail drift: {json.dumps(row)}")
            rows.append(row)

    if hold_to_plain:
        drift_seeds(params, SEED)
    else:
        check(rel <= 5e-2, f"{arch} no-drop bf16 tail drift {rel} through "
              f"the kernels ({rel_plain} through the plain version); limit "
              f"5e-2")
    _, rel_pub = serve.tail_drift(params, cfg, tokens, LM_TAIL)
    serve.generate(params, cfg, serve.prompt_tokens(cfg, batch, 512, SEED,
                                                    dev), 2)   # warm-up
    del params
    torch.cuda.empty_cache()

    seen = []

    def rec_shape(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                     kw["window"], kw["q_offset"], kw.get("scale")))
        return orig(q, k, v, **kw)

    tm.attention = rec_shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        res = serve.serve_lm(arch, batch, prompt, gen, device=dev, seed=SEED,
                             cfg=cfg)
        torch.cuda.synchronize()
    finally:
        tm.attention = orig
    n = kernels.launch_counts()
    want = {"flash_attention": layers * (1 + gen),
            "flash_attention_prefill": layers, dec: layers * gen}
    check({k: v for k, v in n.items() if v} == want, f"{arch} serve_lm "
          f"launched {n}, not {want}: every prefill call through "
          f"flash_prefill.cu, every decode call through {dec}, none "
          f"through flash_attention.cu")
    check(bool(torch.isfinite(res["prefill_logits"].float()).all()),
          f"{arch} prefill logits not finite")
    check(res["tokens"].shape == (batch, gen) and
          ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all(),
          f"{arch} generated tokens out of range")
    rec = {"arch": arch, "layers": layers,
           "layer_groups": cfg.layer_groups(), "parameters": n_params,
           "batch": batch, "prompt": prompt, "decode_steps": gen,
           "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms_per_step": res["decode_s"] / gen * 1e3,
           "decode_tok_per_s": batch * gen / res["decode_s"],
           "launches": n, "peak_device_memory_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "tail_rel_err_bf16_no_drop": rel,
           "tail_rel_err_bf16_no_drop_plain_attention": rel_plain,
           "tail_rel_err_bf16_published_capacity": rel_pub,
           "no_drop_capacity_factor": nodrop.moe.capacity_factor}
    del res
    torch.cuda.empty_cache()
    if hold_to_plain:
        for w_seed in DRIFT_WEIGHT_SEEDS[1:]:
            _, params = serve.load_lm(arch, device=dev, seed=w_seed, cfg=cfg)
            drift_seeds(params, w_seed)
            del params
            torch.cuda.empty_cache()
        med = {key: statistics.median(r[key] for r in rows)
               for key in ("free", "free_plain")}
        ratios = [r["pinned"] / max(r["pinned_plain"], 1e-30) for r in rows]
        rec["no_drop_drift_seeds"] = {
            "weight_seeds": list(DRIFT_WEIGHT_SEEDS),
            "prompt_seeds": DRIFT_PROMPT_SEEDS,
            "free_median": med["free"],
            "free_median_plain_attention": med["free_plain"],
            "free_seeds_over_limit": sum(
                r["free"] > DRIFT_OVER_PLAIN * r["free_plain"] for r in rows),
            "free_plain_seeds_over_0_05": sum(r["free_plain"] > 5e-2
                                              for r in rows),
            "pinned_max_over_plain": max(ratios),
            "mla_calls_checked": n_calls,
            "mla_calls_max_over_bf16_limit": call_ratio}
        limit = DRIFT_OVER_PLAIN * med["free_plain"]
        check(med["free"] <= limit, f"{arch} no-drop bf16 tail drift, free "
              f"routes, median over {len(rows)} seeds: {med['free']} through "
              f"the kernels, {med['free_plain']} through the plain version; "
              f"limit {limit}")
        for r in rows:
            check(r["pinned"] <= DRIFT_OVER_PLAIN * r["pinned_plain"],
                  f"{arch} no-drop bf16 tail drift with pinned routes "
                  f"{r['pinned']} through the kernels, "
                  f"{r['pinned_plain']} through the plain version (weight "
                  f"seed {r['weight_seed']}, prompt seed "
                  f"{r['prompt_seed']}); limit {DRIFT_OVER_PLAIN} x")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"LM serving {arch}: {json.dumps(rec)}")
    return rec, seen


def mla_moe_phase(dev) -> tuple[dict, dict]:
    """deepseek-v3 and arctic served at full width (phase 8), each model's
    weights freed before the next; then the MLA kernel against its plain
    version at the served decode shape and the MLA prefill shape (192,
    128) through ``flash_prefill.cu``.  Returns the MLA kernel's record
    and the prefill shape's."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import attention, attention_ref

    # deepseek-v3's absorbed decode differs from its prefill path whatever
    # computes attention, so its drift (free and pinned routes) is held to
    # the plain version's; arctic at 2 layers to the reference's 5e-2 (its
    # plain drift may be 0)
    ds, seen = moe_serving(DS_ARCH, DS_LAYERS, DS_DENSE, DS_BATCH, DS_PROMPT,
                           DS_GEN, dev, hold_to_plain=True)
    ar, _ = moe_serving(AR_ARCH, AR_LAYERS, None, AR_BATCH, AR_PROMPT,
                        AR_GEN, dev, hold_to_plain=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    off = DS_PROMPT + 4
    qs, ks, vs, _, _, scale = next(s for s in seen if s[0][2] == 1 and
                                   s[4] == off)
    dec = mla_decode_check(rand(qs), rand(ks), vs[3], off, scale)
    print(f"MLA decode kernel: {json.dumps(dec)}")
    # the MLA prefill shape through flash_prefill.cu's (192, 128)
    # instantiation; heads are independent at Hq = Hkv, so the plain
    # version (the full f32 score matrix would be 69 GB) runs on 4 heads
    qs, ks, vs, _, _, scale = next(s for s in seen if s[0][2] > 1)
    q, k, v = rand(qs), rand(ks), rand(vs)
    kw = dict(causal=True, window=None, q_offset=0, scale=scale)
    got = attention(q, k, v, **kw)
    want = attention_ref(q[:, :4], k[:, :4], v[:, :4], **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got[:, :4].float(), want.float())
    ratio = over_bf16_limit(got[:, :4], want)
    check(err <= 2e-2 and ratio <= 1.0, f"flash_prefill differs from plain "
          f"at the MLA prefill shape: {err}, {ratio}")

    def lib():      # SDPA's fused backends only: the math one would hold
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,   # a 69 GB score
                          SDPBackend.EFFICIENT_ATTENTION,     # matrix
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=scale)

    try:
        lib_err = max_abs_err(lib()[:, :4].float(), want.float())
        lib_rec = {"library_ms": graph_ms(lib, 3),
                   "library_max_abs_err_4_heads": lib_err,
                   "library_note": "scaled_dot_product_attention, is_causal, "
                                   "its fused backends"}
    except RuntimeError as e:
        lib_rec = {"library_ms": None, "library_note": f"no fused SDPA "
                   f"backend took the call: {str(e)[:200]}"}
    del got, want
    B, Hq, Sq, D = qs
    pairs, lo, hi = visible_span(Sq, ks[2], None, 0)
    Dv = vs[3]
    nbytes = 2.0 * (B * Hq * Sq * (D + Dv) + B * ks[1] * (hi - lo) * (D + Dv))
    b, by = bound_ms(nbytes, 2.0 * B * Hq * pairs * (D + Dv), BF16_OPS_PER_S)
    pre = {"shape": f"deepseek-v3 MLA prefill: q {list(qs)} k {list(ks)} v "
                    f"{list(vs)} causal bf16",
           "kernel": "flash_prefill.cu: attention_prefill_kernel<192, 128>",
           "launches": ds["launches"]["flash_attention_prefill"],
           "ms": graph_ms(lambda: attention(q, k, v, **kw), 3),
           "plain_ms_4_heads": cuda_ms(
               lambda: attention_ref(q[:, :4], k[:, :4], v[:, :4], **kw), 2,
               warmup=1),
           "bound_ms": b, "bound_by": by, "max_abs_err_4_heads": err,
           "err_over_bf16_limit_4_heads": ratio, **lib_rec}
    del q, k, v
    torch.cuda.empty_cache()
    print(f"MLA prefill shape: {json.dumps(pre)}")
    rec = {"name": "flash_attention_mla", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_mla_wgmma.cu",
           "replaces": "src/repro/kernels/flash_attention/flash_attention.py"
                       ":95", "launches": ds["launches"]["flash_attention_mla"],
           "limits": {"bf16": "max abs <= 2e-2, and |kernel - plain| <= "
                              "2^-6 |plain| + 1e-5 per element"},
           **dec, "serving_deepseek_v3": ds, "serving_arctic": ar}
    return rec, pre


# one rank of the rank-local phase: argv = src, rank, world, port, output
# directory, partitions
RANK_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist

from repro_torch import kernels
from repro_torch.core import GraphManager, replay
from repro_torch.data.generators import churn_network
from repro_torch.runtime import torch_exec as tx
from repro_torch.storage.kv import MemKV

rank, world, port, out, P = (int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4]), sys.argv[5], int(sys.argv[6]))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
uni, ev = churn_network(n_initial_edges=2000, n_events=50_000, seed=1)
gm = GraphManager(uni, ev, store=MemKV(), L=2_000, k=2, cache_bytes=0,
                  num_partitions=P, partition_fn="word_cyclic",
                  device="cuda")
times = sorted({int(t) for t in np.linspace(0, int(ev.time[-1]) + 3, 8)})
shapes = []
real = tx.delta_apply_chain_batched
def spy(b, a, d):
    shapes.append(list(a.shape))
    return real(b, a, d)
tx.delta_apply_chain_batched = spy
tx.execute_singlepoint_sharded_rank(gm.dg, times[0], partitions=P,
                                    pool=gm.pool)            # warm-up
del shapes[:]
torch.cuda.synchronize()
kernels.reset_launch_counts()
t0 = time.perf_counter()
res = {t: tx.execute_singlepoint_sharded_rank(gm.dg, t, partitions=P,
                                              pool=gm.pool) for t in times}
torch.cuda.synchronize()
wall = time.perf_counter() - t0
launches = kernels.launch_counts()
tx.delta_apply_chain_batched = real
bad = []
for t in times:
    truth = replay(uni, ev, t)
    one = tx.execute_singlepoint_sharded_torch(gm.dg, t, partitions=P,
                                               pool=gm.pool)
    for (got, want, label) in ((res[t], (truth.node_mask, truth.edge_mask),
                                "replay"), (res[t], one, "one launch")):
        if not (np.array_equal(got[0], want[0]) and
                np.array_equal(got[1], want[1])):
            bad.append(f"{label} at t={t}")
gm.close()
with open(f"{out}/rank{rank}.json", "w") as fh:
    json.dump({"times": times, "bad": bad, "wall_s": wall,
               "chain_launches": launches["delta_apply_chain"],
               "other_launches": {k: v for k, v in launches.items()
                                  if v and k != "delta_apply_chain"},
               "chain_shapes": shapes,
               "device": torch.cuda.get_device_name(0)}, fh)
dist.destroy_process_group()
"""


def rank_phase(src: Path) -> dict:
    """Rank-local sharded retrieval (``execute_singlepoint_sharded_rank``):
    RANK_WORLD gloo ranks, each a process on the one card, over 8
    word_cyclic partitions of a churn history; each rank's launch counts
    zeroed before and read after its 8 timepoints: 2 chain launches a
    timepoint, each batch its P / world rows; masks equal to ``replay`` and
    to the one-launch path on every rank."""
    import socket
    import tempfile

    P = SHARD_PARTITIONS
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, "-c", RANK_CHILD, str(src), str(r),
             str(RANK_WORLD), str(port), out, str(P)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(RANK_WORLD)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=600)
                errs.append((p.returncode, err[-2000:]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (rc, err) in enumerate(errs):
            check(rc == 0, f"rank {r} failed ({rc}): {err}")
        ranks = [json.loads((Path(out) / f"rank{r}.json").read_text())
                 for r in range(RANK_WORLD)]
    for r, res in enumerate(ranks):
        n = len(res["times"])
        check(not res["bad"], f"rank {r}: masks differ from {res['bad']}")
        check(res["chain_launches"] == 2 * n == len(res["chain_shapes"]),
              f"rank {r}: {res['chain_launches']} chain launches for {n} "
              f"timepoints")
        check(all(s[0] == P // RANK_WORLD for s in res["chain_shapes"]),
              f"rank {r}: chain batches {res['chain_shapes']}")
        check(not res["other_launches"], f"rank {r} launched "
              f"{res['other_launches']}")
    rec = {"world": RANK_WORLD, "partitions": P,
           "rows_per_rank": P // RANK_WORLD,
           "timepoints": len(ranks[0]["times"]),
           "chain_launches_per_rank": [r["chain_launches"] for r in ranks],
           "wall_s_per_rank": [r["wall_s"] for r in ranks],
           "phase_s": time.perf_counter() - t0}
    print(f"rank-local sharded: {json.dumps(rec)}; masks equal replay and "
          f"the one-launch path on every rank")
    return rec


def profiled_ms(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: the host-clock wall ms (ended
    by a synchronise), the device's busy ms, device ms by kind of kernel
    (the attention kernels, matrix products, the rest) and the eight
    kernels that took the most device ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kind(name: str) -> str:
        if "attention" in name:
            return "attention_kernels"
        if name.startswith("nvjet") or "gemm" in name.lower():
            return "matrix_products"
        return "other"

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out = {"wall_ms": wall, "device_busy_ms": 0.0, "attention_kernels": 0.0,
           "matrix_products": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms = e.self_device_time_total / 1e3
            out["device_busy_ms"] += ms
            out[kind(e.key)] += ms
            top.append((ms, e.count, e.key[:90]))
    out["device_busy_share"] = out["device_busy_ms"] / wall
    out["top_kernels"] = [{"kernel": k, "calls": n, "ms": ms}
                          for ms, n, k in sorted(top, reverse=True)[:8]]
    return out


def differing_leaf(tree, other):
    """The path of the first leaf where two trees of tensors differ in a
    bit (or in dtype or shape), or None."""
    import torch

    from repro_torch.tree_util import flatten_with_paths

    b = dict(flatten_with_paths(other))
    for path, x in flatten_with_paths(tree):
        y = b.get(path)
        if y is None or x.dtype != y.dtype or x.shape != y.shape:
            return path
        if x.is_floating_point():
            width = {2: torch.int16, 4: torch.int32}[x.element_size()]
            if not torch.equal(x.view(width), y.view(width)):
                return path
        elif not torch.equal(x, y):
            return path
    return None


class Preempted(Exception):
    """The training phase's simulated crash."""


def stats_case(q, k, v, label: str, kw: dict, iters: int) -> dict:
    """``attention_stats`` (the prefill kernel of the inputs' dtype with its
    statistics output) at one shape: ``out`` bit for bit against the
    launch without statistics (``attention()``), ``(out, m, l)`` against
    the plain version, and the two launches and SDPA timed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention,
                                                     attention_ref_stats,
                                                     attention_stats)
    from repro_torch.kernels.flash_attention.ref import visible

    out, m, l = attention_stats(q, k, v, **kw)
    plain = attention(q, k, v, **kw)
    want, wm, wl = attention_ref_stats(q, k, v, **kw)
    torch.cuda.synchronize()
    bf16 = q.dtype == torch.bfloat16
    check(same_bits(out, plain), f"stats {label}: out differs from the "
          f"launch without statistics")
    err = max_abs_err(out.float(), want.float())
    ratio = over_bf16_limit(out, want) if bf16 else None
    check(err <= (2e-2 if bf16 else 3e-5) and (ratio or 0) <= 1.0,
          f"stats {label}: out differs from plain ({err}, {ratio})")
    seen = wl > 0
    check(torch.equal(l > 0, seen), f"stats {label}: rows with no key")
    m_err = float(((m - wm).abs() / (1 + wm.abs()))[seen].max())
    l_err = float(((l - wl).abs() / wl.clamp(min=1e-30))[seen].max())
    check(m_err <= STATS_M_TOL and l_err <= STATS_L_TOL,
          f"stats {label}: m off by {m_err}, l by {l_err}")
    check(bool((m[~seen] == -1e30).all()) and bool((l[~seen] == 0).all()),
          f"stats {label}: a row with no key keeps m = -1e30, l = 0")
    del want, wm, wl, plain
    ms = graph_ms(lambda: attention_stats(q, k, v, **kw), iters)
    nostats_ms = graph_ms(lambda: attention(q, k, v, **kw), iters)
    plain_ms = cuda_ms(lambda: attention_ref_stats(q, k, v, **kw), 2,
                       warmup=1)
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    win, off = kw.get("window"), kw.get("q_offset", 0)
    pairs, lo, hi = visible_span(Sq, Sk, win, off)
    mask = visible(Sq, hi - lo, causal=True, window=win, q_offset=off - lo,
                   device=q.device)
    sdpa_kw = ({"is_causal": True} if Sq == hi - lo and torch.equal(
        mask, torch.ones_like(mask).tril()) else {"attn_mask": mask})
    kk, vv = k[:, :, lo:hi], v[:, :, lo:hi]
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        q, kk, vv, enable_gqa=True, **sdpa_kw), iters)
    esize = q.element_size()
    nbytes = (esize * (B * Hq * Sq * (D + Dv) + B * Hkv * (hi - lo) *
                       (D + Dv)) + 8.0 * B * Hq * Sq)
    ops = 2.0 * B * Hq * pairs * (D + Dv)
    b, by = (bound_ms(nbytes, ops, BF16_OPS_PER_S) if bf16 else
             bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S))
    return {"shape": f"{label}: q {list(q.shape)} k {list(k.shape)} v "
                     f"{list(v.shape)} window {win} q_offset {off} "
                     f"{str(q.dtype).split('.')[-1]}",
            "ms": ms, "no_stats_ms": nostats_ms, "over_no_stats": ms /
            nostats_ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms, "library_note": "SDPA forward (out alone)",
            "max_abs_err": err, "err_over_bf16_limit": ratio,
            "m_err": m_err, "l_err": l_err, "out_equals_no_stats": True}


def backward_case(q, k, v, kw: dict) -> dict:
    """The attention backward (``attention_bwd``: the reference's chunked
    recompute in torch ops, f32) timed beside SDPA's backward on the same
    inputs and output gradient; their gradients compared."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_bwd,
                                                     attention_stats)

    gen = torch.Generator(device=q.device)
    gen.manual_seed(SEED + 1)
    out, m, l = attention_stats(q, k, v, **kw)
    dout = torch.randn(out.shape, generator=gen, device=q.device).to(q.dtype)
    grads = attention_bwd(q, k, v, out, m, l, dout, **kw)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                       enable_gqa=True)
    lib = torch.autograd.grad(o, (qr, kr, vr), dout, retain_graph=True)
    rel = [max_abs_err(g.float(), w.float()) / float(w.float().abs().max())
           for g, w in zip(grads, lib)]
    torch.cuda.synchronize()
    check(max(rel) <= 5e-2, f"attention_bwd and SDPA's backward disagree "
          f"({rel})")
    ms = cuda_ms(lambda: attention_bwd(q, k, v, out, m, l, dout, **kw), 3)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (qr, kr, vr), dout, retain_graph=True), 10)
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    pairs, _, _ = visible_span(Sq, Sk, None, 0)
    nbytes = (2.0 * (2 * B * Hq * Sq * (D + Dv) + 2 * B * Hkv * Sk * (D + Dv))
              + 8.0 * B * Hq * Sq)
    ops = 2.0 * B * Hq * pairs * (3 * D + 2 * Dv)
    b, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
    return {"shape": f"q {list(q.shape)} k/v {list(k.shape)} causal bf16",
            "ms": ms, "library_ms": lib_ms, "over_library": ms / lib_ms,
            "bound_ms": b, "bound_by": by,
            "rel_err_vs_library": dict(zip(("dq", "dk", "dv"), rel))}


def reduced_grads(dev) -> dict:
    """Reduced gemma3-1b and deepseek-v3 (``mtp`` on, every token's routes
    pinned) in f32: ``loss_fn``'s gradients on the card against the
    CPU's, every leaf within GRAD_TOL of its largest magnitude."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import reduced_config
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import model as tm
    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree_util import tree_map

    out = {}
    for arch in GRAD_ARCHS:
        cfg = dataclasses.replace(reduced_config(arch), dtype=torch.float32)
        gen = torch.Generator().manual_seed(SEED)
        cpu = init_params(tm.param_defs(cfg), gen, "cpu")
        if cfg.moe is not None:
            for g in cpu.values():
                if isinstance(g, dict) and "router_bias" in g:
                    g["router_bias"].zero_()
                    g["router_bias"][..., :cfg.moe.top_k] = 2.0
        card = tree_map(lambda t: t.to(dev), cpu)
        tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (2, 32)))
        (loss, _), g_cpu = value_and_grad(
            lambda p, b: tm.loss_fn(p, b, cfg), cpu, {"tokens": tokens})
        (loss_d, _), g_dev = value_and_grad(
            lambda p, b: tm.loss_fn(p, b, cfg), card,
            {"tokens": tokens.to(dev)})
        worst, at = worst_leaf(g_cpu, g_dev)
        check(worst <= GRAD_TOL, f"{arch} reduced f32: gradient {at} off by "
              f"{worst} of its largest magnitude on the card")
        check(abs(float(loss_d) - float(loss)) <= 1e-5 * float(loss),
              f"{arch} reduced f32: loss {float(loss_d)} on the card, "
              f"{float(loss)} on the CPU")
        out[arch] = {"worst_leaf_rel_err": worst, "worst_leaf": at,
                     "loss_card": float(loss_d), "loss_cpu": float(loss),
                     "mtp": cfg.mtp}
    return out


def train_phase(dev) -> list[dict]:
    """Training (the slice's main path; see the module docstring): the
    statistics kernels at their shapes, the backward beside SDPA's, the
    reduced f32 gradients against the CPU's, then gemma3-1b at full width
    through ``launch/train``.  Returns the records of the two statistics
    kernels."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train as tr

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    cfg, _ = get_arch(TRAIN_ARCH)
    H, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    # the statistics launches at the served and the training shapes: the
    # LM phase's local and global prefill (B 8 x 4,096 on the 4,128-key
    # cache), the training step's (B 2 x 2,048), in bf16 and f32
    shapes = {"bf16": [], "f32": []}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for label, (B, Sq, Sk), win, iters in (
                ("served global prefill", (LM_BATCH, LM_PROMPT,
                                           LM_PROMPT + LM_GEN), None, 4),
                ("served local prefill", (LM_BATCH, LM_PROMPT,
                                          LM_PROMPT + LM_GEN), W, 4),
                ("training global", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ),
                 None, 10),
                ("training local", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ), W,
                 10)):
            if dtype == torch.float32 and label.startswith("served local"):
                continue
            q = rand((B, H, Sq, D), dtype)
            k, v = rand((B, Hkv, Sk, D), dtype), rand((B, Hkv, Sk, D), dtype)
            shapes[name].append(stats_case(
                q, k, v, label, {"window": win}, iters if dtype ==
                torch.bfloat16 else 2))
            del q, k, v
            torch.cuda.empty_cache()
    q = rand((TRAIN_BATCH, H, TRAIN_SEQ, D), torch.bfloat16)
    k = rand((TRAIN_BATCH, Hkv, TRAIN_SEQ, D), torch.bfloat16)
    v = rand((TRAIN_BATCH, Hkv, TRAIN_SEQ, D), torch.bfloat16)
    bwd = backward_case(q, k, v, {"causal": True})
    del q, k, v
    print(f"train: statistics launches {json.dumps(shapes)}; "
          f"attention backward {json.dumps(bwd)}")

    kernels.reset_launch_counts()
    grads = reduced_grads(dev)
    torch.cuda.synchronize()
    n_grad = kernels.launch_counts()
    check(n_grad["flash_attention_prefill_f32_stats"] > 0 and
          n_grad["flash_attention_prefill_f32_stats"] ==
          n_grad["flash_attention_prefill_f32"] ==
          n_grad["flash_attention"], f"reduced f32 gradients: every "
          f"attention call through the f32 statistics kernel ({n_grad})")
    print(f"train: reduced f32 gradients on the card against the CPU's "
          f"{json.dumps(grads)}; launches {json.dumps(n_grad)}")

    # the main path: launch/train at full width on one repeated batch
    rng = np.random.default_rng(SEED)
    batch = tr.synth_batch(TRAIN_ARCH, cfg, rng, TRAIN_BATCH, TRAIN_SEQ,
                           dev)
    L = cfg.n_layers

    def run(batch=TRAIN_BATCH, log=lambda *_: None, **kw):
        return tr.train(TRAIN_ARCH, full_config=True, batch=batch,
                        seq=TRAIN_SEQ, lr=TRAIN_LR, device=dev, log=log,
                        **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    main = run(steps=TRAIN_STEPS, data=lambda step: batch)
    torch.cuda.synchronize()
    n_main = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses = main["losses"]
    step_ms = [s * 1e3 for s in main["step_s"]]
    steady_ms = statistics.median(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"train: {TRAIN_ARCH} at full width ({L} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}, bf16, AdamW), B "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} a step on one batch, {TRAIN_STEPS} "
          f"steps: losses {losses}; ms per step {step_ms} (median after the "
          f"first {steady_ms:.3f}, {tokens / steady_ms * 1e3:.1f} tokens/s); "
          f"peak {peak:.3f} GiB; launches {json.dumps(n_main)}")
    # each micro-batch: L forward launches and L more when the backward
    # recomputes each layer (cfg.remat)
    want = 2 * L * TRAIN_STEPS
    check(n_main["flash_attention_prefill_stats"] == want ==
          n_main["flash_attention_prefill"] == n_main["flash_attention"],
          f"training launched {n_main}, not {want} statistics launches")
    check(n_main["flash_attention_decode"] == 0 ==
          n_main["flash_attention_prefill_f32"], f"training ran other "
          f"attention kernels: {n_main}")
    check(all(np.isfinite(losses)), f"training losses {losses}")
    check(losses[-1] < losses[0], f"the loss does not fall on a repeated "
          f"batch: {losses}")

    # one more step of the same code under the profiler: device time by
    # kind of kernel, and the device's busy share of the step's wall
    from repro_torch.training.optim import OPTIMIZERS, warmup_cosine
    from repro_torch.training.trainer import make_train_step
    loss_fn, _ = tr.make_loss(TRAIN_ARCH, cfg)
    opt = OPTIMIZERS[get_arch(TRAIN_ARCH)[1]](
        lr=TRAIN_LR, schedule=warmup_cosine(TRAIN_LR, 20, TRAIN_STEPS))
    step_fn = make_train_step(loss_fn, opt)
    prof = profiled_ms(lambda: step_fn(main["params"], main["opt_state"],
                                       batch))
    print(f"train: one step profiled {json.dumps(prof)}")

    # a crash after the checkpoint at TRAIN_CKPT_EVERY, then the resume
    def crashing(step):
        if step == TRAIN_CRASH_AT:
            raise Preempted(step)
        return batch

    with tempfile.TemporaryDirectory() as ckdir:
        said = []
        try:
            run(steps=TRAIN_STEPS, data=crashing, ckpt_dir=ckdir,
                ckpt_every=TRAIN_CKPT_EVERY, log=said.append)
            fail("the crashing run did not crash")
        except Preempted:
            pass
        save_s = float(next(line for line in said if line.startswith(
            "checkpoint @")).split()[-2])
        t0 = time.perf_counter()
        resumed = run(steps=TRAIN_STEPS, data=lambda step: batch,
                      ckpt_dir=ckdir, ckpt_every=TRAIN_STEPS + 1)
        resume_s = time.perf_counter() - t0
        ck_bytes = sum(f.stat().st_size for f in Path(ckdir).rglob("*")
                       if f.is_file())
    check(resumed["start"] == TRAIN_CKPT_EVERY, f"resumed at "
          f"{resumed['start']}")
    check(resumed["losses"] == losses[TRAIN_CKPT_EVERY:], f"resumed losses "
          f"{resumed['losses']}, uninterrupted {losses}")
    for tree in ("params", "opt_state"):
        at = differing_leaf(main[tree], resumed[tree])
        check(at is None, f"resume differs at {tree} {at}")
    restore_s = resumed["ckpt_s"]["restore"]
    del main, resumed
    torch.cuda.empty_cache()

    # one pass at TRAIN_ACCUM micro-batches of TRAIN_BATCH: 2 steps, the
    # second timed
    big = tr.synth_batch(TRAIN_ARCH, cfg, rng, TRAIN_ACCUM * TRAIN_BATCH,
                         TRAIN_SEQ, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    acc = run(steps=2, accum_steps=TRAIN_ACCUM, batch=TRAIN_ACCUM *
              TRAIN_BATCH, data=lambda step: big)
    torch.cuda.synchronize()
    n_acc = kernels.launch_counts()
    acc_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(n_acc["flash_attention_prefill_stats"] ==
          2 * L * TRAIN_ACCUM * 2, f"accumulation launched {n_acc}")
    check(all(np.isfinite(acc["losses"])), f"accumulation losses "
          f"{acc['losses']}")
    acc_ms = acc["step_s"][1] * 1e3
    del acc, big, batch
    torch.cuda.empty_cache()
    train = {
        "arch": TRAIN_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "lr": TRAIN_LR, "losses": losses,
        "ms_per_step": step_ms, "steady_ms_per_step": steady_ms,
        "tokens_per_s": tokens / steady_ms * 1e3, "peak_gib": peak,
        "accum_steps": TRAIN_ACCUM, "accum_ms_per_step": acc_ms,
        "accum_tokens_per_s": TRAIN_ACCUM * tokens / acc_ms * 1e3,
        "accum_peak_gib": acc_peak, "resume_bit_for_bit": True,
        "checkpoint_bytes": ck_bytes, "save_s": save_s,
        "resume_run_s": resume_s, "restore_s": restore_s,
        "profiled_step": prof, "reduced_f32_grads": grads,
        "phase_s": time.perf_counter() - t_phase}
    print(f"train: resumed after a crash at step {TRAIN_CRASH_AT} from the "
          f"checkpoint at {TRAIN_CKPT_EVERY}: parameters and optimizer state "
          f"equal the uninterrupted run's, bit for bit; one step at "
          f"accum_steps {TRAIN_ACCUM} (B {TRAIN_ACCUM * TRAIN_BATCH}) "
          f"{acc_ms:.3f} ms, peak {acc_peak:.3f} GiB; {json.dumps(train)}")
    csrc = "src/repro_torch/kernels/csrc"
    replaces = "src/repro/kernels/flash_attention/flash_attention.py:95"
    recs = []
    for name, source, dtype, n_launch, path in (
            ("flash_attention_prefill_stats", f"{csrc}/flash_prefill.cu",
             "bf16", n_main["flash_attention_prefill_stats"],
             "launch/train, gemma3-1b at full width"),
            ("flash_attention_prefill_f32_stats",
             f"{csrc}/flash_prefill_f32.cu", "f32",
             n_grad["flash_attention_prefill_f32_stats"],
             "the reduced f32 gradients (gemma3-1b, deepseek-v3)")):
        top = next(s for s in shapes[dtype]
                   if s["shape"].startswith("training global"))
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": n_launch,
               "launches_note": f"the training path: {path}, counts zeroed "
                                f"before and read after",
               "max_abs_err": max(s["max_abs_err"] for s in shapes[dtype]),
               "ms": top["ms"], "plain_ms": top["plain_ms"],
               "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
               "library_ms": top["library_ms"], "shape": top["shape"],
               "no_stats_ms": top["no_stats_ms"],
               "shapes": shapes[dtype]}
        if dtype == "bf16":
            rec["training"] = train
            rec["backward"] = bwd
        print(f"kernel {name}: {json.dumps(rec)}")
        recs.append(rec)
    return recs


def load_example(root: Path, name: str = "pt_temporal_gnn_train"):
    """``examples/<name>.py`` of the checkout at ``root``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, root / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worst_leaf(g_cpu, g_dev, zero=()) -> tuple[float, str]:
    """The largest |got - want| of a gradient leaf (``g_dev`` against
    ``g_cpu``, compared on the host) over that leaf's largest magnitude in
    ``g_cpu``, and its leaf; a leaf in ``zero`` (exact gradient 0) over
    the tree's largest magnitude instead."""
    from repro_torch.tree_util import flatten_with_paths, path_name

    want = {path_name(p): x for p, x in flatten_with_paths(g_cpu)}
    top = max(float(w.abs().max()) for w in want.values())
    worst, at = 0.0, None
    for p, x in flatten_with_paths(g_dev):
        w = want[path_name(p)].cpu()
        scale = top if path_name(p) in zero else float(w.abs().max())
        err = float((x.cpu() - w).abs().max()) / (scale or 1.0)
        if err > worst:
            worst, at = err, path_name(p)
    return worst, at


def card_against_cpu(loss_fn, params, batch, dev, zero=()) -> dict:
    """``loss_fn``'s loss and gradients on the card against the CPU's, from
    the same parameters and batch moved to the host: the loss within 1e-5
    relative, every leaf within GRAD_TOL (``worst_leaf``)."""
    import torch

    from repro_torch.training.trainer import value_and_grad
    from repro_torch.tree_util import tree_map

    def on(d, b):
        return {k: v.to(d) if isinstance(v, torch.Tensor) else v
                for k, v in b.items()}

    (l_dev, _), g_dev = value_and_grad(loss_fn, tree_map(
        lambda t: t.to(dev), params), on(dev, batch))
    (l_cpu, _), g_cpu = value_and_grad(loss_fn, tree_map(
        lambda t: t.cpu(), params), on("cpu", batch))
    worst, at = worst_leaf(g_cpu, g_dev, zero)
    rel = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
    return {"loss_rel_err": rel, "worst_grad_err": worst, "worst_leaf": at}


def hold_card_against_cpu(res: dict, label: str) -> None:
    check(res["loss_rel_err"] <= 1e-5 and res["worst_grad_err"] <= GRAD_TOL,
          f"{label}: card against CPU {res}")


def temporal_gcn(gm, ev, dev, root: Path) -> dict:
    """Phase 10(a): the example's GCN trained on GCN_WINDOWS loader windows
    of the main history through the example's own functions."""
    import itertools
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.models.gnn import gnn_loss
    from repro_torch.storage.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
    from repro_torch.storage.kv import LogFileKV

    ex = load_example(root)
    uni = gm.universe
    tmax = int(ev.time[-1])
    T = ex.BATCH_SIZE
    times = ex.time_grid(tmax)[:GCN_WINDOWS * T]
    horizon = tmax // 10
    loader = ex.make_loader(gm, times, tmax)
    windows, window_s = [], []

    class Recorded:
        """The loader, each window kept and its seconds taken."""

        def __iter__(self):
            it = iter(loader)
            while True:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                b = next(it, None)
                torch.cuda.synchronize()
                if b is None:
                    return
                window_s.append(time.perf_counter() - t0)
                windows.append(b)
                yield b

    params = ex.init_model(ex.CFG, dev)
    opt, step_fn = ex.make_step()
    opt_state = opt[0](params)
    steps = GCN_WINDOWS * T
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t_all = time.perf_counter()
    stream = ex.snapshot_stream(Recorded())
    first = next(stream)
    grads = card_against_cpu(lambda p, b: gnn_loss(p, b, ex.CFG), params,
                             first, dev)
    t0 = time.perf_counter()
    params, opt_state, losses = ex.train_steps(
        step_fn, params, opt_state, itertools.chain([first], stream), 0,
        steps, log=lambda *_: None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    wall = time.perf_counter() - t_all
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(len(windows) == GCN_WINDOWS, f"temporal GCN: {len(windows)} "
          f"windows for {steps} steps")
    check(launches["delta_apply_fused"] == 2 * GCN_WINDOWS and
          launches["segment_sum_bucketed"] == 4 * T * GCN_WINDOWS and
          launches["delta_apply_chain"] > 0, f"temporal GCN: launches "
          f"{launches}, not 2 fused and {4 * T} segment-sum a window and "
          f"some chain launches")
    check_loader_batch(uni, ev, windows[0], times[:T], horizon, dev,
                       "temporal GCN")
    check(all(np.isfinite(losses)), f"temporal GCN losses {losses}")
    hold_card_against_cpu(grads, "temporal GCN first step")
    with tempfile.TemporaryDirectory() as ckdir:
        store = LogFileKV(ckdir)
        save_checkpoint(store, steps, (params, opt_state))
        store.close()
        store = LogFileKV(ckdir)
        (p, s), _, at = restore_checkpoint(store, like=(params, opt_state))
        store.close()
    check(at == steps and differing_leaf(params, p) is None and
          differing_leaf(opt_state, s) is None,
          "temporal GCN: the checkpoint does not read back bit for bit")
    # the steps' own time: the training wall less the second window's
    step_ms = (train_s - sum(window_s[1:])) / steps * 1e3
    rec = {"nodes": uni.num_nodes, "edge_slots": 2 * uni.num_edges,
           "times": times, "horizon": horizon, "window_s": window_s,
           "wall_s": wall, "ms_per_step": step_ms, "losses": losses,
           "peak_gib": peak, "launches": launches, "first_step": grads,
           "checkpoint_bit_for_bit": True}
    print(f"gnn: (a) temporal GCN on {GCN_WINDOWS} loader windows of {T} "
          f"points of the main history ({uni.num_nodes} nodes, "
          f"{2 * uni.num_edges} edge slots): wall {wall:.3f} s, windows "
          f"{[round(w, 3) for w in window_s]} s, {step_ms:.3f} ms a step, "
          f"peak {peak:.3f} GiB; {json.dumps(rec)}")
    return rec


def gnn_cell_batch(cfg, shape, rng, block=None) -> dict:
    """A batch of ``shape`` for ``cfg``, drawn from ``rng`` as the train
    launcher's ``synth_batch`` draws (its fields in its order), at the
    shape's padded sizes: a random graph (GIN: 4-node molecules, a
    graph-level readout), or a sampler ``block``'s edges (sampled
    shapes)."""
    import numpy as np
    import torch

    if block is not None:
        N, E = block.nodes.size, block.edge_index.shape[1]
        ei = block.edge_index
    else:
        N, E = shape.padded()
        src = rng.integers(0, N, E // 2).astype(np.int32)
        if cfg.kind == "gin":
            per = N // shape.n_graphs
            dst = (src // per * per + rng.integers(0, per, E // 2)).astype(
                np.int32)
        else:
            dst = rng.integers(0, N, E // 2).astype(np.int32)
        ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst,
                                                                   src])])
    b = {"edge_index": ei}
    f32 = np.float32
    if cfg.kind == "gcn":
        b.update(x=rng.standard_normal((N, cfg.d_in)).astype(f32),
                 labels=rng.integers(0, cfg.n_classes, N).astype(np.int32),
                 label_mask=np.ones(N, f32))
    elif cfg.kind == "gin":
        G = shape.n_graphs
        b.update(x=rng.standard_normal((N, cfg.d_in)).astype(f32),
                 labels=rng.integers(0, cfg.n_classes, G).astype(np.int32),
                 label_mask=np.ones(G, f32),
                 graph_ids=(np.arange(N) * G // N).astype(np.int32),
                 node_mask=np.ones(N, f32), n_graphs=G)
    elif cfg.kind == "meshgraphnet":
        b.update(x=rng.standard_normal((N, cfg.d_node_in)).astype(f32),
                 edge_attr=rng.standard_normal((E, cfg.d_edge_in)).astype(
                     f32),
                 target=rng.standard_normal((N, cfg.d_out)).astype(f32),
                 node_mask=block.node_mask.astype(f32))
    else:
        b.update(z=rng.integers(1, 10, N).astype(np.int32),
                 pos=rng.standard_normal((N, 3)).astype(f32),
                 triplet_kj=rng.integers(0, E, 4 * E).astype(np.int32),
                 triplet_ji=rng.integers(0, E, 4 * E).astype(np.int32),
                 graph_ids=np.zeros(N, np.int32),
                 target=rng.standard_normal((1, cfg.d_out)).astype(f32),
                 n_graphs=1)
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in b.items()}


def sampled_block(gm, tmax: int, shape, dev):
    """A ``sample_blocks`` + ``pad_blocks`` block of ``shape`` (its seeds
    and fanouts) from the history's last snapshot, retrieved on the card;
    padded as the reference's sampled cell (``sampled_shapes`` rounded to
    512)."""
    import numpy as np

    from repro_torch.graph.csr import build_csr
    from repro_torch.graph.sampler import (pad_blocks, sample_blocks,
                                           sampled_shapes)
    from repro_torch.runtime import torch_exec

    uni = gm.universe
    nm, em = torch_exec.execute_singlepoint_torch(gm.dg, tmax, device=dev)
    csr = build_csr(uni.edge_src, uni.edge_dst, uni.num_nodes, em,
                    uni.edge_directed)
    rng = np.random.default_rng(SEED)
    seeds = rng.choice(np.nonzero(nm)[0], shape.batch_nodes, replace=False)
    block = sample_blocks(csr, seeds, list(shape.fanouts), rng)
    n_raw, e_raw = sampled_shapes(shape.batch_nodes, list(shape.fanouts))
    return pad_blocks(block, -(-n_raw // 512) * 512, -(-e_raw // 512) * 512)


def gnn_cells(gm, tmax: int, dev) -> dict:
    """Phase 10(b): each GNN architecture at its published widths, the
    config adapted to its shape as the reference's cell adapts it, on one
    seeded batch of that shape: GNN_STEPS AdamW steps; its reduced config
    on the card against the CPU; MeshGraphNet at MGN_CHUNKS gather chunks
    against the unchunked step."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch, reduced_config
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch import train as tr
    from repro_torch.models.common import init_params
    from repro_torch.training.optim import OPTIMIZERS
    from repro_torch.training.trainer import make_train_step, value_and_grad
    from repro_torch.tree_util import leaves

    t0 = time.perf_counter()
    block = sampled_block(gm, tmax, GNN_SHAPES["minibatch_lg"], dev)
    print(f"gnn: sampled block of the last snapshot: "
          f"{int(block.node_mask.sum())} nodes, "
          f"{int(block.edge_mask.sum())} live edges, padded to "
          f"{block.nodes.size}, {block.edge_index.shape[1]} "
          f"({time.perf_counter() - t0:.3f} s)")
    out = {}
    for arch, shape_name in GNN_CELLS:
        t_arch = time.perf_counter()
        shape = GNN_SHAPES[shape_name]
        cfg, opt_name = get_arch(arch)
        if cfg.kind in ("gcn", "gin"):
            cfg = dataclasses.replace(cfg, d_in=shape.d_feat,
                                      n_classes=shape.n_classes)
        elif cfg.kind == "meshgraphnet":
            cfg = dataclasses.replace(cfg, d_node_in=shape.d_feat)
        batch = gnn_cell_batch(cfg, shape, np.random.default_rng(SEED),
                               block if shape.kind == "sampled" else None)
        batch = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                 for k, v in batch.items()}
        loss_fn, defs = tr.make_loss(arch, cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = init_params(defs, gen, dev)
        opt = OPTIMIZERS[opt_name](lr=GNN_LR)
        step = make_train_step(loss_fn, opt)
        state = opt[0](params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        # the first gradient's global norm, in f64 and as AdamW's clip
        # takes it in f32 (an f32 overflow there zeroes the whole update)
        _, g = value_and_grad(loss_fn, params, batch)
        norm64 = math.sqrt(sum(float(torch.sum(x.double() ** 2))
                               for x in leaves(g)))
        norm32 = float(torch.sqrt(sum(torch.sum(x.float() ** 2)
                                      for x in leaves(g))))
        del g
        losses, step_ms = [], []
        for _ in range(GNN_STEPS):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{arch} at {shape_name}: losses {losses}")
        rcfg = reduced_config(arch)
        rloss, rdefs = tr.make_loss(arch, rcfg)
        rparams = init_params(rdefs, torch.Generator().manual_seed(SEED),
                              "cpu")
        reduced = card_against_cpu(rloss, rparams, tr.synth_batch(
            arch, rcfg, np.random.default_rng(SEED), 4, 8, "cpu"), dev)
        hold_card_against_cpu(reduced, f"{arch} reduced")
        edges = batch["edge_index"].shape[1]
        nodes = (batch["x"] if "x" in batch else batch["z"]).shape[0]
        rec = {"shape": shape_name, "nodes": nodes, "edge_slots": edges,
               "losses": losses, "ms_per_step": step_ms,
               "steady_ms_per_step": statistics.median(step_ms[1:]),
               "peak_gib": peak, "grad_norm_f64": norm64,
               "grad_norm_f32": norm32,
               "clip_zeroes_update": not math.isfinite(norm32),
               "reduced_card_against_cpu": reduced}
        if cfg.kind == "dimenet":
            rec["triplets"] = int(batch["triplet_kj"].shape[0])
        if cfg.kind == "meshgraphnet":
            # in f64, where the float atomics' order of additions is far
            # below the limit (in f32 it alone reached 8.5e-5 of a leaf's
            # largest magnitude at this block, PERF.md); the decoder,
            # which the model runs in f32, and its target stay f32
            f64 = dataclasses.replace(cfg, act_dtype=torch.float64)
            p64 = {k: v if k.startswith("dec_") else v.double()
                   for k, v in params.items()}
            b64 = {k: v.double() if k != "target" and isinstance(
                v, torch.Tensor) and v.is_floating_point() else v
                for k, v in batch.items()}
            res = {}
            for c in (f64, dataclasses.replace(f64,
                                               gather_chunks=MGN_CHUNKS)):
                lf, _ = tr.make_loss(arch, c)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (loss, _), g = value_and_grad(lf, p64, b64)
                torch.cuda.synchronize()
                res[c.gather_chunks] = (float(loss), g,
                                        (time.perf_counter() - t0) * 1e3)
            del p64, b64
            (l0, g0, ms0), (l1, g1, ms1) = res[0], res[MGN_CHUNKS]
            worst, at = worst_leaf(g0, g1)
            rel = abs(l1 - l0) / abs(l0)
            check(rel <= 1e-5 and worst <= GRAD_TOL, f"meshgraphnet: "
                  f"{MGN_CHUNKS} gather chunks against none: loss "
                  f"{rel}, gradient {at} {worst}")
            rec["gather_chunks"] = {"chunks": MGN_CHUNKS, "dtype": "f64",
                                    "loss_rel_err": rel,
                                    "worst_grad_err": worst, "worst_leaf": at,
                                    "unchunked_ms": ms0, "chunked_ms": ms1}
        rec["wall_s"] = time.perf_counter() - t_arch
        print(f"gnn: (b) {arch} at {shape_name}: wall {rec['wall_s']:.3f} s, "
              f"{rec['steady_ms_per_step']:.3f} ms a step, peak "
              f"{peak:.3f} GiB; {json.dumps(rec)}")
        out[arch] = rec
        del params, state, batch, m
        torch.cuda.empty_cache()
    return out


def din_phase(dev) -> dict:
    """Phase 10(c): DIN at its published config: DIN_STEPS AdamW steps
    through ``launch/train`` at ``train_batch``; serving through
    ``launch/serve``'s DIN mode at ``serve_p99`` and ``serve_bulk``;
    ``din_retrieval`` at ``retrieval_cand`` against the CPU's; the
    reduced DIN's gradients on the card against the CPU's."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch, reduced_config
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.launch import serve
    from repro_torch.launch import train as tr
    from repro_torch.models.common import init_params
    from repro_torch.models.recsys.din import din_retrieval
    from repro_torch.tree_util import tree_map

    t_part = time.perf_counter()
    cfg, _ = get_arch("din")
    B = RECSYS_SHAPES["train_batch"].batch
    batch = tr.synth_batch("din", cfg, np.random.default_rng(SEED), B, 0,
                           dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    res = tr.train("din", full_config=True, steps=DIN_STEPS, batch=B,
                   lr=DIN_LR, device=dev, data=lambda step: batch,
                   log=lambda *_: None)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    losses = res["losses"]
    step_ms = [s * 1e3 for s in res["step_s"]]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"din training losses {losses}")
    rcfg = reduced_config("din")
    rloss, rdefs = tr.make_loss("din", rcfg)
    reduced = card_against_cpu(
        rloss, init_params(rdefs, torch.Generator().manual_seed(SEED),
                           "cpu"),
        tr.synth_batch("din", rcfg, np.random.default_rng(SEED), 64, 0,
                       "cpu"), dev, zero=("attn_b2",))
    hold_card_against_cpu(reduced, "din reduced")
    train = {"batch": B, "losses": losses, "ms_per_step": step_ms,
             "steady_ms_per_step": statistics.median(step_ms[1:]),
             "peak_gib": peak, "reduced_card_against_cpu": reduced}
    print(f"din: (c) train_batch B {B}, {DIN_STEPS} AdamW steps through "
          f"launch/train: wall {time.perf_counter() - t_part:.3f} s, "
          f"{train['steady_ms_per_step']:.3f} ms a step, peak {peak:.3f} "
          f"GiB; {json.dumps(train)}")

    # retrieval: one user against every candidate in one product, from
    # the trained weights, against the CPU's
    params = res["params"]
    del res, batch
    torch.cuda.empty_cache()
    shape = RECSYS_SHAPES["retrieval_cand"]
    rng = np.random.default_rng(SEED)
    S, Nc = cfg.seq_len, shape.n_candidates
    rb = {"hist_goods": rng.integers(0, cfg.n_goods, (shape.batch, S)),
          "hist_cates": rng.integers(0, cfg.n_cates, (shape.batch, S)),
          "hist_mask": rng.random((shape.batch, S)) < 0.8,
          "cand_goods": rng.integers(0, cfg.n_goods, (shape.batch, Nc)),
          "cand_cates": rng.integers(0, cfg.n_cates, (shape.batch, Nc))}
    rb = {k: torch.from_numpy(v.astype(np.int32) if v.dtype != bool else v)
          for k, v in rb.items()}
    card_b = {k: v.to(dev) for k, v in rb.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        got = din_retrieval(params, card_b, cfg)
        ms = cuda_ms(lambda: din_retrieval(params, card_b, cfg), 10)
        want = din_retrieval(tree_map(lambda t: t.cpu(), params), rb, cfg)
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    check(got.shape == (shape.batch, Nc) and bool(torch.isfinite(got).all())
          and rel <= 1e-5, f"din_retrieval against the CPU: {rel}")
    retrieval = {"candidates": Nc, "ms": ms, "rel_err": rel,
                 "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    print(f"din: (c) retrieval_cand, one user x {Nc} candidates in one "
          f"product: {ms:.4f} ms, relative error against the CPU {rel:.3e}, "
          f"peak {retrieval['peak_gib']:.3f} GiB")
    del params, got, card_b
    torch.cuda.empty_cache()

    served = {}
    for name in ("serve_p99", "serve_bulk"):
        Bs = RECSYS_SHAPES[name].batch
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        r = serve.serve_din(Bs, device=dev, seed=SEED)
        check(r["scores"].shape == (Bs,) and
              bool(torch.isfinite(r["scores"]).all()),
              f"din serving at {name}: scores")
        served[name] = {"batch": Bs, "ms_per_batch": r["ms_per_batch"],
                        "scores_per_s": r["scores_per_s"],
                        "peak_gib": torch.cuda.max_memory_allocated(dev)
                        / 2 ** 30, "wall_s": time.perf_counter() - t0}
        print(f"din: (c) serving at {name} (B {Bs}) through launch/serve: "
              f"wall {served[name]['wall_s']:.3f} s, "
              f"{r['ms_per_batch']:.4f} ms a batch, "
              f"{r['scores_per_s']:.0f} scores/s, peak "
              f"{served[name]['peak_gib']:.3f} GiB")
        del r
        torch.cuda.empty_cache()
    return {"train": train, "retrieval": retrieval, "serve": served}


def gnn_din_phase(gm, ev, dev, root: Path) -> dict:
    """Phase 10: GNN and DIN on the card (see the module docstring)."""
    import torch

    t_phase = time.perf_counter()
    out = {"temporal_gcn": temporal_gcn(gm, ev, dev, root)}
    torch.cuda.empty_cache()
    out["gnn"] = gnn_cells(gm, int(ev.time[-1]), dev)
    out["din"] = din_phase(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"gnn/din: phase {out['phase_s']:.3f} s")
    return out

def card_cell_args(cell, dev, seed: int = SEED) -> tuple:
    """The arguments of a GNN or DIN cell (``configs/registry.py``) on the
    card, at the shapes of its ``meta`` arguments: seeded parameters
    (``init_params``), the optimizer's fresh state over them (as the
    cell's), and a batch drawn key by key in each key's range (indices
    below the node, edge, graph, class or table counts; masks of ones;
    features normal)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.models.common import init_params
    from repro_torch.models.gnn import gnn_param_defs
    from repro_torch.models.recsys.din import din_param_defs
    from repro_torch.training.optim import OPTIMIZERS

    cfg, gen = cell.cfg, torch.Generator(device=dev).manual_seed(seed)
    din = cfg.kind == "din"
    params = init_params(din_param_defs(cfg) if din else gnn_param_defs(cfg),
                         gen, dev)
    batch = cell.args[-1]
    if din:
        highs = {"goods": cfg.n_goods, "cates": cfg.n_cates, "labels": 2}
    else:
        nodes = batch["node_mask"].shape[0]
        highs = {"edge_index": nodes, "labels": getattr(cfg, "n_classes", 1),
                 "triplet_kj": batch["edge_index"].shape[1],
                 "triplet_ji": batch["edge_index"].shape[1]}

    def draw(key, m):
        if m.dtype == torch.bool:
            return torch.rand(m.shape, generator=gen, device=dev) < 0.8
        if m.is_floating_point():
            if key.endswith("mask"):
                return torch.ones(m.shape, dtype=m.dtype, device=dev)
            return torch.randn(m.shape, generator=gen, device=dev).to(m.dtype)
        if key == "graph_ids":      # sorted, as a batch of graphs lies
            G = GNN_SHAPES[cell.shape].n_graphs
            n = m.shape[0]
            return (torch.arange(n, device=dev) * G // n).to(m.dtype)
        if key == "z":
            lo, hi = 1, 10
        else:
            lo, hi = 0, highs[key.rsplit("_", 1)[-1] if din else key]
        return torch.randint(lo, hi, m.shape, generator=gen, device=dev,
                             dtype=m.dtype)

    batch = {k: draw(k, m) for k, m in batch.items()}
    if cell.step_kind != "train":
        return params, batch
    return params, OPTIMIZERS[get_arch(cell.arch)[1]]()[0](params), batch


def meta_launches(cfg, batch: int, prompt: int, gen: int) -> dict:
    """Calls per kernel route of one ``prefill_step`` over ``prompt``
    tokens and one ``decode_step`` at ``cache_len = prompt`` on a cache of
    ``prompt + gen``, traced on the ``meta`` device; and each step's
    predicted peak bytes."""
    import torch

    from repro_torch.configs.registry import abstract_cache
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.models import common as mc
    from repro_torch.models.transformer import model as tm

    params = mc.abstract_params(tm.param_defs(cfg))
    prefill = analyze(lambda p, t: tm.prefill_step(p, t, cfg), params,
                      torch.empty((batch, prompt), dtype=torch.int32,
                                  device="meta"))
    decode = analyze(lambda p, c, t: tm.decode_step(p, c, t, prompt, cfg),
                     params, abstract_cache(cfg, batch, prompt + gen),
                     torch.empty((batch, 1), dtype=torch.int32,
                                 device="meta"))
    return {step: {k: v["launches"] for k, v in a.kernels.items()}
            for step, a in (("prefill", prefill), ("decode", decode))}, {
        "prefill_peak_bytes": prefill.peak_bytes,
        "decode_peak_bytes": decode.peak_bytes}


def dryrun_phase(dev, card: dict) -> dict:
    """Phase 11, the dry run: (a) the whole sweep on ``meta``; (b) the
    :data:`DRYRUN_CARD_CELLS` predicted on ``meta`` and run on the card,
    the predicted peak within :data:`PEAK_BAND` of the measured one, the
    roofline's time beside the measured ms; (c) the kernel routes and
    calls a meta trace of gemma3-1b's and deepseek-v3's (cut to
    :data:`DS_LAYERS`) prefill and decode steps counts, for one prefill
    and :data:`LM_GEN` / :data:`DS_GEN` decode steps, held exactly against
    ``card``, the launches of phases 7 and 8's main-path runs."""
    import torch

    from repro_torch.configs.registry import get_arch, get_cell, list_cells
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    results = dryrun.sweep(list_cells(), [False, True], {},
                           log=lambda line: print(f"dryrun: {line}"))
    sweep_s = time.perf_counter() - t0
    counts = {k: sum(r["status"] == k for r in results.values())
              for k in DRYRUN_SWEEP}
    print(f"dryrun: (a) the sweep, {len(results)} records on the meta "
          f"device: {counts} in {sweep_s:.3f} s")
    check(counts == DRYRUN_SWEEP, f"dry run sweep: {counts}, not "
          f"{DRYRUN_SWEEP}: " + "; ".join(
              r["error"] for r in results.values() if r["status"] == "error"))
    ok = {k: r for k, r in results.items() if r["status"] == "ok"}
    unmodeled = {k: r["collectives_unmodeled"] for k, r in ok.items()
                 if r["collectives_unmodeled"]}
    check(not unmodeled, f"dry run: ops without a sharding rule {unmodeled}")
    check(all(math.isfinite(r["roofline"]["collective_s"]) and
              r["roofline"]["collective_s"] >= 0 for r in ok.values()),
          "dry run: a collective term that is not finite")
    bottlenecks = {mesh: {b: sorted(k.split("|", 2)[0] + " x " +
                                    k.split("|", 2)[1] for k, r in ok.items()
                                    if k.endswith(mesh) and
                                    r["roofline"]["bottleneck"] == b)
                          for b in ("compute_s", "memory_s", "collective_s")}
                   for mesh in ("single", "multi")}
    print(f"dryrun: (a) cells by bottleneck on each mesh (collective_s: "
          f"the sharding pass's bytes over {dryrun.LINK_BW:.0f} B/s) "
          f"{json.dumps(bottlenecks)}")

    one = make_mesh((1, 1), ("data", "model"))
    cells = {}
    for arch, shape in DRYRUN_CARD_CELLS:
        cell = get_cell(arch, shape, one)
        counted, trace_s, _ = dryrun.trace_cell(cell, record=False)
        roof = dryrun.roofline(counted, 1, cell.flops_model)
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(dev)
        args = card_cell_args(cell, dev)
        arg_bytes = torch.cuda.memory_allocated(dev) - m0
        out = cell.fn(*args)                      # warm-up
        del out
        torch.cuda.synchronize()
        # what the warm-up left allocated: a library's workspace made at
        # its first use in the process (cuBLAS's), not the step's; more
        # than that workspace is a leak of the first call
        kept = torch.cuda.memory_allocated(dev) - m0 - arg_bytes
        check(0 <= kept <= CUBLAS_WORKSPACE_BYTES, f"{arch} x {shape}: the "
              f"warm-up step left {kept} bytes allocated, more than "
              f"cuBLAS's workspace of {CUBLAS_WORKSPACE_BYTES}")
        torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for _ in range(DRYRUN_STEPS):
            t0 = time.perf_counter()
            out = cell.fn(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if len(ms) == 1:
                peak = torch.cuda.max_memory_allocated(dev) - m0 - kept
                # a step's loss, or the scores served
                check(bool(torch.isfinite(out[2]["loss"] if cell.step_kind
                                          == "train" else out).all()),
                      f"{arch} x {shape}: not finite")
            del out
        torch.cuda.synchronize()
        check(torch.cuda.memory_allocated(dev) - m0 - arg_bytes == kept,
              f"{arch} x {shape}: steps left memory allocated")
        prof = profiled_ms(lambda: cell.fn(*args))    # device ms by kind
        del args
        torch.cuda.empty_cache()
        ratio = counted["peak_bytes"] / peak
        bound = max(roof["compute_s"], roof["memory_s"]) * 1e3
        rec = {"arch": arch, "shape": shape, "step_kind": cell.step_kind,
               "trace_s": trace_s,
               "predicted_peak_bytes": counted["peak_bytes"],
               "predicted_argument_bytes": counted["argument_bytes"],
               "measured_peak_bytes": peak, "measured_argument_bytes":
                   arg_bytes, "kept_by_warm_up_bytes": kept,
               "peak_ratio": ratio,
               "roofline_ms": bound, "compute_ms": roof["compute_s"] * 1e3,
               "memory_ms": roof["memory_s"] * 1e3,
               "bottleneck": roof["bottleneck"], "measured_ms": ms,
               "measured_median_ms": statistics.median(ms),
               "counted_flops": counted["flops"],
               "counted_hbm_bytes": counted["hbm_bytes"],
               "top_by_bytes": counted["top_by_bytes"][:6],
               "top_by_flops": counted["top_by_flops"][:3],
               "profiled_step": prof}
        cells[f"{arch}|{shape}"] = rec
        print(f"dryrun: (b) {arch} x {shape}: peak predicted "
              f"{counted['peak_bytes'] / 2**30:.4f} GiB, measured "
              f"{peak / 2**30:.4f} GiB (x{ratio:.3f}); roofline "
              f"{bound:.4f} ms ({roof['bottleneck']}: compute "
              f"{rec['compute_ms']:.4f}, memory {rec['memory_ms']:.4f}), "
              f"measured {rec['measured_median_ms']:.4f} ms (profiled: "
              f"device busy {prof['device_busy_ms']:.4f}, products "
              f"{prof['matrix_products']:.4f}, other {prof['other']:.4f}); "
              f"{json.dumps(rec)}")
        check(PEAK_BAND[0] <= ratio <= PEAK_BAND[1], f"{arch} x {shape}: "
              f"predicted peak {counted['peak_bytes']} against the card's "
              f"{peak}: x{ratio:.3f}, outside {PEAK_BAND}")

    gemma, _ = get_arch(LM_ARCH)
    ds_cfg = dataclasses.replace(get_arch(DS_ARCH)[0], n_layers=DS_LAYERS,
                                 n_dense_layers=DS_DENSE, mtp=False)
    traced = {LM_ARCH: meta_launches(gemma, LM_BATCH, LM_PROMPT, LM_GEN),
              DS_ARCH: meta_launches(ds_cfg, DS_BATCH, DS_PROMPT, DS_GEN)}
    gens = {LM_ARCH: LM_GEN, DS_ARCH: DS_GEN}
    meta = {arch: {"prefill": t[0]["prefill"], "decode": {
                k: n * gens[arch] for k, n in t[0]["decode"].items()}}
            for arch, t in traced.items()}
    lm_peaks = {arch: t[1] for arch, t in traced.items()}
    print(f"dryrun: (c) meta-traced routes and calls, one prefill and "
          f"{gens} decode steps {json.dumps(meta)}; the card's launches "
          f"{json.dumps(card)}; predicted peaks (not held) "
          f"{json.dumps(lm_peaks)}")
    check(meta == card, f"meta-traced launches {meta} differ from the "
          f"card's {card}")
    rec = {"sweep": {"records": len(results), **counts, "seconds": sweep_s,
                     "partition_s": sum(r["partition_s"]
                                        for r in ok.values()),
                     "bottlenecks": bottlenecks,
                     "collective_s": {k: r["roofline"]["collective_s"]
                                      for k, r in ok.items()},
                     "trace_s_by_cell": {
                         k.rsplit("|", 1)[0]: r["trace_s"]
                         for k, r in results.items()
                         if r["status"] == "ok" and k.endswith("|single")}},
           "card_cells": cells, "launches": {"meta": meta, "card": card},
           "lm_predicted_peak_bytes": lm_peaks,
           "peak_band": PEAK_BAND, "phase_s": time.perf_counter() - t_phase}
    print(f"dryrun: phase {rec['phase_s']:.3f} s")
    return rec


def examples_phase(gm, uni, ev, dev, root: Path) -> dict:
    """Phase 12, the three retrieval examples through their functions on
    the card: (a) ``pt_quickstart`` as written, its lines equal to the
    host's; (b) ``pt_evolution_analysis`` on the main history's manager
    at :data:`EXAMPLE_EPOCHS` epochs, its PageRank planes on the card
    within :data:`PAGERANK_TOL` of the host's from the same planes
    (relative to the host's largest rank); (c)
    ``pt_snapshot_server`` on a manager of the main history built with
    the example's index parameters but ``L`` = :data:`SERVER_L`,
    :data:`SERVER_REQUESTS` requests in batches of :data:`SERVER_BATCH`,
    the first batch's masks equal to ``replay``.  Each part's wall
    seconds; launch counts zeroed before and read after."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import GraphManager, replay

    t_phase = time.perf_counter()
    rec: dict = {}
    kernels.reset_launch_counts()

    qs = load_example(root, "pt_quickstart")
    lines: dict[str, list] = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        u, e = qs.build_history()
        qgm = qs.make_manager(u, e, where)
        got = lines[str(where)] = []
        qs.tour(qgm, u, log=lambda *a: got.append(" ".join(map(str, a))))
        qgm.close()
        if where == dev:
            rec["quickstart_s"] = time.perf_counter() - t0
    check(lines[str(dev)] == lines["cpu"], "quickstart: the card's lines "
          "differ from the host's")
    print(f"examples: (a) quickstart {rec['quickstart_s']:.3f} s, "
          f"{len(lines['cpu'])} lines, equal to the host's:")
    for line in lines[str(dev)]:
        print(f"examples:   {line}")

    ea = load_example(root, "pt_evolution_analysis")
    epochs = ea.epoch_times(int(ev.time[-1]), EXAMPLE_EPOCHS)
    t0 = time.perf_counter()
    hs, nps, eps = ea.retrieve(gm, epochs)
    t1 = time.perf_counter()
    prs = ea.pagerank(gm, nps, eps, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    table = ea.rank_table(uni, prs.cpu().numpy(), epochs)
    tri = ea.triangle_lines(uni, hs, epochs)
    t3 = time.perf_counter()
    for h in hs:
        h.close()
    host = ea.pagerank(gm, nps, eps, "cpu")
    err = float((prs.cpu() - host).abs().max() / host.abs().max())
    check(bool(torch.isfinite(prs).all()) and err <= PAGERANK_TOL,
          f"evolution analysis: PageRank on the card {err} of the host's "
          f"largest rank from the host's")
    rec["evolution"] = {"epochs": epochs, "retrieve_s": t1 - t0,
                        "pagerank_s": t2 - t1, "host_s": t3 - t2,
                        "wall_s": t3 - t0, "pagerank_max_rel_err": err,
                        "launches": kernels.launch_counts()}
    print(f"examples: (b) evolution analysis, {len(epochs)} epochs of the "
          f"main history: {rec['evolution']['wall_s']:.3f} s (retrieval "
          f"{t1 - t0:.3f}, PageRank on the card {t2 - t1:.3f}, ranks and "
          f"triangles on the host {t3 - t2:.3f}); PageRank within {err:.3g} "
          f"of the host's largest rank; kernel launches "
          f"{json.dumps(rec['evolution']['launches'])}")
    for line in table + tri:
        print(f"examples:   {line}")

    srv = load_example(root, "pt_snapshot_server")
    t0 = time.perf_counter()
    sgm = GraphManager(uni, ev, L=SERVER_L, k=4, diff_fn="balanced",
                        num_partitions=4, device=dev)
    build_s = time.perf_counter() - t0
    checked = []

    def first_batch(times, results):
        if checked:
            return
        for t, r in zip(times, results):
            truth = replay(uni, ev, t)
            check(np.array_equal(r.value.node_mask, truth.node_mask) and
                  np.array_equal(r.value.edge_mask, truth.edge_mask),
                  f"snapshot server: t={t} differs from replay")
        checked.extend(times)

    kernels.reset_launch_counts()
    stats = srv.serve(sgm, int(ev.time[-1]), SERVER_REQUESTS, SERVER_BATCH,
                      on_batch=first_batch)
    served = []
    srv.report(sgm, stats, log=served.append)
    fetches, hedged = srv.straggler_schedule(sgm, int(ev.time[-1]))
    sgm.close()
    lat = stats["lat_ms"]
    rec["server"] = {"build_s": build_s, "wall_s": stats["wall_s"],
                     "served": stats["served"], "kv_gets": stats["kv_gets"],
                     "p50_ms": float(np.percentile(lat, 50)),
                     "p99_ms": float(np.percentile(lat, 99)),
                     "replay_checked": checked, "fetches": fetches,
                     "hedged": hedged, "launches": kernels.launch_counts()}
    check(len(checked) == SERVER_BATCH and stats["served"] ==
          SERVER_REQUESTS, "snapshot server: batches not served")
    print(f"examples: (c) snapshot server on the main history (L "
          f"{SERVER_L}, 4 partitions, index built in {build_s:.3f} s): "
          + "; ".join(served) + f"; straggler scheduler {fetches} "
          f"fetches, {hedged} hedged; the first batch equals replay")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"examples: phase {rec['phase_s']:.3f} s")
    return rec


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    import numpy as np

    from repro_torch import kernels
    from repro_torch.core import GraphManager, GraphPool, replay
    from repro_torch.data.generators import churn_network, growing_network
    from repro_torch.kernels import _build
    from repro_torch.kernels.delta_apply.ref import (delta_apply_chain_ref,
                                                     delta_apply_fused_ref)
    from repro_torch.kernels.segment_sum import (bucket_edges,
                                                 segment_sum_bucketed,
                                                 segment_sum_bucketed_ref)
    from repro_torch.runtime import torch_exec
    from repro_torch.runtime.staging import DeviceStager
    from repro_torch.storage.kv import MemKV

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- set-up
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    build_s = _build.build()
    print(f"build: nvcc per source {json.dumps(build_s)}; all sources "
          f"{time.perf_counter() - t0:.3f} s wall (parallel)")
    for source, kernel in (("flash_prefill", "attention_prefill_kernel"),
                           ("flash_prefill_f32",
                            "attention_prefill_f32_kernel"),
                           ("flash_mla", "mla_split_kernel"),
                           ("flash_mla_wgmma", "mla_wgmma_kernel"),
                           ("delta_apply", "delta_apply_fused_kernel"),
                           ("segment_sum", "segment_sum_bucketed_kernel")):
        print_ptxas(_build.logs.get(source, ""), kernel)

    # ------------------------------------------------------------- main path
    t0 = time.perf_counter()
    uni, ev = growing_network(n_events=2_000_000, seed=SEED,
                              attrs_on_add=False)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    gm = GraphManager(uni, ev, store=MemKV(), L=50_000, k=4,
                      diff_fn="intersection", cache_bytes=0, device=dev)
    dg = gm.dg
    t_index = time.perf_counter() - t0
    N, E = uni.num_nodes, uni.num_edges
    print(f"history: {len(ev)} events, {N} nodes, {E} edges, "
          f"{len(dg.leaf_nids)} leaves; generate {t_gen:.3f} s, "
          f"GraphManager (index, current graph, rates) {t_index:.3f} s")
    tmax = int(ev.time[-1])
    rng = np.random.default_rng(SEED)
    times = sorted({int(t) for t in np.linspace(0, tmax, 64)})
    fused_times = [int(t) for t in rng.choice(times, 8, replace=False)]

    # record the shapes the main path hands the kernels
    seen = {"chain": [], "fused": []}
    orig_chain = torch_exec.delta_apply_chain_batched
    orig_fused = torch_exec.delta_apply_fused_pair

    def rec_chain(b, a, d):
        seen["chain"].append(tuple(a.shape))
        return orig_chain(b, a, d)

    def rec_fused(bn, an, dn, be, ae, de, wn=None, we=None, **kw):
        seen["fused"].append((an.shape[0], an.shape[1], ae.shape[1],
                              wn is not None))
        return orig_fused(bn, an, dn, be, ae, de, wn, we, **kw)

    torch_exec.delta_apply_chain_batched = rec_chain
    torch_exec.delta_apply_fused_pair = rec_fused

    pool = GraphPool(uni)
    weights = rng.random(N, dtype=np.float32)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gids = torch_exec.execute_multipoint_torch(dg, times, pool=pool,
                                               land_in_pool=True)
    torch.cuda.synchronize()
    t_multi = time.perf_counter() - t0
    fused = {}
    t0 = time.perf_counter()
    for t in fused_times:
        nm, em, an = torch_exec.execute_singlepoint_fused(
            dg, t, node_weights=weights)
        fused[t] = (nm, em, an.degrees(), an.num_nodes(), an.num_edges(),
                    float(an.node.weighted_total()))
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    launches = kernels.launch_counts()
    torch_exec.delta_apply_chain_batched = orig_chain
    torch_exec.delta_apply_fused_pair = orig_fused
    print(f"main path: multipoint 64 timepoints into GraphPool "
          f"{t_multi:.3f} s; fused + degrees at 8 timepoints "
          f"{t_fused:.3f} s; launches {json.dumps(launches)}")
    for name in RETRIEVAL_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the retrieval path")
    # one fused launch lands a retrieval's node and edge planes together,
    # and each degrees() call reduces by source and by destination
    check(launches["delta_apply_chain"] == len(seen["chain"]),
          f"{launches['delta_apply_chain']} chain launches for "
          f"{len(seen['chain'])} calls")
    check(launches["delta_apply_fused"] == len(fused_times) ==
          len(seen["fused"]), f"{launches['delta_apply_fused']} fused "
          f"launches for {len(fused_times)} fused retrievals")
    check(launches["segment_sum_bucketed"] == 2 * len(fused_times),
          f"{launches['segment_sum_bucketed']} segment-sum launches for "
          f"{len(fused_times)} degrees() calls")

    for t in times[:: len(times) // 4]:
        truth = replay(uni, ev, t)
        check(np.array_equal(pool.get_node_mask(gids[t]), truth.node_mask),
              f"pool node mask differs from replay at t={t}")
        check(np.array_equal(pool.get_edge_mask(gids[t]), truth.edge_mask),
              f"pool edge mask differs from replay at t={t}")
    for t in fused_times[:3]:
        nm, em, deg, n_nodes, n_edges, wt = fused[t]
        truth = replay(uni, ev, t)
        check(np.array_equal(nm, truth.node_mask), f"fused nodes t={t}")
        check(np.array_equal(em, truth.edge_mask), f"fused edges t={t}")
        check(n_nodes == int(truth.node_mask.sum()), f"num_nodes t={t}")
        check(n_edges == int(truth.edge_mask.sum()), f"num_edges t={t}")
        ref = np.zeros(N, np.float32)
        live = np.nonzero(truth.edge_mask)[0]
        np.add.at(ref, uni.edge_src[live], 1)
        np.add.at(ref, uni.edge_dst[live], 1)
        check(np.array_equal(deg, ref), f"degrees t={t}")
        check(np.isfinite(wt) and np.isclose(
            wt, weights[truth.node_mask].sum(dtype=np.float64), rtol=1e-4),
            f"weighted total t={t}")
    print("main path: masks, counts and degrees agree with replay")

    # ----------------------------------------------------------- evolve path
    evolve_launches = evolve_phase(gm, ev, dev)

    # ---------------------------------------------------------- sharded path
    sharded = sharded_phase(uni, ev, gm, fused_times, dev)
    sharded["rank_local"] = rank_phase(src)

    # --------------------------------------------------------------- kernels
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    record = []

    def entry(name, source, replaces, ms, plain_ms, err, nbytes, ops,
              library_ms=None, **extra):
        b, by = bound_ms(nbytes, ops)
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b, "bound_by": by, "library_ms": library_ms,
               "evolve_path_launches": evolve_launches[name], **extra}
        print(f"kernel {name}: {json.dumps(rec)}")
        return rec

    def timed(fn, iters):
        """Device time (CUDA-graph replay) and host-loop time of ``fn``."""
        return {"ms": graph_ms(fn, iters), "host_loop_ms": cuda_ms(fn, iters)}

    def chain_words(B, K, W):
        return (rand_words(gen, (B, W), dev), rand_words(gen, (B, K, W), dev),
                rand_words(gen, (B, K, W), dev))

    def chain_bytes(B, K, W):
        return B * (2 * K + 2) * W * 4.0, B * K * W * 3.0

    def chain_case(B, K, W, iters):
        words = chain_words(B, K, W)
        got = kernels.delta_apply_chain_batched(*words)
        want = delta_apply_chain_ref(*words)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"chain kernel differs at {B, K, W}")
        t = timed(lambda: kernels.delta_apply_chain_batched(*words), iters)
        plain = cuda_ms(lambda: delta_apply_chain_ref(*words), 5)
        return max_abs_err(got, want), t, plain, *chain_bytes(B, K, W)

    def fused_bytes(K, W, with_weights, emit_live):
        nbytes = ((2 * K + 1) * W * 4.0 + W * 4 + -(-W // 1024) * 4 + W * 4
                  + W * 32 * 4.0 * (with_weights + emit_live))
        return nbytes, K * W * 3.0 + W * 32.0 * (2 if with_weights else 0)

    def check_fused(got, want, label):
        err = 0.0
        for field, g, r in zip(got._fields, got, want):
            if r is None:
                check(g is None, f"fused {field} should be None")
                continue
            check(same_bits(g, r), f"fused {field} differs at {label}")
            err = max(err, max_abs_err(g, r))
        return err

    def fused_case(K, W, with_weights, emit_live):
        base = rand_words(gen, (W,), dev)
        adds = rand_words(gen, (K, W), dev)
        dels = rand_words(gen, (K, W), dev)
        w = (torch.rand(W * 32, generator=gen, device=dev)
             if with_weights else None)
        got = kernels.delta_apply_fused(base, adds, dels, w,
                                        emit_live=emit_live)
        want = delta_apply_fused_ref(base, adds, dels, w,
                                     emit_live=emit_live)
        torch.cuda.synchronize()
        err = check_fused(got, want, f"K={K} W={W} weights={with_weights} "
                                     f"live={emit_live}")
        t = timed(lambda: kernels.delta_apply_fused(
            base, adds, dels, w, emit_live=emit_live),
            20 if W > 2 ** 20 else 200)
        plain = cuda_ms(lambda: delta_apply_fused_ref(
            base, adds, dels, w, emit_live=emit_live), 3)
        return err, t, plain, *fused_bytes(K, W, with_weights, emit_live)

    def fused_pair_case(K, W_n, W_e):
        """Both planes of a fused retrieval in one call: the node plane
        with weights, both with ``live``, as the main path lands them."""
        planes = [(rand_words(gen, (W,), dev), rand_words(gen, (K, W), dev),
                   rand_words(gen, (K, W), dev)) for W in (W_n, W_e)]
        w = torch.rand(W_n * 32, generator=gen, device=dev)
        got = kernels.delta_apply_fused_pair(*planes[0], *planes[1], w)
        want = (delta_apply_fused_ref(*planes[0], w),
                delta_apply_fused_ref(*planes[1]))
        torch.cuda.synchronize()
        err = max(check_fused(g, r, f"pair K={K} W={W_n}+{W_e}")
                  for g, r in zip(got, want))
        t = timed(lambda: kernels.delta_apply_fused_pair(
            *planes[0], *planes[1], w), 200)
        plain = cuda_ms(lambda: (delta_apply_fused_ref(*planes[0], w),
                                 delta_apply_fused_ref(*planes[1])), 3)
        nb_n, ops_n = fused_bytes(K, W_n, True, True)
        nb_e, ops_e = fused_bytes(K, W_e, False, True)
        return err, t, plain, nb_n + nb_e, ops_n + ops_e

    da_src = "src/repro_torch/kernels/csrc/delta_apply.cu"
    da_tpu = "src/repro/kernels/delta_apply/delta_apply.py"
    (cB, cK, cW) = max(seen["chain"], key=lambda s: s[0] * (s[1] + 1) * s[2])
    err, t, plain, nb, ops = chain_case(8, 16, 2 ** 21, 20)
    m_err, m_t, m_plain, m_nb, m_ops = chain_case(cB, cK, cW, 200)
    record.append(entry(
        "delta_apply_chain", da_src, f"{da_tpu}:45", t["ms"], plain, err, nb,
        ops, host_loop_ms=t["host_loop_ms"], shape="B=8 K=16 W=2^21",
        sharded_path=sharded,
        at_main_path_shape={
            "shape": f"B={cB} K={cK} W={cW}", **m_t, "plain_ms": m_plain,
            "bound_ms": bound_ms(m_nb, m_ops)[0], "max_abs_err": m_err}))

    err_off, t_off, plain_off, nb_off, ops_off = fused_case(
        16, 2 ** 21, True, False)
    err, t, plain, nb, ops = fused_case(16, 2 ** 21, True, True)
    fK, fWn, fWe, _ = max(seen["fused"], key=lambda s: s[0] * (s[1] + s[2]))
    e_err, e_t, e_plain, e_nb, e_ops = fused_case(fK, fWe, False, True)
    m_err, m_t, m_plain, m_nb, m_ops = fused_pair_case(fK, fWn, fWe)
    record.append(entry(
        "delta_apply_fused", da_src, f"{da_tpu}:151", t["ms"], plain,
        max(err, err_off, e_err, m_err), nb, ops,
        host_loop_ms=t["host_loop_ms"], shape="K=16 W=2^21 weights live",
        emit_live_off={**t_off, "plain_ms": plain_off,
                       "bound_ms": bound_ms(nb_off, ops_off)[0]},
        at_main_path_shape={
            "shape": f"one pair call: K={fK} W={fWn} (nodes, weights) + "
                     f"{fWe} (edges), live", **m_t, "plain_ms": m_plain,
            "bound_ms": bound_ms(m_nb, m_ops)[0], "max_abs_err": m_err},
        edge_plane_alone={
            "shape": f"K={fK} W={fWe} live", **e_t, "plain_ms": e_plain,
            "bound_ms": bound_ms(e_nb, e_ops)[0], "max_abs_err": e_err}))

    # segment sum on the main path's degree feeds: a live indicator over
    # every edge slot, bucketed by source node and by destination node as
    # degrees() does
    live = (torch.rand(E, generator=gen, device=dev) < 0.5).to(torch.float32)

    def segsum_case(ends):
        t0 = time.perf_counter()
        order, local, ME = bucket_edges(ends, N, 128)
        t_bucket = time.perf_counter() - t0
        NB = local.shape[0]
        data = live[torch.from_numpy(order.reshape(-1)).to(dev)].reshape(
            NB, ME, 1)
        lid = torch.from_numpy(local).to(dev)
        got = segment_sum_bucketed(data, lid, block_n=128)
        want = segment_sum_bucketed_ref(data, lid, block_n=128)
        ids = torch.from_numpy(ends.astype(np.int64)).to(dev)

        def library():
            return torch.zeros(N, dtype=torch.float32, device=dev).index_add_(
                0, ids, live)

        lib = library()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"segment-sum kernel differs from "
              f"plain at ME={ME}")
        check(torch.equal(got.reshape(-1)[:N], lib), f"segment-sum differs "
              f"from the library scatter at ME={ME}")
        # general f32 at the same shape: both add each row's edges in order
        noise = torch.randn(data.shape, generator=gen, device=dev)
        check(same_bits(segment_sum_bucketed(noise, lid, block_n=128),
                        segment_sum_bucketed_ref(noise, lid, block_n=128)),
              f"segment-sum kernel differs from plain on general f32 at "
              f"ME={ME}")
        t = timed(lambda: segment_sum_bucketed(data, lid, block_n=128), 200)
        plain = cuda_ms(lambda: segment_sum_bucketed_ref(data, lid,
                                                          block_n=128), 5)
        t_lib = timed(library, 200)
        nbytes = E * 8.0 + NB * 128 * 4.0
        return nbytes, {
                "shape": f"NB={NB} ME={ME} D=1 (E={E})", **t,
                "plain_ms": plain, "bound_ms": bound_ms(nbytes, float(E))[0],
                "max_abs_err": max_abs_err(got, want),
                "library_ms": t_lib["ms"],
                "library_host_loop_ms": t_lib["host_loop_ms"],
                "bucket_edges_host_s": t_bucket}

    nbytes, src_feed = segsum_case(uni.edge_src)
    _, dst_feed = segsum_case(uni.edge_dst)
    record.append(entry(
        "segment_sum_bucketed", "src/repro_torch/kernels/csrc/segment_sum.cu",
        "src/repro/kernels/segment_sum/segment_sum.py:42", src_feed["ms"],
        src_feed["plain_ms"],
        max(src_feed["max_abs_err"], dst_feed["max_abs_err"]), nbytes,
        float(E),
        library_ms=src_feed["library_ms"],
        host_loop_ms=src_feed["host_loop_ms"],
        library_host_loop_ms=src_feed["library_host_loop_ms"],
        shape=f"source feed: {src_feed['shape']}",
        bucket_edges_host_s=src_feed["bucket_edges_host_s"],
        destination_feed=dst_feed))

    # ------------------------------------------------------------------ churn
    t0 = time.perf_counter()
    cuni, cev = churn_network(n_initial_edges=2000, n_events=50_000, seed=1)
    cgm = GraphManager(cuni, cev, store=MemKV(), L=2_000, k=2,
                       cache_bytes=0, device=dev)
    cdg = cgm.dg
    ctmax = int(cev.time[-1])
    ctimes = sorted({int(t) for t in np.linspace(0, ctmax + 3, 16)})
    ctruth = {t: replay(cuni, cev, t) for t in ctimes}
    cpool = GraphPool(cuni)
    cgids = torch_exec.execute_multipoint_torch(cdg, ctimes, pool=cpool,
                                                land_in_pool=True)
    mono = torch_exec.execute_multipoint_torch(cdg, ctimes)
    os.environ["REPRO_STREAM_CHUNK"] = "1"
    stager = DeviceStager()
    streamed = torch_exec.execute_multipoint_torch(cdg, ctimes,
                                                   stager=stager)
    del os.environ["REPRO_STREAM_CHUNK"]
    check(any(k == "apply" for k, _ in stager.events),
          "streamed path did not engage the stager")
    for t in ctimes:
        truth = ctruth[t]
        for nm, em in (mono[t], streamed[t],
                       (cpool.get_node_mask(cgids[t]),
                        cpool.get_edge_mask(cgids[t]))):
            check(np.array_equal(nm, truth.node_mask), f"churn nodes t={t}")
            check(np.array_equal(em, truth.edge_mask), f"churn edges t={t}")
    for t in ctimes[::4]:
        nm, em, an = torch_exec.execute_singlepoint_fused(cdg, t)
        truth = ctruth[t]
        check(np.array_equal(em, truth.edge_mask), f"churn fused t={t}")
        check(an.num_edges() == int(truth.edge_mask.sum()), f"churn t={t}")
        ref = np.zeros(cuni.num_nodes, np.float32)
        live_e = np.nonzero(truth.edge_mask)[0]
        np.add.at(ref, cuni.edge_src[live_e], 1)
        np.add.at(ref, cuni.edge_dst[live_e], 1)
        check(np.array_equal(an.degrees(), ref), f"churn degrees t={t}")
    # the evolve path over deletes and transient slots: two overlapping
    # intervals swept monolithic and streamed, and one loader window
    civs = [ctimes[:12], ctimes[5:]]
    for chunk in ("0", "2"):
        os.environ["REPRO_STREAM_CHUNK"] = chunk
        kernels.reset_launch_counts()
        swept = torch_exec.evolve_intervals_torch(cdg, civs, device=dev,
                                                  pool=cpool)
        check(kernels.launch_counts()["delta_apply_chain"] > 0,
              f"churn: evolve_intervals_torch (chunk {chunk}) launched no "
              f"chain kernel")
        for out, iv in zip(swept, civs):
            for t in iv:
                check(np.array_equal(out[t][0], ctruth[t].node_mask) and
                      np.array_equal(out[t][1], ctruth[t].edge_mask),
                      f"churn: evolve_intervals_torch (chunk {chunk}) "
                      f"differs from replay at t={t}")
    del os.environ["REPRO_STREAM_CHUNK"]
    clw = loader_window(cgm, cev, ctimes[2:10], ctimes[3] - ctimes[2], dev,
                        "churn")
    cgm.close()
    torch.cuda.synchronize()
    print(f"churn: {len(cev)} events, {int(cuni.edge_transient.sum())} "
          f"transient edge slots, 16 timepoints monolithic, streamed and "
          f"pooled + fused at 4, evolve_intervals_torch (monolithic and "
          f"streamed) and a loader window (launches "
          f"{json.dumps(clw['launches'])}) agree with replay "
          f"({time.perf_counter() - t0:.3f} s)")

    # ------------------------------------------------------------ LM serving
    record.extend(lm_phase(dev))
    mla_rec, mla_prefill = mla_moe_phase(dev)
    next(r for r in record if r["name"] == "flash_attention_prefill")[
        "shapes"].append(mla_prefill)
    record.append(mla_rec)

    # -------------------------------------------------------------- training
    record.extend(train_phase(dev))

    # ----------------------------------------------------------- GNN and DIN
    gnn_din = gnn_din_phase(gm, ev, dev, src.parent)
    for rec in record:
        if rec["name"] in RETRIEVAL_KERNELS:
            rec["temporal_gcn_launches"] = gnn_din["temporal_gcn"][
                "launches"][rec["name"]]

    # --------------------------------------------------------------- dry run
    by_name = {r["name"]: r for r in record}
    card = {LM_ARCH: {
                "prefill": {"flash_prefill": by_name[
                    "flash_attention_prefill"]["launches"]},
                "decode": {"flash_decode": by_name[
                    "flash_attention_decode"]["launches"]}},
            DS_ARCH: {
                "prefill": {"flash_prefill": mla_rec["serving_deepseek_v3"][
                    "launches"]["flash_attention_prefill"]},
                "decode": {"flash_mla": mla_rec["launches"]}}}
    print(json.dumps({"dryrun": dryrun_phase(dev, card)}))

    # -------------------------------------------------------------- examples
    print(json.dumps({"examples": examples_phase(gm, uni, ev, dev,
                                                 src.parent)}))
    gm.close()

    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
