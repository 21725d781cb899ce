#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (``nvcc``); it builds the port's
kernels from ``src/repro_torch/kernels/csrc`` at first use.  Phases, each of
which raises on failure (the script then exits non-zero and prints no
result line):

1. setup: the card's name and power limit, the versions, TF32 off, the
   kernel build (timed), and the registers and spills ptxas reports for
   every instantiation of K1 and K4 (storage type x K1 with and without
   row scales, K4 on its shared and its peeled path; none may spill), of
   K2 (storage type x queries per CTA, none may spill) and of K3 (storage
   type x tile);
2. every kernel against its plain PyTorch version on the card, for every
   storage dtype, at small shapes (unpadded ones included) and at the main
   paths' shapes, and two calls bit-identical: K1, the fused step; K2, the
   streaming batched matvec (at B = 1, 8 and 64 on 5120 x 5120, each
   query alone equal to the same query in its batch); K3, the
   BSR SpMV (bs 32 and 128, ragged n, an empty block row, B = 1, 8, 64 and
   100, and the 5000-protein 40 x 40-block layout at B = 1, 8, 64); K4,
   the unpadded step (300 x 130 and 5000 x 5000);
3. the main path at the paper's full size: PageRank over the 5000-protein
   network, 100 iterations, d = 0.85, through ``PageRankEngine`` on the
   ``dense``, ``ell`` and ``fused_dense`` tiers (every precision on the
   fused tier, each held to the dense tier at its own precision),
   ``run_tol``, ``top_k_proteins`` and the launcher; the kernel launch
   counts are zeroed just before and read just after, and ``run`` is held
   to making no host sync;
3b. the serving path on the same network: ``engine.ppr`` of 8 seed sets
   and of 1 on ``fused_dense`` at every precision (held to the ``dense``
   tier), a 64-hub ``LandmarkIndex`` build on each reduced-precision
   ``fused_dense`` engine (held to the same build on the ``dense`` tier),
   then a ``PageRankQueryEngine`` with a ``ResultCache`` and a 64-hub
   ``LandmarkIndex`` on ``fused_dense`` f32 serving 64 Zipf(1.1) queries
   (every landmark answer held to an exact 200-iteration solve, every
   cache hit to its miss); K2's launch counts are zeroed before and read
   after each step, checked exactly, and kept by batch size and step;
3c. the ``bsr`` tier on the same network at every precision: ``run(100)``
   (exactly 100 K3 launches), ``run_tol(1e-6)`` and ``ppr`` of 8 seed sets,
   each held to the ``dense`` tier at its own precision, top-10 identical;
3d. quickstart's loop at the paper's size: 100 ``ops.pagerank_iteration``
   steps (exactly 100 K4 launches) against ``pagerank_dense_fixed``, and
   the same loop with the dangling leak on the bf16 and f16 ``dense`` H
   against that tier's ``run(100)``;
3e. live updates: ``examples/streaming_pagerank.py``'s ``EdgeStream`` over
   a ``DynamicPageRankEngine`` on ``bsr`` and on ``fused_dense`` (f32),
   16 ticks of ``push_update`` + ``flush`` serving Zipf picks from the
   serve pool through ``ResultCache(1024)``; the ranks end within L1 1e-5
   of a from-scratch solve, every cached answer matches an exact solve of
   the final graph, and the K1 / K2 / K3 launches of every tick are
   checked exactly against its strategy and sweeps (K2's kept by batch
   size);
3f. the resilient serve path: ``examples/faulty_stream_pagerank.py``'s
   stream and 8 faulted steps, then an Inf and a 1e4 layout, a poisoned
   layout served with no delta pending (the serve path's recovery), a
   rebuild that raises once (the snapshot restored, answers stale) and a
   clean step, through ``PageRankQueryEngine(resilience=...)`` on
   ``fused_dense`` f32 and bf16 (K1, K2) and ``bsr`` f32 (K3); every
   outcome, watchdog verdict, query status, dead letter and the injector
   log held to the same script through the plain versions on the CPU, the
   final f32 ranks to the CPU run's and to a from-scratch solve; then the
   watchdog's cost per iteration, ``restore`` against a cold solve and
   the clean-tick flush of the resilient mode against the legacy one;
3g. the fabric simulator (``repro_torch.core``): the six Fig. 5 words
   decoded and encoded bit-exact on the card; Fig. 2 on a 1 x 4 fabric
   (7.4, 0 conflicts); the Fig. 5 testbench on a 4 x 4 fabric, every
   cycle's wires bit-equal to the CPU run; a hop-mode matvec of a random
   64 x 64 matrix on the whole 64 x 65 fabric (0 conflicts, 67 steps, equal
   to fast mode at rtol 1e-6); ``pagerank_on_fabric`` at N = 64 against
   ``pagerank_dense_fixed``; the Fig. 4C ``pagerank_tiled`` over the
   5000-protein network, 100 iterations, against ``pagerank_dense_fixed``
   (rtol 1e-4, atol 1e-7, top-10 identical, 42,728,000 steps) and 3 of its
   iterations against the CPU (rtol 1e-6); ``examples/torch_quickstart.py``
   on the card; then the tiled run's time and device launches per
   iteration and one hop-mode cycle's time on the 64 x 65 fabric (CUDA
   events, median of 5), with the paper's 213.6 ms printed beside as the
   model of its own fabric;
3h. the sharded mesh tiers on the same network, every mesh position on
   the one card (the device list is printed: a 2 x 2 mesh of one card is
   not four cards): ``dense_sharded`` on 2 x 2 at f32 and bf16 and on
   1 x 4 (the R != C re-injection) at f32, ``ell_sharded`` on 4 shards;
   each runs ``run(100)`` (no host sync), ``run_tol(1e-6)``, ``ppr`` of 8
   seed sets and a 64-hub landmark build, with K2's launches checked
   exactly against the schedule (one per shard per iteration, by batch
   size), held to the ``dense`` tier at its storage type (rtol 1e-5, atol
   1e-7, top-10 identical, iterations within 1) and to the same calls on a
   CPU mesh of the same shape; ``lower_run``'s collectives per iteration
   and the wall times (median of 5, smallest and largest); then 16 live
   ticks of the streaming stream on both sharded tiers (ranks within L1
   1e-5 of a fresh solve), and K2 flushed at the 2500 x 2500 tile beside
   ``torch.mv`` (a row of the kernel table);
3i. the LM stack's token-serving path (no kernel of the port: the JAX
   package computes it outside Pallas): llama3-8b at its full published
   width (8,030,257,152 parameters, bf16) drawn on the card from a seeded
   generator; the JAX launcher's default traffic through
   ``repro_torch.launch.serve.run`` (6 requests, 3 slots, 16 new tokens,
   ``max_len`` 128) and one request at T = 0.8, every greedy ``serve``
   output equal to ``generate``; one request's decode logits held to
   ``forward`` over the prompt plus the generated prefix (bf16
   tolerance), its greedy tokens equal to ``forward``'s argmax wherever
   the top-2 gap is over twice the measured difference; prefill and
   decode times (CUDA events), tokens/s and one decode step's kernels and
   device time under ``torch.profiler`` beside its byte bounds (the
   weights alone, and as ported with the head's f32 upcast); the ten
   smoke configs in float32 on the card against the CPU (``forward``,
   ``prefill``, 4 ``decode_step``s, every cache entry); and
   ``examples/torch_serve_lm.py`` in its own process;
3j. the LM training path (no kernel of the port either: the JAX trainer
   is ``jnp`` outside Pallas): the ten smoke configs' ``train_step`` on
   the card against the CPU from the same weights and a fixed-seed batch
   (loss, gradient norm, every gradient leaf) and each backward repeated
   on the card (bit-equal or not); internlm2-1.8b at its full published
   width and depth (1,889,634,304 parameters, a float32 master copy, bf16
   activations, the config's "full" remat) through
   ``repro_torch.launch.train.run`` for 5 steps of 2 x 4096 tokens in two
   microbatches: every loss and gradient norm finite, step 1's loss
   against a no_grad forward, "full" remat against "none" at 512 tokens,
   the step times (CUDA events around each ``train_step``), tokens/s, the
   model-FLOPs share, ``max_memory_allocated`` and one step under
   ``torch.profiler``; the launcher's fault drill at smoke size
   (``--fail-at 3``, then ``--resume``) bit-equal to an uninterrupted run;
   and ``examples/torch_train_lm.py --large`` in its own process;
3k. the LM stack on the mesh (no kernel of the port either: the JAX
   ``moe_ep`` and the sharding rules are ``jnp`` and ``shard_map``), every
   mesh position on the one card: ``moe_ep`` of the olmoe and granite-moe
   smoke configs (5 experts padded to 8) on 2 x 4 and 1 x 4 meshes under
   the training and the inference rules against the same meshes on the
   CPU (output, aux loss, dropped fraction, every gradient; a repeat
   bit-equal or not); olmoe-1b-7b at its full published width and depth
   (6,919,094,272 parameters, bf16, random weights from seed 0) served the
   JAX serve launcher's traffic under ``use_mesh`` of a 1 x 4 mesh with
   the inference rules and without a mesh: each MoE layer of every
   prompt's prefill and first decode step on its own activations within
   one bf16 step of the no-mesh output, the logits on 1 x 4, 1 x 2 and no
   mesh and the step at which the greedy tokens part (reported, not
   gated), the decode step's time (CUDA events)
   and one profiled step on the mesh and without, its collectives and
   peak memory; one olmoe MoE layer at full width (2 x 4096 tokens,
   float32 master weights, capacity factor 8) on 2 x 4 under the training
   rules against ``moe_reference``, x in float32 and in bf16; the
   2-layer full-width olmoe trainer (1,045,176,320 parameters) on 2 x 4
   with the default rules, 3 steps of 2 x 4096 tokens (losses, step
   times, peak memory, collectives per step); and the train launcher at
   smoke size on 4 positions of the card against 4 of the CPU;
3l. the multi-pod dry run (``repro_torch.launch.dryrun``; no kernel: it
   runs on meta tensors and the JAX dry run reaches no Pallas call) held
   to the card: internlm2-1.8b's train cell at full width (4096 tokens, a
   global batch of 1, "full" remat) dry-run on a 1 x 1 mesh of a meta
   position, then the real state and batch on the card and one
   ``train_step`` under the same counting mode, the predicted argument
   bytes equal to the state's and batch's and the predicted dot FLOPs
   equal to the step's (the predicted live bytes beside
   ``max_memory_allocated``, reported); olmoe-1b-7b's decode at one slot
   with phase 3k's cache on a 1 x 4 meta mesh, its collectives equal to
   those phase 3k counted on the card; and the command line in its own
   process (llama3-8b and olmoe-1b-7b, ``decode_32k``, the 16 x 16 pod
   mesh of meta positions), exit 0 and every record with the JAX keys;
4. times on the card (CUDA events, medians) beside each kernel's bound:
   the kernel, its plain version and the library call each with the L2
   cache flushed before the call, and the kernel back to back as well
   (every row carries the configuration its kernel takes, for K2 and K3
   by batch size, and its registers and spills; K2's and K3's bounds
   count the cheapest float32-accurate split product on the tensor cores
   (``SPLIT_SCHEMES``), K2's launches are those of its batch size on the
   paths above, by step);
   the split-ELL step of the ``ell`` tier at the ``graph500_22.solve``
   cell's shapes (scale 20, seed 0) at every storage type
   (:func:`ell_step_phase`: the layout's fill, the step against its plain
   version, ``run(10)`` bit for bit with its launches, flushed / warm /
   eager-call times beside its byte bound, the plain version, the eager
   step it replaced and ``torch.sparse_csr @ x``);
   the serve flush's p50 / p95 and the landmark build time;
   ``run(100)`` and ``run_tol`` on every tier, ``bsr`` included; and the
   two paths K3 serves at B >= 8, each with its exact K3 launch count:
   the ``bsr`` f32 engine's ``ppr`` of 8 seed sets (100 iterations, B =
   8) and a 64-hub ``LandmarkIndex`` build on it (B = 64, its hub columns
   held to the ``fused_dense`` index's), wall time, median of 5, beside
   the same on ``fused_dense``.

Then it prints its total time and a JSON object of its measurements.  The
last lines are a JSON object ``{"kernels": [...]}``, the card's name and
power limit as ``nvidia-smi`` prints them, and the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
from collections import Counter
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# data-sheet figures of the H100 SXM (NVIDIA): device-memory rate, the
# float32 rate outside the tensor cores (K1's and K4's FMAs are float32)
# and the dense TF32 and BF16 tensor-core rates (K2's and K3's bounds)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# The float32-accurate schemes on the tensor cores for each storage type
# of W, as (products per term, input type, rate); a bound takes the
# cheapest.  TF32 (10-bit mantissa): float32 W and X each split in two
# parts (3 products: xs*wb, xb*ws, xb*wb), the narrower types exact in
# TF32 (2: xs*w, xb*w).  BF16 (7-bit mantissa, float32's exponent): X in
# three parts (24 bits); bf16 and int8 W are exact in bf16 (3 products),
# f16 W takes two parts (5 products of the 6 that float32's digits need),
# float32 W three (6).
SPLIT_SCHEMES = {
    "f32": ((3, "tf32", TF32_OPS_PER_S), (6, "bf16", BF16_OPS_PER_S)),
    "bf16": ((2, "tf32", TF32_OPS_PER_S), (3, "bf16", BF16_OPS_PER_S)),
    "f16": ((2, "tf32", TF32_OPS_PER_S), (5, "bf16", BF16_OPS_PER_S)),
    "int8": ((2, "tf32", TF32_OPS_PER_S), (3, "bf16", BF16_OPS_PER_S)),
}


def split_bound(precision: str, terms: int) -> tuple[float, int, str]:
    """The least time of ``terms`` float32-accurate multiply-adds with W
    stored as ``precision`` on the tensor cores: (ms, operations, scheme),
    over the schemes of ``SPLIT_SCHEMES``."""
    return min((2 * k * terms / rate * 1e3, 2 * k * terms, f"{k} x {kind}")
               for k, kind, rate in SPLIT_SCHEMES[precision])


N_NODES, N_ITERS, DAMPING, SEED = 5000, 100, 0.85, 0
TOL32 = dict(rtol=1e-5, atol=5e-5)        # kernel vs plain (f32 accumulation)
# the same comparison scaled to PageRank's values (every yp is at least
# t ~ 1e-5 and H, xp >= 0, so rtol governs): a kernel that loses a single
# 16-byte vector of a row at N = 5000 is off by about 1e-3 relative
TIGHT = dict(rtol=1e-5, atol=1e-9)
# fused tier vs the dense tier at the same precision: the same H, the same
# explicit leak, only the summation order differs
TOL_TIER = dict(rtol=1e-5, atol=1e-7)
PRECISIONS = ("f32", "bf16", "f16", "int8")
K1_SOURCE = "src/repro_torch/kernels/csrc/pagerank_step.cu"
K1_REPLACES = "src/repro/kernels/pagerank_step.py:86"
K2_SOURCE = "src/repro_torch/kernels/csrc/streaming_matvec.cu"
K2_REPLACES = "src/repro/kernels/streaming_matvec.py:29"
K3_SOURCE = "src/repro_torch/kernels/csrc/bsr_spmv.cu"
K3_REPLACES = "src/repro/kernels/bsr_spmv.py:29"
K4_SOURCE = K1_SOURCE
K4_REPLACES = "src/repro/kernels/pagerank_step.py:35"
ELL_SOURCE = "src/repro_torch/kernels/csrc/ell_step.cu"
ELL_REPLACES = "none: the JAX ell tier reaches no Pallas call"
# the live phase: examples/streaming_pagerank.py's stream and tick count
STREAM = dict(m_edges=4, seed=0, insert_per_step=6, delete_per_step=4)
TICKS, QUERIES_PER_TICK = 16, 4
# phase 3f: examples/faulty_stream_pagerank.py's stream and its 8 faulted
# steps, then an Inf and a 1e4 layout, a poisoned layout served with no
# delta pending (the serve path's own recovery), a rebuild that raises once
# (the snapshot restored, answers stale) and a clean step (fresh again)
FAULTY_STREAM = dict(m_edges=4, seed=0, insert_per_step=4, delete_per_step=0)
FAULTY_SCRIPT = (("delta", "out_of_range"), ("delta", "negative"),
                 ("layout", "nan"), ("delta", "self_loop"),
                 ("update", None), ("delta", "nan"), ("layout", "scale"),
                 ("delta", "dup_flood"), ("layout", "inf"),
                 ("layout", "huge"), ("serve", "nan"), ("rebuild", "nan"),
                 ("clean", None))
# phase 3g: the six messages of the paper's Fig. 5 testbench as
# tests/test_isa.py lists them (hex, opcode, dest, value, next opcode, next
# dest), LEFT-1 first; Prog = 1, A_ADD = 4, A_ADDS = 7
FIG5_MESSAGES = (("00f44121999a0051", 1, 5, 10.1, 4, 15),
                 ("00f44111999a0091", 1, 9, 9.1, 4, 15),
                 ("00f44101999a0091", 1, 9, 8.1, 4, 15),
                 ("00f440e333330091", 1, 9, 7.1, 4, 15),
                 ("00d7404000000091", 1, 9, 3.0, 7, 13),
                 ("00f440c333330091", 1, 9, 6.1, 4, 15))
# the paper's fabric (64 x 64 sites + the adder column) and its Fig. 4C step
# count at N = 5000 and 100 iterations (213.64 ms at 200 MHz)
FABRIC_SIDE, TILED_STEPS = 64, 42_728_000
# the tiers of phase 3f: K1 and K2 (f32, and bf16, whose float operand for
# the injector is the dangling mask), and K3
RESILIENT_TIERS = (("fused_dense", "f32"), ("fused_dense", "bf16"),
                   ("bsr", "f32"))
# phase 3h: the sharded mesh tiers as (label, backend, mesh shape, axes,
# storage type), every position on the one card: dense_sharded on 2 x 2
# (the diagonal re-injection) at f32 and bf16 and on 1 x 4 (R != C),
# ell_sharded on 4 shards; the live ticks run the first and the last
SHARDED_TIERS = (
    ("dense_sharded 2x2 f32", "dense_sharded", (2, 2), ("row", "col"),
     "f32"),
    ("dense_sharded 2x2 bf16", "dense_sharded", (2, 2), ("row", "col"),
     "bf16"),
    ("dense_sharded 1x4 f32", "dense_sharded", (1, 4), ("row", "col"),
     "f32"),
    ("ell_sharded 4 f32", "ell_sharded", (4,), ("shard",), "f32"))
SHARDED_LIVE_TICKS = 16
# K4's storage types on its path (ops.pagerank_iteration takes no int8
# row scales, as in the JAX package)
K4_PRECISIONS = ("f32", "bf16", "f16")
# the serve phase: 8 queries per flush, a 64-hub landmark index, and the
# query mix of benchmarks/serve_bench.py (Zipf(1.1) over a pool of seed
# sets, here 32 sets of 1 to 5 proteins, 64 queries)
SERVE_BATCH, N_HUBS, POOL, N_QUERIES, ZIPF_S = 8, 64, 32, 64, 1.1
LM_TOL, LM_MAX_PUSHES = 1e-7, 256
# |column sum - 1| of a PPR matrix: 1e-3 for f32; a reduced-precision H
# does not keep the mass at 1, so those tiers get the JAX suite's slack
# (tests/test_precision.py SUM_TOL) and are held to the dense tier's sums
SUM_TOL = {"f32": 1e-3, "bf16": 0.06, "f16": 0.01, "int8": 0.2}
# phase 3i: llama3-8b at full width served as the JAX launcher's defaults
# (launch/serve.py: 6 requests, 3 slots, 16 new tokens, max_len 128);
# decode logits against forward's in bf16 within LLM_BF16_ATOL; the smoke
# configs card against CPU in float32 within LLM_F32_TOL (kinds as in
# tests/lm_parity.py), over prompts of 8 tokens, a 16-position cache and
# 4 decode steps; the timed prefills and decode steps
LLM_ARCH, LLM_MAX_LEN = "llama3-8b", 128
# decode vs forward at full width in bf16: 0.364 measured on logits up to
# 5.16 (NVIDIA H100 80GB HBM3, 700 W), the two paths rounding their
# bf16 products apart over 32 layers
LLM_BF16_ATOL = 0.5
LLM_F32_TOL = {"logits": dict(rtol=1e-5, atol=1e-4),
               "kv": dict(rtol=1e-5, atol=2e-4),
               "state": dict(rtol=1e-4, atol=1e-3)}
LLM_SMOKE_PROMPT, LLM_SMOKE_MAX_LEN, LLM_SMOKE_DECODES = 8, 16, 4
LLM_TIMED_PREFILLS, LLM_TIMED_DECODES = 7, 30
# phase 3j: LM training.  The smoke configs' train step on the card
# against the CPU within the CPU-vs-JAX tolerances of tests/train_parity.py
# (loss rtol 1e-5, gradient norm rtol 1e-4, each gradient leaf within 1e-3
# of its largest CPU gradient), on a (2, 16) batch from a fixed seed;
# internlm2-1.8b at full width through the launcher (train_4k's sequence,
# two microbatches of one); step 1's loss against a no_grad forward within
# tests/lm_parity.py's bf16 logits tolerance; "full" remat against "none"
# at TRAIN_REMAT_SEQ, each leaf within TRAIN_GRAD_SHARE of its largest
# gradient
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM = 5, 2, 4096, 2
TRAIN_REMAT_SEQ = 512
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_GRAD_SHARE = 1e-5, 1e-4, 1e-3
TRAIN_BF16_ATOL = 0.1
TRAIN_SMOKE_SHAPE = (2, 16)
# phase 3k: the LM stack on the mesh, every position on the one card.  The
# MoE smoke configs' moe_ep card mesh against CPU mesh within the
# CPU-vs-JAX tolerances of tests/test_torch_moe_ep.py (the output beyond
# rtol MESH_Y_RTOL by at most MESH_Y_ATOL_SHARE of its largest value, the
# aux loss within MESH_AUX_RTOL, each gradient leaf within MESH_GRAD_SHARE
# of its largest); olmoe-1b-7b served at full width on MESH_SERVE_SHAPE
# against no mesh, each MoE layer on the model's own activations within
# one bf16 step (MESH_LAYER_TOL["bfloat16"]); one
# full-width MoE layer of MESH_LAYER_SHAPE tokens on 2 x 4 against
# moe_reference (MESH_LAYER_TOL); the full-width trainer at MESH_TRAIN_LAYERS
# layers; the launcher's loss lines on 4 positions of the card against 4
# of the CPU as tests/test_torch_train_launch.py holds them to JAX
MESH_ARCH, MESH_MAX_LEN = "olmoe-1b-7b", 128
MESH_SMOKE_ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
MESH_SMOKE_MESHES = ((2, 4), (1, 4))
MESH_SMOKE_RULES = ("DEFAULT_RULES", "INFERENCE_RULES")
MESH_Y_RTOL, MESH_Y_ATOL_SHARE = 1e-5, 1e-6
MESH_AUX_RTOL, MESH_GRAD_SHARE = 1e-6, 1e-5
MESH_SERVE_SHAPE, MESH_TIMED_DECODES = (1, 4), 20
MESH_SERVE_SHAPES = (MESH_SERVE_SHAPE, (1, 2))
MESH_LAYER_SHAPE = (2, 4096)
# the full-width layer against moe_reference.  x in float32: the CPU-vs-JAX
# output tolerance and phase 3j's gradient gate (TRAIN_GRAD_SHARE, 1e-3
# of each leaf's largest value).  x in bf16: the output within one bf16 step (2^-7); the weights'
# gradients too, since each data shard's partial product is rounded to
# bf16 before the sum over shards (on the CPU at smoke size: 3.4e-3 of
# the largest); x's gradient, summed in bf16 over the model positions,
# within four steps (2^-5; 1.0e-2 on the CPU at smoke size)
MESH_LAYER_TOL = {
    "float32": dict(dtype="float32", y_rtol=1e-5, y_atol_share=1e-6,
                    w_share=1e-3, x_share=1e-3),
    "bfloat16": dict(dtype="bfloat16", y_rtol=2.0 ** -7, y_atol_share=1e-5,
                     w_share=2.0 ** -7, x_share=2.0 ** -5)}
MESH_LAYER_AUX_RTOL = 1e-5
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 2, 3
MESH_LAUNCH_SAME_LOSS, MESH_LAUNCH_EARLY_LOSS = 1.5e-4, 1e-3
LOSS_LINE = re.compile(
    r"^step (?:\d+): loss=([\d.]+) gnorm=([\d.]+) lr=([\d.e+-]+)")


# phase 3l: the dry run held to the card.  Phase 3j's microbatch of
# TRAIN_ARCH (TRAIN_SEQ tokens, a global batch of 1, "full" remat) on a
# 1 x 1 mesh; MESH_ARCH's decode at one slot with phase 3k's cache
# (MESH_MAX_LEN) on 1 x 4; the command line on DRYRUN_CLI_ARCHS at
# decode_32k on the pod mesh, in its own process, within DRYRUN_CLI_TIMEOUT
DRYRUN_CLI_ARCHS = ("llama3-8b", "olmoe-1b-7b")
DRYRUN_CLI_TIMEOUT = 400
DRYRUN_RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "status",
                      "lower_s", "compile_s", "memory", "cost",
                      "collectives", "dots", "param_count",
                      "active_param_count", "n_ops"}


# the storage types of K3's instantiations, as the compiler mangles them
K3_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
            "a": "int8"}
K3_TILE_KEYS = ("RL", "QW", "WR", "WQ", "ST")
K2_CONFIG_KEYS = ("MT", "WR", "WQ", "ST", "KG", "PF", "SPLITS", "RESTART")
K2_BATCHES = (1, 8, 64)
# K1's and K4's core configuration, and the kernels of each: K1 with and
# without row scales, K4 on its shared (aligned) and its peeled path
STEP_CONFIG_KEYS = ("R", "D")
STEP_VARIANTS = {("K1", False): "no scales", ("K1", True): "row scales",
                 ("K4", True): "shared path", ("K4", False): "peeled path"}


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, by mangled entry name."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        m = m or re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out.setdefault(fn, {}).update(spill_stores=int(m.group(1)),
                                          spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.setdefault(fn, {})["registers"] = int(m.group(1))
    return out


def k3_instantiations(log: str) -> dict:
    """K3's kernels in its build log: (storage type, tile) -> registers and
    spills, the tile as ``K3_TILE_KEYS``."""
    out = {}
    for fn, info in ptxas_report(log).items():
        m = re.search(r"bsr_spmv_kernelI(\w+?)NS_4TileI"
                      + r"Li(\d+)E" * 5 + "EE", fn)
        if m:
            tile = tuple(int(v) for v in m.groups()[1:])
            out[(K3_TYPES[m.group(1)], tile)] = info
    return out


def k2_instantiations(log: str) -> dict:
    """K2's kernels in its build log: (storage type, queries per CTA) ->
    registers and spills."""
    out = {}
    for fn, info in ptxas_report(log).items():
        m = re.search(r"streaming_matvec_kernelI(\w+?)Li(\d+)ENS_3CfgI", fn)
        if m:
            out[(K3_TYPES[m.group(1)], int(m.group(2)))] = info
    return out


def step_instantiations(log: str) -> dict:
    """K1's and K4's kernels in their build log: (kernel, storage type,
    (R, D), variant) -> registers and spills; the variant is K1's row
    scales or K4's shared (aligned) path."""
    out = {}
    for fn, info in ptxas_report(log).items():
        for kernel, name in (("K1", "17fused_step_kernel"),
                             ("K4", "11step_kernel")):
            m = re.search(name + r"I(\w+?)NS\d*_3CfgI"
                          + r"Li(\d+)E" * len(STEP_CONFIG_KEYS)
                          + r"EELb([01])E", fn)
            if m:
                cfg = tuple(int(v) for v in m.groups()[1:-1])
                out[(kernel, K3_TYPES[m.group(1)], cfg,
                     m.group(m.lastindex) == "1")] = info
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def allclose(torch, a, b, *, rtol, atol, what):
    err = float((a - b).abs().max())
    check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
          f"{what}: max|diff| {err:.3e} outside rtol={rtol} atol={atol}")
    return err


def capture(torch, fn, reps: int):
    """``reps`` back-to-back calls of ``fn`` captured into one CUDA graph,
    after three warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return graph


def cuda_ms(torch, fn, *, reps: int = 20, rounds: int = 7) -> float:
    """Device time of one call: ``reps`` back-to-back calls captured into
    one CUDA graph (so the host's launch overhead is not timed), replayed
    ``rounds`` times under CUDA events; the median over ``reps``."""
    graph = capture(torch, fn, reps)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def eager_ms(torch, fn, *, reps: int = 50, rounds: int = 7) -> float:
    """Time per call of ``reps`` calls issued back to back from Python, by
    CUDA events: the host's launch overhead included, as a loop sees it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cuda_ms_cold(torch, fn, flush, *, samples: int = 21) -> float:
    """Device time of one call with the L2 cache flushed before it: the
    call is captured into a CUDA graph, so the device runs it straight
    after the flush, with no wait on the host; the median of ``samples``.
    """
    graph = capture(torch, fn, 1)
    times = []
    for _ in range(samples):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(torch, fn, *, rounds: int = 5) -> float:
    """Median host-clock time of ``fn`` ending in a device sync."""
    return wall_stats(torch, fn, rounds=rounds)["median_ms"]


def random_case(np, Np, Mp, precision, seed):
    """Seeded inputs in PageRank's range on a padded (Np, Mp) layout; ``t``
    is the teleport term plus the leak of a tenth of the mass, so the
    product carries most of ``yp``."""
    rng = np.random.default_rng(seed)
    n, m = Np - 37, Mp - 21
    H = np.zeros((Np, Mp), np.float32)
    H[:n, :m] = rng.random((n, m), dtype=np.float32) * (2.0 / m)
    x = np.zeros((1, Mp), np.float32)
    x[0, :m] = rng.random(m, dtype=np.float32) / m
    dang = np.zeros((1, Np), np.float32)
    dang[0, :n] = rng.random(n) < 0.05
    scales = None
    if precision == "int8":
        absmax = np.abs(H).max(axis=1)
        s = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        H = np.clip(np.rint(H / s[:, None]), -127, 127).astype(np.int8)
        scales = s[None, :]
    t = ((1.0 - DAMPING) + DAMPING * 0.1) / n
    return H, x, dang, np.float32(t), scales, n


def k2_case(np, N, M, B, precision, seed):
    """Seeded W (N, M) at PageRank's scale (entries in [0, 2/M); int8 as
    integers, their row scales being the caller's) and X (B, M) whose rows
    are distributions, as the PPR iterates are."""
    rng = np.random.default_rng(seed)
    W = rng.random((N, M), dtype=np.float32) * (2.0 / M)
    if precision == "int8":
        W = np.rint(W * (127.0 * M / 2.0)).astype(np.int8)
    X = rng.random((B, M), dtype=np.float32)
    X /= X.sum(axis=1, keepdims=True)
    return W, X


def bsr_case(np, torch, BSRMatrix, n, bs, density, B, precision, seed,
             empty_row=False):
    """A BSR layout (built on the host) of a seeded (n, n) matrix at
    PageRank's scale, blocks in the storage type (int8 as integers, their
    scales being the caller's), and X (B, n) whose rows are distributions;
    ``empty_row`` leaves block row 0 without a block."""
    rng = np.random.default_rng(seed)
    A = rng.random((n, n), dtype=np.float32) * (2.0 / n)
    A[rng.random((n, n)) > density] = 0.0
    if empty_row:
        A[:bs] = 0.0
    bsr = BSRMatrix.from_dense(A, bs=bs, device="cpu")
    blocks = bsr.blocks
    if precision == "int8":
        blocks = torch.round(blocks * (127.0 * n / 2.0)).to(torch.int8)
    X = rng.random((B, n), dtype=np.float32)
    X /= X.sum(axis=1, keepdims=True)
    return blocks, bsr.block_cols, X


def zipf_queries(np, n, seed):
    """The serve phase's traffic: a pool of POOL seed sets of 1 to 5
    proteins and N_QUERIES picks from it with Zipf(ZIPF_S) weights."""
    rng = np.random.default_rng(seed)
    pool = [np.sort(rng.choice(n, size=int(rng.integers(1, 6)),
                               replace=False)) for _ in range(POOL)]
    w = 1.0 / np.arange(1, POOL + 1, dtype=np.float64) ** ZIPF_S
    picks = rng.choice(POOL, size=N_QUERIES, p=w / w.sum())
    return pool, picks


def issued_sweeps(sweeps, max_pushes, chunk):
    """Sweeps (or steps) the port's chunked tolerance loop issues for a
    push or solve that exited after ``sweeps``: whole chunks of ``chunk``
    (the masked sweeps after the exit change nothing), never past
    ``max_pushes``."""
    return min(max_pushes, -(-sweeps // chunk) * chunk)


def host_reference(np, src, dst, n, n_iters, d):
    """Independent float64 power iteration on the host: dense
    column-stochastic H with uniform dangling columns."""
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    H = np.zeros((n, n), np.float64)
    H[dst, src] = 1.0 / outdeg[src]
    H[:, outdeg == 0] = 1.0 / n
    pr = np.full(n, 1.0 / n)
    for _ in range(n_iters):
        pr = d * (H @ pr) + (1.0 - d) / n
    return pr


def topk_overlap(np, a, b, k):
    ta = np.argpartition(-a, k - 1)[:k]
    tb = np.argpartition(-b, k - 1)[:k]
    return len(np.intersect1d(ta, tb)) / k


def faulty_stream(np, torch, device, backend, precision, n, kernels=None):
    """FAULTY_SCRIPT through the port's resilient serve engine on
    ``device``: ``PageRankQueryEngine(n_iters=60, max_batch=4,
    resilience=ServeResilience(healthy_atol=SUM_TOL[precision]))`` over a
    ``DynamicPageRankEngine`` on ``EdgeStream(n, **FAULTY_STREAM)``, 2
    queries of 3 seeds per step.
    Returns each step's record (its refresh outcome and watchdog verdict
    when it refreshed, the serve path's recoveries, each query's status
    and version, and, with ``kernels`` = {name: module}, the launches of
    the flush by kernel), the served scores, the dead letters, the
    injector log, the final ranks and the accepted edges."""
    from repro_torch.graph.delta import EdgeStream, apply_delta
    from repro_torch.obs.registry import NullRegistry
    from repro_torch.pagerank import DynamicPageRankEngine, FaultInjector
    from repro_torch.serve import PageRankQueryEngine, ServeResilience

    stream = EdgeStream(n, **FAULTY_STREAM)
    cur = stream.base()
    eng = DynamicPageRankEngine(cur[0], cur[1], n, d=DAMPING,
                                backend=backend, precision=precision,
                                device=device, metrics=NullRegistry())
    eng.run_tol(1e-7)
    # a reduced-precision H does not keep the mass at 1: the health checks
    # take the tier's SUM_TOL (1e-3, the default, for f32)
    qe = PageRankQueryEngine(eng, n_iters=60, max_batch=4,
                             resilience=ServeResilience(
                                 healthy_atol=SUM_TOL[precision]))
    inj = FaultInjector(seed=SEED)
    rng = np.random.default_rng(SEED)
    recovers = []
    recover = qe.refresher.recover

    def counted_recover(*a, **kw):
        recovers.append(1)
        return recover(*a, **kw)
    qe.refresher.recover = counted_recover
    steps, scores = [], []
    for step, (klass, kind) in enumerate(FAULTY_SCRIPT):
        if klass != "serve":
            good = stream.step()
            qe.push_update(good)
            cur = apply_delta(cur[0], cur[1], good, n)
        if klass == "delta":
            res = qe.push_update(inj.corrupt_delta(n, kind=kind))
            if res.delta is not None:
                cur = apply_delta(cur[0], cur[1], res.delta, n)
        elif klass in ("layout", "serve", "rebuild"):
            inj.corrupt_layout(eng, kind=kind)
        elif klass == "update":
            inj.fail_next_updates(eng, times=1)
        if klass == "rebuild":
            def failing_once(*a, **kw):
                del eng.rebuild_and_solve
                raise RuntimeError("injected rebuild failure")
            eng.rebuild_and_solve = failing_once
        queries = [qe.submit(uid=step * 10 + q,
                             seeds=rng.choice(n, size=3, replace=False),
                             top_k=10) for q in range(2)]
        for k in (kernels or {}).values():
            k.reset_launches()
        before, n_rec = qe.last_refresh_outcome, len(recovers)
        qe.flush()
        if device.type == "cuda":
            torch.cuda.synchronize()
        o = qe.last_refresh_outcome
        info = o.update_info if o is not before else None
        steps.append({
            "fault": f"{klass}:{kind}",
            "refresh": (None if o is before
                        else (o.status, o.attempts, o.delta_applied)),
            "verdict": (None if info is None else
                        "nonfinite" if info.nonfinite else
                        "diverged" if info.diverged else "healthy"),
            "recovers": len(recovers) - n_rec,
            "queries": [(q.status, q.graph_version) for q in queries],
            "launches": {name: sum(k.launches.values())
                         for name, k in (kernels or {}).items()}})
        scores.append([np.asarray(q.result[1]) for q in queries])
    return {"steps": steps, "scores": scores,
            "dead_letters": qe.dead_letters.counts(), "log": list(inj.log),
            "ranks": eng.ranks.double().cpu().numpy(), "edges": cur}


def check_faulty_stream(np, card, cpu, what):
    """Phase 3f's checks of one tier's card run against the same script
    through the plain versions on the CPU: the same steps (outcomes,
    verdicts, recoveries, query statuses and versions), dead letters and
    injector log; every served answer finite; the script's faults ending
    as the ladder says; every clean step ok and fresh."""
    for k, (g, c) in enumerate(zip(card["steps"], cpu["steps"])):
        check({key: v for key, v in g.items() if key != "launches"}
              == {key: v for key, v in c.items() if key != "launches"},
              f"{what} step {k} ({g['fault']}): card {g} != cpu {c}")
    check(card["dead_letters"] == cpu["dead_letters"],
          f"{what}: dead letters {card['dead_letters']} != "
          f"{cpu['dead_letters']}")
    check(card["log"] == cpu["log"],
          f"{what}: injector log {card['log']} != {cpu['log']}")
    for k, sc in enumerate(card["scores"]):
        check(all(np.isfinite(s).all() for s in sc),
              f"{what} step {k}: a served answer is not finite")
    st = {s["fault"]: s for s in card["steps"]}
    for s in card["steps"]:
        klass = s["fault"].split(":")[0]
        if klass in ("delta", "clean"):
            check(s["refresh"] == ("ok", 1, True) and s["recovers"] == 0
                  and {q[0] for q in s["queries"]} == {"fresh"},
                  f"{what}: clean step {s}")
    check(st["layout:inf"]["verdict"] == "nonfinite"
          and st["layout:inf"]["refresh"][0] == "recovered",
          f"{what}: layout:inf {st['layout:inf']}")
    check(st["serve:nan"]["refresh"] is None
          and st["serve:nan"]["recovers"] == 1
          and {q[0] for q in st["serve:nan"]["queries"]} == {"fresh"},
          f"{what}: the serve path's recovery {st['serve:nan']}")
    check(st["rebuild:nan"]["refresh"] == ("restored", 1, False)
          and {q[0] for q in st["rebuild:nan"]["queries"]} == {"stale"},
          f"{what}: the restore {st['rebuild:nan']}")
    check(st["update:None"]["refresh"] == ("ok", 2, True),
          f"{what}: the raising update {st['update:None']}")


def kernel_label(name: str) -> str:
    """A short name for a PyTorch elementwise kernel: its functor (the
    profiler's names are whole template instantiations)."""
    m = re.search(r"\b(?!Binary)(\w+Functor\w*|direct_copy_kernel_cuda)",
                  name)
    return m.group(1) if m else name[:60]


def wall_stats(torch, fn, *, rounds: int = 5) -> dict:
    """Host-clock time of ``fn`` ending in a device sync, after one
    warm-up call: the median of ``rounds`` with the smallest and largest
    beside it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times)}


def ell_instantiations(log: str) -> dict:
    """The split-ELL kernels in their build log: (pass, storage type, row
    scales) -> registers and spills."""
    out = {}
    for fn, info in ptxas_report(log).items():
        m = re.search(r"(overflow|rows)_kernelI(\w+?)(?:Lb([01])E)?EEv", fn)
        if m:
            out[(m.group(1), K3_TYPES[m.group(2)], m.group(3) == "1")] = info
    return out


def eager_cold_ms(torch, fn, flush, *, samples: int = 7) -> float:
    """One call issued eagerly between two events right after an L2 flush
    (for calls a CUDA graph cannot hold: the gaps of their host syncs are
    counted); the median of ``samples``."""
    times = []
    for _ in range(samples):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ell_step_phase(np, torch, dev, card, flush=None) -> dict:
    """The split-ELL kernel at the ``graph500_22.solve`` cell's shapes
    (``perfbench/configs/graph500_22.json``, seed 0), at every storage
    type: the layout's fill; one step against its plain version (rtol
    1e-5, atol 1e-7) and bit-identical on a second call; ``run(10)``
    repeated bit for bit with 10 x 2 launches; one step flushed, warm and
    as an eager call beside its byte bound (each real entry's value and
    index, the metadata, x, dang, the new vector and the int8 scales, once
    each), the eager step it replaced (the tier's product + ``sparse_step``)
    flushed, and, issued eagerly after a flush, the plain version (its
    host syncs' gaps included) and in float32 ``torch.sparse_csr`` times
    x, the library yardstick the port never calls.  Returns the measurements and
    the kernel table's rows.  Alone, from the repository root:
    ``PYTHONPATH=src python3 -c "import numpy as np, torch, chip_smoke;
    chip_smoke.ell_step_phase(np, torch, torch.device('cuda'),
    chip_smoke.nvidia_smi())"``."""
    from perfbench.graphs import kronecker
    from repro_torch.kernels import _build
    from repro_torch.kernels import ell_step as ell
    from repro_torch.obs.registry import NullRegistry
    from repro_torch.pagerank import PageRankEngine
    from repro_torch.pagerank.engine import TIERS
    from repro_torch.pagerank.steps import sparse_step

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    if flush is None:
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    regs = ell_instantiations(_build.build_all()["logs"]["ell_step"])
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / "graph500_22.json").read_text())
    g = kronecker.make(cfg, 0, dev)
    out, rows = {"card": card}, []
    for p in PRECISIONS:
        eng = PageRankEngine(g.src, g.dst, g.n, d=cfg["d"], backend="ell",
                             precision=p, device=dev, metrics=NullRegistry())
        ops, meta, dang = eng.operands, eng._ell_meta, eng._dang
        n, k0 = ops[0].shape
        E, R = ops[4].numel(), meta.ov_rows.numel()
        real = int(meta.counts.sum())
        if p == "f32":
            out["layout"] = {
                "n": n, "k0": k0, "ell_slots": n * k0, "ell_entries": real,
                "ell_fill": real / (n * k0), "overflow_entries": E,
                "overflow_rows": R, "overflow_share": E / (E + real),
                "chunks": meta.chunk_row.numel() - 1,
                "longest_overflow": int(meta.ov_ptr.diff().max()),
                "meta_bytes": meta.nbytes,
                "layout_bytes": eng.layout_bytes["total_bytes"]}
            print(f"  graph500_22 at scale {cfg['scale']}, seed 0: n {n}, "
                  f"k0 {k0}; {real} of {n * k0} ELL slots real "
                  f"({real / (n * k0):.1%}), {E} overflow entries "
                  f"({E / (E + real):.1%} of all) in {R} rows, the longest "
                  f"{out['layout']['longest_overflow']}; metadata "
                  f"{meta.nbytes} bytes beside {out['layout']['layout_bytes']}"
                  " of operands")
        x = eng.run(10)
        leak = torch.sum(x * dang)

        def kernel():
            return ell.ell_step(ops, meta, dang, x, leak, d=eng.d)

        def plain():
            return ell.ell_step_ref(ops, meta, dang, x, leak, d=eng.d)

        def eager():
            return sparse_step(lambda v: TIERS["ell"].product(ops, v), x,
                               dang, eng.d, n)

        new, lk = kernel()
        want, want_lk = plain()
        torch.cuda.synchronize()
        err = allclose(torch, new, want, rtol=1e-5, atol=1e-7,
                       what=f"ell_step {p} vs its plain version")
        allclose(torch, lk, want_lk, rtol=1e-5, atol=1e-7,
                 what=f"ell_step {p} leak vs its plain version")
        again = kernel()
        check(bool(torch.equal(again[0], new) and torch.equal(again[1], lk)),
              f"ell_step {p}: two calls are not bit-identical")
        before = ell.launches[p]
        pr = eng.run(10)
        torch.cuda.synchronize()
        run_launches = ell.launches[p] - before
        check(run_launches == 20, f"run(10) {p}: {run_launches} launches")
        check(bool(torch.equal(eng.run(10), pr)),
              f"run(10) {p}: two solves are not bit-identical")
        ms = cuda_ms_cold(torch, kernel, flush)
        warm_ms = cuda_ms(torch, kernel)
        call_ms = eager_ms(torch, kernel)
        plain_ms = eager_cold_ms(torch, plain, flush)
        eager_step_ms = cuda_ms_cold(torch, eager, flush)
        library_ms = None
        if p == "f32":
            keep = torch.arange(k0, device=dev)[None, :] < meta.counts[:, None]
            r_ell = torch.nonzero(keep)[:, 0]
            A = torch.sparse_coo_tensor(
                torch.stack([torch.cat([r_ell, ops[2].long()]),
                             torch.cat([ops[1][keep].long(),
                                        ops[3].long()])]),
                torch.cat([ops[0][keep], ops[4]]), (n, n)).coalesce()
            A = A.to_sparse_csr()
            library_ms = eager_cold_ms(torch, lambda: A @ x, flush)
            del A
        es = ops[0].element_size()
        nbytes = ((real + E) * (es + 4) + meta.nbytes + 3 * 4 * n
                  + (4 * n if len(ops) == 6 else 0))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        scales = len(ops) == 6
        info = {k: regs.get((k, p, scales if k == "rows" else False), {})
                for k in ("overflow", "rows")}
        rows.append({
            "name": f"ell_step[{p}]", "route": "cuda", "source": ELL_SOURCE,
            "replaces": ELL_REPLACES, "launches": run_launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes", "library_ms": library_ms,
            "library_call": "torch.sparse_csr @ x" if p == "f32" else None,
            "eager_step_ms": eager_step_ms,
            "ms_warm_l2": warm_ms, "ms_eager_call": call_ms,
            "shape": [n, k0, E, R], "bytes": nbytes,
            "registers": {k: v.get("registers") for k, v in info.items()},
            "spills": {k: (v.get("spill_stores"), v.get("spill_loads"))
                       for k, v in info.items()}})
        print(f"  ell_step {p}: {ms * 1e3:.2f} us/step flushed, "
              f"{warm_ms * 1e3:.2f} us warm, {call_ms * 1e3:.2f} us per "
              f"eager call; bound {bound * 1e3:.2f} us ({nbytes} bytes, "
              f"{bound / ms:.1%}); plain {plain_ms * 1e3:.2f} us (eager, "
              f"its host syncs included); the eager step it replaced "
              f"{eager_step_ms * 1e3:.2f} us"
              + ("" if library_ms is None else
                 f"; torch.sparse_csr @ x {library_ms * 1e3:.2f} us")
              + f"; max|diff| {err:.3e}; run(10) {run_launches} launches, "
              f"repeats bit-identical; registers {rows[-1]['registers']}, "
              f"spills {rows[-1]['spills']}")
        del eng, ops, meta, dang, x, pr
    out["rows"] = rows
    out["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"ell_step_phase": out}))
    return out


def sharded_phase(np, torch, dev, src, dst, sets, card, flush) -> dict:
    """Phase 3h: the sharded mesh tiers at the paper's size, each mesh of
    the one card (``SHARDED_TIERS``).  Per tier: ``run(100)`` (no host
    sync), ``run_tol(1e-6)``, ``ppr`` of ``sets`` and a 64-hub landmark
    build, each with K2's launches zeroed before and read after and held
    to the schedule (one launch per shard per iteration, at B = 1 for the
    tiles and B = Q / C for the row blocks of PPR); each result held to
    the ``dense`` tier at the same storage type (rtol 1e-5, atol 1e-7,
    top-10 identical, iterations within 1) and to the same calls on a CPU
    mesh of the same shape (rtol 1e-5, atol 1e-7); ``lower_run``'s
    collectives per iteration; the wall times (median of 5, smallest and
    largest).  Then 16 live ticks of the streaming stream on both sharded
    tiers (the ranks within L1 1e-5 of a fresh solve) and K2 flushed at the
    2500 x 2500 tile beside ``torch.mv`` on the same tile."""
    from repro_torch.graph.delta import EdgeStream, apply_delta
    from repro_torch.kernels import streaming_matvec as k2
    from repro_torch.kernels.ref import streaming_matvec_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs.registry import MetricsRegistry, NullRegistry
    from repro_torch.obs.trace import CHUNK
    from repro_torch.pagerank import (DynamicPageRankEngine, LandmarkIndex,
                                      PageRankEngine)
    from repro_torch.pagerank.sparse import top_k_proteins
    from repro_torch.serve import PageRankQueryEngine

    def engine(backend, p, mesh=None, device=None):
        return PageRankEngine(src, dst, N_NODES, d=DAMPING, backend=backend,
                              precision=p, mesh=mesh, device=device,
                              metrics=NullRegistry())

    def landmarks(eng):
        return LandmarkIndex(eng, n_hubs=N_HUBS, tol=LM_TOL,
                             max_pushes=LM_MAX_PUSHES, n_iters=N_ITERS,
                             metrics=NullRegistry())

    dense, dense_lm = {}, {}
    launches = Counter()          # (storage, B, W shape) -> K2 launches
    tiers = {}
    for label, backend, shape, axes, p in SHARDED_TIERS:
        t_tier = time.perf_counter()
        k = int(np.prod(shape))
        mesh = make_mesh(shape, axes, [dev] * k)
        cpu_mesh = make_mesh(shape, axes, ["cpu"] * k)
        eng = engine(backend, p, mesh)
        cpu = engine(backend, p, cpu_mesh)
        if p not in dense:
            dense[p] = engine("dense", p, device=dev)
            dense_lm[p] = landmarks(dense[p])
            dense_lm[p].build(0)
        ref = dense[p]
        devices = [str(d) for d in mesh.device_list]
        print(f"  {label}: mesh {dict(mesh.shape)} over devices {devices} "
              f"(one card, {k} positions) [{eng.layout}]")
        sharded = backend == "dense_sharded"
        tile = (N_NODES // shape[0], N_NODES // shape[-1]) if sharded else None
        rows = (N_NODES // shape[0], N_NODES) if sharded else None
        cols = shape[-1] if sharded else k

        def counted(fn, step, B, W, steps):
            k2.reset_launches()
            out = fn()
            torch.cuda.synchronize()
            got = dict(k2.batch_launches)
            n_steps = steps(out) if callable(steps) else steps
            want = {(p, B): k * n_steps} if sharded else {}
            check(got == want, f"{label} {step}: K2 launches {got}, want "
                  f"{want} ({k} shards x {n_steps} iterations)")
            for (q, b), c in got.items():
                launches[q, b, W] += c
            return out

        torch.cuda.set_sync_debug_mode("error")
        try:
            pr = counted(lambda: eng.run(N_ITERS), "run", 1, tile, N_ITERS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        res = counted(lambda: eng.run_tol(tol=1e-6, max_iters=1000),
                      "run_tol", 1, tile,
                      lambda r: issued_sweeps(r.info.iters, 1000, CHUNK))
        q_pad = -(-len(sets) // cols) * cols
        X = counted(lambda: eng.ppr(sets, N_ITERS), "ppr", q_pad // cols,
                    rows, N_ITERS)
        lm = landmarks(eng)
        counted(lambda: lm.build(0), "landmark build", N_HUBS // cols, rows,
                N_ITERS)
        # against the dense tier at the same storage type
        ref_pr = ref.run(N_ITERS)
        ref_tol = ref.run_tol(tol=1e-6, max_iters=1000)
        errs = {
            "run_vs_dense": allclose(torch, pr, ref_pr, **TOL_TIER,
                                     what=f"{label} run vs dense[{p}]"),
            "run_tol_vs_dense": allclose(torch, res.pr, ref_tol.pr,
                                         **TOL_TIER, what=f"{label} run_tol "
                                         f"vs dense[{p}]"),
            "ppr_vs_dense": allclose(torch, X, ref.ppr(sets, N_ITERS),
                                     **TOL_TIER, what=f"{label} ppr vs "
                                     f"dense[{p}]"),
            "landmark_vs_dense": allclose(
                torch, torch.from_numpy(lm._Y),
                torch.from_numpy(dense_lm[p]._Y), **TOL_TIER,
                what=f"{label} landmark hub columns vs dense[{p}]")}
        check(np.array_equal(lm.hubs, dense_lm[p].hubs),
              f"{label}: the landmark index chose other hubs than dense")
        check(res.info.converged and abs(res.info.iters
                                         - ref_tol.info.iters) <= 1,
              f"{label} run_tol: {res.info.status} in {res.info.iters} "
              f"iterations, dense {ref_tol.info.iters}")
        top = top_k_proteins(pr, k=10)[0].cpu().numpy()
        check(np.array_equal(top, top_k_proteins(ref_pr, k=10)[0]
                             .cpu().numpy()),
              f"{label}: top-10 {top} differs from dense[{p}]'s")
        # against the same calls on the CPU mesh
        cpu_res = cpu.run_tol(tol=1e-6, max_iters=1000)
        cpu_lm = landmarks(cpu)
        cpu_lm.build(0)
        errs.update({
            "run_vs_cpu": allclose(torch, pr.cpu(), cpu.run(N_ITERS),
                                   **TOL_TIER, what=f"{label} run vs CPU"),
            "run_tol_vs_cpu": allclose(torch, res.pr.cpu(), cpu_res.pr,
                                       **TOL_TIER,
                                       what=f"{label} run_tol vs CPU"),
            "ppr_vs_cpu": allclose(torch, X.cpu(), cpu.ppr(sets, N_ITERS),
                                   **TOL_TIER, what=f"{label} ppr vs CPU"),
            "landmark_vs_cpu": allclose(
                torch, torch.from_numpy(lm._Y), torch.from_numpy(cpu_lm._Y),
                **TOL_TIER, what=f"{label} landmark hub columns vs CPU")})
        check(abs(res.info.iters - cpu_res.info.iters) <= 1,
              f"{label} run_tol: {res.info.iters} iterations, CPU mesh "
              f"{cpu_res.info.iters}")
        schedule = eng.lower_run()
        times = {"run": wall_stats(torch, lambda: eng.run(N_ITERS)),
                 "run_tol": wall_stats(torch, lambda: eng.run_tol(tol=1e-6)),
                 "ppr": wall_stats(torch, lambda: eng.ppr(sets, N_ITERS)),
                 "landmark_build": wall_stats(torch, lambda: lm.build(0))}
        tiers[label] = {"devices": devices, "layout": eng.layout,
                        "iters": res.info.iters,
                        "dense_iters": ref_tol.info.iters,
                        "cpu_iters": cpu_res.info.iters,
                        "max_abs_diff": errs, "schedule": schedule,
                        "wall_ms": times,
                        "phase_s": time.perf_counter() - t_tier}
        print("    K2 launches per iteration: "
              + (f"{k} (one per shard) at run B=1, ppr B={q_pad // cols}, "
                 f"landmark build B={N_HUBS // cols}" if sharded else
                 "none (the ELL gather is plain PyTorch)")
              + f"; collectives per iteration {schedule['collectives']}, "
              f"bytes {schedule['bytes']}")
        print(f"    run_tol(1e-6) {res.info.iters} iterations (dense "
              f"{ref_tol.info.iters}, CPU mesh {cpu_res.info.iters}); "
              "max|diff| " + ", ".join(f"{a} {v:.3e}" for a, v in
                                       errs.items()))
        print(f"    wall time on {card} (median of 5 [min, max]): "
              + ", ".join(f"{a} {v['median_ms']:.3f} ms "
                          f"[{v['min_ms']:.3f}, {v['max_ms']:.3f}]"
                          for a, v in times.items()))

    # 16 live ticks of the streaming example's stream on both sharded tiers
    live = {}
    for label, backend, shape, axes, p in (SHARDED_TIERS[0],
                                           SHARDED_TIERS[-1]):
        mesh = make_mesh(shape, axes, [dev] * int(np.prod(shape)))
        stream = EdgeStream(N_NODES, **STREAM)
        cur = stream.base()
        reg = MetricsRegistry()
        dyn = DynamicPageRankEngine(cur[0], cur[1], N_NODES, d=DAMPING,
                                    backend=backend, mesh=mesh, metrics=reg)
        dyn.run_tol(1e-7, max_iters=1000)
        qe = PageRankQueryEngine(dyn, n_iters=60, max_batch=4, metrics=reg)
        rng = np.random.default_rng(SEED)
        strategies = []
        k2.reset_launches()
        for tick, delta in zip(range(SHARDED_LIVE_TICKS), stream):
            qe.push_update(delta)
            qs = [qe.submit(tick * 10 + q, rng.choice(N_NODES, size=3,
                                                      replace=False))
                  for q in range(4)]
            qe.flush()
            info = qe.last_update_info
            check(info.healthy and all(q.result is not None for q in qs),
                  f"{label} tick {tick}: {info}")
            strategies.append(info.strategy)
            cur = apply_delta(cur[0], cur[1], delta, N_NODES)
        torch.cuda.synchronize()
        # the solves launch at B = 1 on the tiles, the flushes' PPR of 4
        # queries at B = 4 / C on the row blocks
        for (q, b), c in k2.batch_launches.items():
            launches[q, b, (N_NODES // shape[0], N_NODES // shape[-1])
                     if b == 1 else (N_NODES // shape[0], N_NODES)] += c
        fresh = PageRankEngine(cur[0], cur[1], N_NODES, d=DAMPING,
                               backend="dense", device=dev,
                               metrics=NullRegistry()).run(300)
        l1 = float(torch.sum(torch.abs(dyn.ranks - fresh)))
        check(l1 <= 1e-5, f"{label} live: L1 vs a fresh solve {l1:.3e}")
        upd = reg.histogram("span.update")
        live[label] = {"strategies": strategies, "l1_vs_fresh": l1,
                       "k2_launches": sum(k2.launches.values()),
                       "update_p50_ms": upd.quantile(0.5),
                       "update_p95_ms": upd.quantile(0.95),
                       "flush_p50_ms": reg.histogram(
                           "serve.batch_ms").quantile(0.5)}
        print(f"  {label}: {SHARDED_LIVE_TICKS} live ticks, strategies "
              f"{dict(Counter(strategies))}, L1 vs a fresh solve {l1:.3e}, "
              f"update p50 {live[label]['update_p50_ms']:.3f} ms on {card}")

    # K2 flushed at the 2 x 2 tile (2500 x 2500, B = 1) beside torch.mv
    tile_eng = engine("dense_sharded", "f32", make_mesh(
        (2, 2), ("row", "col"), [dev] * 4))
    W = tile_eng.operands[0].shards[0]
    x = torch.from_numpy(np.random.default_rng(SEED).dirichlet(
        np.ones(W.shape[1])).astype(np.float32)).to(dev)
    X1 = x[None, :]
    y = k2.streaming_matvec(W, X1)
    torch.cuda.synchronize()
    err = allclose(torch, y, streaming_matvec_ref(W, X1), **TOL32,
                   what="K2 at the 2500 x 2500 tile")
    allclose(torch, y, streaming_matvec_ref(W, X1), **TIGHT,
             what="K2 at the 2500 x 2500 tile")
    check(bool(torch.equal(k2.streaming_matvec(W, X1), y)),
          "K2 at the tile: two calls are not bit-identical")
    ms = cuda_ms_cold(torch, lambda: k2.streaming_matvec(W, X1), flush)
    plain_ms = cuda_ms_cold(torch, lambda: streaming_matvec_ref(W, X1),
                            flush)
    mv_ms = cuda_ms_cold(torch, lambda: torch.mv(W, x), flush)
    Np, Mp = W.shape
    nbytes = W.numel() * W.element_size() + 4 * (Mp + Np)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms, ops_n, scheme = split_bound("f32", Np * Mp)
    tile_launches = launches["f32", 1, (Np, Mp)]
    check(tile_launches > 0, "the sharded phase launched K2 at the tile no "
          "time")
    print(f"  K2 f32 at the {Np} x {Mp} tile, B=1: {ms * 1e3:.2f} us "
          f"flushed, bound {max(bytes_ms, ops_ms) * 1e3:.2f} us ({nbytes} "
          f"bytes at {HBM_BYTES_PER_S / 1e12} TB/s); plain "
          f"{plain_ms * 1e3:.2f} us, torch.mv {mv_ms * 1e3:.2f} us flushed; "
          f"{tile_launches} launches in this phase")
    print("  K2 launches in this phase by (storage, B, W shape): "
          + ", ".join(f"{q} B={b} {w[0]}x{w[1]}: {c}"
                      for (q, b, w), c in sorted(launches.items())))
    row = {"name": f"streaming_matvec[f32,B=1,tile {Np}x{Mp}]",
           "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
           "launches": tile_launches, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": mv_ms, "library_call": "torch.mv",
           "shape": [Np, Mp], "batch": 1, "bytes": nbytes,
           "operations": ops_n, "ops_scheme": scheme}
    return {"tiers": tiers, "live": live, "k2_row": row,
            "k2_launches": {f"{q},B={b},{w[0]}x{w[1]}": c
                            for (q, b, w), c in launches.items()}}


def fabric_phase(np, torch, dev, src, dst, card) -> dict:
    """Phase 3g: the fabric simulator on the card.  Raises on any failure;
    returns the measurements."""
    from repro_torch.core import fabric as fab
    from repro_torch.core import isa, schedule, timing
    from repro_torch.graph.generators import protein_network
    from repro_torch.graph.transition import build_transition_dense
    from repro_torch.pagerank import pagerank_on_fabric
    from repro_torch.pagerank.dense import pagerank_dense_fixed
    from repro_torch.pagerank.sparse import top_k_proteins
    cpu = torch.device("cpu")
    Message = isa.Message
    out = {}

    # the codec: the six Fig. 5 words, both ways, bit for bit
    for hx, op, dest, val, nop, ndest in FIG5_MESSAGES:
        m = isa.from_hex(hx, device=dev)
        check(m.value.device.type == dev.type, "from_hex left the card")
        check((int(m.opcode), int(m.dest), float(m.value),
               int(m.next_opcode), int(m.next_dest))
              == (op, dest, float(np.float32(val)), nop, ndest),
              f"decode {hx}: {isa.describe(m)}")
        got = isa.to_hex(Message.make(op, dest, val, nop, ndest,
                                      device=dev))
        check(got == hx, f"encode {isa.describe(m)}: {got}, want {hx}")
    print(f"  codec: the {len(FIG5_MESSAGES)} Fig. 5 words decode and "
          "encode bit-exact on the card")

    def one(m, n, i):
        """An (n,) edge of empty messages with ``m`` in slot ``i``."""
        hit = torch.arange(n, device=m.opcode.device) == i
        return m.map(lambda x: torch.where(hit, x, torch.zeros_like(x)))

    # Fig. 2: 1.1 * 1 + 1.2 * 2 + 1.3 * 3 at site 3 of a 1 x 4 fabric
    seq = [(isa.PROG, 2, 1.3, isa.UPDATE, 3), (isa.PROG, 1, 1.2, isa.A_ADD, 3),
           (isa.PROG, 0, 1.1, isa.A_ADD, 3), (isa.A_MULS, 2, 3.0, 0, 0),
           (isa.A_MULS, 1, 2.0, 0, 0), (isa.A_MULS, 0, 1.0, 0, 0)]
    left = isa.stack([one(Message.make(*a, device=dev), 1, 0) for a in seq])
    fin, _ = fab.run(fab.Fabric.create(1, 4, dev), left,
                     Message.empty((len(seq), 4), device=dev),
                     extra_cycles=10)
    fig2 = fin.values[0].cpu().numpy()
    check(bool(np.allclose(fig2[:3], [1.1, 1.2, 1.3], rtol=1e-6, atol=0))
          and abs(float(fig2[3]) - 7.4) <= 7.4e-6
          and int(fin.conflicts) == 0,
          f"Fig. 2: {fig2}, conflicts {int(fin.conflicts)}")
    out["fig2"] = float(fig2[3])
    print(f"  Fig. 2 on a 1 x 4 fabric: site 3 holds {fig2[3]:.6f}, "
          "0 conflicts")

    # Fig. 5: the testbench on a 4 x 4 fabric, every cycle's wires held to
    # the CPU run bit for bit (hop mode is elementwise float32 only)
    def fig5(device):
        msgs = [isa.from_hex(m[0], device=device) for m in FIG5_MESSAGES]
        T = len(msgs) - 1
        left = isa.stack([one(msgs[0], 4, 1)]
                         + [Message.empty((4,), device=device)] * (T - 1))
        top = isa.stack([one(m, 4, 1) for m in msgs[1:]])
        return fab.run(fab.Fabric.create(4, 4, device), left, top,
                       extra_cycles=6)

    def leaves(obj):
        if isinstance(obj, (tuple, list)):
            return [x for o in obj for x in leaves(o)]
        if dataclasses.is_dataclass(obj):
            return leaves([getattr(obj, f.name)
                           for f in dataclasses.fields(obj)])
        obj = obj.cpu()
        return [obj.view(torch.int32) if obj.dtype == torch.float32 else obj]

    card_run, cpu_run = fig5(dev), fig5(cpu)
    check(all(torch.equal(a, b) for a, b in zip(leaves(card_run),
                                                leaves(cpu_run))),
          "Fig. 5: the card's wires or state differ from the cpu run's")
    fin, (_, down) = card_run
    ops = down.opcode[:, 1, 1].cpu().numpy()
    vals = down.value[:, 1, 1].cpu().numpy()
    carried = [float(v) for o, v in zip(ops, vals) if o == isa.PROG]
    check(np.allclose(carried, [9.1, 8.1, 7.1, 3.0, 6.1], rtol=1e-6)
          and abs(float(fin.values[1, 1]) - 10.1) < 1e-5
          and abs(float(fin.values[2, 1]) - 6.1) < 1e-5
          and int(fin.conflicts) == 0,
          f"Fig. 5: down wire of site 5 carried {carried}")
    print(f"  Fig. 5 on a 4 x 4 fabric: {len(ops)} cycles, every wire and "
          "the final state bit-equal to the cpu run; site 5's down wire "
          f"carried {carried}, site 5 holds 10.1, site 9 6.1, 0 conflicts")

    # hop mode at full width: a 64 x 64 matrix loaded by Prog messages onto
    # the whole 64 x 65 fabric
    rng = np.random.default_rng(SEED)
    side = FABRIC_SIDE
    A = torch.from_numpy(rng.standard_normal((side, side)).astype(
        np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(side).astype(np.float32)).to(dev)
    slow = schedule.matvec(A, b, use_messages=True)
    fast = schedule.matvec(A, b)
    check(slow.state.shape == (side, side + 1)
          and int(slow.state.conflicts) == 0
          and slow.steps == fast.steps == side + 3,
          f"hop mode: shape {slow.state.shape}, conflicts "
          f"{int(slow.state.conflicts)}, steps {slow.steps}")
    out["hop_matvec_max_abs_diff"] = allclose(
        torch, slow.result, fast.result, rtol=1e-6, atol=0.0,
        what="hop-mode matvec vs fast mode")
    print(f"  hop-mode matvec on the {side} x {side + 1} fabric: "
          f"{2 * side} cycles, 0 conflicts, {slow.steps} steps, vs fast "
          f"mode max|diff| {out['hop_matvec_max_abs_diff']:.3e} (rtol 1e-6)")

    # the untiled schedule at the fabric's limit, N = 64
    s64, d64 = protein_network(side, seed=SEED)
    H64 = build_transition_dense(s64, d64, side, device=dev)
    pr64, steps64, secs64 = pagerank_on_fabric(H64, n_iters=N_ITERS)
    check(steps64 == N_ITERS * (side + 6), f"untiled steps {steps64}")
    out["untiled_max_abs_diff"] = allclose(
        torch, pr64, pagerank_dense_fixed(H64, N_ITERS), rtol=1e-4,
        atol=0.0, what="pagerank_on_fabric(N=64) vs pagerank_dense_fixed")
    print(f"  pagerank_on_fabric N = {side}, {N_ITERS} iterations: "
          f"{steps64} steps, vs pagerank_dense_fixed max|diff| "
          f"{out['untiled_max_abs_diff']:.3e} (rtol 1e-4)")

    # Fig. 4C at the paper's size: the 5000-protein network's dense H
    H = build_transition_dense(src, dst, N_NODES, device=dev)
    tiled = schedule.pagerank_tiled(H, n_iters=N_ITERS)
    ref = pagerank_dense_fixed(H, N_ITERS)
    check(tiled.steps == TILED_STEPS == timing.pagerank_steps_tiled(
        N_NODES, N_ITERS), f"tiled steps {tiled.steps}")
    out["tiled_max_abs_diff"] = allclose(
        torch, tiled.result, ref, rtol=1e-4, atol=1e-7,
        what="pagerank_tiled(N=5000) vs pagerank_dense_fixed")
    top_t, _ = top_k_proteins(tiled.result, 10)
    top_r, _ = top_k_proteins(ref, 10)
    check(top_t.tolist() == top_r.tolist(),
          f"tiled top-10 {top_t.tolist()} vs {top_r.tolist()}")
    short = schedule.pagerank_tiled(H, n_iters=3)
    out["tiled3_vs_cpu_max_abs_diff"] = allclose(
        torch, short.result.cpu(),
        schedule.pagerank_tiled(H.cpu(), n_iters=3).result, rtol=1e-6,
        atol=0.0, what="3 tiled iterations, card vs cpu")
    print(f"  pagerank_tiled N = {N_NODES}, {N_ITERS} iterations: "
          f"{tiled.steps} steps; vs pagerank_dense_fixed max|diff| "
          f"{out['tiled_max_abs_diff']:.3e} (rtol 1e-4, atol 1e-7), top-10 "
          f"identical {top_t.tolist()}; 3 iterations vs the cpu max|diff| "
          f"{out['tiled3_vs_cpu_max_abs_diff']:.3e} (rtol 1e-6)")

    # the port's quickstart on the card
    t0 = time.perf_counter()
    qs = subprocess.run([sys.executable,
                         str(ROOT / "examples" / "torch_quickstart.py")],
                        capture_output=True, text=True, timeout=600,
                        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)})
    check(qs.returncode == 0 and qs.stdout.rstrip().endswith(
        "quickstart: ALL OK"), f"torch_quickstart.py exited "
        f"{qs.returncode}: {qs.stdout[-2000:]} {qs.stderr[-2000:]}")
    out["quickstart_s"] = time.perf_counter() - t0
    print(f"  examples/torch_quickstart.py on the card: exit 0 "
          f"({out['quickstart_s']:.2f} s)")

    # times: CUDA events, median of 5
    def event_ms(fn):
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    out["tiled_100_ms"] = event_ms(
        lambda: schedule.pagerank_tiled(H, n_iters=N_ITERS))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # device launches and the device's busy time per iteration: a run of
    # 3 iterations less a run of 1, halved, so the set-up drops out
    counts, busy = {}, {}
    for iters in (1, 3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            schedule.pagerank_tiled(H, n_iters=iters)
            torch.cuda.synchronize()
        counts[iters], busy[iters] = Counter(), Counter()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                counts[iters][e.name] += 1
                busy[iters][e.name] += e.time_range.elapsed_us()
    per_iter = (counts[3].total() - counts[1].total()) / 2 or None
    out["tiled_launches_per_iteration"] = per_iter
    out["tiled_busy_us_per_iteration"] = (
        (busy[3].total() - busy[1].total()) / 2 if per_iter else None)
    # the kernels that take the most device time per iteration
    out["tiled_kernels_per_iteration"] = sorted(
        ({"kernel": k, "launches": (counts[3][k] - counts[1][k]) / 2,
          "us": (busy[3][k] - busy[1][k]) / 2} for k in busy[3]),
        key=lambda r: -r["us"])[:4]
    cycle = slow.state
    # A_ADD messages for the bottom row enter every column's top port
    inj_t = Message.make(isa.A_ADD, torch.arange(
        (side - 1) * (side + 1), side * (side + 1), device=dev), 1.0)
    inj_l = Message.empty((side,), device=dev)
    out["hop_cycle_ms"] = eager_ms(torch, lambda: fab.step(cycle, inj_l,
                                                            inj_t),
                                   reps=20, rounds=5)
    model_ms = timing.pagerank_latency_s(N_NODES, N_ITERS) * 1e3
    print(f"  times on {card} (CUDA events, median of 5): pagerank_tiled "
          f"N = {N_NODES}, {N_ITERS} iterations {out['tiled_100_ms']:.3f} "
          "ms, "
          + (f"{per_iter:.0f} device launches and "
             f"{out['tiled_busy_us_per_iteration']:.1f} us of kernel time "
             "per iteration (torch.profiler, 3 iterations less 1)"
             if per_iter else "launches and kernel time per iteration not "
             "measured (the profiler recorded no device events)")
          + "".join(f"; {r['launches']:.0f} x {kernel_label(r['kernel'])} "
                    f"{r['us']:.1f} us" for r in
                    out["tiled_kernels_per_iteration"])
          + f"; one hop-mode cycle on the {side} x {side + 1} fabric "
          f"{out['hop_cycle_ms']:.3f} ms (20 back to back); the paper's "
          f"model of its own fabric for the same run: {model_ms:.2f} ms at "
          "200 MHz (printed beside, not compared)")
    return out


def lm_inputs(np, cfg, rng, length: int) -> dict:
    """Numpy inputs of one LM call at batch 1: tokens, or frame embeddings
    for the audio family."""
    if cfg.embed_input:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, length))}
    else:
        batch = {"embeds": rng.standard_normal(
            (1, length, cfg.d_model)).astype(np.float32)}
    return batch


def lm_smoke_vs_cpu(np, torch, dev, arch: str) -> dict:
    """One smoke config in float32 on the card against the CPU on the
    same weights and inputs: ``forward``, ``prefill`` and four
    ``decode_step``s, logits and every cache entry (``LLM_F32_TOL``).
    Returns the largest difference of each kind."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    cfg = get_smoke_config(arch)
    cpu = M.init_params(cfg, 0, device="cpu")
    card = M.init_params(cfg, 0, device="cpu").to(dev)
    rng = np.random.default_rng(0)
    batch = lm_inputs(np, cfg, rng, LLM_SMOKE_PROMPT)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (1, cfg.n_vision_tokens, cfg.vision_dim)).astype(np.float32)
    errs = Counter()

    def held(kind, a, b, what):
        tol = LLM_F32_TOL[kind]
        b = b.to(a.device)
        err = float((a.float() - b.float()).abs().max())
        check(bool(torch.allclose(a.float(), b.float(), **tol)),
              f"{arch} {what}: card vs CPU max|diff| {err:.3e} outside "
              f"{tol}")
        errs[kind] = max(errs[kind], err)

    def both(b):
        return ({k: torch.from_numpy(v) for k, v in b.items()},
                {k: torch.from_numpy(v).to(dev) for k, v in b.items()})

    hb, db = both(batch)
    (hl, ha), (dl, da) = M.forward(cpu, hb, cfg), M.forward(card, db, cfg)
    held("logits", hl, dl, "forward logits")
    held("logits", ha["aux_loss"], da["aux_loss"], "forward aux_loss")
    (hl, hc), (dl, dc) = (M.prefill(cpu, hb, cfg, LLM_SMOKE_MAX_LEN),
                          M.prefill(card, db, cfg, LLM_SMOKE_MAX_LEN))
    held("logits", hl, dl, "prefill logits")
    for step in range(LLM_SMOKE_DECODES + 1):
        check(set(hc) == set(dc) and int(hc["len"]) == int(dc["len"]),
              f"{arch}: the caches differ in layout or fill")
        for name in sorted(set(hc) - {"len"}):
            kind = "state" if name in ("ssm", "conv") else "kv"
            held(kind, hc[name], dc[name], f"cache {name} after "
                 f"{step} decode steps")
        if step == LLM_SMOKE_DECODES:
            break
        hb, db = both(lm_inputs(np, cfg, rng, 1))
        (hl, hc), (dl, dc) = (M.decode_step(cpu, hb, hc, cfg),
                              M.decode_step(card, db, dc, cfg))
        held("logits", hl, dl, f"decode step {step} logits")
    return dict(errs)


def profile_once(torch, fn) -> dict:
    """Kernels and device time of one call of ``fn`` under
    torch.profiler, against its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name, n_by_name = Counter(), Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        n_by_name[e.name] += 1
    return {"kernels": len(kernels) or None,
            "device_busy_ms": busy_us / 1e3 if kernels else None,
            "wall_ms": wall_us / 1e3,
            "device_share": busy_us / wall_us if kernels else None,
            "top_kernels": [{"kernel": k, "launches": n_by_name[k], "us": us}
                            for k, us in by_name.most_common(5)]}


def event_times(torch, fn, n: int) -> dict:
    """``fn`` called ``n`` times, each call between two CUDA events (the
    host's issue time included): median, smallest and largest ms."""
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in pairs]
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "max_ms": max(times)}


def lm_phase(np, torch, dev, card) -> dict:
    """Phase 3i: the LM stack's token-serving path.  (a) llama3-8b at its
    full published width in bf16, drawn on the card from a seeded
    generator; (b) the JAX launcher's default traffic through the port's
    ``launch/serve.run`` (6 requests, prompts of 5-8 tokens from
    ``default_rng(0)``, 3 slots, 16 new tokens, ``max_len`` 128, greedy)
    and one request at T = 0.8: every request done with all its tokens,
    each greedy ``serve`` output equal to ``generate`` on its prompt, and
    one request's decode logits at every generated position held to
    ``forward`` over the prompt plus the generated prefix
    (``LLM_BF16_ATOL``), its greedy tokens equal to ``forward``'s argmax
    wherever the top-2 gap is over twice the measured difference; (c)
    prefill and decode times (CUDA events), the serve's tokens/s and one
    decode step under ``torch.profiler``, beside the step's byte bounds;
    (d) the ten smoke configs in float32 on the card against the CPU
    (``lm_smoke_vs_cpu``); (e) ``examples/torch_serve_lm.py`` in its own
    process."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import serve as lm_launch
    from repro_torch.models import model as M
    from repro_torch.obs.registry import (MetricsRegistry,
                                          set_default_registry)
    from repro_torch.serve import ServeEngine

    out = {}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls must be off for the float32 comparisons")
    # (a) full width, drawn on the card
    cfg = get_config(LLM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.dtype, cfg.param_count())
          == (32, 4096, 32, 8, 14336, 128256, "bfloat16", 8_030_257_152),
          f"the llama3-8b config changed: {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    weight_bytes = sum(p.numel() * p.element_size() for p in params)
    # the tree also holds the final norm's scales, which param_count omits
    check(n_params == cfg.param_count() + cfg.d_model
          and all(p.dtype == torch.bfloat16 and p.device.type == "cuda"
                  for p in params), f"{n_params} parameters")
    out["params"], out["weight_bytes"] = n_params, weight_bytes
    out["init_max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  llama3-8b at full width: {n_params:,} parameters "
          f"({cfg.param_count():,} by param_count, + the final norm's "
          f"{cfg.d_model}), {weight_bytes / 1e9:.2f} GB of bf16, drawn on "
          f"the card in {out['init_s']:.2f} s; "
          f"torch.cuda.max_memory_allocated {out['init_max_memory_gb']:.2f}"
          " GB")

    # (b) the launcher's default traffic, then one request at T = 0.8
    def launch(extra):
        reg = MetricsRegistry()
        prev = set_default_registry(reg)
        try:
            reqs = lm_launch.run(["--arch", LLM_ARCH] + extra, model=model)
        finally:
            set_default_registry(prev)
        return reqs, reg.histogram("launch.serve_batch_ms").summary()["max"]

    reqs, serve_ms = launch([])
    check(len(reqs) == 6 and all(
        r.done and len(r.output) == 16 and 5 <= len(r.prompt) <= 8
        for r in reqs), "the launcher's traffic: a request not done")
    engine = ServeEngine(cfg, model, max_len=LLM_MAX_LEN)
    for r in reqs:
        check(engine.generate(r.prompt, r.max_new_tokens) == r.output,
              f"request {r.uid}: serve and generate disagree")
    tokens = sum(len(r.output) for r in reqs)
    out["serve"] = {"requests": len(reqs), "tokens": tokens,
                    "ms": serve_ms, "tokens_per_s": tokens / serve_ms * 1e3}
    hot, hot_ms = launch(["--requests", "1", "--temperature", "0.8"])
    check(len(hot) == 1 and hot[0].done and len(hot[0].output) == 16
          and all(0 <= t < cfg.vocab_size for t in hot[0].output),
          "the T = 0.8 request")
    out["sampled_ms"] = hot_ms
    print(f"  the launcher's traffic (6 requests, prompts of 5-8 tokens, 3 "
          f"slots, 16 new tokens, max_len {LLM_MAX_LEN}, greedy): "
          f"{tokens} tokens in {serve_ms:.1f} ms "
          f"({out['serve']['tokens_per_s']:.1f} tokens/s); serve == "
          f"generate for every request; one request at T = 0.8: 16 tokens "
          f"in the vocabulary ({hot_ms:.1f} ms)")

    # decode against forward over the prompt plus the generated prefix
    r = reqs[0]
    prompt = torch.as_tensor(r.prompt, dtype=torch.long, device=dev)
    logits, cache = M.prefill(model, {"tokens": prompt[None]}, cfg,
                              LLM_MAX_LEN)
    steps = [logits[0]]
    for t in r.output[:-1]:
        logits, cache = M.decode_step(
            model, {"tokens": torch.tensor([[t]], device=dev)}, cache, cfg)
        steps.append(logits[0])
    decoded = torch.stack(steps)                         # (16, V)
    seq = torch.cat([prompt, torch.tensor(r.output[:-1], device=dev)])
    fwd, _ = M.forward(model, {"tokens": seq[None]}, cfg)
    fwd = fwd[0, len(r.prompt) - 1:]
    check(bool(torch.isfinite(decoded).all() and torch.isfinite(fwd).all()),
          "non-finite logits at full width")
    diff = float((decoded - fwd).abs().max())
    check(diff <= LLM_BF16_ATOL, f"decode vs forward: max|diff| {diff:.4f} "
          f"over the bf16 tolerance {LLM_BF16_ATOL}")
    top2 = fwd.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * diff
    want = fwd.argmax(-1).tolist()
    for i in range(len(r.output)):
        check(not bool(decided[i]) or r.output[i] == want[i],
              f"token {i}: greedy {r.output[i]}, forward's argmax "
              f"{want[i]} with a top-2 gap over 2 x {diff:.4f}")
    out["decode_vs_forward"] = {
        "max_abs_diff": diff, "atol": LLM_BF16_ATOL,
        "logit_scale": float(fwd.abs().max()),
        "checked": int(decided.sum()), "skipped": int((~decided).sum()),
        "positions": len(r.output)}
    dvf = out["decode_vs_forward"]
    print(f"  decode vs forward over request 0 ({dvf['positions']} "
          f"positions): max|diff| {diff:.4f} of logits up to "
          f"{dvf['logit_scale']:.2f} (bf16 tolerance {LLM_BF16_ATOL}); "
          f"greedy == forward's argmax at the {dvf['checked']} positions "
          f"with a top-2 gap over 2 x max|diff|, {dvf['skipped']} "
          f"positions skipped")

    # (c) times: prefill of request 0's prompt, then decode steps at one
    # slot, each between two CUDA events (the host's issue time included)
    out["prefill"] = event_times(
        torch, lambda: M.prefill(model, {"tokens": prompt[None]}, cfg,
                                 LLM_MAX_LEN), LLM_TIMED_PREFILLS)
    out["prefill"]["tokens"] = len(r.prompt)
    _, cache = M.prefill(model, {"tokens": prompt[None]}, cfg, LLM_MAX_LEN)
    tok = torch.tensor([[r.output[0]]], device=dev)
    for _ in range(3):                                   # warm-up
        M.decode_step(model, {"tokens": tok}, cache, cfg)
    out["decode"] = event_times(
        torch, lambda: M.decode_step(model, {"tokens": tok}, cache, cfg),
        LLM_TIMED_DECODES)
    out["profiled_step"] = profile_once(
        torch, lambda: M.decode_step(model, {"tokens": tok}, cache, cfg))
    fill = int(cache["len"])
    # the byte bound of a step: every parameter but the embedding table
    # read once, plus the K / V of the filled positions; as ported, the
    # head's f32 copy is written and read once more (layers.lm_head)
    stream_bytes = weight_bytes - model["embed"]["table"].numel() * 2
    kv_bytes = 2 * cfg.n_layers * fill * cfg.n_kv_heads * cfg.head_dim * 2
    upcast_bytes = 2 * model["head"]["kernel"].numel() * 4
    out["bound"] = {
        "weights_gb": stream_bytes / 1e9, "kv_gb": kv_bytes / 1e9,
        "head_upcast_gb": upcast_bytes / 1e9,
        "weights_ms": stream_bytes / HBM_BYTES_PER_S * 1e3,
        "kv_ms": kv_bytes / HBM_BYTES_PER_S * 1e3,
        "as_ported_ms": (stream_bytes + kv_bytes + upcast_bytes)
        / HBM_BYTES_PER_S * 1e3}
    b, p = out["bound"], out["profiled_step"]
    print(f"  times on {card}: prefill of {len(r.prompt)} tokens "
          f"{out['prefill']['median_ms']:.3f} ms [min "
          f"{out['prefill']['min_ms']:.3f}, max {out['prefill']['max_ms']:.3f}"
          f"] (median of {LLM_TIMED_PREFILLS}); decode at one slot "
          f"{out['decode']['median_ms']:.3f} ms per step [min "
          f"{out['decode']['min_ms']:.3f}, max {out['decode']['max_ms']:.3f}]"
          f" (CUDA events, median of {LLM_TIMED_DECODES}); serve "
          f"{out['serve']['tokens_per_s']:.1f} tokens/s")
    print(f"  one decode step under torch.profiler on {card}: "
          + (f"{p['kernels']} kernels, {p['device_busy_ms']:.3f} ms of "
             f"device time in {p['wall_ms']:.3f} ms of wall (device busy "
             f"{100 * p['device_share']:.1f} %; the profiler's own cost "
             "is in the wall)" + "".join(
                 f"; {r['launches']} x {kernel_label(r['kernel'])} "
                 f"{r['us']:.1f} us" for r in p["top_kernels"])
             if p["kernels"] else
             "device time not measured (the profiler recorded no device "
             "events)")
          + f"; byte bound: {b['weights_gb']:.2f} GB of weights at 3.35 "
          f"TB/s {b['weights_ms']:.2f} ms + the K / V of {fill} positions "
          f"{b['kv_ms']:.4f} ms; with the head's f32 upcast as ported "
          f"(+{b['head_upcast_gb']:.2f} GB) {b['as_ported_ms']:.2f} ms")
    del model, engine, cache, params, decoded, fwd, logits
    torch.cuda.empty_cache()

    # (d) every architecture's smoke config, card against CPU
    out["smoke_vs_cpu"] = {arch: lm_smoke_vs_cpu(np, torch, dev, arch)
                           for arch in ARCH_IDS}
    worst = {k: max(e.get(k, 0.0) for e in out["smoke_vs_cpu"].values())
             for k in LLM_F32_TOL}
    print(f"  the {len(ARCH_IDS)} smoke configs in float32, card vs CPU "
          f"(forward, prefill, {LLM_SMOKE_DECODES} decode steps; TF32 off):"
          f" largest max|diff| logits {worst['logits']:.2e}, K / V "
          f"{worst['kv']:.2e}, SSM / conv states {worst['state']:.2e} "
          f"(tolerances {LLM_F32_TOL})")

    # (e) the example in its own process
    t0 = time.perf_counter()
    ex = subprocess.run([sys.executable,
                         str(ROOT / "examples" / "torch_serve_lm.py")],
                        capture_output=True, text=True, timeout=600,
                        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)})
    check(ex.returncode == 0 and ex.stdout.rstrip().endswith(
        "serve_lm: OK"), f"torch_serve_lm.py exited {ex.returncode}: "
        f"{ex.stdout[-2000:]} {ex.stderr[-2000:]}")
    out["example_s"] = time.perf_counter() - t0
    print(f"  examples/torch_serve_lm.py on the card: serve_lm: OK "
          f"({out['example_s']:.2f} s)")
    return out


def train_smoke_batch(np, torch, cfg, dev) -> dict:
    """make_batch's inputs at TRAIN_SMOKE_SHAPE from numpy seed 0 (its
    own stream is seeded by a per-process str hash)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import batch_shapes
    rng = np.random.default_rng(0)
    out = {}
    shape = ShapeConfig("t", TRAIN_SMOKE_SHAPE[1], TRAIN_SMOKE_SHAPE[0],
                        "train")
    for name, (dims, dtype) in batch_shapes(cfg, shape).items():
        a = (rng.integers(0, cfg.vocab_size, dims, dtype=np.int32)
             if dtype == torch.int32 else
             rng.standard_normal(dims).astype(np.float32))
        out[name] = torch.from_numpy(a).to(dev)
    return out


def grad_share(torch, got, want) -> float:
    """The largest leaf's max|got - want| over its max|want|."""
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want, strict=True))


def train_smoke_vs_cpu(np, torch, dev, arch: str) -> dict:
    """One smoke config's gradients (loss_fn + backward) and one
    train_step on the card and on the CPU from the same weights and
    batch; the gradients of a second backward on the card against the
    first, bit for bit or not.  Returns the differences."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   loss_fn, make_train_state, train_step)

    cfg = get_smoke_config(arch)
    got = {}
    for side, where in (("cpu", "cpu"), ("card", dev)):
        model, _ = make_train_state(cfg, 0, device="cpu")
        model = model.to(where)
        batch = train_smoke_batch(np, torch, cfg, where)
        grads = []
        for _ in range(2 if side == "card" else 1):
            for p in model.parameters():
                p.grad = None
            total, _ = loss_fn(model, batch, cfg)
            total.backward()
            grads.append([p.grad.detach().cpu() for p in model.parameters()])
        _, _, m = train_step(model, init_opt_state(model), batch, cfg,
                             OptimizerConfig(warmup_steps=2, total_steps=10))
        got[side] = (float(m["loss"]), float(m["grad_norm"]), grads)
    (hl, hn, hg), (dl, dn, dg) = got["cpu"], got["card"]
    out = {"loss_rel": abs(dl - hl) / abs(hl),
           "grad_norm_rel": abs(dn - hn) / abs(hn),
           "grad_share": grad_share(torch, dg[0], hg[0]),
           "repeat_bit_equal": all(torch.equal(a, b)
                                   for a, b in zip(dg[0], dg[1]))}
    check(all(bool(torch.isfinite(g).all()) for g in dg[0]),
          f"{arch}: non-finite gradients on the card")
    check(out["loss_rel"] <= TRAIN_LOSS_RTOL, f"{arch}: loss card {dl} vs "
          f"CPU {hl}")
    check(out["grad_norm_rel"] <= TRAIN_NORM_RTOL, f"{arch}: gradient norm "
          f"card {dn} vs CPU {hn}")
    check(out["grad_share"] <= TRAIN_GRAD_SHARE, f"{arch}: a gradient leaf "
          f"off by {out['grad_share']:.2e} of its largest value")
    return out


def train_phase(np, torch, dev, card) -> dict:
    """Phase 3j: the LM training path.  (a) the ten smoke configs' train
    step on the card against the CPU, and each backward repeated on the
    card (bit-equal or not); (b) internlm2-1.8b at its full published
    width and depth through ``repro_torch.launch.train.run``
    (``TRAIN_*``: train_4k's sequence, microbatch 1, the config's own
    "full" remat and bf16 activations over float32 master weights): every
    step's loss and gradient norm finite, step 1's loss against a no_grad
    forward, "full" remat against "none" at ``TRAIN_REMAT_SEQ``, the step
    times (CUDA events), tokens/s, the model-FLOPs share, peak memory and
    one profiled step; (c) the smoke-size fault drill through the
    launcher on the card, bit-equal to an uninterrupted run; (d)
    ``examples/torch_train_lm.py --large`` in its own process."""
    import dataclasses
    import tempfile

    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import train as train_launch
    from repro_torch.models import model as M
    from repro_torch.train import (OptimizerConfig, checkpoint as ckpt,
                                   init_opt_state, loss_fn, make_train_state)
    from repro_torch.train.train_step import _split_microbatches

    out = {}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls must be off for the float32 comparisons")
    # (a) the smoke configs, card against CPU
    out["smoke_vs_cpu"] = {arch: train_smoke_vs_cpu(np, torch, dev, arch)
                           for arch in ARCH_IDS}
    sv = out["smoke_vs_cpu"]
    varies = [a for a, e in sv.items() if not e["repeat_bit_equal"]]
    out["smoke_repeat_not_bit_equal"] = varies
    print(f"  the {len(ARCH_IDS)} smoke configs' train step, card vs CPU "
          f"(float32, TF32 off): largest loss rel diff "
          f"{max(e['loss_rel'] for e in sv.values()):.2e}, gradient norm "
          f"{max(e['grad_norm_rel'] for e in sv.values()):.2e}, gradient "
          f"leaf {max(e['grad_share'] for e in sv.values()):.2e} of its "
          f"largest value (tolerances {TRAIN_LOSS_RTOL}, {TRAIN_NORM_RTOL},"
          f" {TRAIN_GRAD_SHARE}); a repeated backward on the card is "
          + ("bit-equal for all ten" if not varies else
             f"not bit-equal for {varies}"))

    # (b) full width
    cfg = get_config(TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.dtype, cfg.remat_policy)
          == (24, 2048, 16, 8, 8192, 92544, "bfloat16", "full"),
          f"the {TRAIN_ARCH} config changed: {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, trainable=True)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    check(all(p.dtype == torch.float32 and p.requires_grad
              and p.device.type == dev.type for p in params),
          "the master copy is not trainable float32 on the card")
    out["params"] = n_params
    seq, batch, accum, steps = TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS
    tokens = seq * batch

    # step 1's batch, as the launcher's iterator will make it in this
    # process, through a no_grad forward: the loss step 1 must report
    first = make_batch(cfg, ShapeConfig("cli", seq, batch, "train"), 0,
                       device=dev)
    with torch.no_grad():
        fwd_loss = sum(float(loss_fn(model, mb, cfg)[1]["loss"])
                       for mb in _split_microbatches(first, accum)) / accum
    del first

    # "full" remat against "none" at a sequence "none" fits
    short = make_batch(cfg, ShapeConfig("t", TRAIN_REMAT_SEQ, batch,
                                        "train"), 0, device=dev)
    remat_grads = {}
    for policy in ("full", "none"):
        for p in params:
            p.grad = None
        total, _ = loss_fn(model, short,
                           dataclasses.replace(cfg, remat_policy=policy))
        total.backward()
        remat_grads[policy] = [p.grad for p in params]
    for p in params:
        p.grad = None
    share = grad_share(torch, remat_grads["full"], remat_grads["none"])
    bit_equal = all(torch.equal(a, b) for a, b in
                    zip(remat_grads["full"], remat_grads["none"]))
    del remat_grads, short, total
    check(share <= TRAIN_GRAD_SHARE, f"full remat vs none: a leaf off by "
          f"{share:.2e} of its largest gradient")
    out["remat_full_vs_none"] = {"seq": TRAIN_REMAT_SEQ, "grad_share": share,
                                 "bit_equal": bit_equal}

    # the launcher's run, each train_step between two CUDA events
    timed = []
    inner = train_launch.train_step

    def timed_step(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = inner(*a, **kw)
        end.record()
        timed.append((start, end, res[2]))
        return res

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train_launch.train_step = timed_step
    try:
        t0 = time.perf_counter()
        res = train_launch.run([
            "--arch", TRAIN_ARCH, "--steps", str(steps), "--batch",
            str(batch), "--seq", str(seq), "--accum", str(accum),
            "--log-every", "1", "--device", str(dev)], model=model)
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
    finally:
        train_launch.train_step = inner
    out["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(len(timed) == steps, f"{len(timed)} steps timed")
    history = [{k: float(v) for k, v in m.items()} for _, _, m in timed]
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in history), f"a non-finite step: {history}")
    check(res["final_loss"] == history[-1]["loss"], "final_loss")
    diff = abs(history[0]["loss"] - fwd_loss)
    check(diff <= TRAIN_BF16_ATOL, f"step 1's loss {history[0]['loss']} vs "
          f"the no_grad forward's {fwd_loss}")
    ms = [s.elapsed_time(e) for s, e, _ in timed]
    later = ms[1:]
    step_ms = statistics.median(later)
    # model FLOPs per token: 6 per parameter in a product (all but the
    # embedding table, a gather), plus attention's 12 * L * H * hd * S
    # (PaLM's count: QK^T and PV, forward and backward, unmasked)
    n_matmul = n_params - model["embed"]["table"].numel()
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq
    flops = (6 * n_matmul + attn) * tokens
    out.update({
        "history": history, "first_loss_vs_forward": {
            "step1": history[0]["loss"], "forward": fwd_loss, "diff": diff,
            "atol": TRAIN_BF16_ATOL},
        "step_ms": {"median": step_ms, "min": min(later), "max": max(later),
                    "first": ms[0], "all": ms},
        "tokens_per_step": tokens, "tokens_per_s": tokens / step_ms * 1e3,
        "model_flops_per_step": flops,
        "mfu": flops / (step_ms / 1e3) / BF16_OPS_PER_S})

    # one profiled step on the same model, a fresh optimizer state
    opt = init_opt_state(model, "int8_ef")
    later_batch = make_batch(cfg, ShapeConfig("cli", seq, batch, "train"),
                             steps, device=dev)
    ocfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=steps)
    out["profiled_step"] = profile_once(torch, lambda: inner(
        model, opt, later_batch, cfg, ocfg, accum))
    del model, opt, later_batch, params
    torch.cuda.empty_cache()
    p = out["profiled_step"]
    print(f"  {TRAIN_ARCH} at full width: {n_params:,} parameters (float32 "
          f"master copy, bf16 activations, '{cfg.remat_policy}' remat), "
          f"drawn on the card in {out['init_s']:.2f} s; the launcher's "
          f"{steps} steps of {batch} x {seq} tokens ({accum} microbatches): "
          "losses " + ", ".join(f"{h['loss']:.4f}" for h in history)
          + "; gradient norms " + ", ".join(f"{h['grad_norm']:.3f}"
                                            for h in history))
    print(f"  step 1's loss {history[0]['loss']:.6f} vs a no_grad forward's "
          f"{fwd_loss:.6f} (|diff| {diff:.2e}, tolerance {TRAIN_BF16_ATOL});"
          f" 'full' remat vs 'none' at seq {TRAIN_REMAT_SEQ}: largest leaf "
          f"diff {share:.2e} of its largest gradient"
          + (" (bit-equal)" if bit_equal else ""))
    print(f"  times on {card}: a step {step_ms:.1f} ms (CUDA events, median "
          f"of steps 2-{steps}) [min {min(later):.1f}, max {max(later):.1f}];"
          f" step 1 {ms[0]:.1f} ms; {out['tokens_per_s']:,.0f} tokens/s; "
          f"model-FLOPs share {100 * out['mfu']:.2f} % of 989 TFLOP/s bf16 "
          f"({flops:.3e} FLOP a step); torch.cuda.max_memory_allocated "
          f"{out['max_memory_gb']:.2f} GB")
    print(f"  one train step under torch.profiler on {card}: "
          + (f"{p['kernels']} kernels, {p['device_busy_ms']:.1f} ms of "
             f"device time in {p['wall_ms']:.1f} ms of wall (device busy "
             f"{100 * p['device_share']:.1f} %)" + "".join(
                 f"; {r['launches']} x {kernel_label(r['kernel'])} "
                 f"{r['us'] / 1e3:.1f} ms" for r in p["top_kernels"])
             if p["kernels"] else
             "device time not measured (the profiler recorded no device "
             "events)"))

    # (c) the fault drill at smoke size, on the card
    drill = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "6",
             "--ckpt-every", "3", "--device", str(dev)]
    with tempfile.TemporaryDirectory() as tmp:
        crashed, whole = os.path.join(tmp, "drill"), os.path.join(tmp, "ref")
        try:
            train_launch.run(drill + ["--ckpt-dir", crashed, "--fail-at",
                                      "3"])
        except RuntimeError as e:
            if str(e) != "injected failure at step 3":
                raise
        else:
            check(False, "--fail-at 3 did not fail")
        resumed = train_launch.run(drill + ["--ckpt-dir", crashed,
                                            "--resume"])
        ref = train_launch.run(drill + ["--ckpt-dir", whole])
        like = dict(zip(("params", "opt"), make_train_state(
            get_smoke_config(TRAIN_ARCH), 1, device=dev)))
        a, sa, _ = ckpt.restore(crashed, like, device=dev)
        b, sb, _ = ckpt.restore(whole, like, device=dev)
        check(sa == sb == 6 and resumed == ref and all(
            torch.equal(x, y) for x, y in zip(a["params"].parameters(),
                                              b["params"].parameters())),
            "the resumed run's parameters differ from the uninterrupted "
            "run's")
    out["fault_drill"] = {"final_loss": resumed["final_loss"],
                          "bit_equal": True}
    print(f"  the fault drill on the card ({TRAIN_ARCH} smoke, --fail-at 3 "
          "then --resume, 6 steps): the final parameters bit-equal to an "
          f"uninterrupted run's (final loss {resumed['final_loss']:.4f})")

    # (d) the example in its own process
    t0 = time.perf_counter()
    ex = subprocess.run([sys.executable,
                         str(ROOT / "examples" / "torch_train_lm.py"),
                         "--large"],
                        capture_output=True, text=True, timeout=600,
                        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)})
    check(ex.returncode == 0 and ex.stdout.rstrip().endswith(
        "train_lm: OK"), f"torch_train_lm.py --large exited "
        f"{ex.returncode}: {ex.stdout[-2000:]} {ex.stderr[-2000:]}")
    out["example_s"] = time.perf_counter() - t0
    final = [line for line in ex.stdout.splitlines()
             if line.startswith("final loss")]
    out["example_final"] = final[-1] if final else None
    print(f"  examples/torch_train_lm.py --large on the card: train_lm: OK "
          f"({out['example_final']}; {out['example_s']:.2f} s)")
    return out


def moe_smoke_on_mesh(np, torch, dev, arch: str, shape, rules: str) -> dict:
    """moe_ep of one MoE smoke config (weights and an (8, 16, D) x from
    numpy seed 0) on a mesh whose every position is the card, against the
    same mesh on the CPU: the output, the aux loss, the dropped fraction
    and the gradients of sum(y**2) + aux w.r.t. every weight and x, within
    the CPU-vs-JAX tolerances of tests/test_torch_moe_ep.py; a repeated
    forward and backward on the card, bit-equal or not."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe, moe_ep
    from repro_torch.sharding import partition as P_

    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(0)
    params = {k: (rng.standard_normal(s.shape) * s.std()).astype(np.float32)
              for k, s in moe.moe_specs(cfg).items()}
    x = rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32)
    got = {}
    for name, where in (("cpu", torch.device("cpu")), ("card", dev),
                        ("again", dev)):
        mesh = make_mesh(shape, ("data", "model"),
                         [where] * (shape[0] * shape[1]))
        tp = {k: torch.tensor(v, device=where, requires_grad=True)
              for k, v in params.items()}
        tx = torch.tensor(x, device=where, requires_grad=True)
        with P_.use_mesh(mesh, getattr(P_, rules)):
            y, aux = moe_ep.moe_ep(tp, tx, cfg)
        ((y ** 2).sum() + aux["aux_loss"]).backward()
        got[name] = ([y.detach()] + [tp[k].grad for k in sorted(tp)]
                     + [tx.grad], float(aux["aux_loss"].detach()),
                     float(aux["dropped_frac"]))
    (host, haux, hdrop), (card, daux, ddrop) = got["cpu"], got["card"]
    y_excess = float(((card[0].cpu() - host[0]).abs()
                      - MESH_Y_RTOL * host[0].abs()).max()
                     / host[0].abs().max())
    share = grad_share(torch, [g.cpu() for g in card[1:]], host[1:])
    out = {"y_excess_share": y_excess, "aux_rel": abs(daux - haux) / haux,
           "dropped": ddrop, "grad_share": share,
           "repeat_bit_equal": all(torch.equal(a, b) for a, b in
                                   zip(card, got["again"][0]))
           and got["again"][1:] == (daux, ddrop)}
    what = f"moe_ep {arch} on {shape[0]} x {shape[1]} ({rules})"
    check(y_excess <= MESH_Y_ATOL_SHARE, f"{what}: the output beyond rtol "
          f"{MESH_Y_RTOL} by {y_excess:.2e} of its largest value")
    check(out["aux_rel"] <= MESH_AUX_RTOL, f"{what}: aux {daux} vs {haux}")
    check(ddrop == hdrop, f"{what}: dropped {ddrop} vs {hdrop}")
    check(share <= MESH_GRAD_SHARE, f"{what}: a gradient off by "
          f"{share:.2e} of its largest value")
    return out


def moe_layer_on_mesh(torch, dev, mesh, cfg, x_dtype: str) -> dict:
    """One MoE layer of ``cfg`` (float32 master weights from the package's
    init, seed 1; x of ``MESH_LAYER_SHAPE`` tokens in ``x_dtype``) through
    ``moe`` under ``mesh`` with the training rules and through
    ``moe_reference``: the outputs, the aux loss against the mean of the
    data shards' (per-shard ``moe_reference``), and the gradients of
    mean(y**2) (the two aux losses differ by design), held to
    ``MESH_LAYER_TOL[x_dtype]``."""
    from repro_torch.core import fabric_matvec as fm
    from repro_torch.models import moe
    from repro_torch.sharding import partition as P_

    tol = MESH_LAYER_TOL[x_dtype]
    gen = torch.Generator(device=dev).manual_seed(1)
    weights = {k: s.materialize(gen, torch.float32, dev)
               for k, s in moe.moe_specs(cfg).items()}
    x = torch.randn(MESH_LAYER_SHAPE + (cfg.d_model,), generator=gen,
                    device=dev).to(getattr(torch, tol["dtype"]))
    res = {}
    torch.cuda.reset_peak_memory_stats()
    for path in ("ep", "reference"):
        wp = {k: v.clone().requires_grad_() for k, v in weights.items()}
        xp = x.clone().requires_grad_()
        if path == "ep":
            fm.reset_counts()
            with P_.use_mesh(mesh, P_.DEFAULT_RULES):
                y, aux = moe.moe(wp, xp, cfg)
            coll = {k: {"calls": n, "bytes": fm.collective_bytes[k]}
                    for k, n in fm.collectives.items()}
        else:
            y, aux = moe.moe_reference(wp, xp, cfg)
        (y.float() ** 2).mean().backward()
        res[path] = (y.detach().float(), float(aux["aux_loss"].detach()),
                     float(aux["dropped_frac"]),
                     [wp[k].grad for k in sorted(wp)], xp.grad.float())
        del wp, xp, y, aux
    peak = torch.cuda.max_memory_allocated() / 1e9
    (ye, ae, de, gwe, gxe), (yr, ar, dr, gwr, gxr) = (res["ep"],
                                                      res["reference"])
    with torch.no_grad():
        shard_aux = statistics.fmean(
            float(moe.moe_reference(weights, xs, cfg)[1]["aux_loss"])
            for xs in x.chunk(mesh.shape["data"]))
    yd = (ye - yr).abs()
    scale = float(yr.abs().max())
    out = {"x": list(x.shape), "y_max_abs_diff": float(yd.max()),
           "y_scale": scale,
           "y_excess_share": float((yd - tol["y_rtol"] * yr.abs()).max())
           / scale,
           "y_equal_share": float((yd == 0).float().mean()),
           "aux": ae, "aux_reference": ar, "aux_shard_mean": shard_aux,
           "dropped": [de, dr],
           "weight_grad_share": grad_share(torch, gwe, gwr),
           "x_grad_share": grad_share(torch, [gxe], [gxr]),
           "collectives": coll, "max_memory_gb": peak}
    what = f"the full-width layer, x in {x_dtype}"
    check(de == dr == 0.0, f"{what}: dropped {de} / {dr}")
    check(out["y_excess_share"] <= tol["y_atol_share"], f"{what}: moe_ep's "
          f"output beyond rtol {tol['y_rtol']} by {out['y_excess_share']:.2e}"
          " of its largest value")
    check(abs(ae - shard_aux) <= MESH_LAYER_AUX_RTOL * shard_aux,
          f"{what}: aux {ae} vs the data shards' mean {shard_aux}")
    check(out["weight_grad_share"] <= tol["w_share"]
          and out["x_grad_share"] <= tol["x_share"], f"{what}: gradients "
          f"off by {out['weight_grad_share']:.2e} (weights) and "
          f"{out['x_grad_share']:.2e} (x) of their largest values")
    return out


def mesh_lm_phase(np, torch, dev, card) -> dict:
    """Phase 3k: the LM stack on the mesh, every position on the one card
    (a mesh of one card runs the real schedule and measures its host
    cost; it speeds nothing up).  (a) ``moe_ep`` of the MoE smoke configs
    on 2 x 4 and 1 x 4 meshes of the card under the training and the
    inference rules against the same meshes on the CPU
    (``moe_smoke_on_mesh``); (b) olmoe-1b-7b at its full published width
    and depth in bf16, served the JAX serve launcher's traffic under
    ``use_mesh(1 x 4, INFERENCE_RULES)`` and again without a mesh: every
    MoE layer of each prompt's no-mesh prefill and first decode step given
    its own input again through ``moe_ep`` on the mesh, within one bf16
    step (teacher-forced); end to end, the logits on 1 x 4, 1 x 2 and no
    mesh and the step at which greedy tokens first part (reported, not
    gated: random weights with the reference's init amplify a one-step
    rounding difference over 16 layers); decode times with and without
    the mesh, one profiled step each and the collectives of a step; (c) one olmoe MoE layer
    at full width under the training rules on 2 x 4 (x of 2 x 4096 tokens
    in bf16, float32 master weights, capacity_factor 8) against
    ``moe_reference``: the output, the aux loss against the mean of the
    data shards' and the gradients of mean(y**2); (d) olmoe-1b-7b at full width and
    ``MESH_TRAIN_LAYERS`` layers, ``train_step`` under a 2 x 4 mesh of the
    default rules for ``MESH_TRAIN_STEPS`` steps of 2 x 4096 tokens: losses
    and norms finite, step times, peak memory and collectives per step;
    (e) the train launcher at smoke size on 4 positions of the card
    against 4 of the CPU, the same loss lines."""
    import contextlib
    import io

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import fabric_matvec as fm
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe, moe_ep
    from repro_torch.sharding import partition as P_
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_state, train_step)

    out = {}
    # the mesh names the card by index, as its tensors report it
    cdev = (torch.device("cuda", torch.cuda.current_device())
            if dev.type == "cuda" else dev)

    def mesh(shape, where=cdev):
        return make_mesh(shape, ("data", "model"),
                         [where] * (shape[0] * shape[1]))

    def counted(fn):
        """fn's collectives by kind: calls and bytes."""
        fm.reset_counts()
        res = fn()
        return res, {k: {"calls": n, "bytes": fm.collective_bytes[k]}
                     for k, n in fm.collectives.items()}

    # (a) the smoke configs, card mesh against CPU mesh
    out["smoke"] = {f"{a} {s[0]}x{s[1]} {r}": moe_smoke_on_mesh(
        np, torch, cdev, a, s, r) for a in MESH_SMOKE_ARCHS
        for s in MESH_SMOKE_MESHES for r in MESH_SMOKE_RULES}
    sm = out["smoke"].values()
    varies = [k for k, e in out["smoke"].items() if not e["repeat_bit_equal"]]
    print(f"  moe_ep of {', '.join(MESH_SMOKE_ARCHS)} (smoke) on 2 x 4 and "
          f"1 x 4 meshes of the card, training and inference rules, vs the "
          f"same meshes on the CPU: output beyond rtol {MESH_Y_RTOL} by "
          f"{max(e['y_excess_share'] for e in sm):.2e} of its largest value"
          f", aux rel {max(e['aux_rel'] for e in sm):.2e}, gradient leaf "
          f"{max(e['grad_share'] for e in sm):.2e} of its largest value "
          f"(tolerances {MESH_Y_ATOL_SHARE}, {MESH_AUX_RTOL}, "
          f"{MESH_GRAD_SHARE}), dropped fractions equal (largest "
          f"{max(e['dropped'] for e in sm):.4f}); a repeated forward and "
          "backward on the card is "
          + ("bit-equal in all eight" if not varies
             else f"not bit-equal in {varies}"))

    # (b) olmoe-1b-7b served at full width, on the 1 x 4 mesh and without
    cfg = get_config(MESH_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size, cfg.n_experts, cfg.experts_per_token,
           cfg.dtype, cfg.param_count())
          == (16, 2048, 16, 16, 1024, 50304, 64, 8, "bfloat16",
              6_919_094_272), f"the {MESH_ARCH} config changed: {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    params = list(model.parameters())
    out["serve_params"] = sum(p.numel() for p in params)
    out["serve_weight_gb"] = sum(p.numel() * p.element_size()
                                 for p in params) / 1e9
    serve_meshes = {s: mesh(s) for s in MESH_SERVE_SHAPES}

    def under(shape, fn):
        """fn under the mesh of that shape (inference rules), or none."""
        ctx = (P_.use_mesh(serve_meshes[shape], P_.INFERENCE_RULES)
               if shape else contextlib.nullcontext())
        with ctx:
            return fn()

    served, serve_ms, peak = {}, {}, {}
    for on in (True, False):
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            served[on] = under(on and MESH_SERVE_SHAPE, lambda: serve_launch.run(
                ["--arch", MESH_ARCH, "--device", str(dev)], model=model))
            serve_ms[on] = (time.perf_counter() - t0) * 1e3
        peak[on] = torch.cuda.max_memory_allocated() / 1e9
        check(len(served[on]) == 6 and all(
            r.done and len(r.output) == 16 for r in served[on]),
            "the launcher's traffic: a request not done")
    parted = []
    for a, b in zip(served[True], served[False]):
        first = next((i for i, (u, v) in enumerate(zip(a.output, b.output))
                      if u != v), None)
        parted.append(first)
    # every request's prompt: the prefill logits and the first decode
    # step's (on the no-mesh run's first token) without a mesh and on the
    # 1 x 4 and 1 x 2 meshes (two groupings of the combine's sum), each MoE
    # call of the no-mesh passes recorded with its input and output
    calls, logits = [], {s: [] for s in (None,) + MESH_SERVE_SHAPES}
    plain_moe = moe.moe

    def recording(p, x, c):
        y, aux = plain_moe(p, x, c)
        calls.append((p, x, y))
        return y, aux

    for r in served[False]:
        prompt = torch.as_tensor(r.prompt, dtype=torch.long,
                                 device=dev)[None]
        tok = torch.tensor([[r.output[0]]], device=dev)
        for shape in logits:
            if shape is None:
                moe.moe = recording
            try:
                pl, cache = under(shape, lambda: M.prefill(
                    model, {"tokens": prompt}, cfg, MESH_MAX_LEN))
                dl, _ = under(shape, lambda: M.decode_step(
                    model, {"tokens": tok}, cache, cfg))
            finally:
                moe.moe = plain_moe
            check(bool(torch.isfinite(pl).all() and torch.isfinite(dl).all()),
                  f"request {r.uid}: non-finite logits on {shape}")
            logits[shape].append((pl.float(), dl.float()))
    del cache

    def apart(a, b, i):
        """Per request, max|diff| of prefill (i = 0) or decode (1) logits."""
        return [float((u[i] - v[i]).abs().max())
                for u, v in zip(logits[a], logits[b])]

    one, two = MESH_SERVE_SHAPES
    def label(s):
        return f"{s[0]} x {s[1]}" if s else "no mesh"

    ends = {f"{label(x)} vs {label(y)}": {"prefill": apart(x, y, 0),
                                          "decode": apart(x, y, 1)}
            for x, y in ((one, None), (two, None), (one, two))}
    scale = max(float(u[0].abs().max()) for u in logits[None])
    del logits
    # the same layers on the model's own activations (teacher-forced):
    # each recorded MoE input through moe_ep on the serving mesh, within
    # one bf16 step of the no-mesh output (MESH_LAYER_TOL["bfloat16"])
    tol = MESH_LAYER_TOL["bfloat16"]
    worst, equal, elems = 0.0, 0, 0
    with P_.use_mesh(serve_meshes[MESH_SERVE_SHAPE], P_.INFERENCE_RULES):
        for p, x, y in calls:
            ye = moe_ep.moe_ep(p, x, cfg)[0].float()
            y = y.float()
            d = (ye - y).abs()
            worst = max(worst, float((d - tol["y_rtol"] * y.abs()).max())
                        / float(y.abs().max()))
            equal += int((d == 0).sum())
            elems += d.numel()
    check(worst <= tol["y_atol_share"], f"olmoe's MoE layers on their own "
          f"activations: moe_ep on the mesh beyond rtol {tol['y_rtol']} of "
          f"the no-mesh output by {worst:.2e} of its largest value")
    layers = {"calls": len(calls), "excess_share": worst,
              "bit_equal_share": equal / elems}
    del calls
    r0 = served[False][0]
    prompt = torch.as_tensor(r0.prompt, dtype=torch.long, device=dev)[None]
    # decode times at one slot on request 0's prefilled cache, and one
    # step under torch.profiler
    times, coll, profiled = {}, {}, {}
    for on in (True, False):
        shape = on and MESH_SERVE_SHAPE
        _, cache = under(shape, lambda: M.prefill(
            model, {"tokens": prompt}, cfg, MESH_MAX_LEN))
        tok = torch.tensor([[r0.output[0]]], device=dev)

        def step():
            return under(shape, lambda: M.decode_step(
                model, {"tokens": tok}, cache, cfg))
        for _ in range(3):                               # warm-up
            step()
        _, coll[on] = counted(step)
        times[on] = event_times(torch, step, MESH_TIMED_DECODES)
        profiled[on] = profile_once(torch, step)
    out["serve"] = {
        "mesh": f"{MESH_SERVE_SHAPE[0]} x {MESH_SERVE_SHAPE[1]}",
        "tokens_part_at": parted, "logits_max_abs_diff": ends,
        "logit_scale": scale, "layers_teacher_forced": layers,
        "serve_ms": {"mesh": serve_ms[True],
                                             "none": serve_ms[False]},
        "decode_ms": {"mesh": times[True], "none": times[False]},
        "collectives_per_step": coll[True],
        "profiled_step": {"mesh": profiled[True], "none": profiled[False]},
        "max_memory_gb": {"mesh": peak[True], "none": peak[False]}}
    del model, params, cache
    torch.cuda.empty_cache()
    sv = out["serve"]
    print(f"  {MESH_ARCH} at full width: {out['serve_params']:,} parameters"
          f" ({out['serve_weight_gb']:.2f} GB of bf16), the serve launcher's "
          f"traffic (6 requests, 3 slots, 16 new tokens, greedy) on a "
          f"{sv['mesh']} mesh of the card (inference rules) and without a "
          f"mesh: greedy tokens part at steps {parted} (None: never)")
    print(f"  its {layers['calls']} MoE calls of the six prompts' prefill "
          "and first decode step without a mesh, each input again through "
          f"moe_ep on {sv['mesh']}: {100 * layers['bit_equal_share']:.3f} % "
          f"of the outputs bit-equal, beyond one bf16 step by "
          f"{worst:.2e} of the largest (tolerance {tol['y_atol_share']}); "
          f"end to end, per request, the logits max|diff| (of logits up to "
          f"{scale:.2f}): " + "; ".join(
              f"{k} prefill {[round(v, 4) for v in e['prefill']]}, first "
              f"decode {[round(v, 4) for v in e['decode']]}"
              for k, e in ends.items()))
    print(f"  times on {card}: the traffic {serve_ms[True]:.1f} ms on the "
          f"mesh, {serve_ms[False]:.1f} ms without; a decode step at one "
          f"slot {times[True]['median_ms']:.3f} ms on the mesh [min "
          f"{times[True]['min_ms']:.3f}, max {times[True]['max_ms']:.3f}], "
          f"{times[False]['median_ms']:.3f} ms without [min "
          f"{times[False]['min_ms']:.3f}, max {times[False]['max_ms']:.3f}]"
          f" (CUDA events, median of {MESH_TIMED_DECODES}); collectives of "
          "a mesh step: " + ", ".join(
              f"{k} {v['calls']} calls ({v['bytes']:,} bytes)"
              for k, v in coll[True].items())
          + f"; torch.cuda.max_memory_allocated {peak[True]:.2f} GB on the "
          f"mesh, {peak[False]:.2f} GB without")
    for on, name in ((True, "on the mesh"), (False, "without")):
        p = profiled[on]
        print(f"  one decode step {name} under torch.profiler: "
              + (f"{p['kernels']} kernels, {p['device_busy_ms']:.3f} ms of "
                 f"device time in {p['wall_ms']:.3f} ms of wall (device "
                 f"busy {100 * p['device_share']:.1f} %)" if p["kernels"]
                 else "device time not measured (the profiler recorded no "
                 "device events)"))

    # (c) one MoE layer at full width, training rules, no drops: x in
    # float32 and in bf16 over the same float32 master weights
    lcfg = dataclasses.replace(cfg, capacity_factor=8.0)
    torch.cuda.empty_cache()
    out["layer"] = {name: moe_layer_on_mesh(torch, dev, mesh((2, 4)), lcfg,
                                            name) for name in MESH_LAYER_TOL}
    for name, ly in out["layer"].items():
        tol = MESH_LAYER_TOL[name]
        print(f"  one {MESH_ARCH} MoE layer at full width (x {ly['x']} in "
              f"{name}, float32 master weights, capacity_factor 8) on a 2 x "
              f"4 mesh of the card, training rules, vs moe_reference: "
              f"output max|diff| {ly['y_max_abs_diff']:.3e} of values up to "
              f"{ly['y_scale']:.1f} ({100 * ly['y_equal_share']:.2f} % "
              f"bit-equal; beyond rtol {tol['y_rtol']:.3g} by "
              f"{ly['y_excess_share']:.2e} of the largest, tolerance "
              f"{tol['y_atol_share']}); aux {ly['aux']:.6f} (the data "
              f"shards' mean {ly['aux_shard_mean']:.6f}, the reference's "
              f"global {ly['aux_reference']:.6f}); gradients of mean(y**2): "
              f"weights {ly['weight_grad_share']:.2e}, x "
              f"{ly['x_grad_share']:.2e} of each leaf's largest (tolerances "
              f"{tol['w_share']:.3g}, {tol['x_share']:.3g}); collectives "
              + ", ".join(f"{k} {v['calls']}" for k, v in
                          ly["collectives"].items())
              + f"; peak memory {ly['max_memory_gb']:.2f} GB")

    # (d) the trainer on the 2 x 4 mesh at full width, 2 layers
    tcfg = dataclasses.replace(cfg, n_layers=MESH_TRAIN_LAYERS)
    check(tcfg.param_count() == 1_045_176_320,
          f"{tcfg.param_count()} parameters at {MESH_TRAIN_LAYERS} layers")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = M.init_params(tcfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev, trainable=True)
    opt = init_opt_state(model, "int8_ef")     # as make_train_state has it
    state_gb = torch.cuda.memory_allocated() / 1e9
    ocfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=MESH_TRAIN_STEPS)
    shape = ShapeConfig("cli", MESH_LAYER_SHAPE[1], MESH_LAYER_SHAPE[0],
                        "train")
    history, step_ms, step_coll = [], [], []
    with P_.use_mesh(mesh((2, 4)), P_.DEFAULT_RULES):
        for step in range(MESH_TRAIN_STEPS):
            batch = make_batch(tcfg, shape, step, device=dev)
            fm.reset_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model, opt, m = train_step(model, opt, batch, tcfg, ocfg, 1)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            history.append({k: float(v) for k, v in m.items()})
            step_coll.append({k: {"calls": n,
                                  "bytes": fm.collective_bytes[k]}
                              for k, n in fm.collectives.items()})
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              for h in history), f"a non-finite step: {history}")
    n_params = sum(p.numel() for p in model.parameters())
    out["train"] = {"params": n_params, "state_gb": state_gb,
                    "history": history, "step_ms": step_ms,
                    "collectives_per_step": step_coll[-1],
                    "max_memory_gb": train_peak,
                    "tokens_per_step": MESH_LAYER_SHAPE[0]
                    * MESH_LAYER_SHAPE[1]}
    del model, opt, batch, m
    torch.cuda.empty_cache()
    print(f"  {MESH_ARCH} at full width and {MESH_TRAIN_LAYERS} layers "
          f"({n_params:,} parameters, float32 master copy, "
          f"'{tcfg.remat_policy}' remat) trained on a 2 x 4 mesh of the "
          f"card (default rules: FSDP gathers over data, experts over "
          f"model), {MESH_TRAIN_STEPS} steps of {MESH_LAYER_SHAPE[0]} x "
          f"{MESH_LAYER_SHAPE[1]} tokens: losses "
          + ", ".join(f"{h['loss']:.4f}" for h in history)
          + "; gradient norms " + ", ".join(f"{h['grad_norm']:.3f}"
                                            for h in history)
          + "; dropped " + ", ".join(f"{h['dropped_frac']:.4f}"
                                     for h in history))
    print(f"  times on {card}: steps " + ", ".join(f"{t:.1f}"
                                                   for t in step_ms)
          + " ms (CUDA events around train_step); optimizer state "
          f"{state_gb:.2f} GB; torch.cuda.max_memory_allocated "
          f"{train_peak:.2f} GB; collectives of a step (the remat recompute "
          "included): " + ", ".join(
              f"{k} {v['calls']} calls ({v['bytes'] / 1e9:.2f} GB)"
              for k, v in step_coll[-1].items()))

    # (e) the launcher's host mesh: 4 positions of the card against 4 of
    # the CPU, from the same weights
    argv = ["--arch", MESH_ARCH, "--smoke", "--batch", "8", "--seq", "16",
            "--steps", "3", "--log-every", "1"]
    lines = {}
    scfg = get_smoke_config(MESH_ARCH)
    for where in ("cpu", str(cdev)):
        weights, _ = make_train_state(scfg, 0, device="cpu")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_launch.run(argv, model=weights.to(where),
                             devices=[where] * 4)
        lines[where] = [tuple(float(v) for v in m.groups())
                        for m in map(LOSS_LINE.match,
                                     buf.getvalue().splitlines()) if m]
    host, cardl = lines["cpu"], lines[str(cdev)]
    check(len(host) == len(cardl) == 3, f"loss lines {host} / {cardl}")
    check(abs(cardl[0][0] - host[0][0]) <= MESH_LAUNCH_SAME_LOSS
          and all(abs(c[0] - h[0]) <= MESH_LAUNCH_EARLY_LOSS
                  and c[2] == h[2] for c, h in zip(cardl, host)),
          f"the launcher on 4 positions of the card {cardl} vs the CPU's "
          f"{host}")
    out["launcher"] = {"cpu": host, "card": cardl}
    print("  the train launcher at smoke size on 4 positions of the card vs "
          "4 of the CPU (same weights): losses "
          + ", ".join(f"{c[0]:.4f}/{h[0]:.4f}" for c, h in zip(cardl, host))
          + f" (step 1 within {MESH_LAUNCH_SAME_LOSS}, steps 1-3 within "
          f"{MESH_LAUNCH_EARLY_LOSS})")
    return out


def dryrun_phase(np, torch, dev, card, mesh_collectives: dict) -> dict:
    """Phase 3l: the multi-pod dry run held to the card.  (a)
    ``TRAIN_ARCH`` at full width, one microbatch of ``TRAIN_SEQ`` tokens
    with "full" remat: the cell dry-run on a 1 x 1 mesh of a meta
    position, then the real float32 master copy, optimizer state
    (``compression="none"``) and batch on the card and one ``train_step``
    under the same counting mode (``dryrun.measure``): the predicted
    argument bytes equal the real tensors' bytes and the predicted dot
    FLOPs the step's; the predicted peak (arguments plus the largest live
    bytes of the run) beside ``max_memory_allocated``, reported.  (b)
    ``MESH_ARCH`` decoding one token at one slot with a cache of
    ``MESH_MAX_LEN`` on a 1 x 4 meta mesh: its collectives by kind, calls
    and bytes, equal to ``mesh_collectives``, what phase 3k counted for
    one decode step on 1 x 4 of the card.  (c) the command line in its
    own process on ``DRYRUN_CLI_ARCHS`` x decode_32k on the 16 x 16 pod
    mesh, started first and awaited last: exit 0 and every record with
    exactly the JAX record's keys (``n_ops`` for ``hlo_lines``)."""
    import math
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import make_train_state

    out = {}
    axes = ("data", "model")
    cdev = torch.device("cuda", torch.cuda.current_device())
    tmp = tempfile.TemporaryDirectory()
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         ",".join(DRYRUN_CLI_ARCHS), "--shape", "decode_32k", "--mesh",
         "pod", "--out", tmp.name], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # (a) the train cell against the card's state and step
        cfg = get_config(TRAIN_ARCH)
        shape = ShapeConfig("train", TRAIN_SEQ, 1, "train")
        meta = make_mesh((1, 1), axes, ["meta"])
        rules = dryrun.cell_rules(meta, "train")
        t0 = time.perf_counter()
        fn, args, specs = dryrun.build_cell(cfg, shape, meta, remat="full")
        pred = dryrun.measure(fn, args, specs, meta, rules)
        dry_s = time.perf_counter() - t0
        del args
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, opt = make_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0),
            compression="none", device=dev)
        batch = make_batch(cfg, shape, 0, device=dev)
        state = (list(params.parameters()) + [opt.step]
                 + list(opt.m.parameters()) + list(opt.v.parameters())
                 + list(batch.values()))
        state_bytes = sum(t.numel() * t.element_size() for t in state)
        del state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real = dryrun.measure(fn, (params, opt, batch), specs,
                              make_mesh((1, 1), axes, [cdev]), rules)
        loss = float(real.out[2]["loss"])
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(pred.argument_bytes == state_bytes == real.global_bytes,
              f"{TRAIN_ARCH}: predicted argument bytes "
              f"{pred.argument_bytes:,}, the card's state and batch "
              f"{state_bytes:,}")
        check(pred.counter.dot_flops == real.counter.dot_flops,
              f"{TRAIN_ARCH}: predicted dot FLOPs {pred.counter.dot_flops:,}"
              f", the card's step {real.counter.dot_flops:,}")
        check(math.isfinite(loss), f"{TRAIN_ARCH}: loss {loss}")
        predicted_peak = pred.argument_bytes + pred.counter.peak
        out["train"] = {
            "argument_bytes": pred.argument_bytes, "dot_flops":
            pred.counter.dot_flops, "n_dots": pred.counter.n_dots,
            "n_ops": {"meta": pred.counter.n_ops,
                      "card": real.counter.n_ops},
            "temp_bytes": {"meta": pred.counter.peak,
                           "card": real.counter.peak},
            "predicted_peak_bytes": predicted_peak,
            "max_memory_allocated": peak,
            "predicted_over_allocated": predicted_peak / peak,
            "dry_run_s": dry_s, "card_step_s": step_s, "loss": loss}
        del params, opt, batch, real, fn
        torch.cuda.empty_cache()
        tr = out["train"]
        print(f"  {TRAIN_ARCH} at full width, train of {TRAIN_SEQ} tokens "
              f"(\"full\" remat) on 1 x 1: dry run {dry_s:.2f} s; predicted "
              f"argument bytes {tr['argument_bytes']:,} = the card's state "
              f"and batch; predicted dot FLOPs {tr['dot_flops']:,} = the "
              f"card step's ({tr['n_dots']} products; {step_s:.2f} s with the"
              f" counter, loss {loss:.4f}); predicted peak (arguments + "
              f"{tr['temp_bytes']['meta'] / 1e9:.2f} GB live) "
              f"{predicted_peak / 1e9:.2f} GB against max_memory_allocated "
              f"{peak / 1e9:.2f} GB on {card} (ratio "
              f"{tr['predicted_over_allocated']:.4f}); the counter on the "
              f"card saw {tr['n_ops']['card']} ops and "
              f"{tr['temp_bytes']['card'] / 1e9:.2f} GB live, on meta "
              f"{tr['n_ops']['meta']}")

        # (b) the MoE decode cell against phase 3k's counts
        mcfg = get_config(MESH_ARCH)
        mshape = ShapeConfig("decode", MESH_MAX_LEN, 1, "decode")
        mmesh = make_mesh((1, 4), axes, ["meta"] * 4)
        fn, args, specs = dryrun.build_cell(mcfg, mshape, mmesh)
        got = dryrun.measure(fn, args, specs, mmesh,
                             dryrun.cell_rules(mmesh, "decode")).collectives
        want: dict = {}
        for kind, c in mesh_collectives.items():
            rec = want.setdefault(dryrun.HLO_NAME[kind],
                                  {"count": 0, "bytes": 0})
            rec["count"] += c["calls"]
            rec["bytes"] += c["bytes"]
        seen = {k: {"count": v["count"], "bytes": v["bytes"]}
                for k, v in got.items()}
        check(seen == want, f"{MESH_ARCH} decode on 1 x 4: the dry run's "
              f"collectives {seen}, phase 3k's on the card {want}")
        out["moe_decode"] = {"collectives": got}
        print(f"  {MESH_ARCH} decode at one slot (cache {MESH_MAX_LEN}) on a"
              f" 1 x 4 meta mesh: collectives {got}, equal to phase 3k's on "
              "the card")

        # (c) the command line in its own process
        stdout, stderr = cli.communicate(timeout=DRYRUN_CLI_TIMEOUT)
        cli_s = time.perf_counter() - t_cli
        check(cli.returncode == 0, f"the dry run's command line exited "
              f"{cli.returncode}: {stderr[-2000:]}")
        records = {}
        for name in sorted(os.listdir(tmp.name)):
            with open(os.path.join(tmp.name, name)) as f:
                rec = json.load(f)
            check(set(rec) == DRYRUN_RECORD_KEYS,
                  f"{name}: keys {sorted(rec)}")
            records[name] = {"lower_s": rec["lower_s"],
                             "argument_bytes":
                                 rec["memory"]["argument_bytes"],
                             "dot_flops": rec["dots"]["dot_flops"],
                             "collectives": rec["collectives"]}
        check(len(records) == len(DRYRUN_CLI_ARCHS),
              f"the command line wrote {sorted(records)}")
        out["cli"] = {"wall_s": cli_s, "records": records,
                      "lines": [ln for ln in stdout.splitlines()
                                if ln.startswith(("OK", "FAIL", "SKIP"))]}
        for ln in out["cli"]["lines"]:
            print(f"  {ln}")
        print(f"  the command line ({', '.join(DRYRUN_CLI_ARCHS)} x "
              f"decode_32k on the pod mesh) in its own process: exit 0, "
              f"{len(records)} records with the JAX keys, {cli_s:.1f} s "
              "wall (beside (a) and (b))")
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
        tmp.cleanup()
    return out


def main() -> int:
    t_script = time.perf_counter()
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    # ---------------------------------------------------------------- 1 --
    card = nvidia_smi()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    # the dense reference tier runs torch.matmul; TF32 would break its
    # 1e-7 comparisons, so both switches are set explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.configs.pagerank_5k import full
    from repro_torch.graph.delta import EdgeStream, apply_delta
    from repro_torch.graph.generators import protein_network
    from repro_torch.graph.sparse import BSRMatrix
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import bsr_spmv as k3
    from repro_torch.kernels import pagerank_step as k1
    from repro_torch.kernels import streaming_matvec as k2
    from repro_torch.kernels.ref import (bsr_spmv_ref,
                                         pagerank_step_fused_ref,
                                         pagerank_step_ref,
                                         streaming_matvec_ref)
    from repro_torch.launch import pagerank_run
    from repro_torch.obs.registry import MetricsRegistry, NullRegistry
    from repro_torch.obs.trace import CHUNK
    from repro_torch.pagerank import (DynamicPageRankEngine, LandmarkIndex,
                                      PageRankEngine)
    from repro_torch.pagerank.dense import pagerank_dense_fixed
    from repro_torch.pagerank.fidelity import topk_overlap as overlap
    from repro_torch.pagerank.sparse import top_k_proteins
    from repro_torch.serve import (PageRankQueryEngine, ResultCache,
                                   ServeResilience)

    cfg = full()
    check((cfg.n_nodes, cfg.n_iters, cfg.damping, cfg.seed)
          == (N_NODES, N_ITERS, DAMPING, SEED), f"config changed: {cfg}")
    built = _build.build_all()
    print(f"kernel build: {built['seconds']:.2f} s "
          f"({', '.join(_build.sources())})")
    # K1 and K4: the configuration each storage type takes, and every
    # instantiation's registers and spills (none may spill)
    step_lib = _build.load("pagerank_step")
    step_lib.pagerank_step_config.argtypes = (ctypes.c_int, ctypes.c_void_p)

    def step_config(p):
        """The core's configuration (R, D) for storage type p."""
        out = (ctypes.c_int * len(STEP_CONFIG_KEYS))()
        check(step_lib.pagerank_step_config(PRECISIONS.index(p), out) == 0,
              f"no K1 / K4 configuration for {p}")
        return tuple(out)

    step_configs = {p: step_config(p) for p in PRECISIONS}
    step_regs = step_instantiations(built["logs"]["pagerank_step"])
    fresh = built["logs"]["pagerank_step"] != "(cached)"
    for (kernel, variant), what in STEP_VARIANTS.items():
        for p in PRECISIONS:
            info = step_regs.get((kernel, p, step_configs[p], variant))
            check(info is not None or not fresh,
                  f"{kernel} {p} {what}: not in the ptxas log")
            check(info is None or info["spill_stores"] + info["spill_loads"]
                  == 0, f"{kernel} {p} {what} spills: {info}")
            desc = " ".join(f"{k}{v}" for k, v in zip(STEP_CONFIG_KEYS,
                                                       step_configs[p]))
            print(f"  pagerank_step {kernel} {p} {what} {desc}: "
                  + ("(cached build)" if info is None else
                     f"{info['registers']} registers, "
                     f"{info['spill_stores']} bytes spill stores, "
                     f"{info['spill_loads']} bytes spill loads"))
    # K2: the configuration each batch size takes, and each
    # instantiation's registers and spills (none may spill)
    k2_lib = _build.load("streaming_matvec")
    k2_lib.streaming_matvec_config.argtypes = (ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p)

    def k2_config(p, B):
        """The queries per CTA and the configuration of K2 at B queries."""
        out = (ctypes.c_int * 11)()
        k2_lib.streaming_matvec_config(PRECISIONS.index(p), B, out)
        return out[0], dict(zip(K2_CONFIG_KEYS, out[1:9]))

    k2_configs = {(p, qp): k2_config(p, qp)[1] for p in PRECISIONS
                  for qp in (8, 16, 32, 64)}
    k2_regs = k2_instantiations(built["logs"]["streaming_matvec"])
    fresh = built["logs"]["streaming_matvec"] != "(cached)"
    for (p, qp), conf in k2_configs.items():
        info = k2_regs.get((p, qp))
        check(info is not None or not fresh,
              f"K2 {p} QP={qp}: not in the ptxas log")
        check(info is None or info["spill_stores"] + info["spill_loads"]
              == 0, f"K2 {p} QP={qp} spills: {info}")
        desc = " ".join(f"{k}{v}" for k, v in conf.items())
        print(f"  streaming_matvec {p} QP={qp} {desc}: "
              + ("(cached build)" if info is None else
                 f"{info['registers']} registers, "
                 f"{info['spill_stores']} bytes spill stores, "
                 f"{info['spill_loads']} bytes spill loads"))
    # K3: the tile each batch size takes, and each instantiation's
    # registers and spills
    k3_lib = _build.load("bsr_spmv")
    k3_lib.bsr_spmv_tile.argtypes = (ctypes.c_int, ctypes.c_void_p)
    k3_tiles = {}
    for qp in (1, 2, 4, 8, 16, 32, 64):
        out = (ctypes.c_int * 8)()
        k3_lib.bsr_spmv_tile(qp, out)
        k3_tiles[qp] = tuple(out[:5])
    k3_regs = k3_instantiations(built["logs"]["bsr_spmv"])
    fresh = built["logs"]["bsr_spmv"] != "(cached)"
    for p in PRECISIONS:
        for qp, tile in k3_tiles.items():
            info = k3_regs.get((p, tile))
            check(info is not None or not fresh,
                  f"K3 {p} tile {tile}: not in the ptxas log")
            desc = " ".join(f"{k}{v}" for k, v in zip(K3_TILE_KEYS, tile))
            print(f"  bsr_spmv {p} QP={qp} tile {desc}: "
                  + ("(cached build)" if info is None else
                     f"{info['registers']} registers, "
                     f"{info['spill_stores']} bytes spill stores, "
                     f"{info['spill_loads']} bytes spill loads"))

    # ---------------------------------------------------------------- 2 --
    src, dst = protein_network(N_NODES, seed=SEED)
    engines = {p: PageRankEngine(src, dst, N_NODES, d=DAMPING,
                                 backend="fused_dense", precision=p,
                                 device=dev, metrics=NullRegistry())
               for p in PRECISIONS}
    max_err = {p: 0.0 for p in PRECISIONS}

    def compare(p, Hp, xp, dangp, t, scales, n_real, what):
        yp, leak = k1.pagerank_step_fused(Hp, xp, dangp, t, scales,
                                          d=DAMPING)
        torch.cuda.synchronize()
        yr, lr = pagerank_step_fused_ref(Hp, xp, dangp, t, scales,
                                         d=DAMPING)
        e1 = allclose(torch, yp, yr, **TOL32, what=f"{what} yp")
        e2 = allclose(torch, leak, lr, **TOL32, what=f"{what} leak")
        allclose(torch, yp, yr, **TIGHT, what=f"{what} yp")
        allclose(torch, leak, lr, **TIGHT, what=f"{what} leak")
        rel = float(((yp - yr).abs() / yr.abs()).max())
        check(bool(torch.all(yp[0, n_real:] == t.reshape(()))),
              f"{what}: padded tail is not t")
        max_err[p] = max(max_err[p], e1, e2)
        print(f"  {what}: max|yp diff| {e1:.3e} (relative {rel:.3e}), "
              f"|leak diff| {e2:.3e}")

    print("kernel vs plain version on the card (rtol 1e-5, atol 5e-5, "
          "and rtol 1e-5, atol 1e-9):")
    for p in PRECISIONS:
        for Np, Mp in ((256, 256), (768, 1280), (5120, 5120)):
            H, x, dang, t, scales, n_real = random_case(np, Np, Mp, p,
                                                        seed=Np + Mp)
            Ht = torch.from_numpy(H).to(dev)
            if p != "int8":
                Ht = Ht.to(engines[p].storage_dtype)
            compare(p, Ht, torch.from_numpy(x).to(dev),
                    torch.from_numpy(dang).to(dev),
                    torch.tensor(t, device=dev),
                    None if scales is None
                    else torch.from_numpy(scales).to(dev), n_real,
                    f"{p} random {Np}x{Mp}")
        eng = engines[p]
        Hp, dangp = eng.operands
        xp = torch.zeros((1, Hp.shape[1]), device=dev)
        xp[0, :N_NODES] = torch.from_numpy(
            np.random.default_rng(1).dirichlet(np.ones(N_NODES))
            .astype(np.float32)).to(dev)
        compare(p, Hp, xp, dangp, torch.tensor(0.15 / N_NODES, device=dev),
                eng._scales, N_NODES, f"{p} protein {tuple(Hp.shape)}")

    print("K2 vs plain version on the card (rtol 1e-5, atol 5e-5, and "
          "rtol 1e-5, atol 1e-9; X rows are distributions):")
    k2_err = {}
    for p in PRECISIONS:
        for N, M, B in ((300, 130, 3), (256, 256, 1), (640, 384, 100),
                        (5120, 5120, 1), (5120, 5120, 8),
                        (5120, 5120, 64)):
            W, X = k2_case(np, N, M, B, p, seed=N + M + B)
            Wt = torch.from_numpy(W).to(dev)
            if p != "int8":
                Wt = Wt.to(engines[p].storage_dtype)
            Xt = torch.from_numpy(X).to(dev)
            Y = k2.streaming_matvec(Wt, Xt)
            torch.cuda.synchronize()
            ref = streaming_matvec_ref(Wt, Xt)
            what = f"K2 {p} {N}x{M} B={B}"
            e = allclose(torch, Y, ref, **TOL32, what=what)
            allclose(torch, Y, ref, **TIGHT, what=what)
            check(Y.shape == (B, N), f"{what}: shape {tuple(Y.shape)}")
            check(bool(torch.equal(k2.streaming_matvec(Wt, Xt), Y)),
                  f"{what}: two calls are not bit-identical")
            for q in sorted({0, B - 1}):
                check(bool(torch.equal(
                    k2.streaming_matvec(Wt, Xt[q:q + 1].contiguous()),
                    Y[q:q + 1])), f"{what}: query {q} alone differs from "
                    "the same query in the batch")
            rel = float(((Y - ref).abs() / ref.abs()).max())
            key = (p, B if N == 5120 else 0)
            k2_err[key] = max(k2_err.get(key, 0.0), e)
            print(f"  {what}: max|diff| {e:.3e} (relative {rel:.3e})")

    bsr_engines = {p: PageRankEngine(src, dst, N_NODES, d=DAMPING,
                                     backend="bsr", precision=p, device=dev,
                                     metrics=NullRegistry())
                   for p in PRECISIONS}

    def k3_compare(blocks, cols, X, what):
        Y = k3.bsr_spmv(blocks, cols, X)
        torch.cuda.synchronize()
        ref = bsr_spmv_ref(blocks, cols, X)
        e = allclose(torch, Y, ref, **TOL32, what=what)
        allclose(torch, Y, ref, **TIGHT, what=what)
        check(Y.shape == (X.shape[0], blocks.shape[0] * blocks.shape[2]),
              f"{what}: shape {tuple(Y.shape)}")
        check(bool(torch.equal(k3.bsr_spmv(blocks, cols, X), Y)),
              f"{what}: two calls are not bit-identical")
        check(bool(torch.equal(k3.bsr_spmv(blocks, cols, X[0]), Y[0])),
              f"{what}: query 0 alone differs from query 0 in the batch")
        nz = ref != 0
        rel = float(((Y - ref).abs()[nz] / ref.abs()[nz]).max())
        print(f"  {what}: max|diff| {e:.3e} (relative {rel:.3e})")
        return Y, e

    print("K3 vs plain version on the card (rtol 1e-5, atol 5e-5, and "
          "rtol 1e-5, atol 1e-9; X rows are distributions):")
    k3_err = {}
    for p in PRECISIONS:
        for n, bs, density, B, empty in (
                (200, 32, 0.3, 1, False), (300, 32, 0.2, 8, True),
                (200, 128, 0.3, 64, False), (300, 128, 0.5, 100, True)):
            blocks, cols, X = bsr_case(np, torch, BSRMatrix, n, bs, density,
                                       B, p, seed=n + bs + B,
                                       empty_row=empty)
            if p != "int8":
                blocks = blocks.to(engines[p].storage_dtype)
            Y, e = k3_compare(blocks.to(dev), cols.to(dev),
                              torch.from_numpy(X).to(dev),
                              f"K3 {p} n={n} bs={bs} B={B}"
                              + (" empty block row" if empty else ""))
            if empty:
                check(bool(torch.all(Y[:, :bs] == 0)),
                      f"K3 {p}: the empty block row is not 0")
            k3_err[(p, 0)] = max(k3_err.get((p, 0), 0.0), e)
        bsr = bsr_engines[p].operands[0]
        rng = np.random.default_rng(2)
        for B in (1, SERVE_BATCH, N_HUBS):
            X = np.zeros((B, -(-N_NODES // bsr.block_size)
                          * bsr.block_size), np.float32)
            X[:, :N_NODES] = rng.dirichlet(np.ones(N_NODES), size=B)
            _, e = k3_compare(bsr.blocks, bsr.block_cols,
                              torch.from_numpy(X).to(dev),
                              f"K3 {p} protein {tuple(bsr.blocks.shape)} "
                              f"B={B}")
            k3_err[(p, B)] = e

    print("K4 vs plain version on the card (rtol 1e-5, atol 5e-5, and "
          "rtol 1e-5, atol 1e-9):")
    k4_err = {}
    for p in PRECISIONS:
        for N, M in ((300, 130), (N_NODES, N_NODES)):
            W, X = k2_case(np, N, M, 1, p, seed=N + M)
            H = torch.from_numpy(W).to(dev)
            if p != "int8":
                H = H.to(engines[p].storage_dtype)
            x = torch.from_numpy(X[0]).to(dev)
            t = torch.tensor(0.15 / N, device=dev)
            y = k1.pagerank_step(H, x, t, d=DAMPING)
            torch.cuda.synchronize()
            ref = pagerank_step_ref(H, x, t, d=DAMPING)
            what = f"K4 {p} {N}x{M}"
            e = allclose(torch, y, ref, **TOL32, what=what)
            allclose(torch, y, ref, **TIGHT, what=what)
            check(y.shape == (N,), f"{what}: shape {tuple(y.shape)}")
            check(bool(torch.equal(k1.pagerank_step(H, x, t, d=DAMPING), y)),
                  f"{what}: two calls are not bit-identical")
            k4_err[p] = max(k4_err.get(p, 0.0), e)
            rel = float(((y - ref).abs() / ref.abs()).max())
            print(f"  {what}: max|diff| {e:.3e} (relative {rel:.3e})")

    # ---------------------------------------------------------------- 3 --
    print(f"main path: protein_network({N_NODES}, seed={SEED}), "
          f"{N_ITERS} iterations, d={DAMPING}")
    k1.reset_launches()
    t0 = time.perf_counter()
    dense = PageRankEngine(src, dst, N_NODES, d=DAMPING, backend="dense",
                           device=dev)
    ell = PageRankEngine(src, dst, N_NODES, d=DAMPING, backend="ell",
                         device=dev)
    fused = PageRankEngine(src, dst, N_NODES, d=DAMPING,
                           backend="fused_dense", device=dev)
    # run() must not make the host wait on the device: any synchronizing
    # call inside it raises while this mode is on
    torch.cuda.set_sync_debug_mode("error")
    try:
        pr = {"dense": dense.run(N_ITERS), "ell": ell.run(N_ITERS)}
        before = k1.launches["f32"]
        pr["fused_dense"] = fused.run(N_ITERS)
        check(k1.launches["f32"] - before == N_ITERS,
              f"run({N_ITERS}) launched K1 "
              f"{k1.launches['f32'] - before} times")
        repeat = fused.run(N_ITERS)
        for p in PRECISIONS[1:]:
            before = k1.launches[p]
            pr[f"fused_dense[{p}]"] = engines[p].run(N_ITERS)
            check(k1.launches[p] - before == N_ITERS,
                  f"{p}: run({N_ITERS}) launched K1 "
                  f"{k1.launches[p] - before} times")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # each reduced fused tier against the dense tier at its own precision
    dense_low = {p: PageRankEngine(src, dst, N_NODES, d=DAMPING,
                                   backend="dense", precision=p, device=dev,
                                   metrics=NullRegistry()).run(N_ITERS)
                 for p in PRECISIONS[1:]}
    torch.cuda.synchronize()
    check(bool(torch.equal(repeat, pr["fused_dense"])),
          "two f32 fused runs are not bit-identical")
    tol_runs = {b: e.run_tol(tol=1e-6, max_iters=1000)
                for b, e in (("dense", dense), ("fused_dense", fused))}
    tops = {b: top_k_proteins(pr[b], k=10)[0].cpu().numpy()
            for b in ("dense", "ell", "fused_dense")}
    launcher = pagerank_run.run([])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    main_launches = dict(k1.launches)
    print(f"main path took {main_s:.2f} s; K1 launches {main_launches}")

    for name, v in pr.items():
        check(v.shape == (N_NODES,) and bool(torch.isfinite(v).all()),
              f"{name}: bad output")
    ref = {k: v.double().cpu().numpy() for k, v in pr.items()}
    e_fd = allclose(torch, pr["fused_dense"], pr["dense"], rtol=1e-5,
                    atol=1e-7, what="fused_dense vs dense")
    e_ed = allclose(torch, pr["ell"], pr["dense"], rtol=1e-4, atol=1e-7,
                    what="ell vs dense")
    e_low = {p: allclose(torch, pr[f"fused_dense[{p}]"], v, **TOL_TIER,
                         what=f"fused_dense[{p}] vs dense[{p}]")
             for p, v in dense_low.items()}
    host = host_reference(np, src, dst, N_NODES, N_ITERS, DAMPING)
    e_host = float(np.abs(ref["fused_dense"] - host).max())
    check(e_host <= 1e-6, f"fused_dense vs float64 host: {e_host:.3e}")
    check(abs(ref["fused_dense"].sum() - 1.0) < 1e-4, "f32 mass is not 1")
    for b in ("ell", "fused_dense"):
        check(np.array_equal(tops[b], tops["dense"]),
              f"top-10 of {b} {tops[b]} != dense {tops['dense']}")
    check(np.array_equal(tops["dense"], np.argsort(-host)[:10]),
          "top-10 differs from the float64 host reference")
    overlaps = {p: topk_overlap(np, ref[f"fused_dense[{p}]"],
                                ref["dense"], 100) for p in PRECISIONS[1:]}
    for p, ov in overlaps.items():
        check(ov >= 0.99, f"{p}: top-100 overlap {ov} < 0.99")
    iters = {b: r.info.iters for b, r in tol_runs.items()}
    for b, r in tol_runs.items():
        check(r.info.converged, f"run_tol on {b}: {r.info.status}")
    check(abs(iters["dense"] - iters["fused_dense"]) <= 1,
          f"run_tol iteration counts differ: {iters}")
    check(any(k.startswith("engine_fused_dense") for k in launcher),
          f"launcher tiers: {sorted(launcher)}")
    print(f"  fused_dense vs dense max|diff| {e_fd:.3e}; ell vs dense "
          f"{e_ed:.3e}; fused_dense vs float64 host {e_host:.3e}")
    print(f"  fused_dense[p] vs dense[p] max|diff| (rtol 1e-5, atol 1e-7): "
          + ", ".join(f"{p} {e:.3e}" for p, e in e_low.items()))
    print(f"  top-10 proteins (all f32 tiers and the host): "
          f"{tops['dense'].tolist()}")
    print(f"  top-100 overlap with f32: {overlaps}")
    print(f"  run_tol(1e-6) iterations: {iters}")

    # --------------------------------------------------------------- 3b --
    print(f"serve path: protein_network({N_NODES}, seed={SEED}), "
          f"d={DAMPING}; K2 launch counts zeroed before and read after "
          "each step")
    serve_launches = {p: 0 for p in PRECISIONS}
    # K2's launches by step of the paths, each by (storage type, B)
    k2_steps = {step: Counter() for step in (
        "serve.ppr8", "serve.ppr1", "serve.landmark_build", "serve.answers",
        "live.fused_dense")}

    def counted(fn, step):
        k2.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = dict(k2.launches)
        for p, c in got.items():
            serve_launches[p] += c
        k2_steps[step].update(k2.batch_launches)
        return out, got

    t_serve = time.perf_counter()
    pool, picks = zipf_queries(np, N_NODES, SEED)
    sets8 = [pool[j] for j in range(SERVE_BATCH)]
    ppr, ppr1 = {}, {}
    for p in PRECISIONS:
        ppr[p], got = counted(lambda p=p: engines[p].ppr(sets8, N_ITERS),
                              "serve.ppr8")
        check(got == {q: (N_ITERS if q == p else 0) for q in PRECISIONS},
              f"ppr({N_ITERS}) on fused_dense[{p}] launched K2 {got}")
        ppr1[p], got = counted(
            lambda p=p: engines[p].ppr(sets8[:1], N_ITERS), "serve.ppr1")
        check(got == {q: (N_ITERS if q == p else 0) for q in PRECISIONS},
              f"ppr of one seed set on fused_dense[{p}] launched K2 {got}")
    ppr_err, ppr_sum, ppr1_err, lm_low_err = {}, {}, {}, {}
    for p in PRECISIONS:
        dense_p = PageRankEngine(src, dst, N_NODES, d=DAMPING,
                                 backend="dense", precision=p, device=dev,
                                 metrics=NullRegistry())
        ppr1_err[p] = allclose(torch, ppr1[p], dense_p.ppr(sets8[:1],
                                                           N_ITERS),
                               **TOL_TIER, what=f"ppr of one seed set "
                               f"fused_dense[{p}] vs dense[{p}]")
        if p != "f32":
            # a 64-hub landmark index on the reduced tier: one K2 launch
            # at B = 64 per iteration, held to the same build on dense
            lm_p = LandmarkIndex(engines[p], n_hubs=N_HUBS, tol=LM_TOL,
                                 max_pushes=LM_MAX_PUSHES, n_iters=N_ITERS,
                                 metrics=NullRegistry())
            _, got = counted(lambda i=lm_p: i.build(0),
                             "serve.landmark_build")
            check(got == {q: (N_ITERS if q == p else 0)
                          for q in PRECISIONS},
                  f"landmark build on fused_dense[{p}] launched K2 {got}")
            lm_d = LandmarkIndex(dense_p, n_hubs=N_HUBS, tol=LM_TOL,
                                 max_pushes=LM_MAX_PUSHES, n_iters=N_ITERS,
                                 metrics=NullRegistry())
            lm_d.build(0)
            check(np.array_equal(lm_p.hubs, lm_d.hubs),
                  f"{p}: the landmark indexes chose different hubs")
            lm_low_err[p] = allclose(
                torch, torch.from_numpy(lm_p._Y), torch.from_numpy(lm_d._Y),
                **TOL_TIER, what=f"landmark hub columns fused_dense[{p}] "
                f"vs dense[{p}]")
        ref_p = dense_p.ppr(sets8, N_ITERS)
        X = ppr[p]
        check(X.shape == (N_NODES, SERVE_BATCH)
              and bool(torch.isfinite(X).all()), f"ppr {p}: bad output")
        ppr_err[p] = allclose(torch, X, ref_p, **TOL_TIER,
                              what=f"ppr fused_dense[{p}] vs dense[{p}]")
        sums, ref_sums = X.sum(dim=0), ref_p.sum(dim=0)
        ppr_sum[p] = float((sums - 1.0).abs().max())
        check(ppr_sum[p] <= SUM_TOL[p],
              f"ppr {p}: |column sum - 1| {ppr_sum[p]:.3e} > {SUM_TOL[p]}")
        allclose(torch, sums, ref_sums, rtol=0, atol=1e-5,
                 what=f"ppr {p} column sums vs dense[{p}]")
    print(f"  ppr(8 seed sets, {N_ITERS}) fused_dense vs dense at the same "
          "precision, max|diff|: "
          + ", ".join(f"{p} {e:.3e}" for p, e in ppr_err.items()))
    print("  max |column sum - 1|: "
          + ", ".join(f"{p} {e:.3e}" for p, e in ppr_sum.items()))
    print(f"  ppr(1 seed set, {N_ITERS}) fused_dense vs dense, max|diff|: "
          + ", ".join(f"{p} {e:.3e}" for p, e in ppr1_err.items()))
    print(f"  {N_HUBS}-hub landmark build on fused_dense vs dense at the "
          "same precision, hub columns max|diff|: "
          + ", ".join(f"{p} {e:.3e}" for p, e in lm_low_err.items()))

    fused_serve = engines["f32"]
    reg = MetricsRegistry()
    answers = []

    class CountedIndex(LandmarkIndex):
        """Checks K2's launches of every answer against its sweeps."""

        def answer(self, seed_sets, tol=None, max_pushes=None):
            before = k2.launches["f32"]
            check(before == sum(a["launches"] for a in answers),
                  "K2 launched outside the landmark answers")
            X, info = super().answer(seed_sets, tol, max_pushes)
            torch.cuda.synchronize()
            got = k2.launches["f32"] - before
            want = 1 + issued_sweeps(info["sweeps"], self.max_pushes,
                                     CHUNK)
            if info["fallbacks"]:
                want += self.n_iters
            check(got == want, f"answer of {len(seed_sets)} queries, "
                  f"{info['sweeps']} sweeps: K2 launched {got}, want {want}")
            answers.append(dict(info, launches=got, q=len(seed_sets)))
            return X, info

    lm = CountedIndex(fused_serve, n_hubs=N_HUBS, tol=LM_TOL,
                      max_pushes=LM_MAX_PUSHES, n_iters=N_ITERS,
                      metrics=reg)
    t0 = time.perf_counter()
    _, got = counted(lambda: lm.ensure(0), "serve.landmark_build")
    build_ms = (time.perf_counter() - t0) * 1e3
    check(got["f32"] == N_ITERS and lm.built,
          f"landmark build launched K2 {got}")
    cache = ResultCache(1024)
    qe = PageRankQueryEngine(fused_serve, n_iters=N_ITERS,
                             max_batch=SERVE_BATCH, metrics=reg,
                             cache=cache, landmarks=lm)

    def serve():
        queries = [qe.submit(i, pool[j], top_k=10)
                   for i, j in enumerate(picks)]
        qe.flush()
        return queries

    served, got = counted(serve, "serve.answers")
    check(got["f32"] == sum(a["launches"] for a in answers)
          and sum(got.values()) == got["f32"],
          f"serving launched K2 {got}, the answers "
          f"{[a['launches'] for a in answers]}")
    serve_s = time.perf_counter() - t_serve
    k1_during_serve = sum(k1.launches.values()) - sum(main_launches.values())
    # every landmark answer (each miss is cached whole) against an exact
    # 200-iteration solve, outside the counted run
    keys = list(cache._entries)
    exact = fused_serve.ppr([list(k[1]) for k in keys], 200).cpu().numpy()
    lm_err, lm_ov = 0.0, 1.0
    for j, key in enumerate(keys):
        ranks = cache._entries[key].ranks
        lm_err = max(lm_err, float(np.abs(ranks - exact[:, j]).max()))
        lm_ov = min(lm_ov, overlap(ranks, exact[:, j], k=50))
    check(lm_err <= 1e-5, f"landmark answers vs exact: {lm_err:.3e}")
    check(lm_ov >= 0.99, f"landmark answers top-50 overlap {lm_ov}")
    first = {}
    for q in served:
        check(q.result is not None and np.all(np.isfinite(q.result[1])),
              f"query {q.uid} was not served")
        key = ResultCache.key(q.seeds, "f32")
        if q.cache_outcome == "miss":
            first.setdefault(key, q.result)
        else:
            check(q.cache_outcome == "hit" and key in first
                  and np.array_equal(q.result[0], first[key][0])
                  and np.array_equal(q.result[1], first[key][1]),
                  f"query {q.uid}: the cache hit differs from its miss")
    hits = sum(q.cache_outcome == "hit" for q in served)
    batch_ms = reg.histogram("serve.batch_ms")
    serve_stats = {
        "flush_p50_ms": batch_ms.quantile(0.50),
        "flush_p95_ms": batch_ms.quantile(0.95),
        "flushes": batch_ms.count, "landmark_build_ms": build_ms,
        "queries": len(served), "cache_hits": hits,
        "answers": len(answers),
        "sweeps": [a["sweeps"] for a in answers],
        "answer_q": [a["q"] for a in answers],
        "fallbacks": sum(a["fallbacks"] for a in answers),
        "k2_launches": serve_launches, "serve_phase_s": serve_s,
        "ppr1_max_abs_diff_vs_dense": ppr1_err,
        "landmark_reduced_max_abs_diff_vs_dense": lm_low_err}
    check(k1_during_serve == 0, "the serve path launched K1")
    check(serve_launches["f32"] > 0, "the serve path launched no K2")
    print(f"  landmark build ({N_HUBS} hubs, {N_ITERS} iterations): "
          f"{build_ms:.3f} ms on {card}, K2 launches {N_ITERS}")
    print(f"  served {len(served)} queries in {batch_ms.count} flushes: "
          f"{hits} cache hits, {len(answers)} landmark answers of "
          f"{serve_stats['answer_q']} queries, sweeps "
          f"{serve_stats['sweeps']}, fallbacks {serve_stats['fallbacks']}")
    print(f"  landmark answers vs exact ppr(200): max|diff| {lm_err:.3e}, "
          f"min top-50 overlap {lm_ov}; every cache hit equals its miss")
    print(f"  serve.batch_ms p50 {serve_stats['flush_p50_ms']:.3f} ms, p95 "
          f"{serve_stats['flush_p95_ms']:.3f} ms on {card}; K2 launches on "
          f"the serve path {serve_launches}")

    # --------------------------------------------------------------- 3c --
    print(f"bsr tier: protein_network({N_NODES}, seed={SEED}), d={DAMPING}, "
          "bs=128, every precision held to the dense tier at its own "
          "precision; K3 launch counts zeroed before and read after")
    t_bsr = time.perf_counter()
    k3.reset_launches()
    dense_at = {"f32": dense}
    dense_at.update({p: PageRankEngine(src, dst, N_NODES, d=DAMPING,
                                       backend="dense", precision=p,
                                       device=dev, metrics=NullRegistry())
                     for p in PRECISIONS[1:]})
    bsr_pr, bsr_iters, bsr_err = {}, {}, {}
    for p in PRECISIONS:
        eng = bsr_engines[p]
        ref_p = pr["dense"] if p == "f32" else dense_low[p]
        before = k3.launches[p]
        bsr_pr[p] = eng.run(N_ITERS)
        torch.cuda.synchronize()
        got = k3.launches[p] - before
        check(got == N_ITERS,
              f"bsr[{p}]: run({N_ITERS}) launched K3 {got} times")
        check(bool(torch.isfinite(bsr_pr[p]).all()), f"bsr[{p}]: bad output")
        e_run = allclose(torch, bsr_pr[p], ref_p, **TOL_TIER,
                         what=f"bsr[{p}] run vs dense[{p}]")
        top_b = top_k_proteins(bsr_pr[p], k=10)[0].cpu().numpy()
        top_d = top_k_proteins(ref_p, k=10)[0].cpu().numpy()
        check(np.array_equal(top_b, top_d),
              f"bsr[{p}] top-10 {top_b} != dense[{p}] {top_d}")
        before = k3.launches[p]
        r = eng.run_tol(tol=1e-6, max_iters=1000)
        torch.cuda.synchronize()
        got = k3.launches[p] - before
        rd = dense_at[p].run_tol(tol=1e-6, max_iters=1000)
        check(r.info.converged and r.info.iters == rd.info.iters,
              f"bsr[{p}] run_tol: {r.info.status} after {r.info.iters} "
              f"iterations, dense[{p}] {rd.info.iters}")
        check(got == issued_sweeps(r.info.iters, 1000, CHUNK),
              f"bsr[{p}] run_tol of {r.info.iters} iterations launched K3 "
              f"{got} times")
        e_tol = allclose(torch, r.pr, rd.pr, **TOL_TIER,
                         what=f"bsr[{p}] run_tol vs dense[{p}]")
        before = k3.launches[p]
        X = eng.ppr(sets8, N_ITERS)
        torch.cuda.synchronize()
        got = k3.launches[p] - before
        check(got == N_ITERS,
              f"bsr[{p}]: ppr({N_ITERS}) launched K3 {got} times")
        e_ppr = allclose(torch, X, dense_at[p].ppr(sets8, N_ITERS),
                         **TOL_TIER, what=f"bsr[{p}] ppr vs dense[{p}]")
        bsr_err[p] = {"run": e_run, "run_tol": e_tol, "ppr": e_ppr}
        bsr_iters[p] = r.info.iters
        print(f"  bsr[{p}] vs dense[{p}] max|diff| (rtol 1e-5, atol 1e-7): "
              f"run {e_run:.3e}, run_tol {e_tol:.3e} ({r.info.iters} "
              f"iterations each), ppr {e_ppr:.3e}; top-10 {top_b.tolist()}")
    bsr_launches = dict(k3.launches)
    bsr_s = time.perf_counter() - t_bsr
    check(all(bsr_launches[p] > 0 for p in PRECISIONS),
          f"the bsr path launched K3 {bsr_launches}")
    print(f"  bsr path took {bsr_s:.2f} s; K3 launches {bsr_launches}")

    # --------------------------------------------------------------- 3d --
    print(f"ops.pagerank_iteration: quickstart's loop at N={N_NODES}, "
          f"{N_ITERS} steps on the dense tier's H: f32 (dangling-fixed), "
          "bf16 and f16 (unfixed, with the dangling leak); K4 launch counts "
          "zeroed before and read after")
    k1.reset_launches()
    e_ops = {}
    for p in K4_PRECISIONS:
        H = dense_at[p].operands[0]
        dang = None if p == "f32" else dense_at[p]._dang
        x = torch.full((N_NODES,), 1.0 / N_NODES, device=dev)
        for _ in range(N_ITERS):
            x = ops.pagerank_iteration(H, x, dang, d=DAMPING)
        torch.cuda.synchronize()
        want = (pagerank_dense_fixed(H, n_iters=N_ITERS, d=DAMPING)
                if p == "f32" else dense_low[p])
        # tests/test_kernels.py's tolerance for the kernel loop against
        # the dense reference
        e_ops[p] = allclose(torch, x, want, rtol=1e-4, atol=1e-7,
                            what=f"ops.pagerank_iteration loop [{p}] vs "
                            "the dense tier")
        top_ops = top_k_proteins(x, k=10)[0].cpu().numpy()
        top_ref = top_k_proteins(want, k=10)[0].cpu().numpy()
        check(np.array_equal(top_ops, top_ref),
              f"ops loop [{p}] top-10 {top_ops} != dense {top_ref}")
    k4_launches = dict(k1.step_launches)
    check(k4_launches == {q: N_ITERS if q in K4_PRECISIONS else 0
                          for q in PRECISIONS}
          and sum(k1.launches.values()) == 0,
          f"the loops launched K4 {k4_launches}, K1 {k1.launches}")
    print("  max|diff| "
          + ", ".join(f"{p} {e:.3e}" for p, e in e_ops.items())
          + f"; top-10 as the dense tier; K4 launches {k4_launches}")

    # --------------------------------------------------------------- 3e --
    print(f"live updates: EdgeStream({N_NODES}, {STREAM}), {TICKS} ticks "
          f"of push_update + flush, {QUERIES_PER_TICK} Zipf picks from the "
          "serve pool per tick through ResultCache(1024); launch counts "
          "zeroed before and read after each flush")
    zipf_w = 1.0 / np.arange(1, POOL + 1, dtype=np.float64) ** ZIPF_S
    zipf_w /= zipf_w.sum()
    live = {}
    for backend in ("bsr", "fused_dense"):
        t_live = time.perf_counter()
        stream = EdgeStream(N_NODES, **STREAM)
        cur = stream.base()
        reg = MetricsRegistry()
        dyn = DynamicPageRankEngine(cur[0], cur[1], N_NODES, d=DAMPING,
                                    backend=backend, device=dev,
                                    metrics=reg)
        dyn.run_tol(1e-7, max_iters=1000)
        cache = ResultCache(1024)
        qe = PageRankQueryEngine(dyn, n_iters=N_ITERS, max_batch=SERVE_BATCH,
                                 metrics=reg, cache=cache)
        rng = np.random.default_rng(SEED + 3)
        ticks = []
        for tick, delta in zip(range(TICKS), stream):
            qe.push_update(delta)
            queries = [qe.submit(tick * 10 + q,
                                 pool[rng.choice(POOL, p=zipf_w)], top_k=10)
                       for q in range(QUERIES_PER_TICK)]
            for k in (k1, k2, k3):
                k.reset_launches()
            qe.flush()
            torch.cuda.synchronize()
            info = qe.last_update_info
            check(qe.n_refreshes == tick + 1 and info.healthy,
                  f"{backend} tick {tick}: refresh {info}")
            misses = sum(q.cache_outcome == "miss" for q in queries)
            # the push launches once for its start residual and once per
            # issued sweep; warm and rebuild once per issued step (K1 on
            # the fused tier); the flush's cold ppr N_ITERS times
            solve = issued_sweeps(info.iters, 1000, CHUNK)
            push = info.strategy == "push"
            ppr_l = N_ITERS if misses else 0
            if backend == "bsr":
                want = {"K1": 0, "K2": 0,
                        "K3": solve + int(push) + ppr_l}
            else:
                want = {"K1": 0 if push else solve,
                        "K2": (solve + 1 if push else 0) + ppr_l, "K3": 0}
            got = {"K1": sum(k1.launches.values()),
                   "K2": sum(k2.launches.values()),
                   "K3": sum(k3.launches.values())}
            if backend == "fused_dense":
                k2_steps["live.fused_dense"].update(k2.batch_launches)
            check(got == want, f"{backend} tick {tick} ({info.strategy}, "
                  f"{info.iters} sweeps, {misses} misses): launches {got}, "
                  f"want {want}")
            for q in queries:
                check(q.result is not None
                      and np.all(np.isfinite(q.result[1])),
                      f"{backend} tick {tick}: query {q.uid} not served")
            cur = apply_delta(cur[0], cur[1], delta, N_NODES)
            ticks.append({"strategy": info.strategy, "sweeps": info.iters,
                          "coerced_from": info.coerced_from,
                          "misses": misses, **got})
        scratch = PageRankEngine(cur[0], cur[1], N_NODES, d=DAMPING,
                                 backend="dense", device=dev,
                                 metrics=NullRegistry())
        l1 = float(torch.sum(torch.abs(dyn.ranks - scratch.run(300))))
        check(l1 <= 1e-5, f"{backend}: L1(incremental, from scratch) "
              f"{l1:.3e} > 1e-5")
        entries = list(cache._entries.items())
        exact = scratch.ppr([list(k[1]) for k, _ in entries],
                            n_iters=300).cpu().numpy()
        worst = max(float(np.abs(e.ranks - exact[:, j]).sum())
                    for j, (_, e) in enumerate(entries))
        # the gate of examples/streaming_pagerank.py's cache mode
        check(worst <= 1e-4, f"{backend}: a cached answer is {worst:.3e} "
              "from the exact solve of the final graph (L1)")
        upd = reg.histogram("span.update")
        strategies = {s: sum(t["strategy"] == s for t in ticks)
                      for s in ("push", "warm", "rebuild")}
        live[backend] = {
            "strategies": strategies,
            "sweeps": [t["sweeps"] for t in ticks],
            "update_p50_ms": upd.quantile(0.50),
            "update_p95_ms": upd.quantile(0.95),
            "flush_p50_ms": reg.histogram("serve.batch_ms").quantile(0.50),
            "flush_p95_ms": reg.histogram("serve.batch_ms").quantile(0.95),
            "l1_vs_scratch": l1, "cached_l1_max": worst,
            "cached_entries": len(entries), "cache_hits": cache.hits,
            "invalidations": cache.invalidations,
            "launches": {k: sum(t[k] for t in ticks)
                         for k in ("K1", "K2", "K3")},
            "edges": int(dyn.n_edges), "layout": dyn.layout,
            "phase_s": time.perf_counter() - t_live}
        print(f"  {backend}: strategies {strategies} (sweeps "
              f"{live[backend]['sweeps']}); update p50 "
              f"{live[backend]['update_p50_ms']:.3f} ms, p95 "
              f"{live[backend]['update_p95_ms']:.3f} ms on {card}; flush "
              f"p50 {live[backend]['flush_p50_ms']:.3f} ms; L1 vs scratch "
              f"{l1:.3e}; {len(entries)} cached answers, worst L1 vs exact "
              f"{worst:.3e}; {cache.hits} hits, {cache.invalidations} "
              f"invalidated; launches {live[backend]['launches']}")

    # --------------------------------------------------------------- 3f --
    script = [f"{k}:{v}" for k, v in FAULTY_SCRIPT]
    print(f"resilient serve: EdgeStream({N_NODES}, {FAULTY_STREAM}), "
          f"{len(script)} steps {script}, PageRankQueryEngine(n_iters=60, "
          "max_batch=4, resilience=ServeResilience(healthy_atol=SUM_TOL)), "
          "2 queries of 3 seeds a step; launch counts "
          "zeroed before and read after each flush; each tier held to the "
          "same script on the CPU (the plain versions)")
    t_res = time.perf_counter()
    resilient = {}
    res_launches = Counter()
    cpu = torch.device("cpu")
    for backend, p in RESILIENT_TIERS:
        what = f"{backend}[{p}]"
        t0 = time.perf_counter()
        on_card = faulty_stream(np, torch, dev, backend, p, N_NODES,
                                {"K1": k1, "K2": k2, "K3": k3})
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = faulty_stream(np, torch, cpu, backend, p, N_NODES)
        cpu_s = time.perf_counter() - t0
        check_faulty_stream(np, on_card, on_cpu, what)
        per_step = [s["launches"] for s in on_card["steps"]]
        launches = {k: sum(s[k] for s in per_step) for k in ("K1", "K2",
                                                            "K3")}
        res_launches.update(launches)
        want = {"K3"} if backend == "bsr" else {"K1", "K2"}
        check({k for k, v in launches.items() if v} == want,
              f"{what}: launches {launches}, want {sorted(want)} only")
        l1_cpu = float(np.abs(on_card["ranks"] - on_cpu["ranks"]).sum())
        check(l1_cpu <= 1e-5, f"{what}: L1(card, cpu) {l1_cpu:.3e}")
        l1_scratch = None
        if p == "f32":
            e = float(np.abs(on_card["ranks"] - on_cpu["ranks"]).max())
            check(bool(np.allclose(on_card["ranks"], on_cpu["ranks"],
                                   **TOL_TIER)),
                  f"{what}: final ranks vs the cpu run max|diff| {e:.3e} "
                  f"outside {TOL_TIER}")
            scratch = PageRankEngine(*on_card["edges"], N_NODES, d=DAMPING,
                                     backend="dense", device=dev,
                                     metrics=NullRegistry()).run(300)
            l1_scratch = float(np.abs(on_card["ranks"] - scratch.double()
                                      .cpu().numpy()).sum())
            check(l1_scratch <= 1e-5, f"{what}: L1(live, from scratch) "
                  f"{l1_scratch:.3e} > 1e-5")
        resilient[what] = {
            "steps": on_card["steps"],
            "dead_letters": on_card["dead_letters"],
            "log": on_card["log"], "l1_vs_cpu": l1_cpu,
            "l1_vs_scratch": l1_scratch, "launches": launches,
            "card_s": card_s, "cpu_s": cpu_s}
        steps = on_card["steps"]
        print(f"  {what}: refreshes "
              f"{[s['refresh'] and s['refresh'][0] for s in steps]}; "
              f"queries {[s['queries'][0][0] for s in steps]}; serve "
              f"recoveries {sum(s['recovers'] for s in steps)}; the cpu "
              "run's equal; dead letters "
              f"{on_card['dead_letters']}; L1 vs cpu {l1_cpu:.3e}"
              + ("" if l1_scratch is None
                 else f", vs scratch {l1_scratch:.3e}")
              + f"; {card_s:.2f} s on the card, {cpu_s:.2f} s on the cpu")
        print(f"  {what} launches per step: "
              + "; ".join(f"{s['fault']} "
                          + " ".join(f"{k}={v}" for k, v in
                                     s["launches"].items() if v)
                          for s in on_card["steps"]))
    check(all(res_launches[k] > 0 for k in ("K1", "K2", "K3")),
          f"resilient serve launches {dict(res_launches)}")
    print("  injector log (every tier): "
          f"{resilient['fused_dense[f32]']['log']}")

    # the watchdog's cost, run_tol(tol=0) for 100 iterations with and
    # without it (interleaved, median of 5 each), on K1 and on K3
    watchdog = {}
    for name, eng in (("fused_dense", fused), ("bsr", bsr_engines["f32"])):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            times = {True: [], False: []}
            for _ in range(5):
                for on in (True, False):
                    times[on].append(wall_ms(torch, lambda: eng.run_tol(
                        tol=0.0, max_iters=100, watchdog=on), rounds=1))
        on_ms = statistics.median(times[True])
        off_ms = statistics.median(times[False])
        watchdog[name] = {"on_ms": on_ms, "off_ms": off_ms,
                          "per_iter_us": (on_ms - off_ms) * 10.0}
        print(f"  watchdog on {name} f32: run_tol(tol=0, 100 iterations) "
              f"{on_ms:.3f} ms with it, {off_ms:.3f} ms without: "
              f"{watchdog[name]['per_iter_us']:.2f} us per iteration on "
              f"{card}")
    # restore(snapshot) against a fresh engine and a cold run_tol(1e-6)
    restore = {}
    for backend in ("fused_dense", "bsr"):
        dyn = DynamicPageRankEngine(src, dst, N_NODES, d=DAMPING,
                                    backend=backend, device=dev,
                                    metrics=NullRegistry())
        dyn.run_tol(1e-6)
        snap = dyn.snapshot()
        r_ms = wall_ms(torch, lambda: dyn.restore(snap), rounds=3)
        c_ms = wall_ms(torch, lambda: DynamicPageRankEngine(
            src, dst, N_NODES, d=DAMPING, backend=backend, device=dev,
            metrics=NullRegistry()).run_tol(1e-6), rounds=3)
        check(bool(torch.equal(dyn.ranks.cpu(), torch.from_numpy(
            snap.ranks))), f"{backend}: restore changed the ranks")
        restore[backend] = {"restore_ms": r_ms, "cold_ms": c_ms}
        print(f"  restore(snapshot) on {backend} f32: {r_ms:.2f} ms; a "
              f"fresh engine and a cold run_tol(1e-6) {c_ms:.2f} ms "
              f"(median of 3) on {card}")
    # clean ticks: the resilient mode against the legacy one, two engines
    # fed the same 16 deltas and queries, their flushes taken in turns
    # (the legacy one first on even ticks)
    flushes = {}
    for backend in ("fused_dense", "bsr"):
        stream = EdgeStream(N_NODES, **FAULTY_STREAM)
        cur = stream.base()
        serving = {}
        for mode in ("legacy", "resilient"):
            reg = MetricsRegistry()
            dyn = DynamicPageRankEngine(cur[0], cur[1], N_NODES, d=DAMPING,
                                        backend=backend, device=dev,
                                        metrics=reg)
            dyn.run_tol(1e-7)
            serving[mode] = (reg, PageRankQueryEngine(
                dyn, n_iters=60, max_batch=4, metrics=reg,
                resilience=ServeResilience() if mode == "resilient"
                else None))
        rng = np.random.default_rng(SEED)
        for tick, delta in zip(range(TICKS), stream):
            seeds = [rng.choice(N_NODES, size=3, replace=False)
                     for _ in range(2)]
            order = ("legacy", "resilient")[::1 if tick % 2 == 0 else -1]
            for mode in order:
                qe = serving[mode][1]
                qe.push_update(delta)
                qs = [qe.submit(tick * 10 + q, s) for q, s in
                      enumerate(seeds)]
                qe.flush()
                check(all(q.status == ("fresh" if mode == "resilient"
                                       else "unserved") for q in qs)
                      and qe.last_update_info.healthy,
                      f"{backend} {mode} tick {tick}: {qs[0].status}")
        for mode, (reg, _) in serving.items():
            h = reg.histogram("serve.batch_ms")
            flushes[f"{backend}.{mode}"] = {"p50_ms": h.quantile(0.5),
                                            "p95_ms": h.quantile(0.95)}
        print(f"  {TICKS} clean ticks on {backend} f32, flush p50 / p95 "
              "(the two modes in turns): legacy "
              f"{flushes[backend + '.legacy']['p50_ms']:.3f} / "
              f"{flushes[backend + '.legacy']['p95_ms']:.3f} ms, resilient "
              f"{flushes[backend + '.resilient']['p50_ms']:.3f} / "
              f"{flushes[backend + '.resilient']['p95_ms']:.3f} ms on {card}")
    resilient_stats = {"tiers": resilient, "watchdog": watchdog,
                       "restore": restore, "flush": flushes,
                       "launches": dict(res_launches),
                       "phase_s": time.perf_counter() - t_res}
    print(f"  resilient phase took {resilient_stats['phase_s']:.2f} s")

    # --------------------------------------------------------------- 3g --
    print("fabric simulator: the Fig. 5 codec, Fig. 2 and Fig. 5 in hop "
          f"mode, a hop-mode matvec on the {FABRIC_SIDE} x "
          f"{FABRIC_SIDE + 1} fabric, pagerank_on_fabric at N = "
          f"{FABRIC_SIDE} and the Fig. 4C tiled schedule at N = {N_NODES}, "
          f"{N_ITERS} iterations")
    t_fab = time.perf_counter()
    fabric_stats = fabric_phase(np, torch, dev, src, dst, card)
    fabric_stats["phase_s"] = time.perf_counter() - t_fab
    print(f"  fabric phase took {fabric_stats['phase_s']:.2f} s")

    # --------------------------------------------------------------- 3h --
    print(f"sharded mesh tiers: protein_network({N_NODES}), {N_ITERS} "
          f"iterations, d={DAMPING}, every mesh position on the one card; "
          "K2 launch counts zeroed before and read after each step")
    t_shard = time.perf_counter()
    flush_3h = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    sharded_stats = sharded_phase(np, torch, dev, src, dst, sets8, card,
                                  flush_3h)
    del flush_3h
    sharded_stats["phase_s"] = time.perf_counter() - t_shard
    print(f"  sharded phase took {sharded_stats['phase_s']:.2f} s")

    # --------------------------------------------------------------- 3i --
    print(f"LM serving: {LLM_ARCH} at its full published width in bf16, "
          "the launcher's traffic, decode against forward, prefill and "
          "decode times; the ten smoke configs card against CPU; the "
          "serve example")
    t_lm = time.perf_counter()
    lm_stats = lm_phase(np, torch, dev, card)
    lm_stats["phase_s"] = time.perf_counter() - t_lm
    print(f"  LM phase took {lm_stats['phase_s']:.2f} s")

    # --------------------------------------------------------------- 3j --
    print(f"LM training: the ten smoke configs' train step card against "
          f"CPU; {TRAIN_ARCH} at its full published width through the "
          "launcher; the fault drill; the training example")
    t_train = time.perf_counter()
    train_stats = train_phase(np, torch, dev, card)
    train_stats["phase_s"] = time.perf_counter() - t_train
    print(f"  training phase took {train_stats['phase_s']:.2f} s")

    # --------------------------------------------------------------- 3k --
    print(f"LM on the mesh, every position on the one card: moe_ep of the "
          f"MoE smoke configs card against CPU; {MESH_ARCH} at full width "
          "served on a 1 x 4 mesh and without; one full-width MoE layer and "
          f"the {MESH_TRAIN_LAYERS}-layer full-width trainer on 2 x 4; the "
          "launcher's host mesh")
    t_mesh = time.perf_counter()
    mesh_lm_stats = mesh_lm_phase(np, torch, dev, card)
    mesh_lm_stats["phase_s"] = time.perf_counter() - t_mesh
    print(f"  mesh LM phase took {mesh_lm_stats['phase_s']:.2f} s")

    # --------------------------------------------------------------- 3l --
    print("the multi-pod dry run on meta tensors held to the card: "
          f"{TRAIN_ARCH}'s train cell against the card's state and step; "
          f"{MESH_ARCH}'s decode collectives against phase 3k's; the "
          "command line in its own process")
    t_dry = time.perf_counter()
    dryrun_stats = dryrun_phase(
        np, torch, dev, card,
        mesh_lm_stats["serve"]["collectives_per_step"])
    dryrun_stats["phase_s"] = time.perf_counter() - t_dry
    print(f"  dry-run phase took {dryrun_stats['phase_s']:.2f} s")

    # ---------------------------------------------------------------- 4 --
    print(f"times on {card} (CUDA events, medians of CUDA-graph replays; "
          "'flushed': one call after a 256 MiB write evicts the L2, "
          "'warm': back to back, as run(100) sees it):")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rows = []

    def step_row(p, kernel, variant):
        """The core's configuration for K1 / K4 at storage type p, and the
        registers and spills of the instantiation the path runs."""
        info = step_regs.get((kernel, p, step_configs[p], variant), {})
        return {"config": dict(zip(STEP_CONFIG_KEYS, step_configs[p])),
                "registers": info.get("registers"),
                "spill_stores": info.get("spill_stores"),
                "spill_loads": info.get("spill_loads")}

    for p in PRECISIONS:
        eng = engines[p]
        Hp, dangp = eng.operands
        scales = eng._scales
        xp = torch.zeros((1, Hp.shape[1]), device=dev)
        xp[0, :N_NODES] = pr["fused_dense"]
        t = torch.tensor(0.15 / N_NODES, device=dev)
        Np, Mp = Hp.shape

        def kernel():
            k1.pagerank_step_fused(Hp, xp, dangp, t, scales, d=DAMPING)

        def plain():
            pagerank_step_fused_ref(Hp, xp, dangp, t, scales, d=DAMPING)

        ms = cuda_ms_cold(torch, kernel, flush)
        warm_ms = cuda_ms(torch, kernel)
        call_ms = eager_ms(torch, kernel)
        plain_ms = cuda_ms_cold(torch, plain, flush)
        library_ms = None
        if p == "f32":
            tvec = t.expand(Np).contiguous()
            x1 = xp[0]
            library_ms = cuda_ms_cold(torch, lambda: torch.addmv(
                tvec, Hp, x1, alpha=DAMPING), flush)
        nbytes = (Hp.numel() * Hp.element_size() + 4 * (Mp + Np + 1)
                  + (0 if scales is None else 4 * Np) + 4 * (Np + 1))
        ops = 2 * Np * Mp + 4 * Np
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        rows.append({
            "name": f"pagerank_step_fused[{p}]", "route": "cuda",
            "source": K1_SOURCE, "replaces": K1_REPLACES,
            "launches": main_launches[p], "max_abs_err": max_err[p],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "ms_warm_l2": warm_ms,
            "ms_eager_call": call_ms,
            "shape": [Np, Mp], "bytes": nbytes,
            **step_row(p, "K1", scales is not None)})
        print(f"  K1 {p}: {ms * 1e3:.2f} us/step flushed, "
              f"{warm_ms * 1e3:.2f} us warm, {call_ms * 1e3:.2f} us per "
              f"eager call; bound {max(bytes_ms, ops_ms) * 1e3:.2f} us "
              f"({nbytes} bytes at {HBM_BYTES_PER_S / 1e12} TB/s); plain "
              f"{plain_ms * 1e3:.2f} us flushed"
              + ("" if library_ms is None
                 else f"; torch.addmv {library_ms * 1e3:.2f} us flushed")
              + f"; {rows[-1]['config']}, {rows[-1]['registers']} registers, "
              f"{rows[-1]['spill_stores']} / {rows[-1]['spill_loads']} bytes "
              "spilled (stores / loads)")
    rng = np.random.default_rng(SEED + 1)
    for p in PRECISIONS:
        W = engines[p].operands[0]
        Np, Mp = W.shape
        for B in K2_BATCHES:
            Xh = np.zeros((B, Mp), np.float32)
            Xh[:, :N_NODES] = rng.dirichlet(np.ones(N_NODES), size=B)
            X = torch.from_numpy(Xh).to(dev)

            def kernel():
                k2.streaming_matvec(W, X)

            def plain():
                streaming_matvec_ref(W, X)

            ms = cuda_ms_cold(torch, kernel, flush)
            warm_ms = cuda_ms(torch, kernel)
            call_ms = eager_ms(torch, kernel)
            plain_ms = cuda_ms_cold(torch, plain, flush)
            library_ms = None
            if p == "f32":
                library_ms = cuda_ms_cold(torch, lambda: X @ W.T, flush)
            nbytes = W.numel() * W.element_size() + 4 * B * (Mp + Np)
            # the tensor-core operations of the cheapest split product
            ops_ms, ops, scheme = split_bound(p, B * Np * Mp)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            by = "bytes" if bytes_ms >= ops_ms else "operations"
            by_step = {step: c[(p, B)] for step, c in k2_steps.items()
                       if c[(p, B)]}
            launched = sum(by_step.values())
            check(launched > 0, f"the paths launched K2 {p} at B={B} no "
                  "time")
            qp, _ = k2_config(p, B)
            ptxas = k2_regs.get((p, qp), {})
            rows.append({
                "name": f"streaming_matvec[{p},B={B}]", "route": "cuda",
                "source": K2_SOURCE, "replaces": K2_REPLACES,
                "launches": launched, "launches_by_step": by_step,
                "max_abs_err": k2_err[(p, B)], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": library_ms, "ms_warm_l2": warm_ms,
                "ms_eager_call": call_ms, "shape": [Np, Mp], "batch": B,
                "bytes": nbytes, "operations": ops, "ops_scheme": scheme,
                "config": dict(k2_configs[(p, qp)], QP=qp),
                "registers": ptxas.get("registers"),
                "spill_stores": ptxas.get("spill_stores"),
                "spill_loads": ptxas.get("spill_loads")})
            print(f"  K2 {p} B={B}: {ms * 1e3:.2f} us flushed, "
                  f"{warm_ms * 1e3:.2f} us warm, {call_ms * 1e3:.2f} us per "
                  f"eager call; bound {bound * 1e3:.2f} us by {by} "
                  f"({nbytes} bytes at {HBM_BYTES_PER_S / 1e12} TB/s, "
                  f"{ops} tensor-core operations, {scheme}); plain "
                  f"{plain_ms * 1e3:.2f} us flushed"
                  + ("" if library_ms is None else
                     f"; X @ W.T (TF32 off) {library_ms * 1e3:.2f} us "
                     "flushed")
                  + f"; launches {by_step}; QP={qp} "
                  f"{k2_configs[(p, qp)]}, {ptxas.get('registers')} "
                  "registers, "
                  f"{ptxas.get('spill_stores')} / {ptxas.get('spill_loads')} "
                  "bytes spilled (stores / loads)")
    for p in PRECISIONS:
        bsr = bsr_engines[p].operands[0]
        blocks, cols = bsr.blocks, bsr.block_cols
        nb_r, mb, bs, _ = blocks.shape
        Mp, Np = -(-N_NODES // bs) * bs, nb_r * bs
        # the blocks this run's data needs: the stored non-padding ones
        real = (blocks != 0).flatten(2).any(dim=2)            # (nb_r, mb)
        nnzb = int(real.sum())
        sparse = None
        if p == "f32":
            counts = real.sum(dim=1)
            crow = torch.zeros(nb_r + 1, dtype=torch.int64, device=dev)
            crow[1:] = torch.cumsum(counts, 0)
            try:
                sparse = torch.sparse_bsr_tensor(
                    crow, cols[real].long(), blocks[real], size=(Np, Mp))
            except (RuntimeError, TypeError) as exc:
                print(f"  torch.sparse_bsr_tensor: not available ({exc})")
        for B in (1, SERVE_BATCH, N_HUBS):
            Xh = np.zeros((B, Mp), np.float32)
            Xh[:, :N_NODES] = rng.dirichlet(np.ones(N_NODES), size=B)
            X = torch.from_numpy(Xh).to(dev)
            XT = X.T.contiguous()

            def kernel():
                k3.bsr_spmv(blocks, cols, X)

            def plain():
                bsr_spmv_ref(blocks, cols, X)

            ms = cuda_ms_cold(torch, kernel, flush)
            warm_ms = cuda_ms(torch, kernel)
            call_ms = eager_ms(torch, kernel)
            plain_ms = cuda_ms_cold(torch, plain, flush)
            library_ms, library_note = None, None
            if p != "f32":
                library_note = (f"no single PyTorch call takes {p} blocks "
                                "with a float32 X and accumulates in "
                                "float32")
            if sparse is not None:
                try:
                    library_ms = cuda_ms_cold(torch, lambda: sparse @ XT,
                                              flush)
                except (RuntimeError, NotImplementedError) as exc:
                    library_note = f"sparse BSR @ dense failed: {exc}"
                    print(f"  K3 library call: {library_note}")
            nbytes = (nnzb * bs * bs * blocks.element_size()
                      + 4 * cols.numel() + 4 * B * (Mp + Np))
            # as K2's: the cheapest split product on the tensor cores
            ops_ms, ops_n, scheme = split_bound(p, B * nnzb * bs * bs)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            by = "bytes" if bytes_ms >= ops_ms else "operations"
            tile = k3_tiles[min(64, 1 << (B - 1).bit_length())]
            ptxas = k3_regs.get((p, tile), {})
            rows.append({
                "name": f"bsr_spmv[{p},B={B}]", "route": "cuda",
                "source": K3_SOURCE, "replaces": K3_REPLACES,
                "launches": bsr_launches[p],
                "max_abs_err": k3_err[(p, B)], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": library_ms, "ms_warm_l2": warm_ms,
                "ms_eager_call": call_ms, "shape": list(blocks.shape),
                "nonzero_blocks": nnzb, "batch": B, "bytes": nbytes,
                "operations": ops_n, "ops_scheme": scheme,
                "library_note": library_note,
                "tile": dict(zip(K3_TILE_KEYS, tile)),
                "registers": ptxas.get("registers"),
                "spill_stores": ptxas.get("spill_stores"),
                "spill_loads": ptxas.get("spill_loads")})
            print(f"  K3 {p} B={B}: {ms * 1e3:.2f} us flushed, "
                  f"{warm_ms * 1e3:.2f} us warm, {call_ms * 1e3:.2f} us per "
                  f"eager call; bound {bound * 1e3:.2f} us by {by} "
                  f"({nnzb} of {nb_r * mb} blocks, {nbytes} bytes, {ops_n} "
                  f"tensor-core operations, {scheme}); plain "
                  f"{plain_ms * 1e3:.2f} us flushed"
                  + ("" if library_ms is None else
                     f"; sparse BSR @ X (cuSPARSE) {library_ms * 1e3:.2f} "
                     "us flushed")
                  + f"; tile {dict(zip(K3_TILE_KEYS, tile))}, "
                  f"{ptxas.get('registers')} registers, "
                  f"{ptxas.get('spill_stores')} / {ptxas.get('spill_loads')} "
                  "bytes spilled (stores / loads)")
    xv = pr["dense"].contiguous()
    tt = torch.tensor(0.15 / N_NODES, device=dev)
    for p in K4_PRECISIONS:
        # the dense tier's (N, N) H at each precision, as the loops of
        # phase 3d ran it
        Hs = dense_at[p].operands[0]

        def kernel():
            k1.pagerank_step(Hs, xv, tt, d=DAMPING)

        def plain():
            pagerank_step_ref(Hs, xv, tt, d=DAMPING)

        ms = cuda_ms_cold(torch, kernel, flush)
        warm_ms = cuda_ms(torch, kernel)
        call_ms = eager_ms(torch, kernel)
        plain_ms = cuda_ms_cold(torch, plain, flush)
        library_ms = None
        if p == "f32":
            tvec = tt.expand(N_NODES).contiguous()
            library_ms = cuda_ms_cold(torch, lambda: torch.addmv(
                tvec, Hs, xv, alpha=DAMPING), flush)
        nbytes = Hs.numel() * Hs.element_size() + 4 * (2 * N_NODES + 1)
        ops_n = 2 * N_NODES * N_NODES + 2 * N_NODES
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_n / F32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        rows.append({
            "name": f"pagerank_step[{p}]", "route": "cuda",
            "source": K4_SOURCE, "replaces": K4_REPLACES,
            "launches": k4_launches[p], "max_abs_err": k4_err[p], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, "ms_warm_l2": warm_ms,
            "ms_eager_call": call_ms, "shape": [N_NODES, N_NODES],
            "bytes": nbytes, **step_row(p, "K4", True)})
        print(f"  K4 {p}: {ms * 1e3:.2f} us flushed, {warm_ms * 1e3:.2f} us "
              f"warm, {call_ms * 1e3:.2f} us per eager call; bound "
              f"{bound * 1e3:.2f} us by {by} ({nbytes} bytes); plain "
              f"{plain_ms * 1e3:.2f} us flushed"
              + ("" if library_ms is None
                 else f"; torch.addmv {library_ms * 1e3:.2f} us flushed")
              + f"; {rows[-1]['config']}, {rows[-1]['registers']} registers, "
              f"{rows[-1]['spill_stores']} / {rows[-1]['spill_loads']} bytes "
              "spilled (stores / loads)")
    print("the split-ELL step at the graph500_22.solve cell's shapes:")
    ell_stats = ell_step_phase(np, torch, dev, card, flush)
    del flush
    rows.append(sharded_stats["k2_row"])
    rows.extend(ell_stats["rows"])

    tiers = {"dense": dense, "ell": ell, "fused_dense": fused}
    tiers.update({f"fused_dense[{p}]": engines[p] for p in PRECISIONS[1:]})
    tiers.update({"bsr" if p == "f32" else f"bsr[{p}]": bsr_engines[p]
                  for p in PRECISIONS})
    run_ms = {name: wall_ms(torch, lambda e=e: e.run(N_ITERS))
              for name, e in tiers.items()}
    iters.update({"bsr": bsr_iters["f32"]})
    tol_ms = {b: wall_ms(torch, lambda e=e: e.run_tol(tol=1e-6))
              for b, e in (("dense", dense), ("fused_dense", fused),
                           ("bsr", bsr_engines["f32"]))}
    for name, v in run_ms.items():
        print(f"  run({N_ITERS}) {name}: {v:.3f} ms")
    for name, v in tol_ms.items():
        print(f"  run_tol(1e-6) {name}: {v:.3f} ms ({iters[name]} iters)")

    # the two paths K3 serves at B >= 8, on bsr f32 and, beside them, on
    # fused_dense f32 (K2): wall time, median of 5 after one warm-up call,
    # with the launches of those 6 calls checked exactly
    e2e = {}

    def launched(name):
        got = {"K2": dict(k2.launches), "K3": dict(k3.launches)}
        kern = "K3" if name == "bsr" else "K2"
        want = {k: {q: 6 * N_ITERS if (k == kern and q == "f32") else 0
                    for q in PRECISIONS} for k in ("K2", "K3")}
        check(got == want, f"{name}: launches {got}, want {want}")
        return 6 * N_ITERS

    serve_engines = {"bsr": bsr_engines["f32"], "fused_dense": engines["f32"]}
    for name, eng in serve_engines.items():
        k2.reset_launches()
        k3.reset_launches()
        e2e[f"{name}_ppr8_ms"] = wall_ms(
            torch, lambda e=eng: e.ppr(sets8, N_ITERS))
        e2e[f"{name}_ppr8_launches"] = launched(name)
    lms = {}
    for name, eng in serve_engines.items():
        lms[name] = LandmarkIndex(eng, n_hubs=N_HUBS, tol=LM_TOL,
                                  max_pushes=LM_MAX_PUSHES, n_iters=N_ITERS,
                                  metrics=NullRegistry())
        k2.reset_launches()
        k3.reset_launches()
        e2e[f"{name}_landmark_build_ms"] = wall_ms(
            torch, lambda i=lms[name]: i.build(0))
        e2e[f"{name}_landmark_build_launches"] = launched(name)
    check(np.array_equal(lms["bsr"].hubs, lms["fused_dense"].hubs),
          "the bsr and fused_dense indexes chose different hubs")
    e2e["landmark_columns_max_abs_diff"] = allclose(
        torch, torch.from_numpy(lms["bsr"]._Y),
        torch.from_numpy(lms["fused_dense"]._Y), **TOL_TIER,
        what="bsr landmark hub columns vs fused_dense's")
    for name in serve_engines:
        kern = "K3" if name == "bsr" else "K2"
        print(f"  {name} f32 ppr({SERVE_BATCH} seed sets, {N_ITERS}): "
              f"{e2e[f'{name}_ppr8_ms']:.3f} ms wall (median of 5); "
              f"{N_HUBS}-hub landmark build: "
              f"{e2e[f'{name}_landmark_build_ms']:.3f} ms wall (median of "
              f"5); {kern} launches {N_ITERS} per call, "
              f"{e2e[f'{name}_ppr8_launches']} and "
              f"{e2e[f'{name}_landmark_build_launches']} over the 6 calls "
              "of each, as counted")
    print(f"  bsr landmark hub columns vs fused_dense's max|diff| "
          f"{e2e['landmark_columns_max_abs_diff']:.3e} (rtol 1e-5, atol "
          "1e-7)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fused.run(10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fused.run(10)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if kernels:
        names = sorted({e.name for e in kernels})
        print(f"  fused_dense f32: {len(kernels) / 10:.1f} device launches "
              f"per iteration (torch.profiler over run(10)): {names}")
    else:
        print("  fused_dense launches per iteration: not measured "
              "(the profiler recorded no device events)")

    print(f"chip_smoke took {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"run_ms": run_ms, "run_tol_ms": tol_ms,
                      "run_tol_iters": iters, "build_s": built["seconds"],
                      "main_path_s": main_s, "serve": serve_stats,
                      "bsr": {"max_abs_diff_vs_dense": bsr_err,
                              "k3_launches": bsr_launches,
                              "phase_s": bsr_s},
                      "ops_loop": {"max_abs_diff": e_ops,
                                   "k4_launches": k4_launches},
                      "live": live, "k3_serve_paths": e2e,
                      "resilient": resilient_stats,
                      "fabric": fabric_stats,
                      "sharded": {k: v for k, v in sharded_stats.items()
                                  if k != "k2_row"},
                      "lm": lm_stats,
                      "train": train_stats,
                      "mesh_lm": mesh_lm_stats,
                      "dryrun": dryrun_stats,
                      "ell_step": {k: v for k, v in ell_stats.items()
                                   if k != "rows"},
                      "k2_launches_by_step": {
                          step: {f"{p},B={b}": n for (p, b), n in c.items()}
                          for step, c in k2_steps.items()},
                      "k2_ptxas": [
                          {"storage": p, "QP": qp, **k2_configs[(p, qp)],
                           **info}
                          for (p, qp), info in k2_regs.items()],
                      "k3_ptxas": [
                          {"storage": p, "tile": dict(zip(K3_TILE_KEYS, t)),
                           **info} for (p, t), info in k3_regs.items()],
                      "step_ptxas": [
                          {"kernel": k, "storage": p,
                           "variant": STEP_VARIANTS[(k, v)],
                           **dict(zip(STEP_CONFIG_KEYS, c)), **info}
                          for (k, p, c, v), info in step_regs.items()]}))
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
