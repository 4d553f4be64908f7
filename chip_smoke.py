#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout. It builds every hand-written kernel of
the port from ``src/repro_torch/kernels/csrc`` (into ``build/``), holds
each neighbor-search kernel bitwise against its plain PyTorch version
(``rwkv_scan`` within 1e-5 x max(1, its largest magnitude)), then drives these paths
and checks each against the brute-force oracle or against itself:

- the static query path: ``repro_torch.api`` on a 1M-point KITTI-like
  scene queried by its own points, in knn and in range mode, also checked
  against the port's CPU planning; ``knn_tile_anchored`` bitwise against
  its plain version on sampled tiles of every level and on two
  whole-grid-window tiles, at k = 8 and at k = 100 (the most work items a
  tile can be split into, each merge 100 entries a row). Each launch
  reports how it splits: its work items, the most of one tile, the
  occupied and walked window slots, and the kernel's scratch bytes;
- what the reference accepts beyond the main path's k and query tile:
  ``api.query`` on a 20k-point KITTI-like scene at query tiles 8, 40 and
  2048 (masked CTAs, row blocks) and k = 129 and 300 (passes of 128
  columns), knn and range, each against the oracle on every query and
  ``knn_tile_anchored`` bitwise against its plain version (phase
  ``any_k_and_tile``); ``knn_tile`` and ``range_count`` at tile 8 and
  k = 129, and on streams that their split cuts into several work items
  a tile (ties across item boundaries, tiles 8 and 2048 at k = 129,
  streams 8 % valid), in phase ``layer_vs_plain``;
- the host-planned path: ``NeighborSearch.query`` (partition plan,
  bundling, ``QueryExecutor``) on the same scene in knn and range mode,
  with two blocking transfers per query (the plan fetch and the result
  wait), knn distances bitwise equal to ``api.query``'s, and no new
  launcher on a repeated query;
- the kernel layer (``kernels/ops``: ``knn_tile``, ``range_count``,
  ``distance_tile``) at the static plan's shapes: 64 of its tiles' windows
  materialised as id streams, ``knn_tile`` bitwise equal to
  ``knn_tile_anchored`` on them, ``range_count`` equal to brute force;
  how the two id-stream kernels split them into work items, their
  registers and spills, and the two timed again at 4 x the SM count
  tiles;
- the dynamic path: ``SimulationSession.step`` on 1M particles moving by
  ``benchmarks/fig_dynamic.py``'s trajectory model (8 steps, then one
  that forces a respec, then one more), with one blocking transfer per
  step and both kernels launched on every step;
- the sharded paths (phase ``sharded``, after ``dynamic``):
  ``distributed_neighbor_search`` on the static cell's scene over a (4, 2)
  mesh of slabs sharing the card, knn and range, against ``api.query`` on
  the whole scene, one blocking transfer and 8 launches a query, one
  slab's launch split and held against the plain version (its tile of
  real and parked rows included); then a 4-slab ``ShardedSession`` on the
  dynamic trajectory in range (k = 32) and knn (k = 8) mode beside
  ``SimulationSession``: every row against it, one blocking transfer a
  step (two on the one re-route), 4 launches of each kernel a step, fast
  steps under y/z drift, ``bin_disp_tile`` bitwise on a slab's parked
  rows and shifted origin, step times and the device's idle share;
- the sharded paths on rank layouts (phase ``sharded_ranks``, after
  ``sharded``): a one-rank NCCL group over a ``HashStore``, the (4, 2)
  query (knn, range) and the 4-slab range session (the re-route
  included) on layouts whose one rank holds every slab, in turns with
  the one-process path: bitwise equal, one blocking transfer a query
  and a step (two on the re-route), a launch of each kernel a slab; the
  times of both; the group destroyed after. With two or more cards, 2
  or 4 NCCL ranks, one a card, run the same, every rank's results
  bitwise the one-process path's (by digest); on one card the exchange
  between ranks is not exercised, and the phase says so;
- the LM serving path (phase ``lm_serve``): full-width, full-depth
  ``rwkv6-7b`` with float32 weights from a seed; ``rwkv_scan`` against its
  plain version on layer 0's and the last layer's inputs of a 4 x 2048
  prefill, on the decode shape, an odd length and head widths 8, 16, 12,
  48, 96 and 128 (S = 1, 17, 256); its prefill-shape time, its decode
  launch's device time and its registers from nvcc's report;
  ``make_prefill_step`` timed and profiled; a cache-writing prefill of 64
  tokens against 64 single-token ``decode_step`` calls; ``greedy_generate``
  at ``serve_lm``'s defaults, run three times with identical tokens;
- the LM training path (phase ``lm_train``, after ``lm_serve``):
  ``rwkv6-7b`` at full width with its depth cut to 8 layers, float32
  weights, gradients and AdamW moments, ``make_train_step`` with remat on
  8 x 512 tokens in 2 microbatches: the smoke model's step on the card
  against the CPU's, the chunked core against ``rwkv_scan`` on layer 0's
  inputs, a finite non-zero gradient for every parameter, the loss
  falling over 6 steps on one batch, no blocking transfer in a step and
  one a step in ``ResilientLoop``, a smoke ``ResilientLoop`` resuming
  from its checkpoint after an injected failure, one step with int8
  moments; the step's time, tokens/s, peak memory, profile and FLOP
  share. It launches none of the hand-written kernels (as the
  reference's training runs none of its Pallas kernels);
- the dense attention LMs (phase ``lm_dense``, after ``lm_train``): the
  smoke ``lm-100m`` and ``qwen1.5-110b`` on the card against the CPU
  (logits, decode against the parallel forward, greedy tokens, a train
  step); ``lm-100m`` at full size, float32: ``make_train_step`` on 8 x 256
  tokens in 2 microbatches (loss falling over 6 steps, no blocking
  transfer in a step, step time, tokens/s, peak memory, FLOP share),
  ``launch/train.py`` with no ``--arch`` in a subprocess, a 4 x 2048
  prefill, ``greedy_generate`` at ``serve_lm``'s defaults and single
  decode steps (no blocking transfer), and ``scaled_dot_product_attention``
  against the port's ``_sdpa`` on layer 0's q/k/v for the record;
  ``qwen1.5-110b`` at full width cut to 2 layers: a 1 x 2048 prefill, a
  cache-writing prefill and 16 decode steps against the parallel forward,
  peak memory. No hand-written kernel runs there (the reference's
  attention is einsum math);
- M-RoPE with the vision stub and Multi-head Latent Attention (phase
  ``lm_mla_vlm``, after ``lm_dense``): the smoke ``minicpm3-4b`` and
  ``qwen2-vl-7b`` on the card against the CPU (prefill logits, with
  ``pos3`` and ``vision_embeds`` for the VLM; token-by-token decode
  against the parallel forward, MLA through the absorbed decode and the
  VLM with explicit ``pos3``; a train step); ``minicpm3-4b`` at full width
  and depth (float32, 17.0 GB): a 1 x 2048 prefill, a decode step at cache
  length 2047 against the prefill's last position with no blocking
  transfer, layer 0's absorbed decode against the expanded one for the
  record, ``greedy_generate`` at ``serve_lm``'s defaults, decode steps,
  a profiled step, peak memory, ``launch/serve_lm.py --arch minicpm3-4b``
  in a subprocess; ``minicpm3-4b`` cut to 8 layers and ``qwen2-vl-7b`` cut
  to 2 layers trained (step time, tokens/s, peak memory, FLOP share, the
  loss falling, no blocking transfer); ``qwen2-vl-7b`` at full width and
  depth (30.5 GB): a 1 x 2048 prefill with 1024 vision-stub tokens, decode
  steps with explicit text ``pos3`` against the parallel forward, peak
  memory. No hand-written kernel runs there either;
- Mixture of Experts and DeepSeek-V3's multi-token head (phase
  ``lm_moe``, after ``lm_mla_vlm``): the smoke ``grok-1-314b`` and
  ``deepseek-v3-671b`` (dropless) on the card against the CPU (prefill,
  decode against the parallel forward, a train step); both at full width
  with every expert and capacity factor 1.25, depth cut (grok to 2 layers,
  45.8 GB; deepseek to its 3 dense-prefix layers and 1 MoE layer, MLA,
  57.6 GB): a 1 x 2048 prefill, a cache-writing prefill and 16 decode
  steps at B = 4 against the bandwidth bound of the weights a step reads,
  the share of assignments dropped, the first MoE layer against
  ``moe_fwd_plain`` on the prefill's and a decode step's input and split
  by stage (route, dispatch, expert GEMMs, combine, shared), no blocking
  transfer, peak memory; both trained cut by depth and expert count (grok
  1 layer of 4 experts, deepseek 1 + 1 layers of 32 experts with the
  head; int8 moments; the loss falling, step time, peak memory, FLOP
  shares by active parameters and by the capacity slots run). No
  hand-written kernel runs there;
- RG-LRU with local attention and the Whisper encoder-decoder (phase
  ``lm_hybrid_audio``, after ``lm_moe``): the smoke ``recurrentgemma-2b``
  (with its initial RG-LRU ``lam`` and with one negated so that the
  block recurs) and ``whisper-tiny`` on the card against the CPU
  (logits or loss, decode against the parallel forward past the window
  or the cached cross decode against the parallel decoder, a train
  step); ``recurrentgemma-2b`` at full width and depth (float32, 14.2
  GB): a 4 x 2048 prefill timed and profiled, one layer's
  ``_rglru_scan`` at its shape and its share of the prefill, a
  cache-writing prefill and 16 decode steps at positions 2048-2063 (every
  ring buffer wrapped) against the parallel forward, no blocking
  transfer, the decode cache's bytes equal at 2,064 and 524,288
  positions; trained at full depth with int8 moments (2 x 2048 tokens,
  the loss falling, step time, peak memory, FLOP share); ``whisper-tiny``
  at full size: the encoder over 4 x 1500 frames, a greedy decode of 64
  tokens at B = 4 through the reference's decode pieces
  (``WhisperDecode``) held against the parallel decoder at every step,
  and training on 8 x 448 tokens. No hand-written kernel runs there;
- LM sharding and the dry run (phase ``lm_sharding``, after
  ``lm_hybrid_audio``): inside the LM phases that build them (no model is
  built twice), the static bytes of ``rwkv6-7b`` served, ``lm-100m``
  trained, ``minicpm3-4b`` served, ``recurrentgemma-2b`` trained with int8
  moments and ``whisper-tiny`` trained, by ``hlo_analysis.sharded_bytes``
  under ``sharding.rules`` specs on a one-device mesh, equal to the live
  parameters', optimizer state's and cache's bytes and to the dry run's
  meta-device objects', to the byte; the dry run's analytic peak of a step
  beside ``torch.cuda.max_memory_allocated`` of that step, with their
  ratio (recorded, not checked); ``_sdpa``'s kv-replicated branch on
  ``qwen1.5-110b``'s layer 0 (64 q heads, 8 kv heads, model axis 16, 1 x
  2048, causal and windowed) against the grouped branch within 1e-5 of
  scale; ``train.remesh`` of ``lm-100m``'s parameters onto a (1,) CUDA
  ``DeviceMesh`` of a one-rank NCCL group (a ``HashStore``) and back,
  bitwise, in a subprocess; the train step on DTensors on a (1, 1) CUDA
  mesh of a one-rank NCCL group (the smoke ``grok-1-314b``, the
  reference's sharded case, and the full-width ``lm-100m``) against the
  same step on plain tensors (losses, the first step's gradients and
  parameters), both timed, in a subprocess; full-width ``rwkv6-7b``
  served plain and then on DTensors of a (1, 1) CUDA mesh from the same
  weights (a 4 x 2048 prefill and 8 decode tokens from the cache placed
  by ``cache_pspecs``): logits and final states within 1e-5 of scale,
  32 ``rwkv_scan`` launches a prefill and a token on each path, the
  states on the card, both paths timed, in a subprocess, and with four
  cards the same on a (1, 4) mesh, 16 heads a rank, one NCCL rank a card,
  against the one-card plain logits; and ``launch/dryrun.py`` on three
  cells at once in subprocesses (``lm-100m`` ``train_4k`` on the pod
  mesh, ``rwkv6-7b`` ``decode_32k`` on it, ``lm-100m`` ``train_4k`` on
  the two-pod mesh), each within 300 s, its collectives counted. Of the
  hand-written kernels only ``rwkv_scan`` runs there;
- the reference's three examples (phase ``sph``, after
  ``sharded_ranks``),
  imported from ``examples/`` and driven through their own functions:
  ``sph_fluid_torch.py``'s session at 8,000 and 1,000,000 particles (a
  warm-up step, 20 steps timed by CUDA events with fast, replan and
  respec steps apart and the step split into search and physics, each
  step's blocking transfers (one, two on a respec) and launches (one of
  each kernel) counted, three steps held against the oracle on 512 rows
  and against the same physics on the CPU, the profiler's launches a
  step, and the ``--rebuild`` A/B with its counts equal to the
  session's); ``pointcloud_pipeline_torch.py`` at 60,000 points (search
  and normals times, the sample's oracle match, the vertical share); and
  ``quickstart_torch.py`` once, its asserts holding;
- the neighbor-query service (phase ``serve``, run before ``lm_serve``):
  ``repro_torch.serve`` on three 1M-point KITTI-like scenes, knn and
  range, 256 requests of 1,024-16,384 rows on a simulated 2,000
  requests/s clock, each request against ``api.query`` on its rows
  alone, one blocking sync (counted by ``torch.cuda.set_sync_debug_mode``)
  and one ``knn_tile_anchored`` launch per drained batch, and the device's
  idle share; a request-size launch timed and split; a session-backed
  scene on the dynamic trajectory,
  stepped and drained in turn (bitwise equal to ``api.query``) and
  concurrently; and the chaos gate, ``launch/serve.py --trace short`` under
  ``REPRO_FAULTS`` in a subprocess.

Phases print one JSON line each. The last three lines are the kernel
table, the card's name and power limit as ``nvidia-smi`` reports them,
and ``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero; without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (kernel, its source in the repo, the TPU kernel it replaces)
KERNELS = {
    "knn_tile_anchored": ("src/repro_torch/kernels/csrc/knn_tile_anchored.cu",
                          "src/repro/kernels/knn_tile.py:293"),
    "bin_disp_tile": ("src/repro_torch/kernels/csrc/bin_disp_tile.cu",
                      "src/repro/kernels/update_tile.py:32"),
    "knn_tile": ("src/repro_torch/kernels/csrc/knn_tile.cu",
                 "src/repro/kernels/knn_tile.py:172"),
    "range_count": ("src/repro_torch/kernels/csrc/range_count.cu",
                    "src/repro/kernels/range_tile.py:46"),
    "distance_tile": ("src/repro_torch/kernels/csrc/distance_tile.cu",
                      "src/repro/kernels/distance_tile.py:36"),
    "rwkv_scan": ("src/repro_torch/kernels/csrc/rwkv_scan.cu",
                  "src/repro/kernels/rwkv_scan.py:47"),
}
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (query, candidate) pair in knn_tile_anchored: the
# cross product (3 mul + 2 add), qn + pn, 2*cross, the subtraction, the
# clamp at 0 and the radius test
OPS_PER_PAIR = 10
# bin_disp_tile per point: bytes moved (position and anchor read, cell
# written) and FP32 operations (3 sub, 3 mul, 3 floor, 6 compares, 6 for
# the clamp; 3 sub, 3 mul, 2 add for the displacement; the max)
BIN_BYTES_PER_POINT = 36
BIN_OPS_PER_POINT = 30
# distance_tile per pair: the cross product (3 mul + 2 add), qn + pn,
# 2*cross, the subtraction and the clamp
DIST_OPS_PER_PAIR = 9

N_POINTS = 1_000_000
RADIUS, K = 0.02, 8        # benchmarks/fig11_speedup.py's KITTI setting
N_SAMPLE = 4096
N_KERNEL_TILES = 64
LAYER_WINDOW = (19, 19, 11)   # the static knn plan's most common window
DIST_SHAPE = (8192, 131072)   # distance_tile: 4.3 GB of float32 output
N_TIMED_QUERIES = 3           # NeighborSearch.query timed, median
HP_TILES_PER_LEVEL = 3        # tiles per window of each launch group held
                              # against the plain version
WHOLE_GRID_TILES = 2          # whole-grid-window tiles held against the plain
WHOLE_GRID_K = 100            # ... also at the largest k of the tests
# what the reference accepts beyond the main path's k and tile: a small
# KITTI-like scene whose radius gives 77 % of the points more than 128
# neighbors and 36 % more than 300
ANY_K_POINTS, ANY_K_RADIUS = 20_000, 0.05
ANY_K_TILES = (8, 40, 2048)   # below a warp, not whole warps, 2 row blocks
ANY_K_KS = (129, 300)         # two and three passes of 128 columns
ANY_K_TILES_CHECKED = 16      # tiles of a case held against the plain

# the dynamic path: benchmarks/fig_dynamic.py's trajectory model at the
# radius of the KITTI setting, with examples/sph_fluid.py's K_MAX and mode
DYN_N, DYN_SEED, DYN_RADIUS, DYN_K = 1_000_000, 7, 0.02, 32
DYN_STEPS = 8              # trajectory frames before the respec step
DYN_ESCAPEES = 1000        # points moved 0.1 past the box: forces a respec
N_TIMED_STEPS = 3          # fast steps and replan steps timed, each
DYN_TILES_PER_LEVEL = 3    # tiles per ladder level held against the plain

# the LM serving path: full-width, full-depth rwkv6-7b
# (src/repro_torch/configs/rwkv6_7b.py), float32 weights from a seed
LM_ARCH, LM_SEED = "rwkv6-7b", 0
LM_PREFILL = (4, 2048)     # a cut of configs/shapes.py PREFILL_32K (32 x 32768)
LM_TIMED_PREFILLS = 3      # timed by CUDA events, median
LM_PARITY_PROMPT = 64      # cache-writing prefill vs token-by-token decode
LM_DECODE_TOL = 2e-3       # tests/test_models.py's decode-vs-parallel atol=rtol
LM_CPU_TOL = 1e-4          # card vs CPU path at smoke size, atol=rtol (the
                           # CPU tests' tolerance against the JAX reference)
LM_REQUESTS, LM_PROMPT, LM_MAX_NEW = 4, 16, 32   # serve_lm's defaults
LM_TIMED_TOKENS = 16       # single decode steps timed, median
RWKV_RTOL = 1e-5           # kernel vs plain: max|diff| <= RWKV_RTOL*max(1, max|plain|)
RWKV_HEAD_DIMS = (12, 48, 96, 128)   # head dims off the model's, held
RWKV_SEQS = (1, 17, 256)             # ... against the plain version at these S
RWKV_DECODE_LAUNCHES = 100           # S = 1 launches profiled
# the LM training path (phase ``lm_train``): rwkv6-7b at full width, float32
# weights, gradients and AdamW moments. Depth cut from 32 to 8 layers: 2.29e9
# parameters x 16 bytes (weight, gradient, m, v) = 36.6 GB; all 32 layers
# (7.53e9) would need 120.5 GB, 75 GB even with int8 moments, before
# activations, on an 80 GB card
LM_TRAIN_LAYERS = 8
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO = 8, 512, 2
LM_TRAIN_TIMED = 5          # steps timed by CUDA events after one warm-up,
                            # all on one batch: the loss must fall over the 6
LM_TRAIN_LOOP_STEPS = 2     # ResilientLoop steps counted for transfers
LM_CORE_TOL = 1e-4          # chunked core vs rwkv_scan on layer 0's inputs:
                            # max|diff| <= tol * max(1, max|scan|) (the CPU
                            # tests' tolerance on the reference's cores)
LM_STEP_LOSS_RTOL = 1e-5    # card vs CPU train step at smoke size: the CPU
LM_STEP_PARAM_ATOL = 2e-3   # tests' tolerances against the reference's step
LM_RESUME_STEPS, LM_RESUME_FAIL_AT = 6, 5   # smoke ResilientLoop: steps, and
                            # the call that fails (after the step-4 save)
LM_RESUME_RTOL = 1e-3       # resumed vs uninterrupted losses on the card
                            # (embedding backward accumulates with atomics,
                            # so not bitwise; Adam's 1/sqrt(v) amplifies)

# the dense attention LMs (phase ``lm_dense``): lm-100m at full size
# (src/repro_torch/configs/lm_100m.py), float32, trained with
# examples/train_lm.py's shape and served at serve_lm's defaults; and
# qwen1.5-110b at full width (configs/qwen1_5_110b.py), its depth cut
DENSE_ARCH = "lm-100m"
DENSE_SMOKE_ARCHS = ("lm-100m", "qwen1.5-110b")   # smoke size, card vs CPU
DENSE_TRAIN = (8, 256, 2)      # batch, seq, --n-micro of examples/train_lm.py
DENSE_TRAIN_TIMED = 5          # steps timed after one warm-up, on one batch:
                               # the loss must fall over the 6
DENSE_CLI_STEPS = 3            # launch/train with no --arch, in a subprocess
SDPA_RTOL = 1e-5               # F.scaled_dot_product_attention vs _sdpa:
                               # max|diff| <= SDPA_RTOL * max(1, max|plain|)
def step_shape(name: str, seq: int, batch: int, kind: str):
    """A ``configs.shapes.ShapeSpec`` of a step that a phase runs."""
    from repro_torch.configs.shapes import ShapeSpec
    return ShapeSpec(name, seq, batch, kind)


def sharding_static(tag: str, cfg, *, params, opt=None, cache=None) -> dict:
    """Phase ``lm_sharding``'s check (a) on a live model: the parameters',
    optimizer state's and decode cache's bytes by ``sharded_bytes`` under
    the rules' specs on a one-device mesh equal their tensors' bytes, and
    the dry run's meta-device parameters and optimizer state
    (``init_params``, ``opt_state_specs``) at the run's dtype have the
    same bytes. Appends the record to SHARDING and returns it."""
    from repro_torch.launch import hlo_analysis as H
    from repro_torch.models import model as M
    from repro_torch.sharding import rules as R
    from repro_torch.train.optimizer import OptConfig, opt_state_specs
    mesh = ONE_DEVICE_MESH
    named = dict(params.named_parameters())
    parts = {"params": (named, R.param_pspecs(named, mesh))}
    if opt is not None:
        parts["opt"] = (opt, R.opt_pspecs(opt, mesh))
    if cache is not None:
        # a one-device mesh divides every batch: any batch size will do
        parts["cache"] = (cache, R.cache_pspecs(cache, mesh, 1))
    rec = {"tag": tag, "arch": cfg.name, "n_layers": cfg.n_layers}
    for key, (tree, specs) in parts.items():
        live = H.tree_nbytes(tree)
        predicted = H.sharded_bytes(tree, specs, mesh)
        check(predicted == live, f"lm_sharding: {tag} {key}: sharded_bytes "
              f"{predicted} != the live tensors' {live}")
        rec[f"{key}_bytes"] = live
    dtype = next(iter(named.values())).dtype
    meta = dict(M.init_params(cfg, dtype=dtype,
                              device="meta").named_parameters())
    check(H.tree_nbytes(meta) == rec["params_bytes"],
          f"lm_sharding: {tag}: meta parameters' bytes differ")
    if opt is not None:
        quant = isinstance(next(iter(opt["m"].values())), dict)
        m_opt = opt_state_specs(meta, OptConfig(quantize_moments=quant))
        check(H.tree_nbytes(m_opt) == rec["opt_bytes"],
              f"lm_sharding: {tag}: meta optimizer state's bytes differ")
        rec["quantized_opt"] = quant
    SHARDING["bytes"].append(rec)
    return rec


def sharding_peak(rec: dict, cfg, step, shape, meta: dict, *,
                  params=None) -> None:
    """Phase ``lm_sharding``'s record (b): one more ``step()`` with the
    allocator's peak reset (gradients of ``params`` cleared first), its
    ``max_memory_allocated`` beside the dry run's analytic peak at the
    run's float32 (``analytic_activation_bytes(..., resid_bytes=4)`` over
    the static bytes: parameters, and optimizer state in a train step),
    and their ratio; the reference's bfloat16 model beside it. Recorded,
    not checked."""
    import torch
    from repro_torch.launch import hlo_analysis as H
    if params is not None:
        for p in params.parameters():
            p.grad = None
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    static = rec["params_bytes"] + (rec.get("opt_bytes", 0)
                                    if shape.kind == "train" else 0)
    act = H.analytic_activation_bytes(cfg, shape, ONE_DEVICE_MESH, meta,
                                      resid_bytes=4)
    act_bf16 = H.analytic_activation_bytes(cfg, shape, ONE_DEVICE_MESH,
                                           meta)
    rec.update(step=[shape.kind, shape.global_batch, shape.seq_len],
               step_meta=meta, static_bytes=static,
               live_before_bytes=before, max_allocated_bytes=peak,
               step_transient_bytes=peak - before,
               analytic_activation_bytes=act,
               analytic_activation_bytes_bf16=act_bf16,
               analytic_peak_bytes=static + act,
               peak_ratio=(static + act) / peak,
               transient_ratio=act / max(peak - before, 1))


def kv_replicated_vs_grouped(params, cfg, tokens) -> None:
    """Phase ``lm_sharding``'s check (c) on the live ``qwen1.5-110b``:
    layer 0's ``attention_fwd`` on the embedded ``tokens`` [1, S] with a
    ``shard`` of model axis EXPAND_MODEL_SIZE (its 64 q heads divide it,
    its 8 kv heads do not: ``_sdpa`` repeats the kv heads to 64) against
    the grouped branch (``NO_SHARD``), causal and with a window of
    EXPAND_WINDOW, within EXPAND_RTOL of scale; both timed."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import make_shard_fn
    check(cfg.n_kv_heads % EXPAND_MODEL_SIZE != 0
          and cfg.n_heads % EXPAND_MODEL_SIZE == 0,
          "lm_sharding: the kv-replicated branch needs kv heads that the "
          "model axis does not divide and q heads that it does")
    shard = make_shard_fn({"data": 1, "model": EXPAND_MODEL_SIZE})
    seen = []

    def recording(x, name):
        seen.append(name)
        return shard(x, name)
    recording.model_size = shard.model_size
    blk = params.blocks[0]
    out = {"model_size": EXPAND_MODEL_SIZE, "heads": cfg.n_heads,
           "kv_heads": cfg.n_kv_heads, "shape": list(tokens.shape)}
    with torch.no_grad():
        h = M._norm(params.embed[tokens], blk.ln1, cfg.norm_eps)
        pos = M.positions(cfg, *tokens.shape, tokens.device)
        for case, window in (("causal", None), ("windowed", EXPAND_WINDOW)):
            def run(sh, window=window):
                return L.attention_fwd(blk.mixer, h, cfg, pos=pos,
                                       window=window, shard=sh)[0]
            grouped = run(L.NO_SHARD)
            seen.clear()
            expanded = run(recording)
            check("attn_logits4" in seen and "attn_logits" not in seen,
                  f"lm_sharding: the kv-replicated branch was not taken "
                  f"({seen})")
            err = float((expanded - grouped).abs().max())
            scale = max(1.0, float(grouped.abs().max()))
            check(err <= EXPAND_RTOL * scale,
                  f"lm_sharding: kv-replicated vs grouped {case}: {err} > "
                  f"{EXPAND_RTOL} x {scale}")
            out[case] = {"max_abs_err": err, "scale": scale,
                         "grouped_ms": cuda_time_ms(
                             lambda: run(L.NO_SHARD), 3),
                         "kv_replicated_ms": cuda_time_ms(
                             lambda: run(recording), 3)}
            del grouped, expanded
    SHARDING["kv_replicated"] = out


def remesh_on_card() -> None:
    """Phase ``lm_sharding``'s check (d), run in a subprocess: a one-rank
    NCCL group over a ``HashStore`` (no network), a (1,) CUDA
    ``DeviceMesh`` (``make_test_mesh``), ``lm-100m``'s parameters placed
    by ``train.remesh`` with the rules' specs, then again replicated; both
    must hold every parameter bitwise. Prints one JSON line; the group is
    destroyed at the end."""
    import os
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.sharding.rules import P, param_pspecs
    from repro_torch.train import remesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_test_mesh((1,), ("data",))
        params = {n: p.detach() for n, p in M.init_params(
            get_config(DENSE_ARCH), LM_SEED,
            device="cuda").named_parameters()}
        specs = param_pspecs(params, mesh)
        t0 = time.perf_counter()
        placed = remesh(params, mesh, specs)
        again = remesh(placed, mesh, {n: P() for n in params})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        bitwise = all(torch.equal(placed[n].full_tensor(), p)
                      and torch.equal(again[n].to_local(), p)
                      for n, p in params.items())
        on_card = all(placed[n].to_local().is_cuda for n in params)
        print(json.dumps({"remesh": {
            "mesh": [tuple(mesh.shape), mesh.mesh_dim_names,
                     mesh.device_type],
            "backend": dist.get_backend(), "params": len(params),
            "bytes": sum(p.numel() * p.element_size()
                         for p in params.values()),
            "sharded_specs": sum(any(e is not None for e in sp)
                                 for sp in specs.values()),
            "bitwise": bitwise, "on_card": on_card, "seconds": secs}}),
            flush=True)
    finally:
        dist.destroy_process_group()


def first_step_vs_plain(model, plain, whole) -> dict:
    """A DTensor step's gradients and parameters against the plain step's
    from the same weights, as ``tests/test_torch_sharded_train.py`` holds
    them: gradients within ``DTENSOR_RTOL`` of scale; parameters within
    it wherever the plain gradient is at least ``WELL_CONDITIONED`` of
    its parameter's largest (Adam's first step divides a gradient by its
    own magnitude, so a near-zero one moves its element by up to ``lr``
    on its last bits), and every element within 2 ``lr``."""
    grad, cond, worst = 0.0, 0.0, 0.0
    for p, q in zip(model.parameters(), plain.parameters()):
        if q.grad is None:
            continue
        g = q.grad
        grad = max(grad, float((whole(p.grad) - g).abs().max())
                   / max(1.0, float(g.abs().max())))
        diff = (whole(p) - q.detach()).abs()
        big = g.abs() >= WELL_CONDITIONED * g.abs().max()
        if big.any():
            cond = max(cond, float(diff[big].max())
                       / max(1.0, float(q.detach().abs().max())))
        worst = max(worst, float(diff.max()))
    return {"grad_rel_err": grad, "param_cond_rel_err": cond,
            "param_max_abs_err": worst}


def dtensor_steps_on_card() -> None:
    """Phase ``lm_sharding``'s check (f), run in a subprocess: a one-rank
    NCCL group over a ``HashStore``, a (1, 1) ``("data", "model")`` CUDA
    ``DeviceMesh``; the smoke ``grok-1-314b`` step (the reference's
    sharded case, 8 x 16 tokens) and the full-width ``lm-100m`` step
    (``DENSE_TRAIN``'s 8 x 256 tokens in 2 microbatches), each with its
    parameters, batch and moments placed as DTensors by the rules against
    the same step on plain tensors from the same weights: the loss of
    each of ``DTENSOR_STEPS`` steps within ``DTENSOR_RTOL`` of scale, the
    first step's gradients and parameters as :func:`first_step_vs_plain`
    holds them, and both steps timed (host clock to a synchronise, after
    a first step). Prints one JSON line."""
    import copy
    import os
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import knn_tile as knn_mod
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.kernels import update_tile as upd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.sharding.rules import (P, batch_pspec, make_shard_fn,
                                            param_pspecs, place_parameters,
                                            place_tree)
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    def whole(t):
        t = t.detach()
        return t.full_tensor() if isinstance(t, DTensor) else t

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    out = {}
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        cases = {"grok-1-314b": (smoke_config(get_config("grok-1-314b")),
                                 (8, 16, 1)),
                 DENSE_ARCH: (get_config(DENSE_ARCH), DENSE_TRAIN)}
        for fn in (scan.rwkv_scan, knn_mod.knn_tile_anchored,
                   upd.bin_disp_tile):
            fn.launches = 0
        for arch, (cfg, (b, s, n_micro)) in cases.items():
            oc = OptConfig(lr=DTENSOR_LR, warmup_steps=1)
            plain = M.init_params(cfg, LM_SEED, device="cuda",
                                  requires_grad=True)
            model = copy.deepcopy(plain)
            gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
            batch = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:])
                     for k, v in make_batch(cfg, b, s, gen,
                                            device="cuda").items()}
            place_parameters(model, mesh, param_pspecs(
                dict(model.named_parameters()), mesh))
            sbatch = place_tree(batch, mesh, {
                k: P(None, *batch_pspec(mesh, v.shape[1], v.ndim - 2))
                for k, v in batch.items()})
            opt0, opt = init_opt_state(plain, oc), init_opt_state(model, oc)
            step0 = make_train_step(cfg, oc)
            step = make_train_step(cfg, oc, shard=make_shard_fn(mesh))
            rec = {"losses": [], "plain_losses": [], "step_ms": [],
                   "plain_step_ms": []}
            for i in range(DTENSOR_STEPS):
                (_, opt0, m0), t_plain = timed(lambda: step0(plain, opt0,
                                                            batch))
                (_, opt, m), t_dt = timed(lambda: step(model, opt, sbatch))
                rec["plain_losses"].append(float(m0["loss"]))
                rec["losses"].append(float(whole(m["loss"])))
                rec["plain_step_ms"].append(t_plain)
                rec["step_ms"].append(t_dt)
                if i == 0:
                    rec.update(first_step_vs_plain(model, plain, whole))
            rec["loss_rel_err"] = max(
                abs(a - b_) / max(1.0, abs(b_))
                for a, b_ in zip(rec["losses"], rec["plain_losses"]))
            rec["placed_as_dtensors"] = all(
                isinstance(p, DTensor) and p.to_local().is_cuda
                for p in model.parameters())
            rec["step_ms_median_after_first"] = sorted(
                rec["step_ms"][1:])[len(rec["step_ms"][1:]) // 2]
            rec["plain_step_ms_median_after_first"] = sorted(
                rec["plain_step_ms"][1:])[len(rec["plain_step_ms"][1:]) // 2]
            rec["tokens"] = b * s
            out[arch] = rec
            del plain, model, opt0, opt
            torch.cuda.empty_cache()
        out["kernel_launches"] = {
            "rwkv_scan": scan.rwkv_scan.launches,
            "knn_tile_anchored": knn_mod.knn_tile_anchored.launches,
            "bin_disp_tile": upd.bin_disp_tile.launches}
        print(json.dumps({"dtensor_steps": out}), flush=True)
    finally:
        dist.destroy_process_group()


def serve_on_mesh(cfg, model, tokens, cache, shard, scan) -> dict:
    """The prefill of ``tokens`` and SERVE_DECODE_TOKENS greedy decode
    tokens from ``cache`` (each the argmax of the last logits) on
    ``model``, plain or placed as DTensors with ``shard``: the prefill's
    logits and each token's, gathered to the whole on every rank, the
    final state of every layer, the ``rwkv_scan`` launches of the prefill
    and of each token, the prefill's time by CUDA events (median of
    SERVE_TIMED after one untimed) and each token's."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    prefill = make_prefill_step(cfg, shard=shard)
    decode = make_decode_step(cfg, shard=shard)
    scan.rwkv_scan.launches = 0
    logits = whole(prefill(model, {"tokens": tokens}))
    out = {"prefill_launches": scan.rwkv_scan.launches,
           "prefill_logits": logits,
           "prefill_ms": cuda_time_ms(lambda: prefill(
               model, {"tokens": tokens}), SERVE_TIMED, warmup=0)}
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    token_logits, token_launches, token_ms = [], [], []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(SERVE_DECODE_TOKENS):
        scan.rwkv_scan.launches = 0
        start.record()
        step_logits, cache = decode(model, cache, tok)
        end.record()
        token_launches.append(scan.rwkv_scan.launches)
        step_logits = whole(step_logits)[:, -1]
        torch.cuda.synchronize()
        token_ms.append(start.elapsed_time(end))
        token_logits.append(step_logits)
        tok = torch.argmax(step_logits, -1)[:, None].to(torch.int32)
    out.update(token_logits=torch.stack(token_logits),
               token_launches=token_launches, token_ms=token_ms,
               states=[c["tm"]["state"] for c in cache])
    return out


def _scaled_err(got, want) -> float:
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def dtensor_serve_on_card() -> None:
    """Phase ``lm_sharding``'s check (g), run in a subprocess: full-width
    ``rwkv6-7b`` (float32, 30 GB) served plain, then the same weights
    placed by ``param_pspecs`` as DTensors on a (1, 1) ``("data",
    "model")`` CUDA mesh (a one-rank NCCL group over a ``HashStore``) and
    served again (:func:`serve_on_mesh`, LM_PREFILL's prompt, the decode
    cache that a plain cache-writing prefill of it left, placed by
    ``cache_pspecs``). Logits and final states against the plain path's,
    ``rwkv_scan`` launches, the states' devices and both paths' times.
    Saves the prompt, the cache and the plain logits under
    ``build/dtensor_serve/`` for the several-card branch. Prints one JSON
    line."""
    import os
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.sharding.rules import (cache_pspecs, make_shard_fn,
                                            param_pspecs, place_parameters,
                                            place_tree)

    cfg = get_config(LM_ARCH)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        model = M.init_params(cfg, LM_SEED, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
        b, s = LM_PREFILL
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                               device="cuda", dtype=torch.int32)
        with torch.no_grad():
            _, cache = M.decode_step(model, M.init_decode_cache(
                cfg, b, s + SERVE_DECODE_TOKENS, torch.float32,
                device="cuda"), tokens, cfg)
        torch.cuda.empty_cache()
        plain = serve_on_mesh(cfg, model, tokens, cache, M.NO_SHARD, scan)
        out_dir = ROOT / "build" / "dtensor_serve"
        out_dir.mkdir(parents=True, exist_ok=True)
        torch.save({"tokens": tokens.cpu(), "cache": [
            {k: {n: t.cpu() for n, t in v.items()} for k, v in c.items()}
            for c in cache],
            "prefill_logits": plain["prefill_logits"].cpu(),
            "token_logits": plain["token_logits"].cpu()},
            out_dir / "plain.pt")
        place_parameters(model, mesh, param_pspecs(
            dict(model.named_parameters()), mesh))
        scache = place_tree(cache, mesh, cache_pspecs(cache, mesh, b))
        torch.cuda.reset_peak_memory_stats()
        dt = serve_on_mesh(cfg, model, tokens, scache, make_shard_fn(mesh),
                           scan)
        rec = {"mesh": [list(mesh.shape), list(mesh.mesh_dim_names)],
               "prompt": [b, s], "decode_tokens": SERVE_DECODE_TOKENS,
               "placed_as_dtensors": all(
                   isinstance(p, DTensor) and p.to_local().is_cuda
                   for p in model.parameters()),
               "states_on_card": all(
                   isinstance(t, DTensor) and t.to_local().is_cuda
                   for t in dt["states"]),
               "prefill_bitwise": torch.equal(dt["prefill_logits"],
                                              plain["prefill_logits"]),
               "tokens_bitwise": torch.equal(dt["token_logits"],
                                             plain["token_logits"]),
               "states_bitwise": all(torch.equal(a.full_tensor(), b_)
                                     for a, b_ in zip(dt["states"],
                                                      plain["states"])),
               "prefill_rel_err": _scaled_err(dt["prefill_logits"],
                                              plain["prefill_logits"]),
               "tokens_rel_err": _scaled_err(dt["token_logits"],
                                             plain["token_logits"]),
               "state_rel_err": max(_scaled_err(a.full_tensor(), b_)
                                    for a, b_ in zip(dt["states"],
                                                     plain["states"])),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        for tag, r in (("plain", plain), ("dtensor", dt)):
            rec[tag] = {"prefill_launches": r["prefill_launches"],
                        "token_launches": r["token_launches"],
                        "prefill_ms": r["prefill_ms"],
                        "token_ms": r["token_ms"],
                        "token_ms_median": sorted(r["token_ms"])[
                            len(r["token_ms"]) // 2]}
        print(json.dumps({"dtensor_serve": rec}), flush=True)
    finally:
        dist.destroy_process_group()


def dtensor_serve_rank(rank: int, world: int, store: str,
                       out_dir: str) -> None:
    """One of ``world`` NCCL ranks, one a card (check (g) on several
    cards): full-width ``rwkv6-7b`` placed by ``param_pspecs`` on a
    (1, ``world``) ``("data", "model")`` mesh, 64 / ``world`` heads a
    rank, served from the prompt and cache that the one-card check saved
    (:func:`serve_on_mesh`); its logits against the one-card plain
    path's. Writes ``rank<r>.json``."""
    import os
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.sharding.rules import (cache_pspecs, make_shard_fn,
                                            param_pspecs, place_parameters,
                                            place_tree)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank),
                            timeout=datetime.timedelta(
                                seconds=SERVE_TIMEOUT_S // 2))
    try:
        cfg = get_config(LM_ARCH)
        saved = torch.load(Path(out_dir, "plain.pt"))
        dev = torch.device("cuda", rank)
        mesh = make_test_mesh((1, world), ("data", "model"))
        model = M.init_params(cfg, LM_SEED, device=dev)
        place_parameters(model, mesh, param_pspecs(
            dict(model.named_parameters()), mesh))
        torch.cuda.empty_cache()
        tokens = saved["tokens"].to(dev)
        cache = [{k: {n: t.to(dev) for n, t in v.items()}
                  for k, v in c.items()} for c in saved["cache"]]
        cache = place_tree(cache, mesh, cache_pspecs(cache, mesh,
                                                     tokens.shape[0]))
        r = serve_on_mesh(cfg, model, tokens, cache, make_shard_fn(mesh),
                          scan)
        local = r["states"][0].to_local()
        out = {"rank": rank, "world": world,
               "prefill_rel_err": _scaled_err(
                   r["prefill_logits"].cpu(), saved["prefill_logits"]),
               "tokens_rel_err": _scaled_err(r["token_logits"].cpu(),
                                             saved["token_logits"]),
               "prefill_launches": r["prefill_launches"],
               "token_launches": r["token_launches"],
               "local_state": list(local.shape),
               "state_device": str(local.device),
               "prefill_ms": r["prefill_ms"],
               "token_ms_median": sorted(r["token_ms"])[
                   len(r["token_ms"]) // 2],
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def serve_on_ranks() -> dict | None:
    """Check (g) on ``SERVE_RANKS`` cards, where there are as many:
    :func:`dtensor_serve_rank` spawned one a card, each held within
    DTENSOR_RTOL of scale of the one-card plain logits, 32 launches a
    prefill and a token, 16 heads of state a rank on its card. None on
    fewer cards."""
    import torch
    import torch.multiprocessing as mp
    if torch.cuda.device_count() < SERVE_RANKS:
        return None
    out_dir = ROOT / "build" / "dtensor_serve"
    for old in out_dir.glob("rank*.json"):
        old.unlink()
    (out_dir / "store").unlink(missing_ok=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(dtensor_serve_rank, args=(
        SERVE_RANKS, str(out_dir / "store"), str(out_dir)),
        nprocs=SERVE_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            check(time.monotonic() < deadline, f"lm_sharding: {SERVE_RANKS}"
                  f" serving ranks did not finish in {SERVE_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models.config import get_config
    runs = [json.loads((out_dir / f"rank{r}.json").read_text())
            for r in range(SERVE_RANKS)]
    cfg = get_config(LM_ARCH)
    n_layers = cfg.n_layers
    heads = cfg.d_model // cfg.rwkv_head_dim // SERVE_RANKS
    for r in runs:
        check(r["prefill_rel_err"] <= DTENSOR_RTOL
              and r["tokens_rel_err"] <= DTENSOR_RTOL
              and r["prefill_launches"] == n_layers
              and all(n == n_layers for n in r["token_launches"])
              and r["local_state"][1] == heads
              and r["state_device"] == f"cuda:{r['rank']}",
              f"lm_sharding: rank {r['rank']} of the (1, {SERVE_RANKS}) "
              f"serving mesh: {r}")
    return {"ranks": runs, "wall_s": time.perf_counter() - t0}


def check_dtensor_serve(env: dict) -> dict:
    """Phase ``lm_sharding``'s check (g): :func:`dtensor_serve_on_card` in
    a subprocess, held within DTENSOR_RTOL of scale of the plain path with
    32 ``rwkv_scan`` launches a prefill and a token on each path, then
    :func:`serve_on_ranks`."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, {!r}); "
         "import chip_smoke; chip_smoke.dtensor_serve_on_card()".format(
             str(ROOT))],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=SERVE_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and lines,
          f"lm_sharding: DTensor serving on the card: {proc.returncode} "
          f"{proc.stdout[-800:]} {proc.stderr[-3000:]}")
    serve = json.loads(lines[-1])["dtensor_serve"]
    serve["wall_s"] = time.perf_counter() - t0
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models.config import get_config
    n_layers = get_config(LM_ARCH).n_layers
    check(serve["placed_as_dtensors"] and serve["states_on_card"]
          and max(serve["prefill_rel_err"], serve["tokens_rel_err"],
                  serve["state_rel_err"]) <= DTENSOR_RTOL,
          f"lm_sharding: rwkv6-7b served on DTensors differs from the plain "
          f"path: {serve}")
    for tag in ("plain", "dtensor"):
        check(serve[tag]["prefill_launches"] == n_layers
              and serve[tag]["token_launches"]
              == [n_layers] * SERVE_DECODE_TOKENS,
              f"lm_sharding: {tag} serving launched rwkv_scan "
              f"{serve[tag]['prefill_launches']} times a prefill and "
              f"{serve[tag]['token_launches']} a token, not {n_layers}")
    serve["ranks"] = serve_on_ranks()
    return serve


def check_dryrun_cells(env: dict) -> dict:
    """Phase ``lm_sharding``'s checks (e) and (h): ``launch/dryrun.py`` on
    each cell of DRYRUN_CELLS, all at once in subprocesses, each ``ok``
    within DRYRUN_TIMEOUT_S with its collectives counted."""
    out_dir = ROOT / "build" / "dryrun_chip"
    t0 = time.perf_counter()
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", cell[2], "--force",
         "--out-dir", str(out_dir)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cell in DRYRUN_CELLS}
    dryrun = {}
    for (arch, shape, mesh), p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=max(
                1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
                q.communicate()
            check(False, f"lm_sharding: dryrun {arch} {shape} {mesh} took "
                  f"over {DRYRUN_TIMEOUT_S} s")
        cell_path = out_dir / f"{mesh}__{arch}__{shape}.json"
        check(p.returncode == 0 and cell_path.exists(),
              f"lm_sharding: dryrun {arch} {shape} {mesh}: {p.returncode} "
              f"{stdout[-800:]} {stderr[-2000:]}")
        cell = json.loads(cell_path.read_text())
        check(cell["status"] == "ok", f"lm_sharding: dry-run cell {cell}")
        check(cell["collectives"] is not None
              and cell["collectives"]["total_bytes"] > 0,
              f"lm_sharding: the dry-run cell counted no collectives: "
              f"{cell}")
        dryrun[f"{mesh} {arch} {shape}"] = {
            "wall_s": time.perf_counter() - t0, "status": cell["status"],
            "chips": cell["chips"], "meta": cell["meta"],
            "dominant": cell["roofline"]["dominant"],
            "flops_per_device": cell["cost_per_device"]["flops"],
            "collectives": cell["collectives"],
            "build_s": cell["build_s"], "count_s": cell["count_s"],
            "collectives_s": cell["collectives_s"]}
    return dryrun


def phase_lm_sharding() -> dict:
    """LM sharding and the dry run: the records (a) and (b) that the LM
    phases gathered (``sharding_static``, ``sharding_peak``) and (c)
    (``kv_replicated_vs_grouped``), then in subprocesses (d)
    ``remesh_on_card``, (f) ``dtensor_steps_on_card``, (g)
    ``dtensor_serve_on_card`` (and :func:`serve_on_ranks` where there are
    SERVE_RANKS cards), and ``launch/dryrun.py`` on the cells of
    DRYRUN_CELLS, all at once: (e) ``lm-100m`` ``train_4k`` on the pod
    mesh, (h) ``rwkv6-7b`` ``decode_32k`` on it and ``lm-100m``
    ``train_4k`` on the two-pod mesh, each within DRYRUN_TIMEOUT_S with
    its collectives counted; with their wall times. The only hand-written
    kernel that runs is ``rwkv_scan``, in (g): 32 launches a prefill and
    a token on each path."""
    import os
    from repro_torch.kernels import distance_tile as tdist
    from repro_torch.kernels import knn_tile as knn_mod
    from repro_torch.kernels import range_tile as trange
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.kernels import update_tile as upd
    t_phase = time.perf_counter()
    counters = [scan.rwkv_scan, knn_mod.knn_tile_anchored, knn_mod.knn_tile,
                upd.bin_disp_tile, trange.range_count, tdist.distance_tile]
    for fn in counters:
        fn.launches = 0
    records = {r["tag"]: r for r in SHARDING["bytes"]}
    check(all(t in records and "peak_ratio" in records[t]
              for t in SHARDING_TAGS),
          f"lm_sharding: records missing: {sorted(records)}")
    check(SHARDING["kv_replicated"] is not None,
          "lm_sharding: the kv-replicated branch was not checked")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, {!r}); "
         "import chip_smoke; chip_smoke.remesh_on_card()".format(str(ROOT))],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=REMESH_TIMEOUT_S)
    remesh_s = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and lines,
          f"lm_sharding: remesh on the card: {proc.returncode} "
          f"{proc.stdout[-800:]} {proc.stderr[-2000:]}")
    remesh = json.loads(lines[-1])["remesh"]
    check(remesh["bitwise"] and remesh["on_card"],
          f"lm_sharding: remesh did not round-trip bitwise: {remesh}")
    remesh["wall_s"] = remesh_s

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, {!r}); "
         "import chip_smoke; chip_smoke.dtensor_steps_on_card()".format(
             str(ROOT))],
        cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=REMESH_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(proc.returncode == 0 and lines,
          f"lm_sharding: DTensor steps on the card: {proc.returncode} "
          f"{proc.stdout[-800:]} {proc.stderr[-3000:]}")
    dtensor = json.loads(lines[-1])["dtensor_steps"]
    dtensor["wall_s"] = time.perf_counter() - t0
    for arch in ("grok-1-314b", DENSE_ARCH):
        r = dtensor[arch]
        check(r["placed_as_dtensors"] and r["loss_rel_err"] <= DTENSOR_RTOL
              and r["grad_rel_err"] <= DTENSOR_RTOL
              and r["param_cond_rel_err"] <= DTENSOR_RTOL
              and r["param_max_abs_err"] <= 2 * DTENSOR_LR,
              f"lm_sharding: {arch}'s DTensor step differs from the plain "
              f"step: {r}")
    check(all(v == 0 for v in dtensor["kernel_launches"].values()),
          f"lm_sharding: a hand-written kernel ran in the DTensor steps: "
          f"{dtensor['kernel_launches']}")

    serve = check_dtensor_serve(env)
    dryrun = check_dryrun_cells(env)

    launches = {fn.__name__: fn.launches for fn in counters}
    check(all(v == 0 for v in launches.values()),
          f"lm_sharding: a hand-written kernel ran in this process: "
          f"{launches}")
    row = {"static_bytes": [{k: r[k] for k in r if k in (
        "tag", "arch", "n_layers", "params_bytes", "opt_bytes",
        "cache_bytes", "quantized_opt")} for r in SHARDING["bytes"]],
        "peaks": [{k: r[k] for k in r if k in (
            "tag", "step", "step_meta", "static_bytes", "live_before_bytes",
            "max_allocated_bytes", "step_transient_bytes",
            "analytic_activation_bytes", "analytic_activation_bytes_bf16",
            "analytic_peak_bytes", "peak_ratio", "transient_ratio")}
            for r in SHARDING["bytes"]],
        "kv_replicated": SHARDING["kv_replicated"], "remesh": remesh,
        "dtensor_steps": dtensor, "dtensor_serve": serve,
        "dryrun": dryrun, "kernel_launches": launches,
        "seconds": time.perf_counter() - t_phase}
    emit("lm_sharding", **row, nvidia_smi=smi_line())
    return row


# qwen1.5-110b: depth cut from 80 to 2 layers (5.21e9 parameters, 20.8 GB
# of float32 weights; 80 layers, 1.1e11, would take 444 GB)
QWEN_ARCH, QWEN_LAYERS = "qwen1.5-110b", 2
QWEN_PREFILL, QWEN_DECODE = 2048, 16

# Multi-head Latent Attention and M-RoPE with the vision stub (phase
# ``lm_mla_vlm``): minicpm3-4b (src/repro_torch/configs/minicpm3_4b.py) at
# full width and depth for serving (4.26e9 parameters, 17.0 GB of float32
# weights), its depth cut from 62 to 8 layers for training (0.88e9 x 16
# bytes of weights, gradients and AdamW moments = 14 GB; the 62 layers take
# 68 GB before activations); qwen2-vl-7b (configs/qwen2_vl_7b.py) at full
# width and depth for serving (7.62e9, 30.5 GB), its depth cut from 28 to 2
# layers for training (1.56e9 x 16 bytes = 25 GB; 28 layers: 122 GB)
MLA_ARCH, VLM_ARCH = "minicpm3-4b", "qwen2-vl-7b"
MLA_PREFILL = 2048            # a 1 x 2048 prefill; decode at cache length 2047
MLA_TRAIN_LAYERS, MLA_TRAIN = 8, (4, 512, 2)       # batch, seq, --n-micro
VLM_PREFILL, VLM_DECODE = 2048, 8   # 1024 vision-stub tokens, then text;
                                    # decode steps with explicit text pos3
VLM_TRAIN_LAYERS, VLM_TRAIN = 2, (2, 2048, 2)      # seq > n_vision_tokens:
                              # a sequence of at most 1024 is all masked
MLA_VLM_TIMED = 5             # train steps timed after one warm-up, on one
                              # batch: the loss must fall over the 6
ABSORBED_RTOL = 1e-4          # absorbed vs expanded MLA decode, one layer:
                              # max|diff| <= ABSORBED_RTOL * max(1, max|exp|)

# Mixture of Experts and the multi-token head (phase ``lm_moe``):
# grok-1-314b (src/repro_torch/configs/grok_1_314b.py) and deepseek-v3-671b
# (configs/deepseek_v3_671b.py) at full width, float32. Served with every
# expert and the config's top-k and capacity factor 1.25, depth cut: grok
# from 64 to 2 layers (1.145e10 parameters, 45.8 GB; 64 layers take 1.27
# TB), deepseek from 61 to 4 (its 3 dense-prefix layers and 1 MoE layer,
# MLA, the multi-token head held but unused in serving: 1.439e10, 57.6 GB;
# 61 layers take 2.68 TB). Trained cut by depth first, then by expert count
# (top-k kept): grok 1 layer of 4 of its 8 experts (4.11e9 parameters),
# deepseek 1 dense-prefix and 1 MoE layer of 32 of its 256 experts with the
# multi-token head (4.06e9); 16 bytes a parameter with float32 moments
# would pass the card's 80 GB, so the moments are int8 (OptConfig
# quantize_moments=True): about 41 GB of weights, gradients and moments
MOE_ARCHS = ("grok-1-314b", "deepseek-v3-671b")
MOE_SERVE = {"grok-1-314b": (2, 11_450_578_944),
             "deepseek-v3-671b": (4, 14_388_066_560)}   # layers, parameters
MOE_PREFILL = 2048            # a 1 x 2048 prefill: cap 640 (grok), 80 (ds)
MOE_DECODE_B = 4              # decode at B = 4: cap 2 (grok), 1 (deepseek)
MOE_DECODE_STEPS = 16         # single decode steps after a cache-writing
                              # prefill of LM_PROMPT tokens a row
MOE_PLAIN_RTOL = 1e-4         # moe_fwd vs moe_fwd_plain, one layer:
                              # max|diff| <= MOE_PLAIN_RTOL * max(1, max|plain|)
MOE_TRAIN = (4, 512, 2)       # batch, seq, microbatches
MOE_TRAIN_CUT = {"grok-1-314b": dict(n_layers=1, n_experts=4),
                 "deepseek-v3-671b": dict(n_layers=2, dense_prefix=1,
                                          n_experts=32)}
MOE_PEAK_GB = 72.0            # a training peak above this halves the experts

# RG-LRU with local attention and the Whisper encoder-decoder (phase
# ``lm_hybrid_audio``): recurrentgemma-2b (configs/recurrentgemma_2b.py) at
# full width and depth, float32 (3.55e9 parameters, 14.2 GB), served and
# trained (int8 moments: about 36 GB of weights, gradients and moments
# before the optimizer's temporaries and activations); whisper-tiny
# (configs/whisper_tiny.py) at full size (5.7e7 parameters), served through
# the reference's decode pieces and trained
HYBRID_ARCH, AUDIO_ARCH = "recurrentgemma-2b", "whisper-tiny"
HYBRID_PREFILL = (4, 2048)    # batch, tokens: the window of every local layer
HYBRID_DECODE = 16            # decode steps at positions 2048-2063: every
                              # ring buffer has wrapped
HYBRID_LONG = 524_288         # long_500k: the decode cache's bytes there
                              # equal those at 2048 + HYBRID_DECODE
HYBRID_TRAIN = (2, 2048, 2)   # batch, seq, microbatches
HYBRID_PEAK_GB = 72.0         # a training peak above this cuts whole periods
HYBRID_CUT_LAYERS = 11        # ... to 3 periods and the 2-layer tail
AUDIO_FRAMES = 4              # encoder_fwd over 4 x enc_context (1500) frames
AUDIO_PROMPT, AUDIO_NEW = 4, 64   # greedy cross decode at B = AUDIO_FRAMES
AUDIO_TRAIN = (8, 448, 2)     # batch, seq (the decoder's cap), microbatches

# LM sharding and the dry run (phase ``lm_sharding``, after
# ``lm_hybrid_audio``): static bytes and step peaks are gathered inside the
# LM phases that build each model, and the kv-replicated attention branch
# in ``lm_dense``'s qwen1.5-110b section, into SHARDING
ONE_DEVICE_MESH = {"data": 1, "model": 1}
SHARDING_TAGS = ("rwkv6-7b serve", "lm-100m train", "minicpm3-4b serve",
                 "recurrentgemma-2b train", "whisper-tiny train")
EXPAND_MODEL_SIZE = 16        # the reference's model axis: qwen1.5-110b's 64
                              # q heads divide it, its 8 kv heads do not
EXPAND_WINDOW = 512           # the windowed case
EXPAND_RTOL = 1e-5            # kv-replicated vs grouped attention, layer 0:
                              # max|diff| <= EXPAND_RTOL * max(1, max|grouped|)
REMESH_TIMEOUT_S = 240        # the one-rank NCCL remesh, in a subprocess
DTENSOR_STEPS = 3             # DTensor against plain train steps on the card
DTENSOR_RTOL = 1e-5           # their losses, gradients and well-conditioned
#                               parameters: max|diff| <= 1e-5 x max(1,
#                               max|plain|)
DTENSOR_LR = 1e-3             # OptConfig(lr=1e-3, warmup_steps=1), the
#                               reference's sharded case
WELL_CONDITIONED = 1e-3       # a gradient at least this share of its
#                               parameter's largest
DRYRUN_TIMEOUT_S = 300        # launch/dryrun.py, one cell, in a subprocess
DRYRUN_CELLS = ((DENSE_ARCH, "train_4k", "pod"),    # (e), and (h): a
                ("rwkv6-7b", "decode_32k", "pod"),  # cell rwkv_scan once
                (DENSE_ARCH, "train_4k", "multipod"))  # kept off DTensors
#                               and one with the batch on two mesh dims
SERVE_DECODE_TOKENS = 8       # (g): decode tokens after the DTensor prefill
SERVE_TIMED = 3               # (g): prefills timed by CUDA events, median
SERVE_TIMEOUT_S = 420         # (g), in a subprocess: 30 GB of weights
SERVE_RANKS = 4               # (g) on several cards: a (1, 4) mesh, 16
#                               heads a rank
SHARDING = {"bytes": [], "kv_replicated": None}

# FP32 operations per (b, h, t) and state cell that rwkv_scan needs at
# least: r_i*S_ij and its add to out_j, k_i*v_j, w_i*S_ij and the add of
# k_i*v_j. The bonus term r_t (u (x) k_t^T v_t) = (r_t . (u (x) k_t)) v_t is
# O(hd) per step and left out.
RWKV_OPS_PER_CELL = 5

# the serving path (phase ``serve``): three resident KITTI-like scenes (the
# static cell's and two more), the static cell's two signatures, a trace on
# launch/serve.py's simulated arrival clock (Poisson arrivals, scene
# popularity 1/(i+1)), each request's rows drawn from its scene's points
SERVE_SCENE_SEEDS = (1, 2, 3)
SERVE_REQUESTS, SERVE_RATE, SERVE_SEED = 256, 2000.0, 0
SERVE_ROWS = (1024, 16384)            # rows a request, drawn uniformly
SERVE_OPTS = dict(max_batch=65536, max_pending=1 << 20, pipeline=1)
SERVE_BUCKETS = (1024, 65536)         # launch buckets warmed, powers of 2
SERVE_PROFILED = 64                   # requests of the trace replayed under
                                      # torch.profiler (its parse of every
                                      # kernel event costs seconds a 10k)
# a session-backed scene: the dynamic cell's trajectory, stepped and drained
SERVE_SESSION_ITERS, SERVE_SESSION_ROWS = 20, 4096
SERVE_THREAD_STEPS, SERVE_THREAD_REQUESTS = 20, 30
SERVE_FUTURE_TIMEOUT_S = 60.0
SERVE_CHAOS = "launch:0.2,straggler:0.1"   # the chaos gate's fault plan

# the sharded paths (phase ``sharded``): the static cell's scene on a
# (4, 2) mesh of slabs sharing the card, and the dynamic cell's trajectory
# stepped by a 4-slab ShardedSession beside the single-device session
# the SPH example (phase sph): examples/sph_fluid_torch.py at its own
# 8,000 particles and at the dynamic cell's 1,000,000
SPH_SIZES = (8_000, 1_000_000)
SPH_TIMED = 20               # session steps timed by CUDA events, each counted
SPH_CHECKED = 3              # of them against the oracle and the CPU physics
SPH_SAMPLE = 512             # rows a checked step holds against brute force
SPH_PROFILED = 3             # steps under the profiler: launches a step
SPH_REBUILD = 3              # --rebuild steps (a fresh NeighborSearch each)
SPH_PHYS_RTOL = 1e-5         # card vs CPU physics: max|diff| <= 1e-5 x scale

SHARD_MESH = (4, 2)          # slabs x query columns (make_mesh_compat)
SHARD_SLABS = 4
SHARD_TIMED = 3              # sharded and whole-scene queries timed, median
SHARD_TILES_PER_LEVEL = 2    # tiles per window of a slab launch held
                             # against the plain version
SHARD_YZ_STEPS, SHARD_YZ_SIGMA = 4, 5e-5   # y/z-only drift: fast steps
SHARD_PROBE_SLAB = 1         # the session's slab whose launches are split
                             # and checked
RANKS_TIMEOUT_S = 600        # phase sharded_ranks' NCCL ranks, one a card


def ptxas_entries(report: str) -> dict:
    """Each kernel entry of an ``nvcc -Xptxas -v`` report, by mangled
    name: its registers, stack frame and spill bytes."""
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            out.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def rwkv_layouts(report: str) -> dict:
    """``rwkv_scan``'s instantiations in a ptxas report, keyed by their
    template arguments: row groups, rows a lane, panels."""
    out = {}
    for name, info in ptxas_entries(report).items():
        m = re.search(r"rwkv_scan_kernelILi(\d+)ELi(\d+)ELb([01])E", name)
        if m:
            out["G{}_R{}_panels{}".format(*m.groups())] = info
    return out


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, runs: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def kernel_inputs(index, plan, queries):
    """The arguments the main path hands ``knn_tile_anchored`` for this
    index and plan, and the ladder entries its levels index."""
    from repro_torch.kernels import ops
    params = index.params
    args, kw = ops.launch_inputs(
        index.grid, index.points, queries[plan.perm.long()], index.spec,
        plan.ladder, plan.tile_levels, params.radius, params.k, plan.tile,
        origin=index.origin)
    return args, kw, ops.segment_levels(plan.ladder, tuple(index.spec.dims))


def ladder_inputs(index, plan, args) -> list:
    """The launch ``args`` with every tile on its ladder cube (the anchors
    of ``assign_tile_levels`` and its entries' extents), where the main
    path gives a full-radius tile the exact box of its members' windows."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.knn_tile import table_extents
    dims = tuple(index.spec.dims)
    qc = index.spec.cell_of(args[0], index.origin).reshape(-1, plan.tile, 3)
    plevel, anchors = ops.assign_tile_levels(
        qc, plan.tile_levels, plan.ladder,
        ops.segment_levels(plan.ladder, dims), dims)
    return args[:3] + [anchors, plevel, args[5],
                       table_extents(plevel, args[5])]


def compare_kernel(args, kw, tag: str) -> float:
    """Kernel vs plain version on the same inputs; must agree bitwise.
    Returns the max |d2| difference over finite entries (0 when equal)."""
    import torch
    from repro_torch.kernels.knn_tile import (knn_tile_anchored,
                                              knn_tile_anchored_plain)
    d2_k, idx_k = knn_tile_anchored(*args, **kw)
    d2_p, idx_p = knn_tile_anchored_plain(*args, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(d2_p)
    err = float((d2_k[fin] - d2_p[fin]).abs().max()) if fin.any() else 0.0
    check(torch.equal(d2_k, d2_p) and torch.equal(idx_k, idx_p),
          f"kernel differs from its plain version ({tag}): "
          f"max |d2| err {err}")
    return err


def phase_kernel_vs_plain(api, data) -> float:
    """Bitwise kernel-vs-plain on the small ``_scene`` workload and a
    KITTI-like 100k-point scene, for k in {1, 5, 8, 32, 100}, both sphere-
    test settings, with every 7th tile moved off the table (neutral)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    scenes = {
        "scene": (rng.random((1500, 3)).astype(np.float32),
                  rng.random((397, 3)).astype(np.float32), 0.11, 128),
        "kitti100k": (data.kitti_like_cloud(100_000, seed=2),
                      data.kitti_like_cloud(20_000, seed=3), 0.02, 256),
    }
    worst = 0.0
    for name, (pts, qs, radius, tile) in scenes.items():
        for k in (1, 5, 8, 32, 100):
            params = api.SearchParams(radius=radius, k=k, knn_window="exact")
            opts = api.SearchOpts(use_pallas=True, query_tile=tile)
            index = api.build_index(pts, params, opts)
            q = torch.from_numpy(qs).cuda()
            plan = api.plan_query(index, q)
            args, kw, _ = kernel_inputs(index, plan, q)
            off = args[4].clone()
            off[::7] = -1
            args[4] = off
            for skip in (0, 1):
                table = args[5].clone()
                table[:, 3] = skip
                worst = max(worst, compare_kernel(
                    args[:5] + [table] + args[6:], kw,
                    f"{name} k={k} skip={skip}"))
            emit("kernel_vs_plain", scene=name, k=k, n_tiles=int(
                args[3].shape[0]), bitwise=True)
    return worst


def tile_subset(args, tiles, tile: int) -> list:
    """The launch ``args`` restricted to the query tiles ``tiles``."""
    import torch
    rows = (tiles[:, None] * tile + torch.arange(tile, device=tiles.device)
            ).flatten()
    return [args[0][rows].contiguous(), args[1], args[2],
            args[3][tiles].contiguous(), args[4][tiles].contiguous(),
            args[5], args[6][tiles].contiguous()]


def compare_tiles(args, kw, tiles, tag: str) -> float:
    """Kernel vs plain version on the query tiles ``tiles`` of the launch
    ``args``, at the shapes that launch gives the kernel."""
    return compare_kernel(tile_subset(args, tiles, kw["tile"]), kw, tag)


def compare_level_tiles(args, kw, per_level: int, tag: str,
                        limit: int | None = None):
    """Kernel vs plain version on up to ``per_level`` tiles drawn at random
    from each level the launch ``args`` uses (at most ``limit`` in all),
    at the shapes that launch gives the kernel. Returns the max error and
    the number of tiles checked per level."""
    import torch
    plevel = args[4]
    picks = []
    for lvl in sorted(set(plevel.tolist())):
        ids = torch.nonzero(plevel == lvl).flatten()
        gen = torch.Generator().manual_seed(lvl)
        pick = torch.randperm(ids.numel(), generator=gen)[:per_level]
        picks.append(ids[pick.to(ids.device)])
    tiles = torch.cat(picks)[:limit]
    err = compare_tiles(args, kw, tiles, tag)
    checked = plevel[tiles].tolist()
    return err, {lvl: checked.count(lvl) for lvl in sorted(set(checked))}


def knn_work(index, args, entries):
    """What one ``knn_tile_anchored`` launch with ``args`` must do: the
    valid (query, candidate) pairs its windows hold, every (query, slot)
    pair it walks, the bytes it must move, the two bound times, and the
    tiles per window entry."""
    import torch
    from repro_torch.core.grid import box_count
    spec, plevel, tile = index.spec, args[4], index.opts.query_tile
    ws = args[6]
    hi = torch.minimum(args[3] + ws - 1,
                       torch.tensor([d - 1 for d in spec.dims],
                                    device=ws.device, dtype=torch.int32))
    valid_cands = box_count(index.grid.sat, args[3], hi).to(torch.int64)
    slots = ws.to(torch.int64).prod(-1) * spec.capacity
    pairs = int(valid_cands.sum()) * tile
    slot_pairs = int(slots.sum()) * tile
    nbytes = (sum(a.numel() * 4 for a in args)
              + args[0].shape[0] * index.params.k * 8)
    ops_ms = pairs * OPS_PER_PAIR / PEAK_FP32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    tiles = {str(entries[lvl]): int((plevel == lvl).sum())
             for lvl in sorted(set(plevel.tolist()))}
    return pairs, slot_pairs, nbytes, ops_ms, bytes_ms, tiles


def split_work(index, args, kw):
    """How one ``knn_tile_anchored`` launch with ``args`` splits and walks:
    its work items, the most items of one tile, the window cells it looks
    up, the slots of the occupied ones that it reads, the occupied slots
    among them (the valid candidates) and all the window slots (what a walk
    of every slot would read), summed over tiles, and the kernel's scratch
    in bytes (what the wrapper allocates besides the outputs)."""
    import torch
    from repro_torch.core.grid import _summed_area_table, box_count
    from repro_torch.kernels.knn_tile import launch_scratch
    spec, plevel, cap = index.spec, args[4], kw["cap"]
    scratch = launch_scratch(plevel, args[5], args[6], args[2], cap)
    order, cum, occupied, sync = scratch
    per_tile = cum[1:] - cum[:-1]
    ws = args[6]
    hi = torch.minimum(args[3] + ws - 1,
                       torch.tensor([d - 1 for d in spec.dims],
                                    device=ws.device, dtype=torch.int32))
    occ_sat = _summed_area_table(occupied.view(*spec.dims).to(torch.int32))
    cells = ws.to(torch.int64).prod(-1)
    return dict(items=int(cum[-1]), max_items_per_tile=int(per_tile.max()),
                window_cells=int(cells.sum()),
                slots_read=int(box_count(occ_sat, args[3], hi).to(
                    torch.int64).sum()) * cap,
                valid_slots=int(box_count(index.grid.sat, args[3],
                                          hi).to(torch.int64).sum()),
                window_slots=int(cells.sum()) * cap,
                scratch_bytes=sum(t.numel() * t.element_size()
                                  for t in scratch))


def whole_grid_tiles(args, entries, dims, want: int):
    """The first ``want`` tiles of this launch whose window is the whole
    grid."""
    import torch
    plevel = args[4]
    whole = [i for i, (ws, _) in enumerate(entries) if tuple(ws) == dims]
    tiles = torch.nonzero(torch.isin(plevel, torch.tensor(
        whole, device=plevel.device, dtype=plevel.dtype))).flatten()[:want]
    check(tiles.numel() == want, f"the plan has {tiles.numel()} whole-grid "
          f"tiles, {want} wanted")
    return tiles


def phase_whole_grid(knn_mod, args, kw, entries, dims) -> dict:
    """``knn_tile_anchored`` bitwise against its plain version on
    WHOLE_GRID_TILES whole-grid-window tiles of the static plan, at the
    plan's k and at k = 100, where every tile splits into the most items
    and each merge carries 100 entries a row."""
    from repro_torch.kernels.knn_tile import launch_scratch
    tiles = whole_grid_tiles(args, entries, dims, WHOLE_GRID_TILES)
    sub = tile_subset(args, tiles, kw["tile"])
    out = dict(tiles=int(tiles.numel()), window=list(dims), per_k={})
    for k in (kw["k"], WHOLE_GRID_K):
        kk = dict(kw, k=k)
        t0 = time.perf_counter()
        err = compare_kernel(sub, kk, f"whole-grid tiles, k={k}")
        scratch = launch_scratch(sub[4], sub[5], sub[6], sub[2],
                                 kw["cap"])
        cum = scratch[1]
        kernel_ms = cuda_time_ms(lambda: knn_mod.knn_tile_anchored(*sub, **kk),
                                 3)
        out["per_k"][str(k)] = dict(
            items=int(cum[-1]), max_items_per_tile=int(
                (cum[1:] - cum[:-1]).max()),
            scratch_bytes=sum(t.numel() * t.element_size()
                              for t in scratch),
            kernel_ms=kernel_ms, max_abs_err=err, bitwise=True,
            compare_s=time.perf_counter() - t0)
    emit("whole_grid", **out)
    return out


def level_breakdown(knn_mod, index, args, kw, entries) -> list:
    """What sets the pace of one launch: the launch restricted to the tiles
    of each window entry, timed alone, beside its work (valid pairs, walked
    slots, items). Time that tracks the valid pairs is the compare-and-
    insert; time that tracks the slots is the walk."""
    import torch
    plevel, tile = args[4], kw["tile"]
    out = []
    for lvl in sorted(set(plevel.tolist())):
        tiles = torch.nonzero(plevel == lvl).flatten()
        sub = tile_subset(args, tiles, tile)
        pairs, slot_pairs, _b, ops_ms, _bm, _t = knn_work(index, sub,
                                                          entries)
        ms = cuda_time_ms(lambda: knn_mod.knn_tile_anchored(*sub, **kw), 3)
        split = split_work(index, sub, kw)
        out.append(dict(window=list(entries[lvl][0]), tiles=int(tiles.numel()),
                        items=split["items"], valid_pairs=pairs,
                        slot_pairs=slot_pairs, ms=ms, bound_ops_ms=ops_ms,
                        ns_per_valid_pair=ms * 1e6 / max(pairs, 1),
                        ns_per_slot=ms * 1e6 * tile / max(slot_pairs, 1)))
    return out


def call_trace(knn_mod, args, kw) -> dict:
    """The device work of one ``knn_tile_anchored`` call, by
    ``torch.profiler``: how many device operations it issues (the work-item
    list, the occupancy bytes and the zeroed locks are small PyTorch
    kernels and copies, then the one hand-written kernel) and their device
    time, ours and the rest apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    knn_mod.knn_tile_anchored(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        knn_mod.knn_tile_anchored(*args, **kw)
        torch.cuda.synchronize()
    evts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [e.time_range.elapsed_us() / 1e3 for e in evts
            if "knn_tile_anchored" in e.name]
    total = sum(e.time_range.elapsed_us() for e in evts) / 1e3
    return dict(device_ops=len(evts), hand_written=len(ours),
                kernel_ms=sum(ours), other_ms=total - sum(ours))


def check_oracle(ref, index, queries, res, sample, mode: str,
                 tag: str) -> float:
    """``res`` on the queries ``sample`` against the brute-force oracle:
    counts and inf masks equal, every index reproduces its distance; knn
    distances within 1e-6 of the oracle's, range indices within the
    radius. Returns the largest knn d2 difference."""
    import numpy as np
    import torch
    params = index.params
    oi, od, oc = ref.brute_force_search(index.points, queries[sample],
                                        params.radius, params.k, chunk=256)
    check(torch.equal(oc, res.counts[sample]), f"{tag}: counts differ "
          "from brute force")
    d2 = res.distances2[sample]
    check(torch.equal(torch.isinf(od), torch.isinf(d2)),
          f"{tag}: inf masks differ from brute force")
    fin = torch.isfinite(d2)
    err = float((od[fin] - d2[fin]).abs().max()) if fin.any() else 0.0
    idx = res.indices[sample]
    valid = idx >= 0
    pos = index.points[idx.clamp_min(0).long()]
    rec = ((queries[sample][:, None] - pos) ** 2).sum(-1)
    check(bool((rec[valid] - d2[valid]).abs().max() <= 1e-5),
          f"{tag}: an index does not reproduce its distance")
    if mode == "knn":
        check(err <= 1e-6, f"{tag}: d2 off brute force by {err}")
    else:
        check(bool((d2[valid] <= np.float32(params.radius) ** 2).all()),
              f"{tag}: an index lies outside the radius")
    return err


def phase_any_k_and_tile(api, data, ref, knn_mod) -> float:
    """What the reference accepts beyond the main path's k and tile:
    ``api.query`` with ``use_pallas=True`` on a small KITTI-like scene at
    every query tile of ANY_K_TILES (below a warp, not a whole number of
    warps, two row blocks of 1024) and k of ANY_K_KS (two and three passes
    of 128 columns), in knn and range mode. Each call is counted (one
    launch per pass), held against the brute-force oracle on every query,
    and ``knn_tile_anchored`` against its plain version on sampled tiles
    of every level of its plan, bitwise. Returns the largest kernel
    difference (0 when equal)."""
    import torch
    pts = data.kitti_like_cloud(ANY_K_POINTS, seed=1)
    worst = 0.0
    for tile in ANY_K_TILES:
        for k in ANY_K_KS:
            for mode in ("knn", "range"):
                tag = f"tile={tile} k={k} {mode}"
                params = (api.SearchParams(radius=ANY_K_RADIUS, k=k,
                                           knn_window="exact")
                          if mode == "knn" else
                          api.SearchParams(radius=ANY_K_RADIUS, k=k,
                                           mode="range"))
                opts = api.SearchOpts(use_pallas=True, query_tile=tile)
                index = api.build_index(pts, params, opts)
                queries = index.points.clone()
                torch.cuda.synchronize()
                knn_mod.knn_tile_anchored.launches = 0
                res = api.query(index, queries)
                torch.cuda.synchronize()
                launches = knn_mod.knn_tile_anchored.launches
                passes = -(-k // knn_mod.MAX_K)
                check(launches == passes, f"{tag}: {launches} launches, "
                      f"expected {passes}")
                every = torch.arange(queries.shape[0], device="cuda")
                err = check_oracle(ref, index, queries, res, every, mode,
                                   tag)
                plan = api.plan_query(index, queries)
                args, kw, _ = kernel_inputs(index, plan, queries)
                per = max(1, ANY_K_TILES_CHECKED
                          // len(set(args[4].tolist())))
                kerr, checked = compare_level_tiles(
                    args, kw, per, tag, limit=ANY_K_TILES_CHECKED)
                worst = max(worst, kerr)
                emit("any_k_and_tile", tile=tile, k=k, mode=mode,
                     n_points=ANY_K_POINTS, n_tiles=int(args[3].shape[0]),
                     launches=launches,
                     rows_over_128=int((res.counts > 128).sum()),
                     max_count=int(res.counts.max()),
                     brute_force_max_abs_d2_err=(err if mode == "knn"
                                                 else None),
                     kernel_tiles_checked=sum(checked.values()),
                     bitwise=True)
    return worst


def phase_main(api, ref, knn_mod, index, queries, mode: str):
    """One run of the main path, counted and under sync-debug "error",
    then its checks. Returns what the kernel table needs."""
    import numpy as np
    import torch
    params = index.params
    torch.cuda.synchronize()
    knn_mod.knn_tile_anchored.launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = api.plan_query(index, queries)
        res = api.execute_plan(index, queries, plan)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = knn_mod.knn_tile_anchored.launches
    check(launches >= 1, f"{mode}: the main path launched no kernel")

    # card planning vs the port's CPU planning on the same inputs
    pts_cpu, q_cpu = index.points.cpu(), queries.cpu()
    cindex = api.build_index(pts_cpu, params, index.opts, device="cpu")
    cplan = api.plan_query(cindex, q_cpu)
    spec = index.spec
    check(torch.equal(spec.cell_of(index.points).cpu(),
                      spec.cell_of(pts_cpu)), f"{mode}: cell coords differ")
    for name in ("dense", "counts", "sat", "overflow"):
        check(torch.equal(getattr(index.grid, name).cpu(),
                          getattr(cindex.grid, name)),
              f"{mode}: grid.{name} differs from the CPU build")
    check(cplan.ladder == plan.ladder, f"{mode}: ladder differs")
    check(torch.equal(plan.perm.cpu(), cplan.perm), f"{mode}: perm differs")
    check(torch.equal(plan.tile_levels.cpu(), cplan.tile_levels),
          f"{mode}: tile_levels differ")
    args, kw, entries = kernel_inputs(index, plan, queries)
    cargs, _, _ = kernel_inputs(cindex, cplan, q_cpu)
    check(torch.equal(args[4].cpu(), cargs[4]), f"{mode}: plevel differs")
    check(torch.equal(args[3].cpu(), cargs[3]), f"{mode}: anchors differ")
    check(torch.equal(args[6].cpu(), cargs[6]), f"{mode}: extents differ")

    # sampled exactness against brute force on the card
    rng = np.random.default_rng(7)
    sample = torch.from_numpy(rng.choice(queries.shape[0], N_SAMPLE,
                                         replace=False)).cuda()
    err = check_oracle(ref, index, queries, res, sample, mode, mode)

    # kernel vs plain on tiles sampled across every level
    plevel = args[4]
    per = max(1, N_KERNEL_TILES // len(set(plevel.tolist())))
    kerr, checked = compare_level_tiles(args, kw, per, f"{mode} main-path "
                                        "tiles", limit=N_KERNEL_TILES)

    pairs, slot_pairs, nbytes, ops_ms, bytes_ms, level_tiles = knn_work(
        index, args, entries)
    whole = (phase_whole_grid(knn_mod, ladder_inputs(index, plan, args), kw,
                              entries, tuple(spec.dims))
             if mode == "knn" else None)
    emit("main_path", mode=mode, n_points=int(index.points.shape[0]),
         n_queries=int(queries.shape[0]), dims=list(spec.dims),
         capacity=spec.capacity, w_full=index.statics.w_full,
         ladder=[list(e) for e in plan.ladder], n_tiles=int(plevel.numel()),
         tiles_per_level=level_tiles, launches=launches,
         planned_and_executed_ms=wall_ms, sync_free=True,
         sampled=N_SAMPLE,
         brute_force_max_abs_d2_err=err if mode == "knn" else None,
         mean_count=float(res.counts.float().mean()),
         kernel_tiles_checked=sum(checked.values()),
         kernel_max_abs_err=kerr,
         valid_pairs=pairs, slot_pairs=slot_pairs, bytes=nbytes,
         bound_ops_ms=ops_ms, bound_bytes_ms=bytes_ms,
         split=split_work(index, args, kw),
         per_call=call_trace(knn_mod, args, kw),
         by_window=(level_breakdown(knn_mod, index, args, kw, entries)
                    if mode == "knn" else None))
    if whole is not None:
        kerr = max([kerr] + [v["max_abs_err"]
                             for v in whole["per_k"].values()])
    return dict(args=args, kw=kw, launches=launches, err=kerr,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def trajectory(n: int, steps: int, seed: int, sigma: float):
    """``benchmarks/fig_dynamic.py``'s ``_trajectory`` written out in numpy
    (that module imports the JAX package): a per-point velocity random
    walk, clipped to the unit box. Returns the frames and the last
    velocities."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3)).astype(np.float32)
    vel = rng.normal(0, sigma, (n, 3)).astype(np.float32)
    frames = [pos]
    for _ in range(steps - 1):
        vel = 0.9 * vel + rng.normal(0, 0.3 * sigma,
                                     (n, 3)).astype(np.float32)
        pos = np.clip(pos + vel, 0.0, 1.0).astype(np.float32)
        frames.append(pos)
    return frames, vel


def bin_vs_plain(upd, p, a, spec, tag: str, origin=None,
                 mask_parked: bool = False) -> float:
    """``bin_disp_tile`` kernel vs plain version on the same inputs; cells,
    oob and the bits of max_disp2 must agree. Returns the largest
    difference of any output (0 when equal)."""
    import torch
    got = upd.bin_disp_tile(p, a, spec, origin=origin,
                            mask_parked=mask_parked)
    ref = upd.bin_disp_tile_plain(p, a, spec, origin=origin,
                                  mask_parked=mask_parked)
    torch.cuda.synchronize()
    cell_err = (int((got[0] - ref[0]).abs().max()) if got[0].numel()
                else 0)
    err = max(cell_err, abs(int(got[1]) - int(ref[1])),
              abs(float(got[2]) - float(ref[2])))
    check(torch.equal(got[0], ref[0]) and int(got[1]) == int(ref[1])
          and int(got[2].view(torch.int32)) == int(ref[2].view(torch.int32)),
          f"bin_disp_tile differs from its plain version ({tag}): "
          f"max err {err}")
    return err


def phase_bin_edge_cases(upd) -> float:
    """Bitwise kernel-vs-plain of ``bin_disp_tile`` on edge cases: N = 1 and
    N = 257, rows out of range on each side of each axis, parked rows with
    and without ``mask_parked``, and an ``origin`` override."""
    import numpy as np
    import torch
    from repro_torch.core.grid import choose_grid_spec
    from repro_torch.core.types import PARK_SENTINEL
    rng = np.random.default_rng(3)
    base = rng.random((600, 3)).astype(np.float32)
    spec = choose_grid_spec(base, 0.1)
    anchor = (base + rng.normal(0, 0.01, base.shape)).astype(np.float32)
    oor = base.copy()
    oor[[7, 8, 9]] = [[9.0, 0.5, 0.5], [0.5, 9.0, 0.5], [0.5, 0.5, 9.0]]
    oor[[10, 11, 12]] = [[-4.0, 0.5, 0.5], [0.5, -4.0, 0.5],
                         [0.5, 0.5, -4.0]]
    parked = base.copy()
    parked[[3, 50, 400]] = PARK_SENTINEL
    parked[60] = [0.5, -PARK_SENTINEL, 0.5]
    parked[61] = [9.0, 0.5, 0.5]
    cases = {
        "n1": (base[:1], anchor[:1], None, False),
        "n257": (base[:257], anchor[:257], None, False),
        "out_of_range": (oor, anchor, None, False),
        "parked_masked": (parked, anchor, None, True),
        "parked_unmasked": (parked, anchor, None, False),
        "origin": (base, anchor, np.float32([-0.05, 0.02, -0.11]), False),
    }
    worst = 0.0
    for name, (p, a, o, mask) in cases.items():
        args = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                for x in (p, a)]
        origin = None if o is None else torch.from_numpy(o).cuda()
        err = bin_vs_plain(upd, *args, spec, name, origin=origin,
                           mask_parked=mask)
        worst = max(worst, err)
        emit("bin_vs_plain", case=name, n=int(p.shape[0]), bitwise=True)
    return worst


def phase_layer_vs_plain(ops, tknn, trange, tdist) -> dict:
    """Bitwise kernel-vs-plain of ``knn_tile``, ``range_count`` and
    ``distance_tile`` on the cases of ``tests/test_kernels.py``, and of the
    two id-stream kernels on streams that their own split cuts into
    several work items a tile (ties across segment boundaries, k = 129 at
    tiles 8 and 2048, streams about 8 % valid, range counts at the kernel
    layer's stream length). Returns the largest difference per kernel (0
    when equal)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    worst = {"knn_tile": 0.0, "range_count": 0.0, "distance_tile": 0.0}

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def knn_case(tag, q, p, wnd, k, r2, tile=64):
        for skip in (False, True):
            kw = dict(k=k, r2=r2, skip_test=skip, tile=tile)
            args = (cuda(q), cuda(p), cuda(wnd))
            d2_k, idx_k = ops.knn_tile(*args, **kw)
            d2_p, idx_p = tknn.knn_tile_plain(*args, **kw)
            torch.cuda.synchronize()
            fin = torch.isfinite(d2_p)
            err = (float((d2_k[fin] - d2_p[fin]).abs().max())
                   if fin.any() else 0.0)
            worst["knn_tile"] = max(worst["knn_tile"], err)
            check(torch.equal(d2_k, d2_p) and torch.equal(idx_k, idx_p),
                  f"knn_tile differs from its plain version ({tag}, "
                  f"skip={skip}): max |d2| err {err}")

    cases = 0
    for k in (1, 4, 8, 32, 100):
        for m in (60, 256, 1000):
            q = rng.random((128, 3)).astype(np.float32)
            p = rng.random((m, 3)).astype(np.float32)
            wnd = np.broadcast_to(np.arange(m, dtype=np.int32), (2, m))
            knn_case(f"k={k} m={m}", q, p, wnd, k, 0.4 * 0.4)
            cases += 1
    knn_case("k above the candidates",
             rng.random((64, 3)).astype(np.float32),
             rng.random((5, 3)).astype(np.float32),
             np.arange(5, dtype=np.int32)[None], 8, 10.0)
    knn_case("all masked", rng.random((64, 3)).astype(np.float32),
             np.full((64, 3), 50.0, np.float32),
             np.full((1, 64), -1, np.int32), 4, 0.01)
    knn_case("duplicate points", np.zeros((64, 3), np.float32),
             np.zeros((10, 3), np.float32),
             np.arange(10, dtype=np.int32)[None], 4, 1.0)
    cases += 3
    # a tile of 8 rows (a quarter warp, masked) and k = 129 (two passes)
    p = rng.random((600, 3)).astype(np.float32)
    p[300:] = p[:300]                   # duplicates: ties across passes
    wnd = np.broadcast_to(np.arange(600, dtype=np.int32), (3, 600)).copy()
    wnd[2, 100:] = -1                   # fewer valid candidates than k
    knn_case("k=129 tile=8", rng.random((24, 3)).astype(np.float32), p,
             wnd, 129, 0.4 * 0.4, tile=8)
    cases += 1
    def range_case(tag, q, pos, wnd, r2, tile):
        args = (cuda(q), cuda(pos), cuda(wnd))
        got = ops.range_count(*args, r2=r2, tile=tile)
        want = trange.range_count_plain(*args, r2=r2, tile=tile)
        torch.cuda.synchronize()
        worst["range_count"] = max(worst["range_count"],
                                   int((got - want).abs().max()))
        check(torch.equal(got, want), f"range_count differs from its plain "
              f"version ({tag})")

    for m, tile in ((100, 64), (600, 64), (600, 8)):
        range_case(f"m={m}, tile={tile}",
                   rng.random((2 * tile, 3)).astype(np.float32),
                   rng.random((2, m, 3)).astype(np.float32),
                   rng.integers(-1, m, (2, m)).astype(np.int32),
                   0.25 ** 2, tile)
        cases += 1

    # streams of several work items each, at the kernels' own split:
    # twins (every point at two ids, adjacent in the stream, tile 0's pairs
    # shifted by one) so that segment boundaries fall between equal
    # distances, queries on points, and mostly invalid streams
    split = []

    def twin_streams(n_tiles, m, n, valid=1.0):
        p = rng.random((n, 3)).astype(np.float32)
        pts = np.concatenate([p, p])
        wnd = np.empty((n_tiles, m + 1), np.int32)
        for i in range(n_tiles):
            first = rng.integers(0, n, (m + 1) // 2 + 1)
            pair = np.stack([first, first + n], 1).reshape(-1)
            wnd[i] = pair[1:m + 2] if i == 0 else pair[:m + 1]
        wnd = np.ascontiguousarray(wnd[:, :m])
        wnd[rng.random(wnd.shape) >= valid] = -1
        return pts, wnd

    def on_points(q, pts):
        q[::3] = pts[rng.integers(0, len(pts), q[::3].shape[0])]
        return q

    for tag, n_tiles, tile, m, n, valid, ks, r in (
            ("several items, twins", 3, 64, 40_000, 20_000, 1.0, (8, 32),
             0.05),
            ("k=129 tile=8, twins", 3, 8, 30_000, 15_000, 1.0, (129,), 0.15),
            ("k=129 tile=2048, twins", 2, 2048, 30_000, 15_000, 1.0, (129,),
             0.15),
            ("8 % valid", 4, 256, 198_550, 100_000, 0.08, (8, 100), 0.05)):
        pts, wnd = twin_streams(n_tiles, m, n, valid)
        q = on_points(rng.random((n_tiles * tile, 3)).astype(np.float32),
                      pts)
        for k in ks:
            units, seg, nseg = tknn.knn_tile_items(m, n_tiles, tile, k)
            check(nseg > 1, f"knn_tile: {tag} does not split")
            knn_case(f"{tag}, k={k}", q, pts, wnd, k, r * r, tile=tile)
            split.append(dict(case=tag, kernel="knn_tile", k=k, m=m,
                              tile=tile, units=units, seg=seg, nseg=nseg,
                              valid_ids=int((wnd >= 0).sum())))
            cases += 1
    for tile, valid in ((256, 0.08), (8, 1.0), (2048, 0.08)):
        n_tiles, m = 4 if tile < 2048 else 2, 198_550
        pts, wnd = twin_streams(n_tiles, m, 100_000, valid)
        pos = pts[np.clip(wnd, 0, None)]
        pos[wnd < 0] = np.nan           # an invalid id's slot is never read
        q = on_points(rng.random((n_tiles * tile, 3)).astype(np.float32),
                      pts)
        units, seg, nseg = trange.range_count_items(m, n_tiles, tile)
        check(nseg > 1, f"range_count: m={m} tile={tile} does not split")
        range_case(f"m={m}, tile={tile}, {valid:.0%} valid", q, pos, wnd,
                   0.05 ** 2, tile)
        split.append(dict(case=f"{valid:.0%} valid", kernel="range_count",
                          m=m, tile=tile, units=units, seg=seg, nseg=nseg,
                          valid_ids=int((wnd >= 0).sum())))
        cases += 1
    for nq, npts in ((8, 16), (100, 300), (256, 512), (33, 700), (513, 129)):
        for dtype in (torch.float32, torch.bfloat16):
            q = cuda(rng.random((nq, 3)).astype(np.float32)).to(dtype)
            p = cuda(rng.random((npts, 3)).astype(np.float32)).to(dtype)
            got = ops.distance_tile(q, p)
            want = tdist.distance_tile_plain(q, p)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst["distance_tile"] = max(worst["distance_tile"], err)
            check(torch.equal(got, want), f"distance_tile differs from its "
                  f"plain version ({nq}x{npts} {dtype}): max err {err}")
            cases += 1
    emit("layer_vs_plain", cases=cases, max_abs_err=worst, split=split,
         bitwise=True)
    return worst


def window_ids(dense_flat, anchors, ws, cap, dims):
    """The ids of each anchored window [n, wx*wy*wz*cap], in window order
    (cells in x, y, z raster order, slots innermost): the id stream the
    anchored kernel derives inside itself."""
    import torch
    dev = dense_flat.device
    m = ws[0] * ws[1] * ws[2] * cap
    c = torch.arange(m, device=dev)
    slot, cell = c % cap, c // cap
    iz, iy, ix = cell % ws[2], (cell // ws[2]) % ws[1], cell // (ws[2] * ws[1])
    a = anchors.to(torch.int64)
    flat = ((((a[:, :1] + ix) * dims[1] + (a[:, 1:2] + iy)) * dims[2]
             + (a[:, 2:] + iz)) * cap + slot)
    return dense_flat[flat].contiguous()


def layer_tiles(plan, args, kw, entries, index, n_tiles: int) -> dict:
    """``n_tiles`` tiles of the static knn plan that take LAYER_WINDOW, as
    the kernel layer runs them: those at the full-radius level first
    (their window covers every member's r-ball, which the brute-force
    check of range_count needs), the level's tiles taken again in turn
    where it holds fewer. Returns the tile ids, how many are distinct,
    their queries and anchors, and their windows as id streams (``wnd``)
    with the ids' positions (``wnd_pos``)."""
    import torch
    spec, tile = index.spec, kw["tile"]
    lvl = entries.index((LAYER_WINDOW, False))
    full = plan.ladder.index((index.statics.w_full, False))
    ids = torch.nonzero(args[4] == lvl).flatten()
    ids = torch.cat([ids[plan.tile_levels[ids] == full],
                     ids[plan.tile_levels[ids] != full]])
    distinct = min(ids.numel(), n_tiles)
    ids = ids.repeat(-(-n_tiles // max(ids.numel(), 1)))[:n_tiles]
    rows = (ids[:, None] * tile + torch.arange(tile, device=ids.device)
            ).flatten()
    anchors = args[3][ids].contiguous()
    wnd = window_ids(args[2], anchors, LAYER_WINDOW, spec.capacity,
                     tuple(spec.dims))
    return dict(ids=ids, distinct=distinct, full=full,
                q=args[0][rows].contiguous(), anchors=anchors, wnd=wnd,
                wnd_pos=index.points[wnd.clamp_min(0).long()].contiguous())


def stream_bounds(q, wnd, k: int, tile: int, n_points: int) -> dict:
    """What ``knn_tile`` and ``range_count`` must do on these id streams:
    the valid ids and (query, valid id) pairs, and per kernel the bytes it
    must move (each input read once, each output written once; for
    range_count every id but only the valid ids' positions, and beside it
    every position, what the old kernel read), its operations, and the
    bound: the larger of bytes over the card's memory rate and operations
    over its FP32 rate."""
    n_valid = int((wnd >= 0).sum())
    pairs = n_valid * tile
    ops_count = pairs * OPS_PER_PAIR
    knn_bytes = ((q.numel() + n_points * 3 + wnd.numel()) * 4
                 + q.shape[0] * k * 8)
    rc_bytes = (q.numel() + n_valid * 3 + wnd.numel() + q.shape[0]) * 4
    rc_all_bytes = (q.numel() + wnd.numel() * 4 + q.shape[0]) * 4

    def bound(nbytes):
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        ops_ms = ops_count / PEAK_FP32 * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bytes=nbytes,
                    ops=ops_count,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    return dict(valid_ids=n_valid, valid_pairs=pairs,
                knn_tile=bound(knn_bytes), range_count=bound(rc_bytes),
                range_count_all_positions=bound(rc_all_bytes))


def ptxas_of(report: str, pattern: str) -> dict:
    """Registers and spills of the kernel entries of a ptxas report whose
    mangled name contains ``pattern`` (one instantiation)."""
    return {name: info for name, info in ptxas_entries(report).items()
            if pattern in name}


def phase_kernel_layer(api, ops, tknn, trange, tdist, ref, index, queries,
                       reports):
    """The kernel layer at the static knn plan's shapes. Takes 64 tiles of
    the plan's most common window, materialises each window as an id
    stream and runs ``knn_tile`` and ``range_count`` on it (counted), and
    ``distance_tile`` at DIST_SHAPE in float32 and bfloat16 (counted); then
    holds each against its plain version, ``knn_tile`` against
    ``knn_tile_anchored`` on the same tiles, ``range_count`` against brute
    force on every query whose r-ball its window covers, and times them.
    Records how the two id-stream kernels split (units, segment length,
    items: more items than units) and their registers and spills, and
    times them again at 4 x the SM count tiles of the same window.
    Returns the kernel table's rows for the three."""
    import numpy as np
    import torch
    plan = api.plan_query(index, queries)
    args, kw, entries = kernel_inputs(index, plan, queries)
    args = ladder_inputs(index, plan, args)
    spec, params, tile = index.spec, index.params, kw["tile"]
    dims = tuple(spec.dims)
    lt = layer_tiles(plan, args, kw, entries, index, N_KERNEL_TILES)
    check(lt["distinct"] == N_KERNEL_TILES,
          f"kernel_layer: only {lt['distinct']} tiles take {LAYER_WINDOW}")
    ids, full, q, anchors = lt["ids"], lt["full"], lt["q"], lt["anchors"]
    wnd, wnd_pos = lt["wnd"], lt["wnd_pos"]
    r2 = float(np.float32(params.radius) * np.float32(params.radius))
    gen = torch.Generator().manual_seed(5)
    pick = torch.randperm(index.points.shape[0], generator=gen)
    dq = index.points[pick[:DIST_SHAPE[0]].to(q.device)].contiguous()
    dp = index.points[:DIST_SHAPE[1]].contiguous()
    dq16, dp16 = dq.to(torch.bfloat16), dp.to(torch.bfloat16)

    # the layer's run: every launch count set to 0 just before, read after
    torch.cuda.synchronize()
    for fn in (ops.knn_tile, ops.range_count, ops.distance_tile):
        fn.launches = 0
    d2_s, idx_s = ops.knn_tile(q, index.points, wnd, k=params.k, r2=r2,
                               tile=tile)
    cnt = ops.range_count(q, wnd_pos, wnd, r2=r2, tile=tile)
    dist = ops.distance_tile(dq, dp)
    dist16 = ops.distance_tile(dq16, dp16)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in
                (ops.knn_tile, ops.range_count, ops.distance_tile)}
    for name, n in launches.items():
        check(n >= 1, f"kernel_layer: {name} was not launched")

    # knn_tile: = knn_tile_anchored on the same tiles, = its plain version
    sub = [q, args[1], args[2], anchors, args[4][ids].contiguous(), args[5],
           args[6][ids].contiguous()]
    d2_a, idx_a = ops.knn_tile_anchored(*sub, **kw)
    check(torch.equal(d2_a, d2_s) and torch.equal(idx_a, idx_s),
          "kernel_layer: knn_tile differs from knn_tile_anchored")
    anchored_split = split_work(index, sub, kw)
    d2_p, idx_p = tknn.knn_tile_plain(q, index.points, wnd, k=params.k,
                                      r2=r2, tile=tile)
    fin = torch.isfinite(d2_p)
    knn_err = float((d2_s[fin] - d2_p[fin]).abs().max()) if fin.any() else 0.
    check(torch.equal(d2_s, d2_p) and torch.equal(idx_s, idx_p),
          f"kernel_layer: knn_tile differs from its plain version "
          f"({knn_err})")

    # range_count: = its plain version; = brute force where covered
    cnt_p = trange.range_count_plain(q, wnd_pos, wnd, r2=r2, tile=tile)
    check(torch.equal(cnt, cnt_p),
          "kernel_layer: range_count differs from its plain version")
    w = index.statics.w_full
    dims_t = torch.tensor(dims, device=q.device, dtype=torch.int32)
    c = spec.cell_of(q)
    lo = torch.clamp_min(c - w, 0)
    hi = torch.minimum(c + w, dims_t - 1)
    a = anchors.repeat_interleave(tile, dim=0)
    ws_t = torch.tensor(LAYER_WINDOW, device=q.device, dtype=torch.int32)
    covered = torch.all((lo >= a) & (hi <= a + ws_t - 1), dim=1)
    r2_t = torch.tensor(r2, device=q.device)
    brute = torch.cat([
        torch.sum(ref.pairwise_d2(q[s:s + 256], index.points) <= r2_t,
                  dim=1, dtype=torch.int32)
        for s in range(0, q.shape[0], 256)])
    n_cov = int(covered.sum())
    check(n_cov > 0, "kernel_layer: no query's r-ball inside its window")
    check(int(index.grid.overflow) == 0, "kernel_layer: the grid overflowed")
    check(torch.equal(cnt[covered], brute[covered]),
          "kernel_layer: range_count differs from brute force")

    # distance_tile: = its plain version, f32 and bf16
    dist_err = 0.0
    for got, qq, pp in ((dist, dq, dp), (dist16, dq16, dp16)):
        want = tdist.distance_tile_plain(qq, pp)
        dist_err = max(dist_err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"kernel_layer: distance_tile differs "
              f"from its plain version ({qq.dtype})")
        del want
    del dist, dist16

    # times: kernel, plain version, library call
    t = {}
    t["knn_tile"] = cuda_time_ms(lambda: ops.knn_tile(
        q, index.points, wnd, k=params.k, r2=r2, tile=tile), 10)
    t["knn_tile_plain"] = cuda_time_ms(lambda: tknn.knn_tile_plain(
        q, index.points, wnd, k=params.k, r2=r2, tile=tile), 1, warmup=0)
    t["knn_tile_anchored"] = cuda_time_ms(lambda: ops.knn_tile_anchored(
        *sub, **kw), 10)
    t["range_count"] = cuda_time_ms(lambda: ops.range_count(
        q, wnd_pos, wnd, r2=r2, tile=tile), 10)
    t["range_count_plain"] = cuda_time_ms(lambda: trange.range_count_plain(
        q, wnd_pos, wnd, r2=r2, tile=tile), 3)
    t["distance_tile"] = cuda_time_ms(lambda: ops.distance_tile(dq, dp), 10)
    t["distance_tile_bf16"] = cuda_time_ms(
        lambda: ops.distance_tile(dq16, dp16), 10)
    t["distance_tile_plain"] = cuda_time_ms(
        lambda: tdist.distance_tile_plain(dq, dp), 3)
    t["cdist"] = cuda_time_ms(lambda: torch.cdist(
        dq, dp, compute_mode="use_mm_for_euclid_dist"), 5)

    # how the id-stream kernels split these tiles, and what holds them
    knn_split = dict(zip(("units", "seg", "nseg"), tknn.knn_tile_items(
        wnd.shape[1], N_KERNEL_TILES, tile, params.k)))
    rc_split = dict(zip(("units", "seg", "nseg"), trange.range_count_items(
        wnd.shape[1], N_KERNEL_TILES, tile)))
    for name, sp in (("knn_tile", knn_split), ("range_count", rc_split)):
        sp["items"] = sp["units"] * sp["nseg"]
        check(sp["items"] > sp["units"],
              f"kernel_layer: {name} does not split ({sp})")
    ptxas = {"knn_tile": ptxas_of(reports.get("knn_tile", ""),
                                  "knn_tile_kernelILi8ELb0ELb0E"),
             "range_count": ptxas_of(reports.get("range_count", ""),
                                     "range_count_kernelILb0E")}

    # the two at 4 x the SM count tiles of the same window: the many-tile
    # case, which one CTA a tile already filled, must not be lost
    n_many = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    mt = layer_tiles(plan, args, kw, entries, index, n_many)
    sub_m = [mt["q"], args[1], args[2], mt["anchors"],
             args[4][mt["ids"]].contiguous(), args[5],
             args[6][mt["ids"]].contiguous()]
    d2_m, idx_m = ops.knn_tile(mt["q"], index.points, mt["wnd"], k=params.k,
                               r2=r2, tile=tile)
    d2_ma, idx_ma = ops.knn_tile_anchored(*sub_m, **kw)
    check(torch.equal(d2_m, d2_ma) and torch.equal(idx_m, idx_ma),
          "kernel_layer: knn_tile differs from knn_tile_anchored on "
          f"{n_many} tiles")
    cnt_m = ops.range_count(mt["q"], mt["wnd_pos"], mt["wnd"], r2=r2,
                            tile=tile)
    check(torch.equal(cnt_m, trange.range_count_plain(
        mt["q"], mt["wnd_pos"], mt["wnd"], r2=r2, tile=tile)),
          f"kernel_layer: range_count differs from its plain version on "
          f"{n_many} tiles")
    del d2_m, idx_m, d2_ma, idx_ma, cnt_m
    many = dict(
        n_tiles=n_many, distinct_tiles=mt["distinct"],
        knn_tile_split=dict(zip(("units", "seg", "nseg"),
                                tknn.knn_tile_items(
                                    mt["wnd"].shape[1], n_many, tile,
                                    params.k))),
        range_count_split=dict(zip(("units", "seg", "nseg"),
                                   trange.range_count_items(
                                       mt["wnd"].shape[1], n_many, tile))),
        knn_tile_ms=cuda_time_ms(lambda: ops.knn_tile(
            mt["q"], index.points, mt["wnd"], k=params.k, r2=r2,
            tile=tile), 10),
        range_count_ms=cuda_time_ms(lambda: ops.range_count(
            mt["q"], mt["wnd_pos"], mt["wnd"], r2=r2, tile=tile), 10),
        bounds=stream_bounds(mt["q"], mt["wnd"], params.k, tile,
                             index.points.shape[0]))
    del mt, sub_m

    # bounds from this run's inputs: bytes each input read once and each
    # output written once; operations over the valid (query, id) pairs
    sb = stream_bounds(q, wnd, params.k, tile, index.points.shape[0])
    n_valid, pairs = sb["valid_ids"], sb["valid_pairs"]
    knn_bytes = sb["knn_tile"]["bytes"]
    rc_bytes = sb["range_count"]["bytes"]
    dist_bytes = (dq.numel() + dp.numel() + dq.shape[0] * dp.shape[0]) * 4

    def row(name, nbytes, ops_count, err, ms, plain_ms, library_ms):
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        ops_ms = ops_count / PEAK_FP32 * 1e3
        return dict(launches=launches[name], err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    library_ms=library_ms, bytes=nbytes, ops=ops_count)

    rows = {
        "knn_tile": row("knn_tile", knn_bytes, pairs * OPS_PER_PAIR,
                        knn_err, t["knn_tile"], t["knn_tile_plain"], None),
        "range_count": row("range_count", rc_bytes, pairs * OPS_PER_PAIR,
                           0.0, t["range_count"], t["range_count_plain"],
                           None),
        "distance_tile": row("distance_tile", dist_bytes,
                             dq.shape[0] * dp.shape[0] * DIST_OPS_PER_PAIR,
                             dist_err, t["distance_tile"],
                             t["distance_tile_plain"], t["cdist"]),
    }
    emit("kernel_layer", n_tiles=N_KERNEL_TILES, window=list(LAYER_WINDOW),
         ids_per_tile=int(wnd.shape[1]), ids=int(wnd.numel()),
         valid_ids=n_valid, valid_pairs=pairs,
         wnd_pos_mb=wnd_pos.numel() * 4 / 1e6,
         full_radius_tiles=int((plan.tile_levels[ids] == full).sum()),
         range_brute_force_queries=n_cov, mean_count=float(
             cnt.float().mean()), distance_shape=list(DIST_SHAPE),
         distance_out_gb=dist_bytes / 1e9, launches=launches, times_ms=t,
         knn_tile_anchored_split=anchored_split,
         knn_tile_split=knn_split, range_count_split=rc_split,
         ptxas=ptxas, many_tiles=many,
         range_count_all_positions_bound=sb["range_count_all_positions"],
         bitwise=True, bounds={k: {"bound_ms": v["bound_ms"],
                                   "bound_by": v["bound_by"],
                                   "bytes": v["bytes"], "ops": v["ops"]}
                               for k, v in rows.items()})
    return rows


def group_launches(ns, queries, groups):
    """For each launch group, the arguments the executor's searcher hands
    ``knn_tile_anchored`` (its edge-padded selection, a one-entry ladder)
    and the window entries its levels index."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    tile = ns.opts.query_tile
    perm, _ = ns._schedule(queries)
    queries_s = queries[perm.long()]
    for g in groups:
        sel = np.pad(g.sel, (0, g.pad_n - g.sel.shape[0]), mode="edge")
        qb = queries_s[torch.from_numpy(sel).to(queries.device)]
        ladder = ((int(g.w_search), bool(g.skip_test)),)
        levels = torch.zeros((g.pad_n // tile,), dtype=torch.int32,
                             device=queries.device)
        args, kw = ops.launch_inputs(ns.grid, ns.points, qb, ns.spec,
                                     ladder, levels, ns.params.radius,
                                     ns.params.k, tile)
        yield args, kw, ops.segment_levels(ladder, tuple(ns.spec.dims))


def phase_host_planned(core, api, ref, knn_mod, pts, mode: str):
    """``NeighborSearch.query`` on ``pts`` queried by its own points: one
    counted query under sync-debug "warn" (two blocking transfers: the plan
    fetch and the result wait), brute force on sampled queries, in knn mode
    d2 bitwise equal to ``api.query`` on the same index, ``knn_tile_anchored``
    against its plain version on tiles of every window of every launch
    group, a second query that builds no launcher, then the timings.
    Returns the kernel's max error against its plain version."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    params = (core.SearchParams(radius=RADIUS, k=K, knn_window="exact")
              if mode == "knn" else
              core.SearchParams(radius=RADIUS, k=K, mode="range"))
    ns = core.NeighborSearch(pts, params, core.SearchOpts(use_pallas=True))
    queries = ns.points.clone()

    def counted():
        torch.cuda.synchronize()
        knn_mod.knn_tile_anchored.launches = 0
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = ns.query(queries)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]
        return res, wall_ms, syncs, knn_mod.knn_tile_anchored.launches

    res, first_ms, syncs, launches = counted()
    check(len(syncs) == 2, f"host_planned {mode}: {len(syncs)} blocking "
          f"transfers ({syncs}), expected the plan fetch and the wait")
    check(launches == ns.report.launches >= 1,
          f"host_planned {mode}: {launches} kernel launches for "
          f"{ns.report.launches} launch groups")
    # the plan just run: the executor's newest plan-cache entry
    plan, _bundles, groups = list(ns.executor._plan_cache.values())[-1]

    # brute force on sampled queries
    rng = np.random.default_rng(11)
    sample = torch.from_numpy(rng.choice(queries.shape[0], N_SAMPLE,
                                         replace=False)).cuda()
    _oi, od, oc = ref.brute_force_search(ns.points, queries[sample],
                                         params.radius, params.k, chunk=256)
    check(torch.equal(oc, res.counts[sample]),
          f"host_planned {mode}: counts differ from brute force")
    d2, idx = res.distances2[sample], res.indices[sample]
    check(torch.equal(torch.isinf(od), torch.isinf(d2)),
          f"host_planned {mode}: inf masks differ from brute force")
    valid = idx >= 0
    fin = torch.isfinite(d2)
    err = float((od[fin] - d2[fin]).abs().max()) if fin.any() else 0.0
    pos = ns.points[idx.clamp_min(0).long()]
    rec = ((queries[sample][:, None] - pos) ** 2).sum(-1)
    check(bool((rec[valid] - d2[valid]).abs().max() <= 1e-5),
          f"host_planned {mode}: an index does not reproduce its distance")
    if mode == "knn":
        check(err <= 1e-6, f"host_planned knn: d2 off brute force by {err}")
        other = api.query(ns.index, queries)
        check(torch.equal(other.distances2, res.distances2)
              and torch.equal(other.counts, res.counts),
              "host_planned knn: d2 or counts differ from api.query")
    else:
        check(bool((d2[valid] <= np.float32(RADIUS) ** 2).all()),
              "host_planned range: an index lies outside the radius")

    # each group's launch: its work, and the kernel against its plain
    # version on tiles of every window that launch uses
    kerr, group_rows = 0.0, []
    for g, (args, kw, entries) in zip(groups, group_launches(ns, queries,
                                                             groups)):
        gerr, checked = compare_level_tiles(
            args, kw, HP_TILES_PER_LEVEL,
            f"host_planned {mode} w={g.w_search} skip={g.skip_test}")
        kerr = max(kerr, gerr)
        pairs, slot_pairs, _b, ops_ms, _bm, tiles = knn_work(
            ns.index, args, entries)
        group_rows.append(dict(
            w=g.w_search, skip=g.skip_test, n=int(len(g.sel)),
            pad_n=g.pad_n, bundles=g.n_bundles, tiles_per_window=tiles,
            kernel_vs_plain_tiles={str(entries[lvl]): c
                                   for lvl, c in checked.items()},
            kernel_max_abs_err=gerr, valid_pairs=pairs,
            slot_pairs=slot_pairs, bound_ops_ms=ops_ms,
            split=split_work(ns.index, args, kw)))
        del args

    # a repeated query: plan and launcher caches hit, nothing built
    res2, second_ms, syncs2, _ = counted()
    last = ns.executor.stats()["last"]
    check(len(syncs2) == 2 and last["compilations"] == 0
          and last["plan_cache_hit"] and last["launcher_cache_hit"],
          f"host_planned {mode}: repeated query {last}, syncs {syncs2}")
    check(torch.equal(res2.distances2, res.distances2)
          and torch.equal(res2.indices, res.indices),
          f"host_planned {mode}: a repeated query differs")

    query_ms = cuda_time_ms(lambda: ns.query(queries), N_TIMED_QUERIES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ns.query(queries)
        torch.cuda.synchronize()
    kern_us, kern_n = device_us(prof, "knn_tile_anchored")
    # each launch's device time, in launch (= group) order
    per_launch = sorted(
        (e.time_range.start, e.time_range.elapsed_us() / 1e3)
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "knn_tile_anchored" in e.name)
    del prof
    emit("host_planned", mode=mode, n_points=int(ns.points.shape[0]),
         n_queries=int(queries.shape[0]),
         partitions=[dict(w=p.w_search, skip=p.skip_test, count=p.count)
                     for p in plan.partitions],
         bundles=[dict(members=list(b.members), w=b.w_search,
                       skip=b.skip_test, count=b.count)
                  for b in ns.report.bundles],
         groups=group_rows, kernel_max_abs_err=kerr,
         knn_tile_anchored_launch_ms=[ms for _, ms in per_launch],
         launches=launches, blocking_transfers=syncs,
         blocking_transfers_second=syncs2, first_query_ms=first_ms,
         second_query_ms=second_ms, query_ms=query_ms,
         queries_per_s=queries.shape[0] / query_ms * 1e3,
         t_opt_ms=ns.report.t_opt * 1e3,
         knn_tile_anchored_device_ms=(None if kern_us is None
                                      else kern_us * kern_n / 1e3),
         knn_tile_anchored_profiled=kern_n, sampled=N_SAMPLE,
         brute_force_max_abs_d2_err=err,
         mean_count=float(res.counts.float().mean()),
         stats={k: v for k, v in ns.executor.stats().items()
                if k != "last"})
    return kerr


def device_us(prof, name: str):
    """Mean device time (us) per launch of the kernels whose name contains
    ``name`` in a finished ``torch.profiler`` run, and their launch count;
    (None, 0) if the profiler recorded no device time for them."""
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if name in evt.key:
            total += float(getattr(evt, "device_time_total", 0.0)
                           or getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    return (total / count, count) if count and total else (None, 0)


def profiled_kernel_us(fn, name: str, runs: int = 20):
    """Mean device time (us) of the kernels whose name contains ``name``,
    from ``torch.profiler`` over ``runs`` calls; None if the profiler
    records no device time here."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return device_us(prof, name)[0]


def counted(fn, upd, knn_mod):
    """``fn()`` with the launch counts set to 0 just before and read just
    after, every synchronising CUDA call recorded (sync debug mode
    "warn"). Returns the result, the wall time in ms (ending in a
    synchronise), the sync call sites and the two launch counts."""
    import torch
    torch.cuda.synchronize()
    upd.bin_disp_tile.launches = 0
    knn_mod.knn_tile_anchored.launches = 0
    torch.cuda.set_sync_debug_mode("warn")
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return (res, wall_ms, syncs, upd.bin_disp_tile.launches,
            knn_mod.knn_tile_anchored.launches)


def step_counted(sess, upd, knn_mod, cur):
    """One session step, counted as :func:`counted` does."""
    return counted(lambda: sess.step(cur), upd, knn_mod)


def check_step_exact(ref, res, cur, rng, n_sample: int, tag: str,
                     radius: float = DYN_RADIUS, k: int = DYN_K):
    """Brute force on sampled queries: counts exact, every returned index
    within the radius, and its distance recomputes. Returns the largest
    recomputation error."""
    import numpy as np
    import torch
    n = cur.shape[0]
    sample = torch.from_numpy(rng.choice(n, min(n_sample, n),
                                         replace=False)).cuda()
    q = cur[sample]
    _oi, _od, oc = ref.brute_force_search(cur, q, radius, k, chunk=256)
    check(torch.equal(oc, res.counts[sample]),
          f"{tag}: counts differ from brute force")
    idx, d2 = res.indices[sample], res.distances2[sample]
    valid = idx >= 0
    check(torch.equal(valid, torch.isfinite(d2)), f"{tag}: inf mask")
    check(bool((d2[valid] <= np.float32(radius) ** 2).all()),
          f"{tag}: an index lies outside the radius")
    pos = cur[idx.clamp_min(0).long()]
    rec = ((q[:, None] - pos) ** 2).sum(-1)
    err = float((rec[valid] - d2[valid]).abs().max()) if valid.any() else 0.0
    check(err <= 1e-5, f"{tag}: an index does not reproduce its distance "
          f"({err})")
    return err


def phase_dynamic(core, ref, knn_mod, upd, n: int = DYN_N,
                  steps: int = DYN_STEPS, n_sample: int = N_SAMPLE):
    """The dynamic path: ``SimulationSession.step`` over the trajectory,
    then one step that forces a respec and one more drift step, each step
    counted and checked; ``knn_tile_anchored`` against its plain version on
    tiles of every ladder level the session's plan uses, before and after
    the respec; then ``bin_disp_tile`` against its plain version on the
    1M-point frame, and the timings. Returns what the kernel table
    needs."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.grid import _bin_and_stats
    from repro_torch.core.types import device_table
    frames, vel = trajectory(n, steps, DYN_SEED, 0.03 * DYN_RADIUS / 4.0)
    escape = frames[-1].copy()
    escape[:DYN_ESCAPEES, 0] = np.float32(1.1)
    respec_at = steps
    params = core.SearchParams(radius=DYN_RADIUS, k=DYN_K, mode="range")
    opts = core.SearchOpts(use_pallas=True)
    t0 = time.perf_counter()
    sess = core.SimulationSession(frames[0], params, opts)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    spec = sess.spec
    p0 = sess.index.points
    kern_cells = upd.bin_disp_tile(p0, p0, spec)[0]
    div_cells = _bin_and_stats(spec, p0, p0)[0]
    n_differ = int((kern_cells != div_cells).any(-1).sum())
    emit("dynamic_setup", n_points=n, dims=list(spec.dims),
         cell_size=spec.cell_size, capacity=spec.capacity,
         dense_mb=sess.index.grid.dense.numel() * 4 / 1e6, setup_s=setup_s,
         frame0_cells_differ_from_bin_and_stats=n_differ)

    rng = np.random.default_rng(DYN_SEED)
    counts = {"bin": 0, "knn": 0}
    kinds = []

    def checked_step(i, frame):
        cur = torch.from_numpy(frame).cuda()
        res, wall_ms, syncs, nb, nk = step_counted(sess, upd, knn_mod, cur)
        rep = sess.report
        counts["bin"] += nb
        counts["knn"] += nk
        check(rep.respecced == (i == respec_at),
              f"step {i}: respecced={rep.respecced}")
        want = 2 if rep.respecced else 1
        check(len(syncs) == want, f"step {i}: {len(syncs)} blocking "
              f"transfers, expected {want}: {syncs}")
        check(nb == 1 and nk == 1, f"step {i}: launches bin_disp_tile={nb} "
              f"knn_tile_anchored={nk}, expected 1 each")
        err = check_step_exact(ref, res, cur, rng, n_sample, f"step {i}")
        kinds.append("respec" if rep.respecced else
                     "fast" if rep.fast else "replan")
        emit("dynamic_step", step=i, kind=kinds[-1], max_disp=rep.max_disp,
             oob=rep.oob, overflow=rep.overflow, blocking_transfers=syncs,
             bin_disp_tile_launches=nb, knn_tile_anchored_launches=nk,
             wall_ms=wall_ms, t_update_ms=rep.t_update * 1e3,
             t_plan_ms=rep.t_plan * 1e3, t_step_host_ms=rep.t_search * 1e3,
             capacity=sess.spec.capacity,
             mean_count=float(res.counts.float().mean()),
             sampled=n_sample, d2_recompute_err=err)

    for i, frame in enumerate(frames):
        checked_step(i, frame)
    check("fast" in kinds and "replan" in kinds[1:],
          f"dynamic: expected fast and replan steps, got {kinds}")

    def search_vs_plain(tag: str) -> float:
        """The search's inputs on the session's current plan and index:
        its work, and the kernel against its plain version on tiles of
        every window the plan uses (the whole-grid tiles among them)."""
        args, kw, entries = kernel_inputs(sess.index, sess._plan,
                                          sess.index.points)
        pairs, slot_pairs, knn_bytes, knn_ops_ms, knn_bytes_ms, tiles = \
            knn_work(sess.index, args, entries)
        # what the session's k costs: the same launch at k = 8 too, where
        # the best-K lives in registers (k = 32 keeps it in local memory)
        by_k = {k: cuda_time_ms(lambda: knn_mod.knn_tile_anchored(
            *args, **dict(kw, k=k)), 3) for k in (kw["k"], 8)}
        t0 = time.perf_counter()
        err, checked = compare_level_tiles(args, kw, DYN_TILES_PER_LEVEL,
                                           f"dynamic search, {tag}")
        emit("dynamic_search_work", at=tag, dims=list(sess.spec.dims),
             capacity=sess.spec.capacity, k=kw["k"],
             tiles_per_window=tiles, valid_pairs=pairs,
             slot_pairs=slot_pairs, bytes=knn_bytes,
             bound_ops_ms=knn_ops_ms, bound_bytes_ms=knn_bytes_ms,
             kernel_vs_plain_tiles={str(entries[lvl]): c
                                    for lvl, c in checked.items()},
             kernel_max_abs_err=err, bitwise=True,
             split=split_work(sess.index, args, kw),
             kernel_ms_by_k={str(k): v for k, v in by_k.items()},
             compare_s=time.perf_counter() - t0)
        return err

    search_err = search_vs_plain("frozen spec")

    # step times on the frozen spec: a point moved by one cell and back
    # makes every other step a replan, the steps between them replays;
    # the profiler gives the device time of each kernel in these steps
    a = torch.from_numpy(frames[-1]).cuda()
    b = a.clone()
    b[DYN_ESCAPEES, 0] += spec.cell_size
    times = {"fast": [], "replan": []}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for target in [b, b, a, a] * ((N_TIMED_STEPS + 1) // 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.step(target)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            times["fast" if sess.report.fast else "replan"].append(ms)
    check(len(times["fast"]) >= N_TIMED_STEPS
          and len(times["replan"]) >= N_TIMED_STEPS,
          f"timed steps: {[(k, len(v)) for k, v in times.items()]}")
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    step_knn_us, step_knn_n = device_us(prof, "knn_tile_anchored")
    step_bin_us, step_bin_n = device_us(prof, "bin_disp_tile")
    del prof

    # update_index as the session steps it: into the previous grid's
    # storage (donate=True), on a copy of the session's index
    held = [dataclasses.replace(sess.index, grid=dataclasses.replace(
        sess.index.grid, dense=sess.index.grid.dense.clone()))]

    def donated_update():
        held[0] = core.update_index(held[0], a, donate=True)[0]

    update_ms = cuda_time_ms(donated_update, 10)
    del held

    # the respec step, then one more drift step
    checked_step(respec_at, escape)
    checked_step(respec_at + 1, (escape + vel).astype(np.float32))
    check(kinds.count("respec") == 1, f"dynamic: {kinds}")
    search_err = max(search_err, search_vs_plain("after the respec"))
    check(counts["bin"] >= 1 and counts["knn"] >= 1,
          "dynamic: no kernel launched")
    stats = sess.stats()

    # bin_disp_tile against its plain version on the 1M-point frame
    p1 = torch.from_numpy(frames[1]).cuda()
    a0 = torch.from_numpy(frames[0]).cuda()
    err = bin_vs_plain(upd, p1, a0, spec, "1M frame")

    # kernel times: device time by the profiler with the 50 MB L2 flushed
    # before each launch (as a step finds it: the search ran in between),
    # and warm back-to-back, where the 36 MB it touches stays in L2; CUDA
    # events over back-to-back raw launches besides. Then the plain version
    # and the unfused _bin_and_stats as a yardstick.
    origin = device_table(spec.origin, torch.float32, p1.device)
    ccoord = torch.empty((n, 3), dtype=torch.int32, device=p1.device)
    scratch = torch.zeros((2,), dtype=torch.int32, device=p1.device)
    inv = upd._inv_cell(spec)
    flush = torch.empty((64 << 20,), dtype=torch.int32, device=p1.device)

    def raw(m):
        for _ in range(m):
            upd.launch(p1, a0, origin, inv, tuple(spec.dims), False, ccoord,
                       scratch)

    def cold():
        flush.zero_()
        raw(1)

    events_ms = cuda_time_ms(lambda: raw(100), 5) / 100
    cold_us = profiled_kernel_us(cold, "bin_disp_tile")
    warm_us = profiled_kernel_us(lambda: raw(1), "bin_disp_tile")
    kernel_ms = events_ms if cold_us is None else cold_us / 1e3
    del flush
    plain_ms = cuda_time_ms(
        lambda: upd.bin_disp_tile_plain(p1, a0, spec), 20)
    yard_ms = cuda_time_ms(lambda: _bin_and_stats(spec, p1, a0), 20)

    nbytes = (p1.numel() + a0.numel() + ccoord.numel() + 3 + 2) * 4
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = n * BIN_OPS_PER_POINT / PEAK_FP32 * 1e3
    emit("dynamic", n_points=n, steps=len(kinds), kinds=kinds,
         counters={k: v for k, v in stats.items() if k != "last"},
         bin_disp_tile_launches=counts["bin"],
         knn_tile_anchored_launches=counts["knn"],
         bin_disp_tile_ms=kernel_ms, bin_disp_tile_cold_us=cold_us,
         bin_disp_tile_warm_us=warm_us, bin_disp_tile_events_ms=events_ms,
         bin_disp_tile_plain_ms=plain_ms, bin_and_stats_ms=yard_ms,
         update_index_ms=update_ms, step_knn_tile_anchored_us=step_knn_us,
         step_knn_tile_anchored_profiled=step_knn_n,
         step_bin_disp_tile_us=step_bin_us,
         step_bin_disp_tile_profiled=step_bin_n,
         search_kernel_max_abs_err=search_err, fast_step_ms=med["fast"],
         replan_step_ms=med["replan"], fast_steps_ms=times["fast"],
         replan_steps_ms=times["replan"], bytes=nbytes,
         bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms, bitwise=err == 0.0)
    return dict(search_err=search_err, launches=counts["bin"], err=err,
                ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def same_results(res, want, mode: str, queries, points, radius: float,
                 tag: str) -> dict:
    """``res`` against ``want`` on every row: counts and inf masks equal,
    every index within the radius and its distance reproduced from the
    points; knn: d2 within 1e-6, and where an index differs the point it
    names lies at ``want``'s distance for that slot (a tie). Returns the
    largest d2 gap, whether d2 is bitwise equal, and the count of
    differing indices."""
    import numpy as np
    import torch
    check(torch.equal(res.counts, want.counts), f"{tag}: counts differ")
    d2, wd2 = res.distances2, want.distances2
    check(torch.equal(torch.isinf(d2), torch.isinf(wd2)),
          f"{tag}: inf masks differ")
    fin = torch.isfinite(wd2)
    gap = float((d2[fin] - wd2[fin]).abs().max()) if fin.any() else 0.0
    valid = res.indices >= 0
    check(bool((d2[valid] <= np.float32(radius) ** 2).all()),
          f"{tag}: an index lies outside the radius")
    pos = points[res.indices.clamp_min(0).long()]
    rec = ((queries[:, None] - pos) ** 2).sum(-1)
    rec_err = float((rec[valid] - d2[valid]).abs().max()) if valid.any() \
        else 0.0
    check(rec_err <= 1e-5, f"{tag}: an index does not reproduce its "
          f"distance ({rec_err})")
    differ = (res.indices != want.indices) & valid
    if mode == "knn":
        check(gap <= 1e-6, f"{tag}: d2 off by {gap}")
        tie_err = float((rec[differ] - wd2[differ]).abs().max()) \
            if differ.any() else 0.0
        check(tie_err <= 1e-5, f"{tag}: an index differs off a tie "
              f"({tie_err})")
    return dict(d2_gap=gap, d2_bitwise=bool(torch.equal(d2, wd2)),
                index_differences=int(differ.sum()))


def slab_launch(api, knn_mod, index, queries, tag: str, plan=None):
    """One slab's ``knn_tile_anchored`` launch as its path gives it (on
    ``plan``, or on a fresh plan as ``api.query`` makes): its work and
    split, its parked rows, the tiles that mix real and parked rows, and
    the kernel bitwise against its plain version on sampled tiles of every
    window and on the mixed tiles. Returns the summary and the largest
    error."""
    import torch
    if plan is None:
        plan = api.plan_query(index, queries)
    args, kw, entries = kernel_inputs(index, plan, queries)
    pairs, slot_pairs, nbytes, ops_ms, bytes_ms, tiles = knn_work(
        index, args, entries)
    tile = kw["tile"]
    parked = (args[0].abs() >= 1e29).any(-1).reshape(-1, tile).sum(-1)
    mixed = torch.nonzero((parked > 0) & (parked < tile)).flatten()
    err, checked = compare_level_tiles(args, kw, SHARD_TILES_PER_LEVEL, tag)
    if mixed.numel():
        err = max(err, compare_tiles(args, kw, mixed, f"{tag}, mixed tile"))
    rows = args[0].shape[0]
    n_parked = int(parked.sum())
    ms = cuda_time_ms(lambda: knn_mod.knn_tile_anchored(*args, **kw), 3)
    # what the padding costs: the launch restricted to the mixed tiles and
    # to the all-parked tiles
    pad_ms = {}
    for name, sel in (("mixed", mixed),
                      ("all_parked", torch.nonzero(parked == tile).flatten())):
        if sel.numel():
            sub = tile_subset(args, sel, tile)
            pad_ms[name] = cuda_time_ms(
                lambda: knn_mod.knn_tile_anchored(*sub, **kw), 3)
    return dict(
        rows=rows, real_rows=rows - n_parked, parked_rows=n_parked,
        tiles=int(parked.numel()), mixed_tiles=int(mixed.numel()),
        mixed_tile_windows=[list(entries[int(lvl)][0])
                            for lvl in args[4][mixed].tolist()],
        all_parked_tiles=int((parked == tile).sum()),
        valid_pairs=pairs, valid_pairs_per_row=pairs / max(rows, 1),
        valid_pairs_per_real_row=pairs / max(rows - n_parked, 1),
        slot_pairs=slot_pairs, tiles_per_window=tiles,
        bound_ms=max(ops_ms, bytes_ms), kernel_ms=ms,
        kernel_ms_of_padded_tiles=pad_ms,
        split=split_work(index, args, kw),
        kernel_vs_plain_tiles={str(entries[lvl]): c
                               for lvl, c in checked.items()},
        max_abs_err=err, bitwise=True), err


def sharded_query(api, core, data, ref, knn_mod, upd, n: int,
                  n_sample: int, device: str) -> float:
    """``distributed_neighbor_search`` on a (4, 2) mesh of slabs sharing
    the card, knn (upgraded to the exact window) and range, against
    ``api.query`` on the whole scene; one blocking transfer and S x C
    launches a call; the query timed; one slab's launch split and checked.
    Returns the largest kernel error."""
    import numpy as np
    import torch
    from repro_torch.core import shards
    from repro_torch.core.distributed import distributed_neighbor_search
    from repro_torch.launch.mesh import make_mesh_compat
    pts = data.kitti_like_cloud(n, seed=1)
    mesh = make_mesh_compat(SHARD_MESH, ("data", "model"), device=device)
    n_launch = SHARD_MESH[0] * SHARD_MESH[1]
    opts = api.SearchOpts(use_pallas=True)
    rng = np.random.default_rng(1)
    worst = 0.0
    for mode in ("knn", "range"):
        params = (api.SearchParams(radius=RADIUS, k=K) if mode == "knn" else
                  api.SearchParams(radius=RADIUS, k=K, mode="range"))
        res, call_ms, syncs, nb, nk = counted(
            lambda: distributed_neighbor_search(mesh, pts, pts, params,
                                                opts=opts), upd, knn_mod)
        check(len(syncs) == 1, f"sharded query {mode}: {len(syncs)} "
              f"blocking transfers, expected 1: {syncs}")
        check(nk == n_launch and nb == 0, f"sharded query {mode}: "
              f"{nk} knn_tile_anchored launches, expected {n_launch}")
        if mode == "knn":
            params = dataclasses.replace(params, knn_window="exact")
        index = api.build_index(pts, params, opts, device=device)
        q = index.points
        alone = api.query(index, q)
        cmp = same_results(res, alone, mode, q, q, RADIUS,
                           f"sharded query {mode}")
        oracle_err = check_step_exact(ref, res, q, rng, n_sample,
                                      f"sharded query {mode}", RADIUS, K)
        sindex = core.shard_scene(pts, params, mesh=mesh, opts=opts,
                                  shopts=shards.STATIC_SCENE_OPTS,
                                  queries=pts, query_axis="model")
        query_ms = cuda_time_ms(lambda: sindex.query(q), SHARD_TIMED)
        whole_ms = cuda_time_ms(lambda: api.query(index, q), SHARD_TIMED)
        layout = sindex.layout
        qs, qid, _ovf = shards.route_queries(layout, q)
        all_p, _all_i, _hovf = shards._with_halo(layout, sindex.pts,
                                                 sindex.ids)
        # the (slab, column) buffer with the most parked rows
        real = (qid >= 0).sum(-1)
        ps, pc = divmod(int(real.argmin()), SHARD_MESH[1])
        slab = shards._slab_indexes(layout, params, sindex.opts, all_p)[ps]
        probe, err = slab_launch(api, knn_mod, slab, qs[ps, pc].contiguous(),
                                 f"sharded query {mode}, slab {ps} "
                                 f"column {pc}")
        probe.update(slab=ps, column=pc)
        worst = max(worst, err)
        emit("sharded_query", mode=mode, mesh=list(SHARD_MESH),
             n_points=n, call_ms=call_ms, query_ms=query_ms,
             whole_scene_query_ms=whole_ms, blocking_transfers=syncs,
             knn_tile_anchored_launches=nk,
             layout=dict(point_cap=layout.point_cap,
                         halo_cap=layout.halo_cap,
                         query_cap=layout.query_cap,
                         slab_width=layout.slab_width,
                         dims=list(layout.spec.dims),
                         cell_size=layout.spec.cell_size,
                         capacity=layout.spec.capacity),
             whole_scene_dims=list(index.spec.dims),
             whole_scene_capacity=index.spec.capacity,
             real_rows_per_slab_column=real.tolist(),
             vs_whole_scene=cmp, oracle_sampled=n_sample,
             oracle_d2_recompute_err=oracle_err, probe=probe)
        del index, q, alone, res, sindex, all_p, qs, qid, slab
    torch.cuda.empty_cache()
    return worst


def sharded_session(api, core, ref, knn_mod, upd, mode: str, n: int,
                    steps: int, n_sample: int, device: str) -> dict:
    """A 4-slab ``ShardedSession`` on the dynamic cell's trajectory (8
    steps, the escape step, which must re-route once, one more), beside
    the single-device ``SimulationSession`` on the same frames; then y/z
    drift, which must give fast steps with nothing migrating; timed fast
    and replan steps of both, the device's idle share, and one slab's two
    launches against their plain versions."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    frames, vel = trajectory(n, steps, DYN_SEED, 0.03 * DYN_RADIUS / 4.0)
    escape = frames[-1].copy()
    escape[:DYN_ESCAPEES, 0] = np.float32(1.1)
    seq = frames + [escape, (escape + vel).astype(np.float32)]
    params = (core.SearchParams(radius=DYN_RADIUS, k=DYN_K, mode="range")
              if mode == "range" else
              core.SearchParams(radius=DYN_RADIUS, k=8, knn_window="exact"))
    opts = core.SearchOpts(use_pallas=True)
    t0 = time.perf_counter()
    sess = core.ShardedSession(frames[0], params, opts, n_slabs=SHARD_SLABS,
                               device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    single = core.SimulationSession(frames[0], params, opts, device=device)
    lay = sess.layout
    emit("sharded_session_setup", mode=mode, n_points=n, k=params.k,
         slabs=SHARD_SLABS, point_cap=lay.point_cap, halo_cap=lay.halo_cap,
         migrate_cap=lay.migrate_cap, slab_width=lay.slab_width,
         dims=list(lay.spec.dims), cell_size=lay.spec.cell_size,
         capacity=lay.spec.capacity, single_dims=list(single.spec.dims),
         single_cell_size=single.spec.cell_size,
         single_capacity=single.spec.capacity, setup_s=setup_s)
    rng = np.random.default_rng(DYN_SEED)
    kinds = []

    def checked(i, frame, expect_reroute: bool):
        cur = torch.from_numpy(frame).to(device)
        before = sess.stats()
        res, wall_ms, syncs, nb, nk = step_counted(sess, upd, knn_mod, cur)
        after = sess.stats()
        rerouted = after["reroutes"] - before["reroutes"]
        check(rerouted == int(expect_reroute),
              f"sharded {mode} step {i}: {rerouted} re-routes")
        want = 2 if rerouted else 1
        check(len(syncs) == want, f"sharded {mode} step {i}: {len(syncs)} "
              f"blocking transfers, expected {want}: {syncs}")
        check(nb == SHARD_SLABS and nk == SHARD_SLABS,
              f"sharded {mode} step {i}: launches bin_disp_tile={nb} "
              f"knn_tile_anchored={nk}, expected {SHARD_SLABS} each")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        alone = single.step(cur)
        torch.cuda.synchronize()
        single_ms = (time.perf_counter() - t1) * 1e3
        cmp = same_results(res, alone, params.mode, cur, cur, DYN_RADIUS,
                           f"sharded {mode} step {i}")
        err = check_step_exact(ref, res, cur, rng, n_sample,
                               f"sharded {mode} step {i}", DYN_RADIUS,
                               params.k)
        kinds.append("reroute" if rerouted else
                     "replan" if sess.last_flags & 1 else "fast")
        emit("sharded_step", mode=mode, step=i, kind=kinds[-1],
             blocking_transfers=syncs, bin_disp_tile_launches=nb,
             knn_tile_anchored_launches=nk, wall_ms=wall_ms,
             single_ms=single_ms,
             single_kind=("respec" if single.report.respecced else
                          "fast" if single.report.fast else "replan"),
             migrated=after.get("migrated_rows", 0)
             - before.get("migrated_rows", 0),
             halo_rows=after.get("halo_rows", 0) - before.get("halo_rows", 0),
             vs_single=cmp, sampled=n_sample, d2_recompute_err=err)
        return cur

    for i, frame in enumerate(seq):
        cur = checked(i, frame, i == steps)
    st = sess.stats()
    check(st["host_routings"] == 2 and st["reroutes"] == 1,
          f"sharded {mode}: host_routings={st['host_routings']} "
          f"reroutes={st['reroutes']}")
    check(st["migrated_rows"] > 0, f"sharded {mode}: nothing migrated")
    check("fast" in kinds and "replan" in kinds,
          f"sharded {mode}: expected fast and replan steps, got {kinds}")

    # y/z-only drift: slab and halo membership stay, every slab replays
    frame = seq[-1]
    drng = np.random.default_rng(DYN_SEED + 1)
    for j in range(SHARD_YZ_STEPS):
        frame = frame.copy()
        frame[:, 1:] = np.clip(frame[:, 1:] + drng.normal(
            0, SHARD_YZ_SIGMA, (n, 2)), 0.0, 1.0).astype(np.float32)
        cur = checked(len(seq) + j, frame, False)
        check(kinds[-1] == "fast", f"sharded {mode}: y/z drift step {j} "
              f"was a {kinds[-1]} step")
    check(sess.stats()["migrated_rows"] == st["migrated_rows"],
          f"sharded {mode}: rows migrated under y/z drift")

    # one slab's launches on the session's inputs: its self-query (owned
    # rows, the parked ones included) and its update over the
    # halo-extended rows with their shifted origin
    s = SHARD_PROBE_SLAB
    ix = sess._index[s]
    probe, kerr = slab_launch(api, knn_mod, ix, sess._pts[s],
                              f"sharded {mode} session, slab {s}",
                              plan=sess._plan[s])
    launch_ms = [slab_launch_ms(knn_mod, sess, t) for t in
                 range(SHARD_SLABS)]
    bin_err = bin_vs_plain(upd, ix.points, ix.anchor_points, sess.spec,
                           f"sharded {mode}, slab {s}", origin=ix.origin,
                           mask_parked=True)
    n_parked_bin = int((ix.points.abs() >= 1e29).any(-1).sum())

    # timed steps: a point moved by a cell and back makes replan steps,
    # the steps between them replays; the sharded ones profiled
    a = cur
    b = a.clone()
    b[DYN_ESCAPEES, 0] += max(sess.spec.cell_size, single.spec.cell_size)
    targets = [b, b, a, a] * ((N_TIMED_STEPS + 1) // 2)
    times = {"sharded": {"fast": [], "replan": []},
             "single": {"fast": [], "replan": []}}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for target in targets:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.step(target)
            torch.cuda.synchronize()
            times["sharded"]["replan" if sess.last_flags & 1 else
                             "fast"].append((time.perf_counter() - t0) * 1e3)
    busy = device_breakdown(prof, "knn_tile_anchored")
    del prof
    for target in targets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single.step(target)
        torch.cuda.synchronize()
        times["single"]["fast" if single.report.fast else "replan"].append(
            (time.perf_counter() - t0) * 1e3)
    med = {who: {kind: (sorted(v)[len(v) // 2] if v else None)
                 for kind, v in d.items()} for who, d in times.items()}
    ratio = {kind: (med["single"][kind] / med["sharded"][kind]
                    if med["single"][kind] and med["sharded"][kind]
                    else None) for kind in ("fast", "replan")}
    stats = sess.stats()
    emit("sharded_session", mode=mode, n_points=n, slabs=SHARD_SLABS,
         kinds=kinds, counters={k: v for k, v in stats.items()
                                if not k.startswith("level_occ_")},
         step_ms=med, steps_ms=times, single_over_sharded=ratio,
         device=busy, slab_launch_ms=launch_ms,
         slab_launch_ms_sum=sum(launch_ms), probe=probe,
         bin_disp_tile_rows=int(ix.points.shape[0]),
         bin_disp_tile_parked_rows=n_parked_bin,
         bin_disp_tile_bitwise=bin_err == 0.0)
    del sess, single, ix
    torch.cuda.empty_cache()
    return dict(knn_err=kerr, bin_err=bin_err)


def slab_launch_ms(knn_mod, sess, s: int) -> float:
    """CUDA-event time of slab ``s``'s search launch on the session's
    current plan."""
    index = sess._index[s]
    args, kw, _entries = kernel_inputs(index, sess._plan[s], sess._pts[s])
    return cuda_time_ms(lambda: knn_mod.knn_tile_anchored(*args, **kw), 3)


def phase_sharded(api, core, data, ref, knn_mod, upd, n_query: int = N_POINTS,
                  n: int = DYN_N, steps: int = DYN_STEPS,
                  n_sample: int = N_SAMPLE, device: str = "cuda") -> dict:
    """The sharded paths on the card: the one-shot sharded query, then the
    4-slab session in the dynamic cell's range mode and in knn at k = 8.
    Returns the largest kernel errors of the two kernels."""
    t0 = time.perf_counter()
    knn_err = sharded_query(api, core, data, ref, knn_mod, upd, n_query,
                            n_sample, device)
    bin_err = 0.0
    for mode in ("range", "knn"):
        r = sharded_session(api, core, ref, knn_mod, upd, mode, n, steps,
                            n_sample, device)
        knn_err = max(knn_err, r["knn_err"])
        bin_err = max(bin_err, r["bin_err"])
    emit("sharded_done", seconds=time.perf_counter() - t0)
    return dict(knn_err=knn_err, bin_err=bin_err)


def same_bits(res, want) -> bool:
    """Whether two search results are bitwise equal (d2 by its bits)."""
    import torch
    return (torch.equal(res.indices, want.indices)
            and torch.equal(res.counts, want.counts)
            and torch.equal(res.distances2.view(torch.int32),
                            want.distances2.view(torch.int32)))


def digest(res) -> str:
    """SHA-256 of a search result's bytes (indices, d2, counts)."""
    import hashlib
    h = hashlib.sha256()
    for t in (res.indices, res.distances2, res.counts):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def ranked_paths(api, core, data, knn_mod, upd, meshes: dict,
                 want: dict | None = None, keep: bool = False) -> dict:
    """The (4, 2) query on the static cell's scene (knn, range) and the
    4-slab ``ShardedSession`` on the dynamic trajectory (range, k = 32;
    the escape step re-routes once) on each of ``meshes`` (name ->
    (query mesh, slab mesh)), in turns on the same inputs: every path's
    result bitwise the first's, one blocking transfer a query and a
    launch for each (slab, column) this process holds (8 with every
    slab), one a step (two on the re-route) and a launch of each kernel
    for each slab it holds, counted with the counts set to 0 just before
    each call; query and step times in turns. ``want``: the one-process
    path's digests from another process, which every result must match.
    Returns the records and, with ``keep``, the first path's digests."""
    import numpy as np
    import torch
    from repro_torch.core import shards
    from repro_torch.core.distributed import distributed_neighbor_search
    names = list(meshes)
    opts = api.SearchOpts(use_pallas=True)
    held = {name: (qm.block("data").count * qm.block("model").count,
                   sm.block("data").count)
            for name, (qm, sm) in meshes.items()}
    digests, rec = {}, {"query": {}, "steps": [], "step_ms": {}}
    pts = data.kitti_like_cloud(N_POINTS, seed=1)
    q = torch.from_numpy(pts).cuda()
    for mode in ("knn", "range"):
        params = (api.SearchParams(radius=RADIUS, k=K) if mode == "knn" else
                  api.SearchParams(radius=RADIUS, k=K, mode="range"))
        first, row = None, {}
        for name in names:
            res, call_ms, syncs, nb, nk = counted(
                lambda: distributed_neighbor_search(
                    meshes[name][0], pts, pts, params, opts=opts),
                upd, knn_mod)
            check(len(syncs) == 1, f"sharded_ranks query {mode} {name}: "
                  f"{len(syncs)} blocking transfers, expected 1: {syncs}")
            check(nk == held[name][0] and nb == 0, f"sharded_ranks query "
                  f"{mode} {name}: {nk} knn_tile_anchored launches, "
                  f"expected {held[name][0]}")
            if first is None:
                first = res
                if keep:
                    digests[f"query/{mode}"] = digest(res)
            else:
                check(same_bits(res, first), f"sharded_ranks query {mode}: "
                      f"{name} not bitwise equal to {names[0]}")
            if want:
                check(digest(res) == want[f"query/{mode}"],
                      f"sharded_ranks query {mode} {name}: result differs "
                      "from the one-process path")
            row[name] = dict(call_ms=call_ms, blocking_transfers=syncs,
                             knn_tile_anchored_launches=nk)
        sparams = (dataclasses.replace(params, knn_window="exact")
                   if mode == "knn" else params)
        index = {name: core.shard_scene(pts, sparams, mesh=meshes[name][0],
                                        opts=opts,
                                        shopts=shards.STATIC_SCENE_OPTS,
                                        queries=pts, query_axis="model")
                 for name in names}
        order = names + names[::-1]
        for name in order:
            row[name].setdefault("query_ms", []).append(cuda_time_ms(
                lambda: index[name].query(q), SHARD_TIMED))
        lay = index[names[0]].layout
        row["gather_bytes"] = (lay.n_slabs * lay.n_qsplit * lay.query_cap
                               * (2 * params.k + 1) * 4)
        rec["query"][mode] = row
        del index, first, res
    del q
    torch.cuda.empty_cache()

    frames, vel = trajectory(DYN_N, DYN_STEPS, DYN_SEED,
                             0.03 * DYN_RADIUS / 4.0)
    escape = frames[-1].copy()
    escape[:DYN_ESCAPEES, 0] = np.float32(1.1)
    seq = frames + [escape, (escape + vel).astype(np.float32)]
    params = core.SearchParams(radius=DYN_RADIUS, k=DYN_K, mode="range")
    sess = {name: core.ShardedSession(frames[0], params, opts,
                                      mesh=meshes[name][1])
            for name in names}
    for i, frame in enumerate(seq):
        cur = torch.from_numpy(frame).cuda()
        row, first = {"step": i}, None
        for name in names:
            s = sess[name]
            r0 = s.stats()["reroutes"]
            res, wall_ms, syncs, nb, nk = step_counted(s, upd, knn_mod, cur)
            rerouted = s.stats()["reroutes"] - r0
            check(rerouted == int(i == DYN_STEPS), f"sharded_ranks step {i} "
                  f"{name}: {rerouted} re-routes")
            check(len(syncs) == 1 + rerouted, f"sharded_ranks step {i} "
                  f"{name}: {len(syncs)} blocking transfers: {syncs}")
            check(nb == held[name][1] and nk == held[name][1],
                  f"sharded_ranks step {i} {name}: launches bin_disp_tile="
                  f"{nb} knn_tile_anchored={nk}, expected {held[name][1]} "
                  "each (the slabs this process holds)")
            if first is None:
                first = res
                if keep:
                    digests[f"step/{i}"] = digest(res)
            else:
                check(same_bits(res, first) and s.last_flags
                      == sess[names[0]].last_flags,
                      f"sharded_ranks step {i}: {name} not bitwise equal "
                      f"to {names[0]}")
            if want:
                check(digest(res) == want[f"step/{i}"],
                      f"sharded_ranks step {i} {name}: result differs "
                      "from the one-process path")
            row[name] = dict(wall_ms=wall_ms, blocking_transfers=syncs,
                             launches=[nb, nk], flags=s.last_flags)
        rec["steps"].append(row)
    stats = {name: {k: v for k, v in s.stats().items() if k != "t_step"}
             for name, s in sess.items()}
    for name in names[1:]:
        check(stats[name] == stats[names[0]], f"sharded_ranks: {name}'s "
              f"stats() differ from {names[0]}'s")
    rec["stats"] = {k: v for k, v in stats[names[0]].items()
                    if not k.startswith("level_occ_")}

    # timed steps in turns: a point moved by a cell and back makes replan
    # steps, the steps between them replays
    a = cur
    b = a.clone()
    b[DYN_ESCAPEES, 0] += sess[names[0]].spec.cell_size
    times = {name: {"fast": [], "replan": []} for name in names}
    for j, target in enumerate([b, b, a, a] * ((N_TIMED_STEPS + 1) // 2)):
        for name in (names if j % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess[name].step(target)
            torch.cuda.synchronize()
            times[name]["replan" if sess[name].last_flags & 1 else
                        "fast"].append((time.perf_counter() - t0) * 1e3)
    rec["step_ms"] = {name: {kind: (sorted(v)[len(v) // 2] if v else None)
                             for kind, v in d.items()}
                      for name, d in times.items()}
    rec["steps_ms"] = times
    lay = sess[names[0]].layout
    rec["gather_bytes_per_step"] = (lay.n_slabs * lay.point_cap
                                    * (2 * params.k + 2) * 4)
    del sess, cur, a, b, first, res
    torch.cuda.empty_cache()
    return dict(record=rec, digests=digests)


def sharded_ranks_worker(rank: int, world: int, store: str,
                         out_dir: str) -> None:
    """One of ``world`` NCCL ranks, one a card (phase ``sharded_ranks``):
    :func:`ranked_paths` on the default rank layouts of the (4, 2) mesh
    and of 4 slabs, every result held to the one-process path's digests
    (``want.json``); writes ``rank<r>.json``. An error ends the rank, and
    the phase with it."""
    import os
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    import repro_torch.api as api
    import repro_torch.core as core
    import repro_torch.data as data
    from repro_torch.kernels import knn_tile as knn_mod
    from repro_torch.kernels import update_tile as upd
    from repro_torch.launch.mesh import make_mesh_compat, make_slab_mesh
    want = json.loads(Path(out_dir, "want.json").read_text())
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            device_id=torch.device("cuda", rank),
                            timeout=datetime.timedelta(
                                seconds=RANKS_TIMEOUT_S // 3))
    try:
        meshes = {"ranks": (make_mesh_compat(SHARD_MESH, ("data", "model")),
                            make_slab_mesh(SHARD_SLABS))}
        emit("sharded_ranks_worker", rank=rank, world=world, stage="meshes")
        out = ranked_paths(api, core, data, knn_mod, upd, meshes, want)
        emit("sharded_ranks_worker", rank=rank, world=world, stage="done")
        out["blocks"] = [[b.first, b.count, b.n_ranks] for b in (
            mesh.block("data") for mesh in meshes["ranks"])]
        out["device"] = str(meshes["ranks"][1].device)
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))


def phase_sharded_ranks(api, core, data, knn_mod, upd) -> None:
    """Phase ``sharded_ranks``: the sharded paths on rank layouts. Under a
    one-rank NCCL group over a ``HashStore`` (no network), a ranked (4, 2)
    mesh and a ranked 4-slab mesh, both on this card, against the
    one-process path in turns (:func:`ranked_paths`); the group is
    destroyed after. Where there are several cards, ``min(count, 4)``
    NCCL ranks (2 or 4, to divide the slabs), one a card, run the same,
    every result bitwise the one-process path's."""
    import os
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.mesh import make_mesh_compat, make_slab_mesh
    t0 = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        alone = (make_mesh_compat(SHARD_MESH, ("data", "model")),
                 make_slab_mesh(SHARD_SLABS))
        check(alone[0].ranks is None and alone[1].ranks is None,
              "sharded_ranks: a one-rank group gave a rank layout")
        one_q = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                           mesh_dim_names=("data", "model"))
        one_s = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
        ranked = (make_mesh_compat(SHARD_MESH, ("data", "model"),
                                   ranks=one_q),
                  make_slab_mesh(SHARD_SLABS, ranks=one_s))
        out = ranked_paths(api, core, data, knn_mod, upd,
                           {"one_process": alone, "one_rank": ranked},
                           keep=torch.cuda.device_count() >= 2)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "sharded_ranks: a process group is "
          "left behind")
    cards = torch.cuda.device_count()
    rank_runs = None
    if cards >= 2:
        world = 4 if cards >= 4 else 2
        tmp = ROOT / "build" / "sharded_ranks"
        tmp.mkdir(parents=True, exist_ok=True)
        for old in tmp.glob("*"):
            old.unlink()
        (tmp / "want.json").write_text(json.dumps(out["digests"]))
        ctx = mp.start_processes(sharded_ranks_worker,
                                 args=(world, str(tmp / "store"), str(tmp)),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        try:
            while not ctx.join(timeout=1):
                check(time.monotonic() < deadline, f"sharded_ranks: {world} "
                      f"NCCL ranks did not finish in {RANKS_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
        rank_runs = [json.loads((tmp / f"rank{r}.json").read_text())
                     for r in range(world)]
    emit("sharded_ranks", ranks=len(rank_runs) if rank_runs else 1,
         cards=cards,
         nccl_exchange=("exercised between ranks, one a card" if rank_runs
                        else "not exercised: one card, so a one-rank group "
                        "(its gathers and reductions run, no neighbour to "
                        "send to)"),
         one_card=out["record"],
         rank_runs=[r["record"] | {"blocks": r["blocks"],
                                   "device": r["device"]}
                    for r in rank_runs or []],
         seconds=time.perf_counter() - t0)



def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module (not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sph_physics_vs_cpu(sph, pos, vel, res, tag: str) -> float:
    """The example's physics on the card against the same functions on
    the CPU, on the same lists: the largest error over the largest
    magnitude, checked within ``SPH_PHYS_RTOL``."""
    import torch
    got = sph.advance(pos, vel, res)
    want = sph.advance(pos.cpu(), vel.cpu(), type(res)(
        res.indices.cpu(), res.distances2.cpu(), res.counts.cpu()))
    worst = 0.0
    for name, g, w in zip(("pos", "vel", "density"), got, want):
        scale = max(1.0, float(w.abs().max()))
        err = float((g.cpu() - w).abs().max())
        check(err <= SPH_PHYS_RTOL * scale, f"{tag}: {name} on the card "
              f"differs from the CPU by {err} (scale {scale})")
        worst = max(worst, err / scale)
    return worst


def sph_cell(core, ref, knn_mod, upd, sph, n: int, smi: str) -> dict:
    """The SPH example's session at ``n`` particles: a warm-up step by the
    example's own ``step_session``, then ``SPH_TIMED`` steps timed by CUDA
    events (search, physics, integration; no density fetch), each counted
    (blocking transfers, launches); ``SPH_CHECKED`` of them against the
    oracle and the CPU physics; ``SPH_PROFILED`` under the profiler for
    the kernels' launches a step; then the ``--rebuild`` A/B."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    pos, vel = sph.initial_state(n, dev)
    t0 = time.perf_counter()
    sess = core.SimulationSession(pos, sph.params(), sph.OPTS, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pos, vel, rho, split, info = sph.step_session(sess, pos, vel)
    warm_s = time.perf_counter() - t0
    emit("sph_setup", n_particles=n, dims=list(sess.spec.dims),
         cell_size=sess.spec.cell_size, capacity=sess.spec.capacity,
         setup_s=setup_s, warmup_step_s=warm_s, warmup_split=split,
         warmup_info=info, mean_density=rho, nvidia_smi=smi)
    rng = np.random.default_rng(n)
    checked_at = set(np.linspace(0, SPH_TIMED - 1, SPH_CHECKED).astype(int))
    steps, phys_err, d2_err = [], 0.0, 0.0
    for i in range(SPH_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        cur = pos

        def one_step():
            ev[0].record()
            res = sess.step(cur)
            ev[1].record()
            out = sph.advance(cur, vel, res)
            ev[2].record()
            return res, out

        (res, out), wall_ms, syncs, nb, nk = counted(one_step, upd, knn_mod)
        rep = sess.report
        kind = ("respec" if rep.respecced else "fast" if rep.fast
                else "replan")
        want = 2 if rep.respecced else 1
        check(len(syncs) == want, f"sph n={n} step {i}: {len(syncs)} "
              f"blocking transfers, expected {want}: {syncs}")
        check(nb == 1 and nk == 1, f"sph n={n} step {i}: launches "
              f"bin_disp_tile={nb} knn_tile_anchored={nk}, expected 1 each")
        rec = dict(step=i, kind=kind, step_ms=ev[0].elapsed_time(ev[2]),
                   search_ms=ev[0].elapsed_time(ev[1]),
                   physics_ms=ev[1].elapsed_time(ev[2]), wall_ms=wall_ms,
                   t_update_ms=rep.t_update * 1e3,
                   t_plan_ms=rep.t_plan * 1e3,
                   t_search_ms=rep.t_search * 1e3, max_disp=rep.max_disp,
                   blocking_transfers=len(syncs))
        if i in checked_at:
            tag = f"sph n={n} step {i}"
            d2_err = max(d2_err, check_step_exact(
                ref, res, cur, rng, SPH_SAMPLE, tag, radius=sph.H,
                k=sph.K_MAX))
            phys_err = max(phys_err, sph_physics_vs_cpu(sph, cur, vel, res,
                                                        tag))
            rec["checked"] = True
            rec["mean_count"] = float(res.counts.float().mean())
        pos, vel, _density = out
        check(bool(torch.isfinite(pos).all()), f"sph n={n} step {i}: "
              "positions not finite")
        steps.append(rec)
    kinds = [r["kind"] for r in steps]

    def med(key, kind):
        v = sorted(r[key] for r in steps if r["kind"] == kind)
        return v[len(v) // 2] if v else None

    # launches a step as the profiler records them (reported: in full runs
    # at n = 8,000 it has missed one bin_disp_tile of three), and as the
    # wrappers count them over the same steps (checked)
    torch.cuda.synchronize()
    upd.bin_disp_tile.launches = 0
    knn_mod.knn_tile_anchored.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SPH_PROFILED):
            res = sess.step(pos)
            pos, vel, _density = sph.advance(pos, vel, res)
        torch.cuda.synchronize()
    wrap_bin = upd.bin_disp_tile.launches
    wrap_knn = knn_mod.knn_tile_anchored.launches
    check(wrap_knn == SPH_PROFILED and wrap_bin == SPH_PROFILED,
          f"sph n={n}: knn_tile_anchored {wrap_knn} and bin_disp_tile "
          f"{wrap_bin} launches in {SPH_PROFILED} profiled steps")
    _, prof_knn = device_us(prof, "knn_tile_anchored")
    _, prof_bin = device_us(prof, "bin_disp_tile")
    del prof

    # the --rebuild A/B: a fresh NeighborSearch per frame; on one frame
    # its counts equal the session's
    frame = pos.clone()
    res_s = sess.step(frame)
    ns = core.NeighborSearch(frame, sph.params(), sph.OPTS, device=dev)
    res_r = ns.query(frame)
    check(torch.equal(res_s.counts, res_r.counts),
          f"sph n={n}: --rebuild counts differ from the session's")
    rebuild = []
    for _ in range(SPH_REBUILD):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pos, vel, _rho, split, info = sph.step_rebuild(pos, vel)
        torch.cuda.synchronize()
        rebuild.append(dict(step_ms=(time.perf_counter() - t0) * 1e3,
                            t_opt_ms=split["plan"] * 1e3,
                            search_ms=split["search"] * 1e3,
                            physics_ms=split["physics"] * 1e3, info=info))
    check(bool(torch.isfinite(pos).all()), f"sph n={n}: rebuild positions")
    rb = sorted(r["step_ms"] for r in rebuild)[len(rebuild) // 2]
    st = sess.stats()
    out = dict(n_particles=n, steps=len(steps), kinds=kinds,
               respecs=kinds.count("respec"),
               fast_step_ms=med("step_ms", "fast"),
               replan_step_ms=med("step_ms", "replan"),
               fast_search_ms=med("search_ms", "fast"),
               replan_search_ms=med("search_ms", "replan"),
               physics_ms=sorted(r["physics_ms"]
                                 for r in steps)[len(steps) // 2],
               t_update_ms=sorted(r["t_update_ms"]
                                  for r in steps)[len(steps) // 2],
               t_plan_replan_ms=med("t_plan_ms", "replan"),
               blocking_transfers=[r["blocking_transfers"] for r in steps],
               profiled_launches_per_step=dict(
                   knn_tile_anchored=prof_knn / SPH_PROFILED,
                   bin_disp_tile=prof_bin / SPH_PROFILED),
               d2_recompute_err=d2_err, physics_rel_err=phys_err,
               rebuild_step_ms=rb, rebuild=rebuild,
               rebuild_launches=ns.report.launches,
               counters={k: v for k, v in st.items() if k != "last"},
               nvidia_smi=smi)
    emit("sph", **out, per_step=steps)
    return out


def phase_sph(core, ref, knn_mod, upd) -> dict:
    """The three examples on the card: the SPH fluid at the example's
    8,000 particles and at 1,000,000 (:func:`sph_cell`), the point-cloud
    normals at the example's 60,000 points, and the quickstart once, each
    imported from ``examples/`` and driven through its own functions."""
    import torch
    t0 = time.perf_counter()
    smi = smi_line()
    sph = load_example("sph_fluid_torch")
    cells = [sph_cell(core, ref, knn_mod, upd, sph, n, smi)
             for n in SPH_SIZES]

    pc = load_example("pointcloud_pipeline_torch")
    out = pc.main(["--device", "cuda"])
    idx = out["result"].indices
    pts = torch.from_numpy(pc.kitti_like_cloud(60_000, seed=3)).cuda()
    normals_ms = cuda_time_ms(lambda: pc.estimate_normals(pts, idx), 5)
    emit("sph_normals", n_points=int(pts.shape[0]),
         search_s=out["t_search"], normals_ms=normals_ms,
         sample_oracle_match=True, vertical_share=out["vertical"],
         nvidia_smi=smi)

    qs = load_example("quickstart_torch")
    t1 = time.perf_counter()
    qs.main(["--device", "cuda"])
    emit("sph_quickstart", seconds=time.perf_counter() - t1, asserts=True)
    emit("sph_done", seconds=time.perf_counter() - t0, nvidia_smi=smi)
    return {c["n_particles"]: c for c in cells}

def rwkv_vs_plain(scan, ins, tag: str) -> dict:
    """``rwkv_scan`` kernel vs its plain version on the same inputs: out and
    state_T finite and within RWKV_RTOL * max(1, max|plain|). Returns the
    gaps."""
    import torch
    got = scan.rwkv_scan(*ins)
    want = scan.rwkv_scan_plain(*ins)
    torch.cuda.synchronize()
    row = {"case": tag, "shape": list(ins[0].shape)}
    for name, g, w in zip(("out", "state"), got, want):
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        row[f"{name}_max_abs_err"], row[f"{name}_scale"] = err, scale
        check(bool(torch.isfinite(g).all()), f"rwkv_scan ({tag}): {name} "
              "is not finite")
        check(err <= RWKV_RTOL * scale, f"rwkv_scan differs from its plain "
              f"version ({tag}, {name}): {err} > {RWKV_RTOL} * {scale}")
    emit("rwkv_vs_plain", **row)
    return row


def device_breakdown(prof, kernel: str = "rwkv_scan") -> dict:
    """Device time of a finished ``torch.profiler`` run by kind of kernel
    (``kernel``, matmuls, everything else), the busy time, the span from
    the first kernel's start to the last one's end, the idle share of that
    span, and the five kernels that took the most time. The device-side
    ranges of ``record_function`` annotations are not kernels and are left
    out."""
    import torch
    evts = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if not evts:
        return {"recorded": False}
    kinds, by_name = {kernel: 0.0, "matmul": 0.0, "other": 0.0}, {}
    for e in evts:
        us = e.time_range.elapsed_us()
        low = e.name.lower()
        kind = (kernel if kernel in low else "matmul" if any(
            m in low for m in ("gemm", "gemv", "cutlass", "xmma")) else
            "other")
        kinds[kind] += us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    busy = sum(kinds.values())
    span = (max(e.time_range.end for e in evts)
            - min(e.time_range.start for e in evts)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"recorded": True, "kernels": len(evts), "busy_ms": busy,
            "span_ms": span, "idle_share": 1.0 - busy / span if span else 0.0,
            "ms_by_kind": kinds, "top_ms": [[n[:80], ms] for n, ms in top],
            f"{kernel}_launches": sum(kernel in e.name for e in evts)}


def profiled_device_ms(fn, reps: int = 3) -> dict:
    """``fn``'s device time a call (milliseconds of kernel time, the mean
    of ``reps`` calls in a ``torch.profiler`` run after one warm-up call;
    a run that recorded no kernel is repeated once) and kernels a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        if evts:
            break
    return {"device_ms": sum(e.time_range.elapsed_us()
                             for e in evts) / 1e3 / reps,
            "kernels": len(evts) / reps}


def allclose_gap(got, want, tol: float):
    """(max |got - want|, whether |got - want| <= tol + tol * |want| holds
    everywhere): numpy's assert_allclose rule with atol = rtol = tol."""
    diff = (got - want).abs()
    return float(diff.max()), bool((diff <= tol + tol * want.abs()).all())


def lm_small_vs_cpu(M, cfg) -> None:
    """The smoke-size model of ``cfg`` with one set of weights on the card
    (``rwkv_scan``'s kernel at hd 16) and on the CPU (its plain version,
    the path the CPU tests hold against the JAX reference): logits of
    ``forward_logits`` and of a cache-writing ``decode_step`` within
    LM_CPU_TOL, the decode's states too."""
    import torch
    from repro_torch.configs import smoke_config
    small = smoke_config(cfg)
    cpu_lm = M.init_params(small, LM_SEED, device="cpu")
    # the same seed on the CPU generator: the same weights, then moved
    card_lm = M.init_params(small, LM_SEED, device="cpu").to("cuda")
    toks = torch.randint(0, small.vocab, (2, 37), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(LM_SEED))
    want = M.forward_logits(cpu_lm, toks, small)
    got = M.forward_logits(card_lm, toks.cuda(), small).cpu()
    gaps = {"forward_logits": allclose_gap(got, want, LM_CPU_TOL)}
    cache = M.init_decode_cache(small, 2, 38, torch.float32, device="cpu")
    want, want_c = M.decode_step(cpu_lm, cache, toks, small)
    cache = M.init_decode_cache(small, 2, 38, torch.float32)
    got, got_c = M.decode_step(card_lm, cache, toks.cuda(), small)
    gaps["decode_step"] = allclose_gap(got.cpu(), want, LM_CPU_TOL)
    per_layer = [allclose_gap(g["tm"]["state"].cpu(), w["tm"]["state"],
                              LM_CPU_TOL) for g, w in zip(got_c, want_c)]
    gaps["state"] = (max(g for g, _ in per_layer),
                     all(ok for _, ok in per_layer))
    for key, (gap, ok) in gaps.items():
        check(ok, f"lm: smoke {key} on the card off the CPU path by {gap} "
              f"(atol = rtol = {LM_CPU_TOL})")
    emit("lm_small_vs_cpu", arch=small.name, tokens=list(toks.shape),
         max_abs_err={k: g for k, (g, _) in gaps.items()}, tol=LM_CPU_TOL,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32)


def phase_lm_serve(rwkv_report: str) -> dict:
    """The LM serving path at full ``rwkv6-7b`` width and depth, float32
    weights from a seeded generator, after the smoke-size model on the
    card has been held against the CPU path. The first prefill captures
    layer 0's and the last layer's ``rwkv_scan`` inputs, on which (and on
    the decode shape, an odd S and hd 8 and 16, and on random inputs at
    head dims RWKV_HEAD_DIMS and lengths RWKV_SEQS) the kernel is held
    against its plain version; its prefill-shape and decode launches are
    timed and its registers read from ``rwkv_report``, nvcc's ptxas
    report; then the counted main path (one prefill of LM_PREFILL and one
    ``greedy_generate`` at ``serve_lm``'s defaults), the prefill's time and
    profile, a cache-writing prefill against token-by-token decode, the
    greedy runs' tokens and times, per-token decode latency and blocking
    transfers. Returns the kernel table's row."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.serve_step import (greedy_generate,
                                              make_decode_step,
                                              make_prefill_step)
    cfg = get_config(LM_ARCH)
    lm_small_vs_cpu(M, cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, LM_SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == M.count_params(cfg), "lm: parameter count")
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    b, s = LM_PREFILL
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device="cuda", dtype=torch.int32)
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT),
                            generator=gen, device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens}
    full = SHAPES["prefill_32k"]
    emit("lm_setup", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.d_model // cfg.rwkv_head_dim,
         head_dim=cfg.rwkv_head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab,
         params=n_params, weight_gb=sum(
             p.numel() * p.element_size() for p in params.parameters()) / 1e9,
         dtype="float32", init_s=init_s,
         prefill_cut={"batch": b, "seq": s, "of": full.name,
                      "full_batch": full.global_batch,
                      "full_seq": full.seq_len})
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    # the first prefill: capture layer 0's and the last layer's kernel
    # inputs and final states
    last, real, captured, calls = cfg.n_layers - 1, L.rwkv_scan, {}, [0]

    def capture(*ins):
        out = real(*ins)
        if calls[0] in (0, last):
            captured[calls[0]] = (list(ins), out[1])
        calls[0] += 1
        return out

    L.rwkv_scan = capture
    try:
        prefill(params, batch)
    finally:
        L.rwkv_scan = real
    torch.cuda.synchronize()
    check(calls[0] == cfg.n_layers, f"lm: {calls[0]} scans in a prefill")

    # the kernel against its plain version
    ins0, st0 = captured[0]
    ins_l, st_l = captured[last]
    # the model's init sets u = 0, so one full-width case also takes a
    # nonzero u drawn from the seed
    u_rand = 0.1 * torch.randn(ins_l[4].shape, generator=gen,
                               device="cuda")
    cases = [rwkv_vs_plain(scan, ins0, "layer 0, prefill"),
             rwkv_vs_plain(scan, ins_l, f"layer {last}, prefill"),
             rwkv_vs_plain(scan, ins_l[:4] + [u_rand, st_l],
                           f"layer {last}, prefill, u = 0.1 randn"),
             rwkv_vs_plain(scan, [t[:, :1] for t in ins_l[:4]]
                           + [ins_l[4], st_l], f"S=1 from layer {last}'s "
                           "prefill state"),
             rwkv_vs_plain(scan, [t[:, :17] for t in ins0[:4]]
                           + [ins0[4], st0], "S=17 from layer 0's prefill "
                           "state")]
    rng = np.random.default_rng(3)

    def random_inputs(shape):
        """tests/test_kernels.py's distributions, drawn with numpy."""
        h, hd = shape[2:]
        r, k, v, x = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(4))
        w = np.exp(-np.clip(np.exp(x), 0, 5)).astype(np.float32)
        u = (0.1 * rng.standard_normal((h, hd))).astype(np.float32)
        s0 = (0.3 * rng.standard_normal((shape[0], h, hd, hd))
              ).astype(np.float32)
        return [torch.from_numpy(a).cuda() for a in (r, k, v, w, u, s0)]

    for shape in ((2, 17, 3, 8), (1, 64, 2, 16)):  # tests/test_kernels.py's
        cases.append(rwkv_vs_plain(scan, random_inputs(shape),
                                   f"hd={shape[3]}, random"))
    for hd in RWKV_HEAD_DIMS:
        for s_len in RWKV_SEQS:
            cases.append(rwkv_vs_plain(scan, random_inputs((2, s_len, 4, hd)),
                                       f"hd={hd}, S={s_len}, random"))
    del captured, st0, st_l

    # the counted main path: one prefill and one greedy generation (after
    # a warmup generation, which builds nothing new but warms the GEMVs)
    cache_len = LM_PROMPT + LM_MAX_NEW + 1
    greedy_generate(params, cfg, prompts, LM_MAX_NEW, cache_len)
    torch.cuda.synchronize()
    scan.rwkv_scan.launches = 0
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_launches = scan.rwkv_scan.launches
    served = greedy_generate(params, cfg, prompts, LM_MAX_NEW, cache_len)
    torch.cuda.synchronize()
    launches = scan.rwkv_scan.launches
    n_steps = LM_PROMPT + LM_MAX_NEW
    check(prefill_launches == cfg.n_layers,
          f"lm: {prefill_launches} rwkv_scan launches in a prefill")
    check(launches == cfg.n_layers * (1 + n_steps),
          f"lm: {launches} rwkv_scan launches in a prefill and "
          f"{n_steps} decode steps")
    check(logits.shape == (b, cfg.vocab) and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          "lm: prefill logits not finite float32 [B, V]")
    check(served.shape == (LM_REQUESTS, LM_MAX_NEW)
          and served.dtype == torch.int32
          and bool(((served >= 0) & (served < cfg.vocab)).all()),
          "lm: greedy tokens out of range")

    # the prefill's time and where its device time goes
    prefill_ms = cuda_time_ms(lambda: prefill(params, batch),
                              LM_TIMED_PREFILLS, warmup=0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill(params, batch)
        torch.cuda.synchronize()
    prefill_prof = device_breakdown(prof)
    del prof, logits

    # cache-writing prefill (the kernel at S = 64) vs 64 single-token steps
    prompt = tokens[:, :LM_PARITY_PROMPT]
    whole, cache_w = decode(params, M.init_decode_cache(
        cfg, b, LM_PARITY_PROMPT + 1, torch.float32), prompt)
    cache_t = M.init_decode_cache(cfg, b, LM_PARITY_PROMPT + 1,
                                  torch.float32)
    for i in range(LM_PARITY_PROMPT):
        step_logits, cache_t = decode(params, cache_t, prompt[:, i:i + 1])
    torch.cuda.synchronize()
    gaps = {"logits": allclose_gap(whole[:, -1], step_logits[:, -1],
                                   LM_DECODE_TOL)}
    for key, get in (("state", lambda c: c["tm"]["state"]),
                     ("tm_x_prev", lambda c: c["tm"]["x_prev"]),
                     ("cm_x_prev", lambda c: c["cm"]["x_prev"])):
        per_layer = [allclose_gap(get(a), get(c), LM_DECODE_TOL)
                     for a, c in zip(cache_w, cache_t)]
        gaps[key] = (max(g for g, _ in per_layer),
                     all(ok for _, ok in per_layer))
    for key, (gap, ok) in gaps.items():
        check(ok, f"lm: cache-writing prefill vs token-by-token decode, "
              f"{key} off by {gap} (atol = rtol = {LM_DECODE_TOL})")
    del whole, cache_w, cache_t, step_logits

    # serve: greedy generations, identical tokens, their times
    gen_ms, outs = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(greedy_generate(params, cfg, prompts, LM_MAX_NEW,
                                    cache_len))
        end.record()
        end.synchronize()
        gen_ms.append(start.elapsed_time(end))
    check(all(torch.equal(o, served) for o in outs),
          "lm: greedy tokens differ between runs")
    gen_med = sorted(gen_ms)[1]

    # single decode steps on a live cache: latency, blocking transfers,
    # where the device time goes
    cache = M.init_decode_cache(cfg, LM_REQUESTS, cache_len, torch.float32)
    tok, lat = prompts[:, :1], []
    for _ in range(LM_TIMED_TOKENS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step_logits, cache = decode(params, cache, tok)
        end.record()
        end.synchronize()
        lat.append(start.elapsed_time(end))
        tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None].to(
            torch.int32)
    res = []
    syncs = sync_warnings(lambda: res.append(decode(params, cache, tok)))
    step_logits, cache = res.pop()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(params, cache, tok)
        torch.cuda.synchronize()
    decode_prof = device_breakdown(prof)
    rwkv_bytes = sharding_static("rwkv6-7b serve", cfg, params=params,
                                 cache=cache)
    del prof, cache, step_logits

    # the kernel row: rwkv_scan at the prefill shape (layer 0's inputs),
    # and its decode launch (S = 1, the same B, H and hd) by its device
    # time in torch.profiler: one launch is shorter than the wrapper's host
    # time, which CUDA events around it would measure
    kernel_ms = cuda_time_ms(lambda: scan.rwkv_scan(*ins0), 10)
    dec_ins = [t[:, :1] for t in ins0[:4]] + ins0[4:]
    decode_us = profiled_kernel_us(lambda: scan.rwkv_scan(*dec_ins),
                                   "rwkv_scan_kernel", RWKV_DECODE_LAUNCHES)
    layouts = rwkv_layouts(rwkv_report)
    plan = dict(zip(("groups", "rows", "cols_per_lane", "warps", "cols",
                     "panels"), scan.scan_plan(ins0[0].shape[3])))
    main_layout = layouts.get("G{}_R{}_panels0".format(
        plan["groups"], plan["rows"] // plan["groups"]), {})
    plain_ms = cuda_time_ms(lambda: scan.rwkv_scan_plain(*ins0), 1,
                            warmup=0)
    bb, ss, hh, hd = ins0[0].shape
    nbytes = (5 * bb * ss * hh * hd + 2 * bb * hh * hd * hd + hh * hd) * 4
    n_ops = RWKV_OPS_PER_CELL * hd * hd * bb * hh * ss
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = n_ops / PEAK_FP32 * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = LM_REQUESTS * LM_MAX_NEW
    err = max(max(c["out_max_abs_err"], c["state_max_abs_err"])
              for c in cases)
    emit("lm_serve", arch=cfg.name, prefill_shape=[b, s],
         prefill_ms=prefill_ms, prefill_tokens_per_s=b * s / prefill_ms * 1e3,
         prefill_device=prefill_prof, rwkv_scan_launches=launches,
         rwkv_scan_launches_per_prefill=prefill_launches,
         rwkv_scan_launches_per_decode_step=cfg.n_layers,
         parity_prompt=LM_PARITY_PROMPT,
         decode_vs_prefill_max_abs_err={k: g for k, (g, _) in gaps.items()},
         requests=LM_REQUESTS, prompt_len=LM_PROMPT, max_new=LM_MAX_NEW,
         cache_len=cache_len, generate_ms=gen_ms, tokens_identical=True,
         tokens_per_s=n_tok / gen_med * 1e3,
         decode_step_ms=lat, decode_step_median_ms=sorted(lat)[len(lat) // 2],
         decode_blocking_transfers=syncs, decode_device=decode_prof,
         first_tokens=served[:, :8].tolist(), peak_memory_gb=peak_gb,
         rwkv_scan_ms=kernel_ms, rwkv_scan_plain_ms=plain_ms,
         rwkv_scan_device_ms=(prefill_prof["ms_by_kind"]["rwkv_scan"]
                              / prefill_prof["rwkv_scan_launches"]
                              if prefill_prof.get("rwkv_scan_launches")
                              else None),
         rwkv_scan_decode_us=decode_us,
         rwkv_scan_layout=plan,
         rwkv_scan_registers=main_layout.get("registers"),
         rwkv_scan_spill_bytes=(main_layout.get("spill_stores", 0)
                                + main_layout.get("spill_loads", 0)
                                if main_layout else None),
         rwkv_scan_ptxas=layouts,
         rwkv_scan_max_abs_err=err, bytes=nbytes, ops=n_ops,
         bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms)
    sharding_peak(rwkv_bytes, cfg, lambda: prefill(params, batch),
                  step_shape("lm_serve_prefill", s, b, "prefill"), {})
    del params, ins0, ins_l
    torch.cuda.empty_cache()
    return dict(launches=launches, err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None)


def sync_warnings(fn) -> list:
    """Run ``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``; the
    source lines of the blocking transfers it made."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [f"{Path(w.filename).name}:{w.lineno}" for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


def train_small_vs_cpu(small, prepare=None) -> dict:
    """One train step of the smoke model on the card and on the CPU (the
    path the CPU tests hold against the JAX reference) from the same
    weights (changed alike by ``prepare(params)`` if given) and batch (2
    microbatches): loss, gradient norm and every parameter."""
    import torch
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    opt_cfg = OptConfig(lr=1e-2, warmup_steps=1)
    gen = torch.Generator().manual_seed(LM_SEED)
    batch = make_batch(small, 4, 37, gen, device="cpu")
    batch = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in batch.items()}
    out = {}
    for dev in ("cpu", "cuda"):
        params = M.init_params(small, LM_SEED, device="cpu",
                               requires_grad=True)
        if prepare is not None:
            prepare(params)
        params = params.to(dev)
        params, _, m = make_train_step(small, opt_cfg)(
            params, init_opt_state(params, opt_cfg),
            {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    {k: v.detach().cpu() for k, v in
                     params.state_dict().items()})
    loss_err = abs(out["cuda"][0] - out["cpu"][0])
    param_err = max(float((v - out["cpu"][2][k]).abs().max())
                    for k, v in out["cuda"][2].items())
    check(loss_err <= LM_STEP_LOSS_RTOL * abs(out["cpu"][0]),
          f"lm_train: smoke loss on the card off the CPU's by {loss_err}")
    check(abs(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * out["cpu"][1],
          "lm_train: smoke gradient norm on the card off the CPU's")
    check(param_err <= LM_STEP_PARAM_ATOL, f"lm_train: smoke parameters "
          f"after a step on the card off the CPU's by {param_err}")
    row = {"arch": small.name, "loss": [out["cuda"][0], out["cpu"][0]],
           "loss_abs_err": loss_err, "param_max_abs_err": param_err,
           "loss_rtol": LM_STEP_LOSS_RTOL, "param_atol": LM_STEP_PARAM_ATOL}
    emit("lm_train_small_vs_cpu", **row)
    return row


def resumed_on_card(small) -> dict:
    """A smoke ``ResilientLoop`` on the card with a failure injected after
    its step-4 checkpoint against the same run without one: it reaches the
    last step, and its losses agree within LM_RESUME_RTOL."""
    import shutil
    from repro_torch.data.pipeline import synthetic_stream
    from repro_torch.models import model as M
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import ResilientLoop
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    opt_cfg = OptConfig(lr=1e-2, warmup_steps=1)
    root = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def stream_fn(start):
        it = synthetic_stream(small, 4, 64, start_step=start, seed=LM_SEED,
                              device="cuda")
        return ({k: v.reshape((2, 2) + v.shape[1:]) for k, v in b.items()}
                for b in it)

    runs = {}
    try:
        for tag, fail_at in (("straight", None),
                             ("failed", LM_RESUME_FAIL_AT)):
            params = M.init_params(small, LM_SEED, device="cuda",
                                   requires_grad=True)
            step, calls = make_train_step(small, opt_cfg), [0]

            def flaky(p, o, b, step=step, fail_at=fail_at, calls=calls):
                calls[0] += 1
                if calls[0] == fail_at:
                    raise RuntimeError("injected node failure")
                return step(p, o, b)

            loop = ResilientLoop(CheckpointManager(str(root / tag)),
                                 save_every=2)
            p, o, log = loop.run(flaky, params,
                                 init_opt_state(params, opt_cfg), stream_fn,
                                 LM_RESUME_STEPS)
            runs[tag] = (loop, int(o["step"]), [m["loss"] for m in log],
                         {k: v.detach() for k, v in p.state_dict().items()})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (loop_a, step_a, la, pa), (loop_b, step_b, lb, pb) = (
        runs["straight"], runs["failed"])
    check(loop_b.restarts == 1 and loop_a.restarts == 0,
          "lm_train: ResilientLoop restarts")
    check(step_a == step_b == LM_RESUME_STEPS,
          f"lm_train: resumed loop ended at step {step_b}, not "
          f"{LM_RESUME_STEPS}")
    # the failed run replays from its step-4 checkpoint: its log is steps
    # 0-3, then 4 and 5
    check(len(lb) == LM_RESUME_STEPS, f"lm_train: resumed log {len(lb)}")
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(lb, la))
    check(loss_err <= LM_RESUME_RTOL, f"lm_train: resumed losses off the "
          f"uninterrupted run's by {loss_err} (relative)")
    param_err = max(float((v - pa[k]).abs().max()) for k, v in pb.items())
    row = {"steps": LM_RESUME_STEPS, "failed_call": LM_RESUME_FAIL_AT,
           "restarts": loop_b.restarts, "losses": lb, "losses_straight": la,
           "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
           "rtol": LM_RESUME_RTOL}
    emit("lm_train_resume", **row)
    return row


def rwkv_core_flops(b: int, s: int, h: int, hd: int, chunk: int) -> int:
    """Forward FLOPs of the chunked core per layer: per (batch, head,
    chunk) the inter-chunk product [C, hd] x [hd, hd], the state increment
    [hd, C] x [C, hd], the scores [C, hd] x [hd, C] and their product with
    v [C, C] x [C, hd], 2 operations a multiply-add."""
    s_pad = -(-s // chunk) * chunk
    return b * h * s_pad * (2 * hd * hd * 2 + 2 * chunk * hd * 2)


def phase_lm_train() -> dict:
    """The LM training path: ``rwkv6-7b`` at full width (d_model 4096, 64
    heads of 64, d_ff 14336, vocab 65536, float32), its depth cut to
    LM_TRAIN_LAYERS, weights from a seeded generator, batches from
    ``synthetic_stream``; ``make_train_step`` with remat, 2 microbatches
    and ``OptConfig`` defaults. Checks: the smoke model's step on the card
    equals the CPU's; at full width the chunked core on layer 0's time-mix
    inputs agrees with the ``rwkv_scan`` kernel; every parameter has a
    finite, non-zero gradient; the loss is finite and falls over 6 steps
    on one batch; no blocking transfer inside a step and one a step in
    ``ResilientLoop``; a smoke ``ResilientLoop`` resumes from its
    checkpoint after an injected failure; one step with int8 moments.
    Measures the step (median of LM_TRAIN_TIMED by CUDA events), tokens/s,
    peak memory, a profiled step's device time, and the model FLOPs' share
    of the card's float32 rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import synthetic_stream
    from repro_torch.kernels import distance_tile as tdist
    from repro_torch.kernels import knn_tile as knn_mod
    from repro_torch.kernels import range_tile as trange
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.kernels import update_tile as upd
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import ResilientLoop
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    t_phase = time.perf_counter()
    full = get_config(LM_ARCH)
    small = smoke_config(full)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    check(not tf32 and precision == "highest",
          f"lm_train: float32 matmuls must run in float32 (allow_tf32 "
          f"{tf32}, precision {precision})")
    small_row = train_small_vs_cpu(small)
    resume_row = resumed_on_card(small)

    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, LM_SEED, device="cuda", requires_grad=True)
    opt_cfg = OptConfig()
    opt = init_opt_state(params, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == M.count_params(cfg), "lm_train: parameter count")
    b, s, n_micro = LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MICRO

    def stream_fn(start):
        it = synthetic_stream(cfg, b, s, start_step=start, seed=LM_SEED,
                              device="cuda")
        return ({k: v.reshape((n_micro, b // n_micro) + v.shape[1:])
                 for k, v in x.items()} for x in it)

    batch = next(stream_fn(0))
    step = make_train_step(cfg, opt_cfg)
    emit("lm_train_setup", arch=cfg.name, n_layers=cfg.n_layers,
         full_layers=full.n_layers, d_model=cfg.d_model,
         heads=cfg.d_model // cfg.rwkv_head_dim, head_dim=cfg.rwkv_head_dim,
         d_ff=cfg.d_ff, vocab=cfg.vocab, params=n_params,
         full_params=M.count_params(full), dtype="float32",
         tf32_matmul=tf32, float32_matmul_precision=precision,
         batch=b, seq=s, n_micro=n_micro, chunk=L.RWKV_CHUNK, remat=True,
         opt=dataclasses.asdict(opt_cfg), init_s=init_s,
         cut={"n_layers": [full.n_layers, cfg.n_layers], "why": (
             "weights, gradients and AdamW moments in float32 take 16 "
             "bytes a parameter: 32 layers (7.53e9) need 120.5 GB, 75 GB "
             "with int8 moments, before activations; 8 layers (2.29e9) "
             "take 36.6 GB of the card's 80 GB")})

    # the chunked core against the rwkv_scan kernel on layer 0's time-mix
    # inputs (captured from a forward with gradients)
    real, captured = L.rwkv_chunked_core, []

    def capture(*ins, **kw):
        out = real(*ins, **kw)
        if not captured:
            captured.append(([t.detach() for t in ins],
                             [t.detach() for t in out]))
        return out

    L.rwkv_chunked_core = capture
    try:
        M.train_forward(params, {k: v[0] for k, v in batch.items()}, cfg)
    finally:
        L.rwkv_chunked_core = real
    ins, (core_out, core_state) = captured.pop()
    with torch.no_grad():
        scan_out, scan_state = scan.rwkv_scan(*ins)
        core_ms = cuda_time_ms(lambda: real(*ins), 5)
        scan_ms = cuda_time_ms(lambda: scan.rwkv_scan(*ins), 5)
    core_gap = {}
    for name, got, want in (("out", core_out, scan_out),
                            ("state", core_state, scan_state)):
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        core_gap[name] = {"max_abs_err": err, "scale": scale}
        check(bool(torch.isfinite(got).all()) and err <= LM_CORE_TOL * scale,
              f"lm_train: chunked core off rwkv_scan ({name}) by {err} "
              f"(scale {scale})")
    emit("lm_train_core_vs_scan", shape=list(ins[0].shape), tol=LM_CORE_TOL,
         **core_gap, core_forward_ms=core_ms, rwkv_scan_ms=scan_ms)
    del ins, core_out, core_state, scan_out, scan_state

    # the warm-up step and LM_TRAIN_TIMED timed ones, on one batch
    counters = [scan.rwkv_scan, knn_mod.knn_tile_anchored, knn_mod.knn_tile,
                upd.bin_disp_tile, trange.range_count, tdist.distance_tile]
    for fn in counters:
        fn.launches = 0
    losses, times = [], []
    for i in range(1 + LM_TRAIN_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        losses.append(m["loss"])
        if i == 0:
            # every parameter: a finite, non-zero gradient
            names = [n for n, _ in params.named_parameters()]
            ok = torch.stack([torch.isfinite(p.grad).all()
                              & (p.grad.abs().max() > 0)
                              for p in params.parameters()]).cpu().tolist()
            bad = [n for n, good in zip(names, ok) if not good]
            check(not bad, f"lm_train: parameters without a finite, "
                  f"non-zero gradient: {bad[:8]}")
            grad_max = {n: float(p.grad.abs().max()) for n, p in
                        params.named_parameters() if n.startswith(
                            "blocks.0.mixer.")}
        end.synchronize()
        times.append(start.elapsed_time(end))
    losses = torch.stack(losses).cpu().tolist()
    launches = {fn.__name__: fn.launches for fn in counters}
    check(all(v == 0 for v in launches.values()),
          f"lm_train: a hand-written kernel ran in a train step: {launches}")
    check(all(math.isfinite(x) for x in losses),
          f"lm_train: loss not finite: {losses}")
    check(losses[-1] < losses[0], f"lm_train: loss did not fall over "
          f"{len(losses)} steps on one batch: {losses}")
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # blocking transfers: none inside a step, one a step in ResilientLoop
    # (its metrics fetch; no checkpoint is due in these steps)
    res = []
    in_step = sync_warnings(lambda: res.append(step(params, opt, batch)))
    params, opt, _ = res.pop()
    loop_dir = ROOT / "build" / "lm_train_loop"
    loop = ResilientLoop(CheckpointManager(str(loop_dir)),
                         save_every=LM_TRAIN_LOOP_STEPS + 1)
    in_loop = sync_warnings(lambda: res.append(loop.run(
        step, params, opt, stream_fn, LM_TRAIN_LOOP_STEPS)))
    params, opt, _ = res.pop()
    loop_dir.rmdir()
    check(not in_step, f"lm_train: blocking transfers in train_step: "
          f"{in_step}")
    check(len(in_loop) == LM_TRAIN_LOOP_STEPS, f"lm_train: {len(in_loop)} "
          f"blocking transfers in {LM_TRAIN_LOOP_STEPS} ResilientLoop "
          f"steps: {in_loop}")

    # one profiled step: device busy and idle time, the top kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    device = device_breakdown(prof, kernel="rwkv_scan")
    del prof

    # one step with int8 moments, the float32 moments freed first
    del opt
    torch.cuda.empty_cache()
    q_cfg = OptConfig(quantize_moments=True)
    q_opt = init_opt_state(params, q_cfg)
    torch.cuda.reset_peak_memory_stats()
    params, q_opt, qm = make_train_step(cfg, q_cfg)(params, q_opt, batch)
    q_loss = float(qm["loss"])
    q_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(math.isfinite(q_loss), f"lm_train: int8-moment step loss {q_loss}")
    check(q_opt["m"]["embed"]["code"].dtype == torch.int8,
          "lm_train: int8 moments")

    tokens = b * s
    rec = rwkv_core_flops(b, s, cfg.d_model // cfg.rwkv_head_dim,
                          cfg.rwkv_head_dim, L.RWKV_CHUNK) * cfg.n_layers
    flops = 6 * n_params * tokens + 3 * rec
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "batch": b, "seq": s, "n_micro": n_micro, "tokens": tokens,
           "step_ms": step_ms, "step_ms_all": times,
           "tokens_per_s": tokens / step_ms * 1e3,
           "peak_memory_gb": peak_gb, "losses": losses,
           "grad_max_layer0_mixer": grad_max,
           "blocking_transfers_in_step": in_step,
           "blocking_transfers_in_loop": in_loop,
           "kernel_launches_in_steps": launches,
           "device": device, "model_flops": flops,
           "model_flops_formula": "6 x params x tokens + 3 x recurrence "
           "forward (chunked core)", "recurrence_forward_flops": rec,
           "flops_per_s": flops / step_ms * 1e3,
           "fp32_peak_share": flops / (step_ms / 1e3) / PEAK_FP32,
           "int8_moments": {"loss": q_loss, "peak_memory_gb": q_peak_gb},
           "small_vs_cpu": small_row, "resume": resume_row,
           "seconds": time.perf_counter() - t_phase}
    emit("lm_train", **row)
    del params, q_opt, batch
    torch.cuda.empty_cache()
    return row

def dense_small_vs_cpu(arch: str) -> dict:
    """The smoke-size ``arch`` with one set of weights on the card and on
    the CPU (the path the CPU tests hold against the JAX reference):
    ``forward_logits`` within LM_CPU_TOL, token-by-token decode on the
    card against the card's parallel forward within LM_DECODE_TOL, greedy
    tokens at ``serve_lm``'s defaults equal, and one train step within the
    CPU tests' tolerances (``train_small_vs_cpu``)."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.serve_step import greedy_generate
    small = smoke_config(get_config(arch))
    cpu_lm = M.init_params(small, LM_SEED, device="cpu")
    card_lm = M.init_params(small, LM_SEED, device="cpu").to("cuda")
    gen = torch.Generator().manual_seed(LM_SEED)
    toks = torch.randint(0, small.vocab, (2, 37), dtype=torch.int32,
                         generator=gen)
    want = M.forward_logits(cpu_lm, toks, small)
    got = M.forward_logits(card_lm, toks.cuda(), small)
    gaps = {"forward_logits": allclose_gap(got.cpu(), want, LM_CPU_TOL)}
    cache = M.init_decode_cache(small, 2, 38, torch.float32)
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = M.decode_step(card_lm, cache, toks[:, i:i + 1].cuda(),
                                      small)
        steps.append(logits)
    gaps["decode_vs_forward"] = allclose_gap(torch.cat(steps, 1), got,
                                             LM_DECODE_TOL)
    for key, (gap, ok) in gaps.items():
        check(ok, f"lm_dense: smoke {arch} {key} off by {gap}")
    prompts = torch.randint(0, small.vocab, (LM_REQUESTS, LM_PROMPT),
                            dtype=torch.int32, generator=gen)
    cache_len = LM_PROMPT + LM_MAX_NEW + 1
    cpu_toks = greedy_generate(cpu_lm, small, prompts, LM_MAX_NEW, cache_len)
    card_toks = greedy_generate(card_lm, small, prompts.cuda(), LM_MAX_NEW,
                                cache_len).cpu()
    check(torch.equal(cpu_toks, card_toks),
          f"lm_dense: smoke {arch} greedy tokens on the card differ from "
          "the CPU's")
    row = {"arch": small.name, "max_abs_err": {k: g for k, (g, _) in
                                               gaps.items()},
           "tol": {"forward_logits": LM_CPU_TOL,
                   "decode_vs_forward": LM_DECODE_TOL},
           "greedy_tokens_equal": True, "train_step": train_small_vs_cpu(
               small)}
    emit("lm_dense_small_vs_cpu", **row)
    return row


def sdpa_vs_plain(L, q, k, v) -> dict:
    """``F.scaled_dot_product_attention`` (causal, grouped kv heads: with
    ``enable_gqa``, and with the kv heads repeated) against the port's
    ``_sdpa`` on the same q/k/v [B, S, H, hd]: both within SDPA_RTOL of the
    plain version's scale, and the three timed. For the record: the port
    calls ``_sdpa``."""
    import torch
    import torch.nn.functional as F
    with torch.no_grad():
        plain = L._sdpa(q, k, v, causal=True, window=None)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        g = q.shape[2] // k.shape[2]
        rep_k, rep_v = (t.repeat_interleave(g, dim=1) for t in (kt, vt))
        calls = {"repeat_kv": lambda: F.scaled_dot_product_attention(
            qt, rep_k, rep_v, is_causal=True)}
        try:
            F.scaled_dot_product_attention(qt[:, :, :8], kt[:, :, :8],
                                           vt[:, :, :8], is_causal=True,
                                           enable_gqa=True)
            calls["enable_gqa"] = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        except TypeError:
            pass                      # this PyTorch has no enable_gqa
        scale = max(1.0, float(plain.abs().max()))
        row = {"shape_q": list(q.shape), "shape_kv": list(k.shape),
               "scale": scale, "rtol": SDPA_RTOL,
               "plain_ms": cuda_time_ms(lambda: L._sdpa(
                   q, k, v, causal=True, window=None), 5)}
        for name, call in calls.items():
            err = float((call().transpose(1, 2) - plain).abs().max())
            check(err <= SDPA_RTOL * scale, f"lm_dense: scaled_dot_product_"
                  f"attention ({name}) off _sdpa by {err} (scale {scale})")
            row[name] = {"max_abs_err": err,
                         "ms": cuda_time_ms(call, 5)}
    emit("lm_dense_sdpa", **row)
    return row


def phase_lm_dense() -> dict:
    """The dense attention LMs. The smoke ``lm-100m`` and ``qwen1.5-110b``
    on the card against the CPU (``dense_small_vs_cpu``). ``lm-100m`` at
    full size (12 layers, d_model 768, 12 heads of 64, 4 kv heads, d_ff
    2048, vocab 32000, untied; float32): ``make_train_step`` at
    examples/train_lm.py's shape (8 x 256 tokens in 2 microbatches, remat,
    ``OptConfig`` defaults), the loss falling over 6 steps on one batch,
    no blocking transfer in a step, the median step, tokens/s, peak
    memory, a profiled step and the FLOP share; ``launch/train.py`` with
    no ``--arch`` in a subprocess; serving: a 4 x 2048 prefill through
    ``make_prefill_step``, ``greedy_generate`` at ``serve_lm``'s defaults
    three times with identical tokens, single decode steps with no
    blocking transfer; layer 0's attention through
    ``scaled_dot_product_attention`` for the record. ``qwen1.5-110b`` at
    full width cut to QWEN_LAYERS layers: a 1 x QWEN_PREFILL prefill, a
    cache-writing prefill given its positions, QWEN_DECODE decode steps,
    their logits against the parallel forward at the same positions, peak
    memory. None of the hand-written kernels runs (attention is plain
    tensor operations, as the reference's is einsum math)."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES
    from repro_torch.data.pipeline import synthetic_stream
    from repro_torch.kernels import distance_tile as tdist
    from repro_torch.kernels import knn_tile as knn_mod
    from repro_torch.kernels import range_tile as trange
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.kernels import update_tile as upd
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.serve_step import (greedy_generate,
                                              make_decode_step,
                                              make_prefill_step)
    from repro_torch.train.train_step import make_train_step
    t_phase = time.perf_counter()
    full_prefill = SHAPES["prefill_32k"]
    prefill_cut = {"of": full_prefill.name,
                   "full_batch": full_prefill.global_batch,
                   "full_seq": full_prefill.seq_len}
    small = [dense_small_vs_cpu(arch) for arch in DENSE_SMOKE_ARCHS]
    counters = [scan.rwkv_scan, knn_mod.knn_tile_anchored, knn_mod.knn_tile,
                upd.bin_disp_tile, trange.range_count, tdist.distance_tile]

    # lm-100m training
    cfg = get_config(DENSE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, LM_SEED, device="cuda", requires_grad=True)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == M.count_params(cfg), "lm_dense: parameter count")
    opt_cfg = OptConfig()
    opt = init_opt_state(params, opt_cfg)
    b, s, n_micro = DENSE_TRAIN
    batch = {k: v.reshape((n_micro, b // n_micro) + v.shape[1:])
             for k, v in next(synthetic_stream(cfg, b, s, seed=LM_SEED,
                                               device="cuda")).items()}
    step = make_train_step(cfg, opt_cfg)
    for fn in counters:
        fn.launches = 0
    losses, times = [], []
    for _ in range(1 + DENSE_TRAIN_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, m = step(params, opt, batch)
        end.record()
        losses.append(m["loss"])
        end.synchronize()
        times.append(start.elapsed_time(end))
    losses = torch.stack(losses).cpu().tolist()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"lm_dense: loss not finite or not falling over {len(losses)} "
          f"steps on one batch: {losses}")
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = []
    in_step = sync_warnings(lambda: res.append(step(params, opt, batch)))
    params, opt, _ = res.pop()
    check(not in_step, f"lm_dense: blocking transfers in train_step: "
          f"{in_step}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    train_device = device_breakdown(prof, kernel="softmax")
    rec = sharding_static("lm-100m train", cfg, params=params, opt=opt)
    sharding_peak(rec, cfg, lambda: step(params, opt, batch),
                  step_shape("lm_dense_train", s, b, "train"),
                  {"b_micro": b // n_micro}, params=params)
    del prof, params, opt, batch
    tokens = b * s
    attn_flops = 12 * cfg.n_layers * b * s * s * cfg.n_heads * cfg.head_dim
    flops = 6 * n_params * tokens + attn_flops
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps",
         str(DENSE_CLI_STEPS)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0 and f"arch={DENSE_ARCH} " in proc.stdout
          and proc.stdout.strip().endswith("done"),
          f"lm_dense: launch/train with no --arch: {proc.returncode} "
          f"{proc.stdout[-800:]} {proc.stderr[-1500:]}")
    train_row = {
        "arch": cfg.name, "params": n_params, "batch": b, "seq": s,
        "n_micro": n_micro, "tokens": tokens, "remat": True,
        "opt": dataclasses.asdict(opt_cfg), "step_ms": step_ms,
        "step_ms_all": times, "tokens_per_s": tokens / step_ms * 1e3,
        "peak_memory_gb": train_peak_gb, "losses": losses,
        "blocking_transfers_in_step": in_step, "device": train_device,
        "model_flops": flops, "attention_flops": attn_flops,
        "model_flops_formula": "6 x params x tokens + 12 x L x B x S^2 x "
        "H x hd", "flops_per_s": flops / step_ms * 1e3,
        "fp32_peak_share": flops / (step_ms / 1e3) / PEAK_FP32,
        "cli": {"args": ["--steps", DENSE_CLI_STEPS], "seconds": cli_s,
                "last_lines": proc.stdout.strip().splitlines()[-2:]}}
    emit("lm_dense_train", **train_row)

    # lm-100m serving
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, LM_SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    pb, ps = LM_PREFILL
    pre_batch = {"tokens": torch.randint(0, cfg.vocab, (pb, ps),
                                         generator=gen, device="cuda",
                                         dtype=torch.int32)}
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT),
                            generator=gen, device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    real, captured = L._sdpa, []

    def capture(q, k, v, **kw):
        if not captured:
            captured.append((q, k, v))
        return real(q, k, v, **kw)

    L._sdpa = capture
    try:
        logits = prefill(params, pre_batch)
    finally:
        L._sdpa = real
    check(logits.shape == (pb, cfg.vocab) and bool(
        torch.isfinite(logits).all()), "lm_dense: prefill logits")
    prefill_ms = cuda_time_ms(lambda: prefill(params, pre_batch),
                              LM_TIMED_PREFILLS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill(params, pre_batch)
        torch.cuda.synchronize()
    prefill_device = device_breakdown(prof, kernel="softmax")
    del prof, logits
    sdpa = sdpa_vs_plain(L, *captured.pop())
    cache_len = LM_PROMPT + LM_MAX_NEW + 1
    served = greedy_generate(params, cfg, prompts, LM_MAX_NEW, cache_len)
    gen_ms = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = greedy_generate(params, cfg, prompts, LM_MAX_NEW, cache_len)
        end.record()
        end.synchronize()
        gen_ms.append(start.elapsed_time(end))
        check(torch.equal(out, served), "lm_dense: greedy tokens differ "
              "between runs")
    cache = M.init_decode_cache(cfg, LM_REQUESTS, cache_len, torch.float32)
    tok, lat = prompts[:, :1], []
    for _ in range(LM_TIMED_TOKENS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step_logits, cache = decode(params, cache, tok)
        end.record()
        end.synchronize()
        lat.append(start.elapsed_time(end))
        tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None].to(
            torch.int32)
    res = []
    syncs = sync_warnings(lambda: res.append(decode(params, cache, tok)))
    step_logits, cache = res.pop()
    check(not syncs, f"lm_dense: blocking transfers in a decode step: "
          f"{syncs}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(params, cache, tok)
        torch.cuda.synchronize()
    decode_device = device_breakdown(prof, kernel="softmax")
    del prof, cache, step_logits, params, pre_batch
    n_tok = LM_REQUESTS * LM_MAX_NEW
    serve_row = {
        "arch": cfg.name, "prefill_shape": [pb, ps],
        "prefill_cut": prefill_cut, "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": pb * ps / prefill_ms * 1e3,
        "prefill_device": prefill_device, "requests": LM_REQUESTS,
        "prompt_len": LM_PROMPT, "max_new": LM_MAX_NEW,
        "cache_len": cache_len, "generate_ms": gen_ms,
        "tokens_per_s": n_tok / sorted(gen_ms)[1] * 1e3,
        "decode_step_ms": lat,
        "decode_step_median_ms": sorted(lat)[len(lat) // 2],
        "decode_blocking_transfers": syncs, "decode_device": decode_device,
        "first_tokens": served[:, :8].tolist(),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("lm_dense_serve", **serve_row)

    # qwen1.5-110b at full width, its depth cut
    full = get_config(QWEN_ARCH)
    qcfg = dataclasses.replace(full, n_layers=QWEN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(qcfg, LM_SEED, device="cuda")
    q_params = sum(p.numel() for p in params.parameters())
    check(q_params == M.count_params(qcfg), "lm_dense: qwen parameter count")
    n = QWEN_PREFILL + QWEN_DECODE
    toks = torch.randint(0, qcfg.vocab, (1, n), generator=gen,
                         device="cuda", dtype=torch.int32)
    prefill, decode = make_prefill_step(qcfg), make_decode_step(qcfg)
    head = {"tokens": toks[:, :QWEN_PREFILL]}
    last = prefill(params, head)
    q_prefill_ms = cuda_time_ms(lambda: prefill(params, head), 1, warmup=0)
    with torch.no_grad():
        want = M.forward_logits(params, toks, qcfg)
    cache = M.init_decode_cache(qcfg, 1, n, torch.float32)
    pos = torch.arange(QWEN_PREFILL, device="cuda")[None]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    whole, cache = decode(params, cache, head["tokens"], pos)
    end.record()
    end.synchronize()
    cache_prefill_ms = start.elapsed_time(end)
    gaps = {"prefill_last": allclose_gap(last, want[:, QWEN_PREFILL - 1],
                                         LM_DECODE_TOL),
            "cache_prefill": allclose_gap(whole, want[:, :QWEN_PREFILL],
                                          LM_DECODE_TOL)}
    del whole
    steps, q_lat = [], []
    for i in range(QWEN_PREFILL, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step_logits, cache = decode(params, cache, toks[:, i:i + 1])
        end.record()
        end.synchronize()
        q_lat.append(start.elapsed_time(end))
        steps.append(step_logits)
    gaps["decode"] = allclose_gap(torch.cat(steps, 1),
                                  want[:, QWEN_PREFILL:], LM_DECODE_TOL)
    for key, (gap, ok) in gaps.items():
        check(ok, f"lm_dense: {QWEN_ARCH} {key} against the parallel "
              f"forward off by {gap} (atol = rtol = {LM_DECODE_TOL})")
    kv_replicated_vs_grouped(params, qcfg, head["tokens"])
    launches = {fn.__name__: fn.launches for fn in counters}
    check(all(v == 0 for v in launches.values()),
          f"lm_dense: a hand-written kernel ran: {launches}")
    qwen_row = {
        "arch": qcfg.name, "n_layers": QWEN_LAYERS,
        "full_layers": full.n_layers, "d_model": qcfg.d_model,
        "heads": qcfg.n_heads, "kv_heads": qcfg.n_kv_heads,
        "head_dim": qcfg.head_dim, "d_ff": qcfg.d_ff, "vocab": qcfg.vocab,
        "attn_bias": qcfg.attn_bias, "params": q_params,
        "full_params": M.count_params(full),
        "weight_gb": sum(p.numel() * p.element_size()
                         for p in params.parameters()) / 1e9,
        "cut": {"n_layers": [full.n_layers, QWEN_LAYERS], "why": (
            "80 layers of float32 weights (1.11e11 parameters) take 444 GB; "
            "2 layers with the embedding and unembedding take 20.8 GB of "
            "the card's 80 GB"), "prefill": prefill_cut},
        "prefill_shape": [1, QWEN_PREFILL], "prefill_ms": q_prefill_ms,
        "cache_prefill_ms": cache_prefill_ms, "decode_steps": QWEN_DECODE,
        "decode_step_ms": q_lat,
        "decode_step_median_ms": sorted(q_lat)[len(q_lat) // 2],
        "max_abs_err": {k: g for k, (g, _) in gaps.items()},
        "tol": LM_DECODE_TOL,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("lm_dense_qwen", **qwen_row)
    del params, cache, want, steps, last
    torch.cuda.empty_cache()
    row = {"small_vs_cpu": small, "train": train_row, "serve": serve_row,
           "sdpa": sdpa, "qwen": qwen_row,
           "kernel_launches": launches,
           "seconds": time.perf_counter() - t_phase}
    emit("lm_dense", **{k: row[k] for k in ("kernel_launches", "seconds")})
    return row


def mla_vlm_small_vs_cpu(arch: str, phase: str = "lm_mla_vlm") -> dict:
    """The smoke-size ``arch`` with one set of weights on the card and on
    the CPU (the path the CPU tests hold against the JAX reference): the
    prefill step (with ``pos3`` and ``vision_embeds`` for the VLM) within
    LM_CPU_TOL; token-by-token decode on the card against the card's
    parallel forward within LM_DECODE_TOL (MLA through the absorbed
    decode, the VLM with explicit ``pos3``); one train step within the CPU
    tests' tolerances (``train_small_vs_cpu``)."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.serve_step import make_prefill_step
    small = smoke_config(get_config(arch))
    cpu_lm = M.init_params(small, LM_SEED, device="cpu")
    card_lm = M.init_params(small, LM_SEED, device="cpu").to("cuda")
    batch = make_batch(small, 2, 37, torch.Generator().manual_seed(LM_SEED),
                       device="cpu")
    card_batch = {k: v.cuda() for k, v in batch.items()}
    prefill = make_prefill_step(small)
    gaps = {"prefill": allclose_gap(prefill(card_lm, card_batch).cpu(),
                                    prefill(cpu_lm, batch), LM_CPU_TOL)}
    toks, pos3 = card_batch["tokens"], card_batch.get("pos3")
    with torch.no_grad():
        x = M._run_layers(card_lm, card_lm.embed[toks], small, pos=(
            M.positions(small, *toks.shape, "cuda") if pos3 is None
            else pos3))
        want = M._logits(M._norm(x, card_lm.final_norm, small.norm_eps),
                         card_lm.unembedding())
    cache = M.init_decode_cache(small, 2, toks.shape[1] + 1, torch.float32)
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = M.decode_step(
            card_lm, cache, toks[:, i:i + 1], small,
            pos=None if pos3 is None else pos3[:, i:i + 1])
        steps.append(logits)
    gaps["decode_vs_forward"] = allclose_gap(torch.cat(steps, 1), want,
                                             LM_DECODE_TOL)
    for key, (gap, ok) in gaps.items():
        check(ok, f"{phase}: smoke {arch} {key} off by {gap}")
    row = {"arch": small.name, "max_abs_err": {k: g for k, (g, _) in
                                               gaps.items()},
           "tol": {"prefill": LM_CPU_TOL, "decode_vs_forward": LM_DECODE_TOL},
           "train_step": train_small_vs_cpu(small)}
    emit(f"{phase}_small_vs_cpu", **row)
    return row


def timed_ms(fn):
    """(``fn()``'s result, its milliseconds by CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def mla_serve() -> dict:
    """``minicpm3-4b`` at full width and depth (float32): a 1 x MLA_PREFILL
    prefill, timed; a cache-writing prefill of MLA_PREFILL - 1 tokens then
    one decode step (the absorbed decode) at cache length MLA_PREFILL - 1,
    its logits against the prefill's last position, no blocking transfer
    in it, and it timed; layer 0's absorbed decode against the expanded
    one on that cache, for the record; ``greedy_generate`` at
    ``serve_lm``'s defaults three times with identical tokens, and
    LM_TIMED_TOKENS single decode steps at B = LM_REQUESTS; peak memory;
    a profiled decode step at B = LM_REQUESTS; then ``launch/serve_lm.py
    --arch minicpm3-4b`` in a subprocess."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.serve_step import (greedy_generate,
                                              make_decode_step,
                                              make_prefill_step)
    cfg = get_config(MLA_ARCH)
    m = cfg.mla
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, LM_SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == M.count_params(cfg) == 4_261_902_848,
          f"lm_mla_vlm: {MLA_ARCH} parameter count {n_params}")
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    toks = torch.randint(0, cfg.vocab, (1, MLA_PREFILL), generator=gen,
                         device="cuda", dtype=torch.int32)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    head = {"tokens": toks}
    last = prefill(params, head)
    check(last.shape == (1, cfg.vocab) and bool(torch.isfinite(last).all()),
          "lm_mla_vlm: minicpm3 prefill logits")
    prefill_ms = cuda_time_ms(lambda: prefill(params, head),
                              LM_TIMED_PREFILLS)
    n = MLA_PREFILL - 1
    cache = M.init_decode_cache(cfg, 1, MLA_PREFILL, torch.float32)
    (_, cache), cache_prefill_ms = timed_ms(lambda: decode(
        params, cache, toks[:, :n], torch.arange(n, device="cuda")[None]))
    res = []
    syncs = sync_warnings(lambda: res.append(decode(params, cache,
                                                    toks[:, n:])))
    step_logits, _ = res.pop()
    gap, ok = allclose_gap(step_logits[:, 0], last, LM_DECODE_TOL)
    check(ok, f"lm_mla_vlm: {MLA_ARCH} decode at cache length {n} against "
          f"the prefill's last position off by {gap}")
    check(not syncs, f"lm_mla_vlm: blocking transfers in a decode step: "
          f"{syncs}")
    # the step writes new tensors, so the same cache is decoded again
    long_ms = cuda_time_ms(lambda: decode(params, cache, toks[:, n:]), 5)

    # for the record: layer 0's absorbed decode against the expanded one
    blk, c0 = params.blocks[0].mixer, cache[0]
    with torch.no_grad():
        h = torch.randn((1, 1, cfg.d_model), generator=gen, device="cuda")
        q_nope, q_rope, lat, k_rope = L.mla_project(
            blk, h, cfg, torch.full((1, 1), n, device="cuda"))
        lat_c = L._write(c0["latent"], lat, n)
        kr_c = L._write(c0["k_rope"], k_rope, n)
        args = (blk, q_nope, q_rope, lat_c, kr_c, n, m)
        absorbed = L._mla_absorbed_decode(*args)
        expanded = L.mla_expanded(*args)
        scale = max(1.0, float(expanded.abs().max()))
        diff = float((absorbed - expanded).abs().max())
        record = {"layer": 0, "cache_length": n, "max_abs_diff": diff,
                  "scale": scale, "rtol": ABSORBED_RTOL,
                  "absorbed_ms": cuda_time_ms(
                      lambda: L._mla_absorbed_decode(*args), 20),
                  "expanded_ms": cuda_time_ms(
                      lambda: L.mla_expanded(*args), 20)}
    check(diff <= ABSORBED_RTOL * scale, f"lm_mla_vlm: absorbed decode off "
          f"the expanded one by {diff} (scale {scale})")
    emit("lm_mla_vlm_absorbed", **record)
    del cache, res, step_logits, lat_c, kr_c, absorbed, expanded

    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT),
                            generator=gen, device="cuda", dtype=torch.int32)
    cache_len = LM_PROMPT + LM_MAX_NEW + 1
    served = greedy_generate(params, cfg, prompts, LM_MAX_NEW, cache_len)
    gen_ms = []
    for _ in range(2):
        out, ms = timed_ms(lambda: greedy_generate(
            params, cfg, prompts, LM_MAX_NEW, cache_len))
        gen_ms.append(ms)
        check(torch.equal(out, served), "lm_mla_vlm: greedy tokens differ "
              "between runs")
    cache = M.init_decode_cache(cfg, LM_REQUESTS, cache_len, torch.float32)
    tok, lat_ms = prompts[:, :1], []
    for _ in range(LM_TIMED_TOKENS):
        (step_logits, cache), ms = timed_ms(lambda: decode(params, cache,
                                                           tok))
        lat_ms.append(ms)
        tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None].to(
            torch.int32)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(params, cache, tok)
        torch.cuda.synchronize()
    decode_device = device_breakdown(prof, kernel="softmax")
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = sharding_static("minicpm3-4b serve", cfg, params=params,
                          cache=cache)
    sharding_peak(rec, cfg, lambda: prefill(params, head),
                  step_shape("mla_prefill", MLA_PREFILL, 1, "prefill"), {})
    del params, cache, step_logits, last, prof
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
         MLA_ARCH], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0 and f"arch={MLA_ARCH} on " in proc.stdout,
          f"lm_mla_vlm: launch/serve_lm --arch {MLA_ARCH}: "
          f"{proc.returncode} {proc.stdout[-800:]} {proc.stderr[-1500:]}")
    n_tok = LM_REQUESTS * LM_MAX_NEW
    row = {
        "arch": cfg.name, "params": n_params, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "heads": cfg.n_heads,
        "mla": dataclasses.asdict(m), "vocab": cfg.vocab,
        "weight_gb": n_params * 4 / 1e9, "prefill_shape": [1, MLA_PREFILL],
        "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": MLA_PREFILL / prefill_ms * 1e3,
        "cache_prefill_ms": cache_prefill_ms,
        "decode_at_length": n, "decode_at_length_ms": long_ms,
        "decode_at_length_max_abs_err": gap, "tol": LM_DECODE_TOL,
        "decode_blocking_transfers": syncs, "requests": LM_REQUESTS,
        "prompt_len": LM_PROMPT, "max_new": LM_MAX_NEW,
        "generate_ms": gen_ms, "tokens_per_s": n_tok / min(gen_ms) * 1e3,
        "decode_step_ms": lat_ms,
        "decode_step_median_ms": sorted(lat_ms)[len(lat_ms) // 2],
        "decode_device": decode_device,
        "first_tokens": served[:, :8].tolist(), "peak_memory_gb": peak,
        "cli": {"args": ["--arch", MLA_ARCH], "seconds": cli_s,
                "summary": [ln for ln in proc.stdout.splitlines()
                            if ln.startswith("arch=")]}}
    emit("lm_mla_vlm_minicpm3_serve", **row)
    return row


def cut_train(arch: str, n_layers: int, shape, *, cfg=None, opt_cfg=None,
              phase: str = "lm_mla_vlm", sharding_tag: str | None = None
              ) -> dict:
    """``arch`` at full width, its depth cut to ``n_layers`` (or the cut
    ``cfg`` given), float32: ``make_train_step`` with remat and
    ``opt_cfg`` (``OptConfig`` defaults) on one ``synthetic_stream`` batch
    of ``shape`` (batch, seq, microbatches; ``pos3`` and ``vision_embeds``
    for the VLM), 1 + MLA_VLM_TIMED steps (the loss must fall), their
    median after the first, tokens/s, peak memory, no blocking transfer in
    a step, and the model FLOPs' share of the float32 peak (active
    parameters: an MoE counts its top-k experts; with the expert GEMMs'
    capacity slots also counted as run). With ``sharding_tag``, phase
    ``lm_sharding``'s static bytes and step peak are taken on the trained
    model (``sharding_static``, ``sharding_peak``)."""
    import torch
    from repro_torch.data.pipeline import synthetic_stream
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    full = get_config(arch)
    if cfg is None:
        cfg = dataclasses.replace(full, n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, LM_SEED, device="cuda", requires_grad=True)
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == M.count_params(cfg), f"{phase}: {arch} cut "
          "parameter count")
    opt_cfg = opt_cfg or OptConfig()
    opt = init_opt_state(params, opt_cfg)
    b, s, n_micro = shape
    batch = {k: v.reshape((n_micro, b // n_micro) + v.shape[1:])
             for k, v in next(synthetic_stream(cfg, b, s, seed=LM_SEED,
                                               device="cuda")).items()}
    step = make_train_step(cfg, opt_cfg)
    losses, times = [], []
    for _ in range(1 + MLA_VLM_TIMED):
        (params, opt, metrics), ms = timed_ms(lambda: step(params, opt,
                                                           batch))
        losses.append(metrics["loss"])
        times.append(ms)
    losses = torch.stack(losses).cpu().tolist()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{phase}: {arch} loss not finite or not falling over "
          f"{len(losses)} steps on one batch: {losses}")
    step_ms = sorted(times[1:])[len(times[1:]) // 2]
    res = []
    in_step = sync_warnings(lambda: res.append(step(params, opt, batch)))
    check(not in_step, f"{phase}: blocking transfers in {arch}'s train "
          f"step: {in_step}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # 6 x (active matmul parameters: all but the embedding table and the
    # experts a token skips) x tokens, plus causal-free attention: q.k and
    # p.v, forward and backward, in every attention layer (not the rglru
    # ones; a local layer's window of 2048 covers these sequences) and the
    # multi-token head's. An encoder-decoder's encoder parameters and its
    # cross keys and values run on the encoder's frames, its position
    # tables on none; its attention adds the encoder's (frames^2) and the
    # cross-attention's (S x frames)
    tokens = b * s
    if cfg.mla is not None:
        d_qk, d_v = cfg.mla.d_nope + cfg.mla.d_rope, cfg.mla.d_v
    else:
        d_qk = d_v = cfg.head_dim
    matmul_params = (M.count_params(cfg, active_only=True)
                     - params.embed.numel())
    attn_layers = (sum(k in M.ATTN_KINDS for k in cfg.layer_kinds)
                   + int(cfg.mtp))
    per_pair = 6 * cfg.n_heads * (d_qk + d_v)
    attn_flops = per_pair * attn_layers * b * s * s
    flops = 6 * matmul_params * tokens + attn_flops
    if cfg.enc_dec:
        frames = b * cfg.enc_context
        enc = sum(p.numel() for n, p in params.enc.named_parameters()
                  if n != "pos")
        cross_kv = sum(c.attn.wk.numel() + c.attn.wv.numel()
                       for c in params.cross)
        tables = params.enc.pos.numel() + params.dec_pos.numel()
        enc_attn = (per_pair * cfg.n_enc_layers * b * cfg.enc_context ** 2
                    + per_pair * cfg.n_layers * b * s * cfg.enc_context)
        attn_flops += enc_attn
        flops = (6 * (matmul_params - enc - cross_kv - tables) * tokens
                 + 6 * (enc + cross_kv) * frames + attn_flops)
    moe = {}
    if cfg.moe is not None:
        # the expert GEMMs as run: E x cap rows a microbatch, every slot
        # computed whether filled or not, against the t x k routed rows
        mo = cfg.moe
        t_micro = b // n_micro * s
        cap = L.moe_capacity(t_micro, mo)
        per_row = 6 * 3 * cfg.d_model * (mo.d_expert or cfg.d_ff)
        n_moe = sum(M._layer_uses_moe(cfg, k) for k in cfg.layer_kinds)
        routed = n_moe * n_micro * per_row * t_micro * mo.top_k
        slots = n_moe * n_micro * per_row * mo.n_experts * cap
        moe = {"n_experts": mo.n_experts, "full_experts":
               full.moe.n_experts, "top_k": mo.top_k, "cap": cap,
               "expert_flops_routed": routed, "expert_flops_slots": slots,
               "model_flops_as_run": flops - routed + slots,
               "fp32_peak_share_as_run": (flops - routed + slots)
               / (step_ms / 1e3) / PEAK_FP32}
    if sharding_tag is not None:
        # the newest optimizer state (int8 moments are new tensors a step)
        opt = res.pop()[1]
        rec = sharding_static(sharding_tag, cfg, params=params, opt=opt)
        sharding_peak(rec, cfg, lambda: step(params, opt, batch),
                      step_shape(sharding_tag, s, b, "train"),
                      {"b_micro": b // n_micro}, params=params)
    del params, opt, batch, res
    torch.cuda.empty_cache()
    row = {
        "arch": cfg.name, "n_layers": cfg.n_layers,
        "full_layers": full.n_layers,
        "d_model": cfg.d_model, "params": n_params,
        "full_params": M.count_params(full), "batch": b, "seq": s,
        "n_micro": n_micro, "tokens": tokens, "remat": True,
        "opt": dataclasses.asdict(opt_cfg), "step_ms": step_ms,
        "step_ms_all": times, "tokens_per_s": tokens / step_ms * 1e3,
        "peak_memory_gb": peak, "losses": losses,
        "blocking_transfers_in_step": in_step, "model_flops": flops,
        "attention_flops": attn_flops,
        "model_flops_formula": "6 x (active params - embedding table) x "
        "tokens + 6 x L_attn x B x S^2 x H x (d_qk + d_v)" + (
            "; encoder and cross k/v params x frames, + encoder frames^2 "
            "and cross S x frames attention" if cfg.enc_dec else ""),
        "flops_per_s": flops / step_ms * 1e3,
        "fp32_peak_share": flops / (step_ms / 1e3) / PEAK_FP32, **moe}
    if cfg.frontend == "vision_stub":
        row["vision_tokens"] = min(cfg.n_vision_tokens, s)
    emit(f"{phase}_train_{arch}", **row)
    return row


def vlm_serve() -> dict:
    """``qwen2-vl-7b`` at full width and depth (float32): a 1 x VLM_PREFILL
    prefill through ``make_prefill_step`` with the first 1024 positions
    the vision stub's (``vision_embeds``, grid ``pos3``), timed; a
    cache-writing prefill of the same tokens at their ``pos3``, then
    VLM_DECODE decode steps with explicit text ``pos3``, timed, their
    logits (and the prefill's last) against the parallel forward at the
    same positions; no blocking transfer in a decode step; one more step
    profiled; peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)
    cfg = get_config(VLM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, LM_SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == M.count_params(cfg) == 7_615_616_512,
          f"lm_mla_vlm: {VLM_ARCH} parameter count {n_params}")
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    batch = make_batch(cfg, 1, VLM_PREFILL, gen, device="cuda")
    nv = batch["vision_embeds"].shape[1]
    check(nv == cfg.n_vision_tokens == 1024, "lm_mla_vlm: vision tokens")
    pre = {k: batch[k] for k in ("tokens", "pos3", "vision_embeds")}
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    last = prefill(params, pre)
    check(last.shape == (1, cfg.vocab) and bool(torch.isfinite(last).all()),
          "lm_mla_vlm: qwen2-vl prefill logits")
    prefill_ms = cuda_time_ms(lambda: prefill(params, pre),
                              LM_TIMED_PREFILLS)
    n = VLM_PREFILL + VLM_DECODE
    toks = torch.cat([batch["tokens"], torch.randint(
        0, cfg.vocab, (1, VLM_DECODE), generator=gen, device="cuda",
        dtype=torch.int32)], 1)
    text = torch.arange(VLM_PREFILL, n, dtype=torch.int32, device="cuda")
    pos3 = torch.cat([batch["pos3"], text[None, :, None].expand(
        1, VLM_DECODE, 3)], 1)
    cache = M.init_decode_cache(cfg, 1, n + 1, torch.float32)
    (whole, cache), cache_prefill_ms = timed_ms(lambda: decode(
        params, cache, toks[:, :VLM_PREFILL], pos3[:, :VLM_PREFILL]))
    steps, lat_ms = [whole[:, -1:]], []
    for i in range(VLM_PREFILL, n):
        (step_logits, cache), ms = timed_ms(lambda: decode(
            params, cache, toks[:, i:i + 1], pos3[:, i:i + 1]))
        steps.append(step_logits)
        lat_ms.append(ms)
    del whole
    res = []
    syncs = sync_warnings(lambda: res.append(decode(
        params, M.init_decode_cache(cfg, 1, 4, torch.float32),
        toks[:, :1], pos3[:, :1])))
    check(not syncs, f"lm_mla_vlm: blocking transfers in a qwen2-vl decode "
          f"step: {syncs}")
    with torch.no_grad():
        x = M._run_layers(params, params.embed[toks], cfg, pos=pos3)
        want = M._logits(M._norm(x[:, VLM_PREFILL - 1:], params.final_norm,
                                 cfg.norm_eps), params.unembedding())
    gap, ok = allclose_gap(torch.cat(steps, 1), want, LM_DECODE_TOL)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(params, cache, toks[:, -1:], torch.full(
            (1, 1, 3), n, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
    decode_device = device_breakdown(prof, kernel="softmax")
    del prof
    check(ok, f"lm_mla_vlm: {VLM_ARCH} decode with pos3 against the "
          f"parallel forward off by {gap} (atol = rtol = {LM_DECODE_TOL})")
    row = {
        "arch": cfg.name, "params": n_params, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "vocab": cfg.vocab, "weight_gb": n_params * 4 / 1e9,
        "prefill_shape": [1, VLM_PREFILL], "vision_tokens": nv,
        "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": VLM_PREFILL / prefill_ms * 1e3,
        "cache_prefill_ms": cache_prefill_ms, "decode_steps": VLM_DECODE,
        "decode_step_ms": lat_ms,
        "decode_step_median_ms": sorted(lat_ms)[len(lat_ms) // 2],
        "decode_vs_forward_max_abs_err": gap, "tol": LM_DECODE_TOL,
        "decode_blocking_transfers": syncs, "decode_device": decode_device,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("lm_mla_vlm_qwen2_vl_serve", **row)
    del params, cache, steps, want, x, res, last
    torch.cuda.empty_cache()
    return row


def phase_lm_mla_vlm() -> dict:
    """Multi-head Latent Attention and M-RoPE with the vision stub. The
    smoke ``minicpm3-4b`` and ``qwen2-vl-7b`` on the card against the CPU
    (``mla_vlm_small_vs_cpu``); ``minicpm3-4b`` at full width and depth
    served (``mla_serve``) and cut to MLA_TRAIN_LAYERS layers trained;
    ``qwen2-vl-7b`` at full width and depth served (``vlm_serve``) and cut
    to VLM_TRAIN_LAYERS layers trained (``cut_train``). Each model is
    freed before the next is built. None of the hand-written kernels runs
    (the reference's M-RoPE, MLA and absorbed decode are einsum math)."""
    from repro_torch.kernels import distance_tile as tdist
    from repro_torch.kernels import knn_tile as knn_mod
    from repro_torch.kernels import range_tile as trange
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.kernels import update_tile as upd
    t_phase = time.perf_counter()
    counters = [scan.rwkv_scan, knn_mod.knn_tile_anchored, knn_mod.knn_tile,
                upd.bin_disp_tile, trange.range_count, tdist.distance_tile]
    for fn in counters:
        fn.launches = 0
    row = {"small_vs_cpu": [mla_vlm_small_vs_cpu(a)
                            for a in (MLA_ARCH, VLM_ARCH)],
           "minicpm3_serve": mla_serve(),
           "minicpm3_train": cut_train(MLA_ARCH, MLA_TRAIN_LAYERS,
                                       MLA_TRAIN),
           "qwen2_vl_serve": vlm_serve(),
           "qwen2_vl_train": cut_train(VLM_ARCH, VLM_TRAIN_LAYERS,
                                       VLM_TRAIN)}
    launches = {fn.__name__: fn.launches for fn in counters}
    check(all(v == 0 for v in launches.values()),
          f"lm_mla_vlm: a hand-written kernel ran: {launches}")
    row["kernel_launches"] = launches
    row["seconds"] = time.perf_counter() - t_phase
    emit("lm_mla_vlm", **{k: row[k] for k in ("kernel_launches",
                                              "seconds")})
    return row


@contextlib.contextmanager
def moe_inputs():
    """Records what every MoE feed-forward of the model is called with,
    ``(parameters, x)``, into the list it yields: ``layers.moe_fwd`` (the
    name the model calls) is wrapped for the ``with`` block's length."""
    from repro_torch.models import layers as L
    orig, seen = L.moe_fwd, []

    def recorded(p, x, cfg, shard=L.NO_SHARD):
        seen.append((p, x))
        return orig(p, x, cfg, shard)

    L.moe_fwd = recorded
    try:
        yield seen
    finally:
        L.moe_fwd = orig


def drop_share(seen, cfg) -> dict:
    """The share of top-k assignments dropped by the capacity over the
    recorded MoE calls (``moe_inputs``), and the calls' caps."""
    import torch
    from repro_torch.models import layers as L
    dropped = total = 0
    caps = set()
    with torch.no_grad():
        for p, x in seen:
            route = L.moe_route(p, x.reshape(-1, x.shape[-1]), cfg)
            dropped += int((~route.keep).sum())
            total += route.keep.numel()
            caps.add(route.cap)
    return {"dropped": dropped, "assignments": total,
            "share": dropped / total, "caps": sorted(caps),
            "calls": len(seen)}


def moe_vs_plain(p, x, cfg, tag: str) -> dict:
    """One layer's ``moe_fwd`` against ``moe_fwd_plain`` (each expert's
    first ``cap`` assignments in flat order, no sort) on ``x``: max|diff|
    within MOE_PLAIN_RTOL x max(1, max|plain|)."""
    import torch
    from repro_torch.models import layers as L
    with torch.no_grad():
        got = L.moe_fwd(p, x, cfg)
        want = L.moe_fwd_plain(p, x, cfg)
        route = L.moe_route(p, x.reshape(-1, x.shape[-1]), cfg)
    scale = max(1.0, float(want.abs().max()))
    diff = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and diff <= MOE_PLAIN_RTOL * scale,
          f"lm_moe: moe_fwd off moe_fwd_plain ({tag}) by {diff} (scale "
          f"{scale})")
    return {"tokens": route.experts.shape[0], "cap": route.cap,
            "dropped": int((~route.keep).sum()), "max_abs_diff": diff,
            "scale": scale, "rtol": MOE_PLAIN_RTOL}


def moe_split(p, x, cfg, reps: int = 3) -> dict:
    """One MoE layer on ``x`` stage by stage, each stage's device time
    (milliseconds of kernel time a call, the mean of ``reps`` calls in a
    ``torch.profiler`` run after one warm-up call; a run that recorded no
    kernel is repeated once) and kernels a call: the router, top-k and
    sort (``moe_route``); the dispatch into [E, cap, d]; the three expert
    GEMMs; the combine; the shared experts where the layer has them."""
    import torch
    from repro_torch.models import layers as L
    mo = cfg.moe
    xf = x.reshape(-1, x.shape[-1])
    out = {}
    with torch.no_grad():
        route = L.moe_route(p, xf, cfg)
        buf = L.moe_dispatch(xf, route, mo.n_experts)
        eo = L.moe_experts(p, buf)
        stages = {"route": lambda: L.moe_route(p, xf, cfg),
                  "dispatch": lambda: L.moe_dispatch(xf, route,
                                                     mo.n_experts),
                  "experts": lambda: L.moe_experts(p, buf),
                  "combine": lambda: L.moe_combine(eo, route, x.dtype)}
        if "shared" in p:
            stages["shared"] = lambda: L.swiglu_fwd(p["shared"], xf)
        for name, fn in stages.items():
            out[name] = profiled_device_ms(fn, reps)
    total = sum(v["device_ms"] for v in out.values())
    for v in out.values():
        v["share"] = v["device_ms"] / total if total else 0.0
    return {"tokens": xf.shape[0], "cap": route.cap, "stages": out,
            "device_ms": total}


def moe_serve(arch: str) -> dict:
    """``arch`` at full width with every expert, its depth cut
    (MOE_SERVE), float32: a 1 x MOE_PREFILL prefill, timed, its MoE
    layers' drop share, the first MoE layer against ``moe_fwd_plain`` on
    the prefill's input and its stage split; a cache-writing prefill of
    LM_PROMPT tokens a row at B = MOE_DECODE_B, then MOE_DECODE_STEPS
    decode steps timed (their median against the bandwidth bound of the
    weights a step reads), run again recording their drop share, the last
    step's MoE input against the plain computation and split; no blocking
    transfer in a decode step; one step profiled; peak memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)
    full = get_config(arch)
    n_layers, want_params = MOE_SERVE[arch]
    cfg = dataclasses.replace(full, n_layers=n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, LM_SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == M.count_params(cfg) == want_params,
          f"lm_moe: {arch} cut to {n_layers} layers has {n_params} "
          "parameters")
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    toks = torch.randint(0, cfg.vocab, (1, MOE_PREFILL), generator=gen,
                         device="cuda", dtype=torch.int32)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    head = {"tokens": toks}
    with moe_inputs() as seen:
        last = prefill(params, head)
    check(last.shape == (1, cfg.vocab) and bool(torch.isfinite(last).all()),
          f"lm_moe: {arch} prefill logits")
    prefill_drops = drop_share(seen, cfg)
    prefill_plain = moe_vs_plain(*seen[0], cfg, f"{arch} prefill")
    prefill_split = moe_split(*seen[0], cfg)
    del seen
    prefill_ms = cuda_time_ms(lambda: prefill(params, head),
                              LM_TIMED_PREFILLS)

    b, p_len = MOE_DECODE_B, LM_PROMPT
    prompts = torch.randint(0, cfg.vocab, (b, p_len + MOE_DECODE_STEPS),
                            generator=gen, device="cuda", dtype=torch.int32)
    max_len = p_len + MOE_DECODE_STEPS + 1
    pos = torch.arange(p_len, device="cuda").expand(b, p_len)

    def start():
        cache = M.init_decode_cache(cfg, b, max_len, torch.float32)
        return decode(params, cache, prompts[:, :p_len], pos)

    (logits, cache), cache_prefill_ms = timed_ms(start)
    lat_ms = []
    for i in range(p_len, p_len + MOE_DECODE_STEPS):
        (logits, cache), ms = timed_ms(lambda: decode(
            params, cache, prompts[:, i:i + 1]))
        lat_ms.append(ms)
    check(logits.shape == (b, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"lm_moe: {arch} decode logits")
    _, cache = start()
    with moe_inputs() as seen:
        for i in range(p_len, p_len + MOE_DECODE_STEPS):
            _, cache = decode(params, cache, prompts[:, i:i + 1])
    n_moe = sum(M._layer_uses_moe(cfg, k) for k in cfg.layer_kinds)
    decode_drops = drop_share(seen, cfg)
    decode_plain = moe_vs_plain(*seen[-n_moe], cfg, f"{arch} decode")
    decode_split = moe_split(*seen[-n_moe], cfg)
    del seen
    _, cache = start()
    res = []
    syncs = sync_warnings(lambda: res.append(decode(
        params, cache, prompts[:, p_len:p_len + 1])))
    check(not syncs, f"lm_moe: blocking transfers in a {arch} decode step: "
          f"{syncs}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(params, cache, prompts[:, p_len:p_len + 1])
        torch.cuda.synchronize()
    decode_device = device_breakdown(prof, kernel="sort")
    del prof, res
    # a decode step reads every weight of the layers, the final norm and
    # the unembedding once, and b rows of the embedding (the multi-token
    # head is not used in serving): the capacity dispatch runs every expert
    # on its cap slots
    read = [*params.blocks.parameters(), *params.final_norm.values(),
            params.unembedding()]
    step_bytes = 4 * (sum(t.numel() for t in read) + b * cfg.d_model)
    bound_ms = step_bytes / PEAK_BYTES * 1e3
    med = sorted(lat_ms)[len(lat_ms) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    row = {
        "arch": cfg.name, "params": n_params,
        "full_params": M.count_params(full), "n_layers": n_layers,
        "full_layers": full.n_layers, "layer_kinds": list(cfg.layer_kinds),
        "n_experts": cfg.moe.n_experts, "full_experts": full.moe.n_experts,
        "top_k": cfg.moe.top_k, "capacity_factor": cfg.moe.capacity_factor,
        "mla": cfg.mla is not None, "mtp_held": cfg.mtp,
        "d_model": cfg.d_model, "weight_gb": n_params * 4 / 1e9,
        "cut": {"n_layers": [full.n_layers, n_layers], "why": (
            f"{M.count_params(full):.3e} float32 parameters take "
            f"{M.count_params(full) * 4 / 1e12:.2f} TB; {n_layers} layers "
            f"with the embedding and unembedding take "
            f"{n_params * 4 / 1e9:.1f} GB of the card's 80 GB")},
        "prefill_shape": [1, MOE_PREFILL], "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": MOE_PREFILL / prefill_ms * 1e3,
        "prefill_drops": prefill_drops, "prefill_vs_plain": prefill_plain,
        "prefill_moe_split": prefill_split,
        "decode_batch": b, "prompt_len": p_len,
        "cache_prefill_ms": cache_prefill_ms,
        "decode_steps": MOE_DECODE_STEPS, "decode_step_ms": lat_ms,
        "decode_step_median_ms": med, "decode_bytes": step_bytes,
        "decode_bound_ms": bound_ms, "decode_bound_share": bound_ms / med,
        "decode_drops": decode_drops, "decode_vs_plain": decode_plain,
        "decode_moe_split": decode_split,
        "decode_blocking_transfers": syncs, "decode_device": decode_device,
        "peak_memory_gb": peak}
    emit(f"lm_moe_serve_{arch}", **row)
    del params, cache, logits, last
    torch.cuda.empty_cache()
    return row


def moe_train(arch: str) -> dict:
    """``arch`` at full width cut by depth and then by expert count
    (MOE_TRAIN_CUT; top-k kept), trained with int8 moments on MOE_TRAIN
    (``cut_train``); if its peak passes MOE_PEAK_GB, again with half the
    experts, the halving recorded."""
    import torch
    from repro_torch.models.config import get_config
    from repro_torch.train.optimizer import OptConfig
    full = get_config(arch)
    cut = dict(MOE_TRAIN_CUT[arch])
    n_exp = cut.pop("n_experts")
    halved = []
    while True:
        cfg = dataclasses.replace(full, **cut, moe=dataclasses.replace(
            full.moe, n_experts=n_exp))
        why = None
        try:
            row = cut_train(arch, cfg.n_layers, MOE_TRAIN, cfg=cfg,
                            opt_cfg=OptConfig(quantize_moments=True),
                            phase="lm_moe")
            peak = row["peak_memory_gb"]
        except torch.cuda.OutOfMemoryError as exc:
            row, peak, why = None, float("inf"), str(exc).splitlines()[0]
        if peak <= MOE_PEAK_GB:
            break
        torch.cuda.empty_cache()
        halved.append({"n_experts": n_exp, "peak_memory_gb": peak,
                       "out_of_memory": why})
        check(n_exp // 2 >= full.moe.top_k, f"lm_moe: {arch} training does "
              f"not fit in {MOE_PEAK_GB} GB: {halved}")
        n_exp //= 2
    row["experts_halved"] = halved
    return row


def phase_lm_moe() -> dict:
    """Mixture of Experts and DeepSeek-V3's multi-token head. The smoke
    ``grok-1-314b`` and ``deepseek-v3-671b`` on the card against the CPU
    (``mla_vlm_small_vs_cpu``: dropless, so decode equals the parallel
    forward); both at full width with every expert served, depth cut
    (``moe_serve``); both trained cut by depth and expert count
    (``moe_train``). Each model is freed before the next is built. None of
    the hand-written kernels runs (the reference's router, dispatch and
    expert GEMMs are einsum math)."""
    from repro_torch.kernels import distance_tile as tdist
    from repro_torch.kernels import knn_tile as knn_mod
    from repro_torch.kernels import range_tile as trange
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.kernels import update_tile as upd
    t_phase = time.perf_counter()
    counters = [scan.rwkv_scan, knn_mod.knn_tile_anchored, knn_mod.knn_tile,
                upd.bin_disp_tile, trange.range_count, tdist.distance_tile]
    for fn in counters:
        fn.launches = 0
    row = {"small_vs_cpu": [mla_vlm_small_vs_cpu(a, phase="lm_moe")
                            for a in MOE_ARCHS]}
    for arch in MOE_ARCHS:
        row[f"{arch}_serve"] = moe_serve(arch)
    for arch in MOE_ARCHS:
        row[f"{arch}_train"] = moe_train(arch)
    launches = {fn.__name__: fn.launches for fn in counters}
    check(all(v == 0 for v in launches.values()),
          f"lm_moe: a hand-written kernel ran: {launches}")
    row["kernel_launches"] = launches
    row["seconds"] = time.perf_counter() - t_phase
    emit("lm_moe", **{k: row[k] for k in ("kernel_launches", "seconds")},
         nvidia_smi=smi_line())
    return row


def recurring(params):
    """``params`` with every RG-LRU ``lam`` negated, so that its layers
    recur (``a_t`` about 0.9-0.9995; the reference's initial ``lam``
    gives below 3e-8, where a wrong state carry would not show)."""
    import torch
    from repro_torch.models import layers as L
    with torch.no_grad():
        for blk in params.blocks:
            if isinstance(blk.mixer, L.RGLRU):
                blk.mixer.lam.neg_()
    return params


def hybrid_small_vs_cpu() -> list:
    """The smoke ``recurrentgemma-2b`` with one set of weights on the card
    and on the CPU, with its initial ``lam`` and with one that recurs:
    ``forward_logits`` within LM_CPU_TOL; token-by-token decode on the card
    against the card's parallel forward past the window of 8 (the ring
    buffers wrap) within LM_DECODE_TOL; one train step within the CPU
    tests' tolerances (``train_small_vs_cpu``)."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    small = smoke_config(get_config(HYBRID_ARCH))
    rows = []
    for lam in ("init", "recur"):
        prepare = recurring if lam == "recur" else (lambda p: p)
        cpu_lm = prepare(M.init_params(small, LM_SEED, device="cpu"))
        card_lm = prepare(M.init_params(small, LM_SEED,
                                        device="cpu")).to("cuda")
        toks = torch.randint(0, small.vocab, (2, 13), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(LM_SEED))
        got = M.forward_logits(card_lm, toks.cuda(), small)
        gaps = {"forward_logits": allclose_gap(
            got.cpu(), M.forward_logits(cpu_lm, toks, small), LM_CPU_TOL)}
        cache = M.init_decode_cache(small, 2, 14, torch.float32)
        steps = []
        for i in range(toks.shape[1]):
            logits, cache = M.decode_step(card_lm, cache,
                                          toks[:, i:i + 1].cuda(), small)
            steps.append(logits)
        gaps["decode_vs_forward"] = allclose_gap(torch.cat(steps, 1), got,
                                                 LM_DECODE_TOL)
        for key, (gap, ok) in gaps.items():
            check(ok, f"lm_hybrid_audio: smoke {HYBRID_ARCH} ({lam} lam) "
                  f"{key} off by {gap}")
        row = {"arch": small.name, "lam": lam,
               "max_abs_err": {k: g for k, (g, _) in gaps.items()},
               "tol": {"forward_logits": LM_CPU_TOL,
                       "decode_vs_forward": LM_DECODE_TOL},
               "train_step": train_small_vs_cpu(
                   small, prepare=recurring if lam == "recur" else None)}
        emit("lm_hybrid_audio_small_vs_cpu", **row)
        rows.append(row)
    return rows


def whisper_parallel(M, L, params, cfg, tokens, enc_in):
    """The parallel decoder: logits [B, S, V] of ``tokens`` [B, S] over
    ``encoder_fwd`` of ``enc_in``, with ``dec_pos[:S]`` added."""
    import torch
    with torch.no_grad():
        memory = M.encoder_fwd(params, enc_in, cfg)
        x = params.embed[tokens] + params.dec_pos[None, :tokens.shape[1]]
        x, _ = M._dec_layers_with_cross(params, x, memory, cfg, pos=None)
        return M._logits(L.layernorm(x, params.final_norm, cfg.norm_eps),
                         params.unembedding())


class WhisperDecode:
    """Whisper served through the reference's own decode pieces (the
    reference has no serving entry point for an encoder-decoder):
    ``encoder_fwd`` once and each layer's cross keys and values once
    (``start``), then per token the embedding plus ``dec_pos[length]``,
    ``_dec_layers_with_cross`` with the self-attention caches and
    ``cross_kv``, the final LayerNorm and the unembedding (``step``)."""

    def __init__(self, M, L, params, cfg):
        self.M, self.L, self.params, self.cfg = M, L, params, cfg

    def start(self, enc_in, max_len: int) -> None:
        import torch
        M, p = self.M, self.params
        with torch.no_grad():
            memory = M.encoder_fwd(p, enc_in, self.cfg)
            self.kv = [M._cross_kv(c.attn, memory, self.cfg)
                       for c in p.cross]
        self.caches = M.init_decode_cache(self.cfg, enc_in.shape[0], max_len,
                                          torch.float32)

    def step(self, tok):
        """Logits [B, 1, V] of ``tok`` [B, 1] at the caches' length."""
        import torch
        M, L, p, cfg = self.M, self.L, self.params, self.cfg
        n = self.caches[0]["length"]
        with torch.no_grad():
            x = p.embed[tok] + p.dec_pos[None, n:n + 1]
            x, self.caches = M._dec_layers_with_cross(
                p, x, None, cfg, pos=None, self_caches=self.caches,
                cross_kv=self.kv)
            return M._logits(L.layernorm(x, p.final_norm, cfg.norm_eps),
                             p.unembedding())


def audio_small_vs_cpu() -> dict:
    """The smoke ``whisper-tiny`` with one set of weights on the card and
    on the CPU: the ``train_forward`` loss within LM_CPU_TOL; the cached
    cross decode (``WhisperDecode``) on the card against the card's
    parallel decoder within LM_DECODE_TOL; one train step within the CPU
    tests' tolerances."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    small = smoke_config(get_config(AUDIO_ARCH))
    cpu_lm = M.init_params(small, LM_SEED, device="cpu")
    card_lm = M.init_params(small, LM_SEED, device="cpu").to("cuda")
    batch = make_batch(small, 2, 13, torch.Generator().manual_seed(LM_SEED),
                       device="cpu")
    card_batch = {k: v.cuda() for k, v in batch.items()}
    with torch.no_grad():
        gaps = {"loss": allclose_gap(
            M.train_forward(card_lm, card_batch, small).cpu(),
            M.train_forward(cpu_lm, batch, small), LM_CPU_TOL)}
    toks, enc = card_batch["tokens"], card_batch["enc_input"]
    want = whisper_parallel(M, L, card_lm, small, toks, enc)
    dec = WhisperDecode(M, L, card_lm, small)
    dec.start(enc, toks.shape[1] + 1)
    steps = [dec.step(toks[:, i:i + 1]) for i in range(toks.shape[1])]
    gaps["cached_vs_parallel"] = allclose_gap(torch.cat(steps, 1), want,
                                              LM_DECODE_TOL)
    for key, (gap, ok) in gaps.items():
        check(ok, f"lm_hybrid_audio: smoke {AUDIO_ARCH} {key} off by {gap}")
    row = {"arch": small.name,
           "max_abs_err": {k: g for k, (g, _) in gaps.items()},
           "tol": {"loss": LM_CPU_TOL, "cached_vs_parallel": LM_DECODE_TOL},
           "train_step": train_small_vs_cpu(small)}
    emit("lm_hybrid_audio_small_vs_cpu", **row)
    return row


def hybrid_serve() -> dict:
    """``recurrentgemma-2b`` at full width and depth (float32): a
    HYBRID_PREFILL prefill (``make_prefill_step``), timed and profiled;
    one layer's ``_rglru_scan`` at the prefill's shape and its share of
    the prefill; a cache-writing prefill of the same 2048 tokens a row
    with explicit positions, then HYBRID_DECODE decode steps at positions
    2048-2063 (every ring buffer wrapped), timed, their logits and the
    prefill's last against ``forward_logits``' layers over the same 2064
    tokens within LM_DECODE_TOL (phase ``lm_dense``'s tolerance for
    qwen1.5-110b); no blocking transfer in a decode step; one step
    profiled, against the bound of the bytes it reads; the decode cache's
    bytes at 2064 and HYBRID_LONG positions, which must be equal; peak
    memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)
    cfg = get_config(HYBRID_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, LM_SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == M.count_params(cfg) == 3_549_888_000,
          f"lm_hybrid_audio: {HYBRID_ARCH} parameter count {n_params}")
    b, s = HYBRID_PREFILL
    n = s + HYBRID_DECODE
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    toks = torch.randint(0, cfg.vocab, (b, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    head = {"tokens": toks[:, :s]}
    last = prefill(params, head)
    check(last.shape == (b, cfg.vocab) and bool(torch.isfinite(last).all()),
          f"lm_hybrid_audio: {HYBRID_ARCH} prefill logits")
    prefill_ms = cuda_time_ms(lambda: prefill(params, head),
                              LM_TIMED_PREFILLS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill(params, head)
        torch.cuda.synchronize()
    prefill_device = device_breakdown(prof, kernel="softmax")
    del prof

    # one layer's scan at the prefill's shape, on decays that recur
    d = cfg.d_model
    xt = torch.randn((b, s, d), generator=gen, device="cuda")
    a_t = torch.rand((b, s, d), generator=gen, device="cuda") * 0.0995 + 0.9
    h0 = torch.zeros((b, d), device="cuda")
    with torch.no_grad():
        scan = profiled_device_ms(lambda: L._rglru_scan(xt, a_t, h0))
        scan["ms"] = cuda_time_ms(lambda: L._rglru_scan(xt, a_t, h0), 5)
    n_rglru = cfg.layer_kinds.count("rglru")
    scan.update(shape=[b, s, d], rglru_layers=n_rglru,
                prefill_share=scan["device_ms"] * n_rglru / prefill_ms)
    del xt, a_t, h0

    pos = torch.arange(s, device="cuda").expand(b, s)
    cache = M.init_decode_cache(cfg, b, n, torch.float32)
    (whole, cache), cache_prefill_ms = timed_ms(lambda: decode(
        params, cache, toks[:, :s], pos))
    steps, lat_ms = [whole[:, -1:].clone()], []
    del whole
    start_cache = cache
    for i in range(s, n):
        (logits, cache), ms = timed_ms(lambda: decode(params, cache,
                                                      toks[:, i:i + 1]))
        steps.append(logits)
        lat_ms.append(ms)
    ring_pos = [int(c["pos"].min()) for kind, c in zip(cfg.layer_kinds,
                                                        cache)
                if kind == "local_attn"]
    check(all(p == n - cfg.local_window for p in ring_pos),
          f"lm_hybrid_audio: ring buffers not wrapped: {ring_pos}")
    with torch.no_grad():
        x = M._run_layers(params, params.embed[toks], cfg,
                          pos=M.positions(cfg, b, n, "cuda"))
        want = M._logits(M._norm(x[:, s - 1:], params.final_norm,
                                 cfg.norm_eps), params.unembedding())
    del x
    gap, ok = allclose_gap(torch.cat(steps, 1), want, LM_DECODE_TOL)
    check(ok, f"lm_hybrid_audio: {HYBRID_ARCH} decode past the window "
          f"against the parallel forward off by {gap} (atol = rtol = "
          f"{LM_DECODE_TOL})")
    prefill_gap, ok = allclose_gap(last, want[:, 0], LM_DECODE_TOL)
    check(ok, f"lm_hybrid_audio: {HYBRID_ARCH} prefill's last logits off "
          f"the parallel forward by {prefill_gap}")
    del steps, want
    res = []
    syncs = sync_warnings(lambda: res.append(decode(
        params, start_cache, toks[:, s:s + 1])))
    check(not syncs, f"lm_hybrid_audio: blocking transfers in a "
          f"{HYBRID_ARCH} decode step: {syncs}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(params, start_cache, toks[:, s:s + 1])
        torch.cuda.synchronize()
    decode_device = device_breakdown(prof, kernel="softmax")
    del prof, res
    # a decode step reads every weight of the layers, the final norm and
    # the unembedding once, and b rows of the embedding
    read = [*params.blocks.parameters(), *params.final_norm.values(),
            params.unembedding()]
    step_bytes = 4 * (sum(t.numel() for t in read) + b * d)
    bound_ms = step_bytes / PEAK_BYTES * 1e3
    med = sorted(lat_ms)[len(lat_ms) // 2]

    def cache_bytes(max_len):
        c = M.init_decode_cache(cfg, b, max_len, torch.float32,
                                device="meta")
        return sum(t.numel() * t.element_size() for entry in c
                   for t in entry.values() if isinstance(t, torch.Tensor))

    short, long = cache_bytes(n), cache_bytes(HYBRID_LONG)
    check(short == long, f"lm_hybrid_audio: decode cache {short} bytes at "
          f"{n} positions, {long} at {HYBRID_LONG}")
    row = {
        "arch": cfg.name, "params": n_params, "n_layers": cfg.n_layers,
        "full_layers": cfg.n_layers, "layer_kinds": list(cfg.layer_kinds),
        "d_model": d, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "local_window": cfg.local_window,
        "vocab": cfg.vocab, "weight_gb": n_params * 4 / 1e9,
        "prefill_shape": [b, s], "prefill_ms": prefill_ms,
        "prefill_tokens_per_s": b * s / prefill_ms * 1e3,
        "prefill_device": prefill_device, "rglru_scan": scan,
        "cache_prefill_ms": cache_prefill_ms, "decode_batch": b,
        "decode_positions": [s, n - 1], "ring_min_pos": ring_pos,
        "decode_step_ms": lat_ms, "decode_step_median_ms": med,
        "decode_vs_forward_max_abs_err": gap,
        "prefill_vs_forward_max_abs_err": prefill_gap, "tol": LM_DECODE_TOL,
        "decode_bytes": step_bytes, "decode_bound_ms": bound_ms,
        "decode_bound_share": bound_ms / med,
        "decode_blocking_transfers": syncs, "decode_device": decode_device,
        "cache_bytes": {str(n): short, str(HYBRID_LONG): long},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("lm_hybrid_audio_recurrentgemma_serve", **row)
    del params, cache, start_cache, last
    torch.cuda.empty_cache()
    return row


def hybrid_train() -> dict:
    """``recurrentgemma-2b`` at full depth trained with int8 moments on
    HYBRID_TRAIN (``cut_train``); if the step runs out of memory or its
    peak passes HYBRID_PEAK_GB, again cut to HYBRID_CUT_LAYERS layers (whole
    periods and the tail), the cut recorded."""
    import torch
    from repro_torch.models.config import get_config
    from repro_torch.train.optimizer import OptConfig
    full = get_config(HYBRID_ARCH)
    cuts = []
    for n_layers in (full.n_layers, HYBRID_CUT_LAYERS):
        why = None
        try:
            row = cut_train(HYBRID_ARCH, n_layers, HYBRID_TRAIN,
                            opt_cfg=OptConfig(quantize_moments=True),
                            phase="lm_hybrid_audio",
                            sharding_tag=f"{HYBRID_ARCH} train")
            peak = row["peak_memory_gb"]
        except torch.cuda.OutOfMemoryError as exc:
            row, peak, why = None, float("inf"), str(exc).splitlines()[0]
        if peak <= HYBRID_PEAK_GB:
            break
        torch.cuda.empty_cache()
        cuts.append({"n_layers": n_layers, "peak_memory_gb": peak,
                     "out_of_memory": why})
    check(row is not None and row["peak_memory_gb"] <= HYBRID_PEAK_GB,
          f"lm_hybrid_audio: {HYBRID_ARCH} training does not fit: {cuts}")
    row["cuts"] = cuts
    return row


def audio_serve() -> dict:
    """``whisper-tiny`` at full size (float32): ``encoder_fwd`` over
    AUDIO_FRAMES x 1500 frames, timed; a greedy decode of AUDIO_NEW tokens
    from an AUDIO_PROMPT-token prompt at B = AUDIO_FRAMES through
    ``WhisperDecode`` (the prompt fed one token a step), each step timed,
    every step's logits against the parallel decoder over the same tokens
    within LM_DECODE_TOL; no blocking transfer in a step; one step
    profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    cfg = get_config(AUDIO_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, LM_SEED, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == M.count_params(cfg) == 57_126_144,
          f"lm_hybrid_audio: {AUDIO_ARCH} parameter count {n_params}")
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    b = AUDIO_FRAMES
    enc = torch.randn((b, cfg.enc_context, cfg.d_model), generator=gen,
                      device="cuda") * 0.02
    with torch.no_grad():
        enc_ms = cuda_time_ms(lambda: M.encoder_fwd(params, enc, cfg), 3)
    prompt = torch.randint(0, cfg.vocab, (b, AUDIO_PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    n = AUDIO_PROMPT + AUDIO_NEW
    dec = WhisperDecode(M, L, params, cfg)
    (_, start_ms) = timed_ms(lambda: dec.start(enc, n))
    toks, steps, lat_ms = [prompt[:, i:i + 1] for i in range(AUDIO_PROMPT)], [], []
    for i in range(n - 1):
        logits, ms = timed_ms(lambda: dec.step(toks[i]))
        steps.append(logits)
        lat_ms.append(ms)
        if i + 1 >= AUDIO_PROMPT:
            toks.append(torch.argmax(logits[:, -1], dim=-1)[:, None].to(
                torch.int32))
    tokens = torch.cat(toks, 1)
    want = whisper_parallel(M, L, params, cfg, tokens[:, :-1], enc)
    gap, ok = allclose_gap(torch.cat(steps, 1), want, LM_DECODE_TOL)
    check(ok, f"lm_hybrid_audio: {AUDIO_ARCH} cached cross decode against "
          f"the parallel decoder off by {gap} (atol = rtol = "
          f"{LM_DECODE_TOL})")
    syncs = sync_warnings(lambda: dec.step(toks[-1]))
    check(not syncs, f"lm_hybrid_audio: blocking transfers in a "
          f"{AUDIO_ARCH} decode step: {syncs}")
    dec.start(enc, n)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dec.step(toks[0])
        torch.cuda.synchronize()
    step_device = device_breakdown(prof, kernel="softmax")
    del prof
    med = sorted(lat_ms)[len(lat_ms) // 2]
    row = {
        "arch": cfg.name, "params": n_params, "n_layers": cfg.n_layers,
        "enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "vocab": cfg.vocab,
        "encoder_shape": [b, cfg.enc_context, cfg.d_model],
        "encoder_ms": enc_ms, "start_ms": start_ms,
        "batch": b, "prompt_len": AUDIO_PROMPT, "max_new": AUDIO_NEW,
        "decode_step_ms": lat_ms, "decode_step_median_ms": med,
        "tokens_per_s": b / med * 1e3,
        "cached_vs_parallel_max_abs_err": gap, "tol": LM_DECODE_TOL,
        "decode_blocking_transfers": syncs, "decode_device": step_device,
        "first_tokens": tokens[:, AUDIO_PROMPT:AUDIO_PROMPT + 8].tolist(),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("lm_hybrid_audio_whisper_serve", **row)
    del params, dec, enc, steps, want
    torch.cuda.empty_cache()
    return row


def phase_lm_hybrid_audio() -> dict:
    """RG-LRU with local attention and the Whisper encoder-decoder. The
    smoke ``recurrentgemma-2b`` (with a ``lam`` that recurs as well as its
    initial one) and ``whisper-tiny`` on the card against the CPU
    (``hybrid_small_vs_cpu``, ``audio_small_vs_cpu``); ``recurrentgemma-2b``
    at full width and depth served (``hybrid_serve``) and trained
    (``hybrid_train``); ``whisper-tiny`` at full size served through its
    decode pieces (``audio_serve``) and trained (``cut_train``, float32
    moments). Each model is freed before the next is built. None of the
    hand-written kernels runs (the reference's RG-LRU is an associative
    scan and einsums, its encoder and cross-attention einsum math)."""
    from repro_torch.kernels import distance_tile as tdist
    from repro_torch.kernels import knn_tile as knn_mod
    from repro_torch.kernels import range_tile as trange
    from repro_torch.kernels import rwkv_scan as scan
    from repro_torch.kernels import update_tile as upd
    from repro_torch.models.config import get_config
    t_phase = time.perf_counter()
    counters = [scan.rwkv_scan, knn_mod.knn_tile_anchored, knn_mod.knn_tile,
                upd.bin_disp_tile, trange.range_count, tdist.distance_tile]
    for fn in counters:
        fn.launches = 0
    row = {"small_vs_cpu": hybrid_small_vs_cpu() + [audio_small_vs_cpu()],
           "recurrentgemma_serve": hybrid_serve(),
           "recurrentgemma_train": hybrid_train(),
           "whisper_serve": audio_serve(),
           "whisper_train": cut_train(
               AUDIO_ARCH, get_config(AUDIO_ARCH).n_layers, AUDIO_TRAIN,
               phase="lm_hybrid_audio",
               sharding_tag=f"{AUDIO_ARCH} train")}
    launches = {fn.__name__: fn.launches for fn in counters}
    check(all(v == 0 for v in launches.values()),
          f"lm_hybrid_audio: a hand-written kernel ran: {launches}")
    row["kernel_launches"] = launches
    row["seconds"] = time.perf_counter() - t_phase
    emit("lm_hybrid_audio", **{k: row[k] for k in ("kernel_launches",
                                                   "seconds")},
         nvidia_smi=smi_line())
    return row


def serve_trace(scenes: dict, signatures: list, rng):
    """The serve phase's request trace: (arrival gap, scene id, signature,
    rows) per request, the rows drawn from the scene's own points."""
    import numpy as np
    ids = list(scenes)
    weights = np.array([1.0 / (i + 1) for i in range(len(ids))])
    weights /= weights.sum()
    trace = []
    for _ in range(SERVE_REQUESTS):
        dt = float(rng.exponential(1.0 / SERVE_RATE))
        sid = ids[int(rng.choice(len(ids), p=weights))]
        params = signatures[int(rng.integers(len(signatures)))]
        nq = int(rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1))
        pts = scenes[sid]
        trace.append((dt, sid, params, pts[rng.integers(0, len(pts), nq)]))
    return trace


def drive_trace(svc, trace, opts):
    """Submit the trace on its simulated arrival clock, pumping after each
    arrival as ``launch/serve.py`` does, then drain; returns the futures
    and the batch reports."""
    futures, reports, now = [], [], 0.0
    for dt, sid, params, rows in trace:
        now += dt
        futures.append(svc.submit(sid, rows, params, opts, now=now))
        reports += svc.pump(now=now)
    reports += svc.drain(now=now)
    return futures, reports


def serve_vs_alone(res, alone, points, rows, params) -> dict:
    """A served request against ``api.query`` on its rows alone (on the
    card): counts equal; where both return the same index its d2 is
    bitwise equal. knn: d2 bitwise (inf masked) and indices equal except
    at tied distances, each such index reproducing its distance. Range mode
    returns a bounded in-radius subset that depends on the tile a row
    shares (a tile searches the largest window of its rows, and a batch
    groups rows into other tiles than the request alone), so there every
    returned index must lie within the radius and reproduce its
    distance. Returns the largest d2 gap on equal indices and the rows
    whose results differ."""
    import numpy as np
    import torch
    check(torch.equal(res.counts, alone.counts), "serve: counts differ "
          "from api.query on the request alone")
    same = (res.indices == alone.indices) & (res.indices >= 0)
    gap = (float((res.distances2[same] - alone.distances2[same]).abs().max())
           if same.any() else 0.0)
    check(gap == 0.0, f"serve: d2 of one (query, point) pair differs from "
          f"api.query alone by {gap}")
    valid = res.indices >= 0
    q = torch.as_tensor(rows, device=res.indices.device)
    pos = points[res.indices.clamp_min(0).long()]
    rec = ((q[:, None] - pos) ** 2).sum(-1)
    check(bool(((rec - res.distances2).abs() <= 1e-5)[valid].all()),
          "serve: an index does not reproduce its distance")
    d_res = torch.where(torch.isinf(res.distances2), -1.0, res.distances2)
    d_alone = torch.where(torch.isinf(alone.distances2), -1.0,
                          alone.distances2)
    if params.mode == "knn":
        check(torch.equal(d_res, d_alone), "serve: knn d2 not bitwise equal "
              "to api.query on the request alone")
        for r, c in torch.nonzero(res.indices != alone.indices).tolist():
            row = res.distances2[r]
            check(bool(((row - row[c]).abs() <= 1e-6).sum() >= 2),
                  f"serve: row {r} differs from api.query alone at an "
                  "untied distance")
    else:
        r2 = np.float32(params.radius) ** 2
        check(bool((res.distances2[valid] <= r2).all()),
              "serve: a range index lies outside the radius")
    return {"gap": gap, "rows_differ": int(
        (d_res != d_alone).any(-1).sum())}


def phase_serve(api, core, data, knn_mod, upd) -> dict:
    """The neighbor-query service on the card (``repro_torch.serve``): a
    256-request trace over three 1M-point scenes and two signatures on the
    fused path, checked per request against ``api.query`` alone, with one
    blocking sync and one ``knn_tile_anchored`` launch per drained batch;
    its first requests again under ``torch.profiler`` for the device's
    busy share; one request-size launch timed and split
    (``serve_launch_probe``); a session-backed scene stepped and drained in
    turn and then concurrently (donation on); the chaos gate
    (``launch/serve.py --trace short`` under a fault plan) in a subprocess.
    Returns the worst d2 gap on equal indices."""
    import dataclasses
    import os

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import NeighborService, ServeOpts

    opts = core.SearchOpts(use_pallas=True)
    signatures = [core.SearchParams(radius=RADIUS, k=K, knn_window="exact"),
                  core.SearchParams(radius=RADIUS, k=K, mode="range")]
    t0 = time.perf_counter()
    scenes = {f"scene{s}": data.kitti_like_cloud(N_POINTS, seed=s)
              for s in SERVE_SCENE_SEEDS}
    svc = NeighborService(ServeOpts(**SERVE_OPTS))
    buckets = []
    b = SERVE_BUCKETS[0]
    while b <= SERVE_BUCKETS[1]:
        buckets.append(b)
        b *= 2
    for sid, pts in scenes.items():
        svc.register_scene(sid, pts)
        for params in signatures:
            variant = svc.registry.get(sid).variant(params, opts)
            for b in buckets:
                variant.warm(b)
            variant.quality_counters()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    trace = serve_trace(scenes, signatures, np.random.default_rng(SERVE_SEED))

    # the checked, timed run: counts set to 0 just before, read just after
    torch.cuda.synchronize()
    knn_mod.knn_tile_anchored.launches = 0
    upd.bin_disp_tile.launches = 0
    torch.cuda.set_sync_debug_mode("warn")
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            futures, reports = drive_trace(svc, trace, opts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    wall_s = time.perf_counter() - t0
    launches = knn_mod.knn_tile_anchored.launches
    bin_launches = upd.bin_disp_tile.launches
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    st = svc.stats()
    lat = svc._metrics.snapshot()["request_s"]
    batch_s = svc._metrics.snapshot()["batch_s"]
    hung = 0
    for f in futures:
        try:
            f.result(timeout=SERVE_FUTURE_TIMEOUT_S)
        except TimeoutError:
            hung += 1
    check(hung == 0, f"serve: {hung} futures hung")
    check(st["resolved"] == len(futures) == len(trace) and
          all(f.exception() is None for f in futures),
          "serve: not every request resolved with a result")
    batches = len(reports)
    check(st["host_syncs"] == st["batches"] == batches,
          f"serve: {st['host_syncs']} host syncs for {batches} batches")
    check(len(syncs) == batches, f"serve: {len(syncs)} synchronising calls "
          f"for {batches} drained batches ({sorted(set(syncs))})")
    check(launches == batches and bin_launches == 0,
          f"serve: {launches} knn_tile_anchored launches for {batches} "
          "batches")
    check(batches < len(trace), "serve: no request was coalesced")

    # every request against api.query on its rows alone
    t0 = time.perf_counter()
    gap, rows_differ = 0.0, {"knn": 0, "range": 0}
    for (_dt, sid, params, rows), f in zip(trace, futures):
        index = svc.registry.resolve(sid, params, opts).index
        got = serve_vs_alone(f.result(), api.query(index, rows),
                             index.points, rows, params)
        gap = max(gap, got["gap"])
        rows_differ[params.mode] += got["rows_differ"]
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0

    # the trace's first requests again under the profiler (device activity
    # only): the device's busy share
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again, _ = drive_trace(svc, trace[:SERVE_PROFILED], opts)
        for f in again:
            f.result(timeout=SERVE_FUTURE_TIMEOUT_S)
        torch.cuda.synchronize()
    profiled_wall_s = time.perf_counter() - t0
    device = device_breakdown(prof, "knn_tile_anchored")
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = serve_launch_probe(api, core, knn_mod, scenes["scene1"],
                               signatures[0])
    probe_s = time.perf_counter() - t0
    rows_total = sum(len(t[3]) for t in trace)
    emit("serve", n_points=N_POINTS, scenes=len(scenes),
         signatures=[dataclasses.asdict(p) for p in signatures],
         serve_opts=SERVE_OPTS, requests=len(trace), rows=rows_total,
         setup_s=setup_s, warmed_buckets=buckets, wall_s=wall_s,
         requests_per_s=len(trace) / wall_s, rows_per_s=rows_total / wall_s,
         latency_ms={k: lat[k] * 1e3 for k in ("p50", "p95", "p99")},
         batches=batches, mean_batch_rows=rows_total / batches,
         occupancy=sum(r.nq for r in reports) / sum(r.pad_n
                                                    for r in reports),
         batch_ms={k: batch_s[k] * 1e3 for k in ("p50", "p95", "p99")},
         knn_tile_anchored_launches=launches, host_syncs=st["host_syncs"],
         synchronising_calls=len(syncs), hung=hung,
         d2_gap_on_equal_indices=gap, rows_differing_from_alone=rows_differ,
         profiled_requests=SERVE_PROFILED, profiled_wall_s=profiled_wall_s,
         device=device, launch_probe=probe,
         check_s=check_s, profile_s=profile_s, probe_s=probe_s)
    del svc, futures, again, prof
    torch.cuda.empty_cache()

    sess_row = phase_serve_session(api, core, knn_mod, upd)

    # the chaos gate on the card, in its own process
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_FAULTS=SERVE_CHAOS)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--trace",
         "short", "--device", "cuda"], env=env, capture_output=True,
        text=True, timeout=600)
    chaos_s = time.perf_counter() - t0
    out = [ln for ln in proc.stdout.splitlines() if ln.startswith("serve:")]
    check(proc.returncode == 0, f"serve: chaos gate exited "
          f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    check(any("(accounted 64/64)" in ln for ln in out) and
          "HUNG" not in proc.stdout, "serve: chaos gate lost a request")
    emit("serve_chaos", faults=SERVE_CHAOS, exit_code=proc.returncode,
         seconds=chaos_s, lines=out, **sess_row)
    return {"d2_gap": gap}


def serve_launch_probe(api, core, knn_mod, pts, params) -> dict:
    """One request-size ``knn_tile_anchored`` launch (``SERVE_ROWS[1]``
    rows of a static scene), timed by CUDA events (median of 5, kernel and
    whole ``api.query``), with its work and split: rows drawn at random
    from the scene, as a request holds them, and as many rows adjacent in
    x (a dense strip); the random rows again at query tile 64."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SERVE_SEED)
    n = SERVE_ROWS[1]
    cases = {"random": pts[rng.integers(0, len(pts), n)],
             "x_strip": pts[np.argsort(pts[:, 0], kind="stable")[:n]]}
    out = {}
    for tile in (256, 64):
        index = api.build_index(pts, params, core.SearchOpts(
            use_pallas=True, query_tile=tile))
        for name, rows in cases.items():
            if tile != 256 and name != "random":
                continue
            q = torch.as_tensor(rows, device=index.device)
            plan = api.plan_query(index, q)
            args, kw, entries = kernel_inputs(index, plan, q)
            kernel_ms = cuda_time_ms(
                lambda: knn_mod.knn_tile_anchored(*args, **kw), 5)
            query_ms = cuda_time_ms(lambda: api.query(index, q), 5)
            pairs, slot_pairs, _nbytes, ops_ms, bytes_ms, tiles = knn_work(
                index, args, entries)
            out[f"{name}_tile{tile}"] = dict(
                kernel_ms=kernel_ms, query_ms=query_ms,
                bound_ms=max(ops_ms, bytes_ms), valid_pairs=pairs,
                slot_pairs=slot_pairs, tiles_per_window=tiles,
                split=split_work(index, args, kw))
        del index
    return out


def phase_serve_session(api, core, knn_mod, upd) -> dict:
    """A session-backed scene on the card: the dynamic cell's trajectory
    (donation on, as on a card by default), first 20 rounds of (step,
    submit, drain), each drained result bitwise what ``api.query`` returns
    on the current frame; then 20 steps on a thread while the background
    pump serves 30 requests, no future hanging, and once stopped a drain
    bitwise equal to ``api.query`` again."""
    import threading

    import numpy as np
    import torch
    from repro_torch.serve import NeighborService, ServeOpts

    frames, _vel = trajectory(DYN_N, SERVE_SESSION_ITERS
                              + SERVE_THREAD_STEPS + 1, DYN_SEED,
                              0.03 * DYN_RADIUS / 4.0)
    params = core.SearchParams(radius=DYN_RADIUS, k=DYN_K, mode="range")
    sess = core.SimulationSession(frames[0], params,
                                  core.SearchOpts(use_pallas=True))
    check(sess._donate, "serve: the session does not donate on the card")
    svc = NeighborService(ServeOpts(**SERVE_OPTS))
    svc.register_session("sim", sess)
    rng = np.random.default_rng(SERVE_SEED)

    def rows(frame):
        return frame[rng.integers(0, len(frame), SERVE_SESSION_ROWS)]

    def assert_alone(res, q, tag):
        alone = api.query(sess.index, q)
        d_res = torch.where(torch.isinf(res.distances2), -1.0,
                            res.distances2)
        d_alone = torch.where(torch.isinf(alone.distances2), -1.0,
                              alone.distances2)
        check(torch.equal(res.indices, alone.indices) and
              torch.equal(res.counts, alone.counts) and
              torch.equal(d_res, d_alone),
              f"serve: session {tag} not bitwise equal to api.query")

    torch.cuda.synchronize()
    knn_mod.knn_tile_anchored.launches = 0
    upd.bin_disp_tile.launches = 0
    ref_launches = 0
    t0 = time.perf_counter()
    for i in range(1, SERVE_SESSION_ITERS + 1):
        sess.step(frames[i])
        q = rows(frames[i])
        fut = svc.submit("sim", q, params)
        svc.drain()
        k0 = knn_mod.knn_tile_anchored.launches
        assert_alone(fut.result(timeout=SERVE_FUTURE_TIMEOUT_S), q,
                     f"round {i}")
        ref_launches += knn_mod.knn_tile_anchored.launches - k0
    torch.cuda.synchronize()
    rounds_s = time.perf_counter() - t0
    knn_launches = knn_mod.knn_tile_anchored.launches - ref_launches
    bin_launches = upd.bin_disp_tile.launches
    check(bin_launches == SERVE_SESSION_ITERS and
          knn_launches == 2 * SERVE_SESSION_ITERS,
          f"serve: session rounds launched bin_disp_tile {bin_launches} and "
          f"knn_tile_anchored {knn_launches} times")

    # steps on a thread while the background pump serves
    stop, steps = threading.Event(), {"n": 0}

    def stepper():
        for frame in frames[SERVE_SESSION_ITERS + 1:]:
            if stop.is_set():
                return
            sess.step(frame)
            steps["n"] += 1

    hung = 0
    th = threading.Thread(target=stepper, name="serve-session-stepper")
    t0 = time.perf_counter()
    svc.start()
    th.start()
    try:
        for _ in range(SERVE_THREAD_REQUESTS):
            fut = svc.submit("sim", rows(frames[SERVE_SESSION_ITERS]),
                             params)
            try:
                fut.result(timeout=SERVE_FUTURE_TIMEOUT_S)
            except TimeoutError:
                hung += 1
    finally:
        stop.set()
        th.join(timeout=600.0)
        svc.stop()
    torch.cuda.synchronize()
    threaded_s = time.perf_counter() - t0
    check(not th.is_alive() and hung == 0,
          f"serve: {hung} session futures hung")
    q = rows(frames[-1])
    fut = svc.submit("sim", q, params)
    svc.drain()
    assert_alone(fut.result(timeout=SERVE_FUTURE_TIMEOUT_S), q,
                 "drain after the threaded steps")
    st = svc.stats()
    check(st["host_syncs"] == st["batches"],
          "serve: session batches and host syncs differ")
    row = dict(session_rounds=SERVE_SESSION_ITERS, session_rounds_s=rounds_s,
               session_round_launches={"bin_disp_tile": bin_launches,
                                       "knn_tile_anchored": knn_launches},
               session_threaded_steps=steps["n"],
               session_threaded_requests=SERVE_THREAD_REQUESTS,
               session_threaded_s=threaded_s, session_hung=hung,
               session_batches=st["batches"])
    del svc, sess, frames
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.api as api
    import repro_torch.core as core
    import repro_torch.data as data
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import distance_tile as tdist
    from repro_torch.kernels import knn_tile as knn_mod
    from repro_torch.kernels import range_tile as trange
    from repro_torch.kernels import update_tile as upd

    smi = smi_line()
    t0 = time.perf_counter()
    reports = build.build(list(KERNELS), force=True)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in out.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, out in reports.items()}
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas)

    worst = phase_kernel_vs_plain(api, data)
    emit("kernel_vs_plain_done", max_abs_err=worst, bitwise=True)
    worst = phase_bin_edge_cases(upd)
    emit("bin_vs_plain_done", max_abs_err=worst, bitwise=True)
    layer_worst = phase_layer_vs_plain(ops, knn_mod, trange, tdist)
    any_k_err = phase_any_k_and_tile(api, data, ref, knn_mod)

    pts = data.kitti_like_cloud(N_POINTS, seed=1)
    opts = api.SearchOpts(use_pallas=True)
    out = {}
    for mode in ("knn", "range"):
        params = (api.SearchParams(radius=RADIUS, k=K, knn_window="exact")
                  if mode == "knn" else
                  api.SearchParams(radius=RADIUS, k=K, mode="range"))
        index = api.build_index(pts, params, opts)
        queries = index.points.clone()
        out[mode] = phase_main(api, ref, knn_mod, index, queries, mode)
        if mode == "knn":
            query_ms = cuda_time_ms(lambda: api.query(index, queries), 5)
            knn_index, knn_queries = index, queries
            layer = phase_kernel_layer(api, ops, knn_mod, trange, tdist, ref,
                                       index, queries, reports)

    # kernel and plain-version times at the main path's shapes (the plain
    # version takes about a minute a run, so it is timed once)
    m = out["knn"]
    kernel_ms = cuda_time_ms(
        lambda: knn_mod.knn_tile_anchored(*m["args"], **m["kw"]), 10)
    plain_ms = cuda_time_ms(
        lambda: knn_mod.knn_tile_anchored_plain(*m["args"], **m["kw"]), 1,
        warmup=0)
    emit("kernels", kernels=[{
        "name": "knn_tile_anchored", "replaces":
        KERNELS["knn_tile_anchored"][1], "launches": m["launches"],
        "bitwise": m["err"] == 0.0, "ms": kernel_ms}], query_ms=query_ms,
        queries_per_s=knn_queries.shape[0] / query_ms * 1e3,
        n_points=int(knn_index.points.shape[0]))
    del knn_index, knn_queries, index, queries, out

    hp_err = max(phase_host_planned(core, api, ref, knn_mod, pts, mode)
                 for mode in ("knn", "range"))

    d = phase_dynamic(core, ref, knn_mod, upd)

    sharded = phase_sharded(api, core, data, ref, knn_mod, upd)
    d["err"] = max(d["err"], sharded["bin_err"])
    phase_sharded_ranks(api, core, data, knn_mod, upd)

    phase_sph(core, ref, knn_mod, upd)

    t0 = time.perf_counter()
    serve = phase_serve(api, core, data, knn_mod, upd)
    emit("serve_done", seconds=time.perf_counter() - t0,
         d2_gap=serve["d2_gap"])

    lm = phase_lm_serve(reports.get("rwkv_scan", ""))
    phase_lm_train()
    phase_lm_dense()
    phase_lm_mla_vlm()
    phase_lm_moe()
    phase_lm_hybrid_audio()
    phase_lm_sharding()

    rows = [("knn_tile_anchored", dict(
        launches=m["launches"], err=max(m["err"], hp_err, any_k_err,
                                        d["search_err"], serve["d2_gap"],
                                        sharded["knn_err"]),
        ms=kernel_ms, plain_ms=plain_ms, bound_ms=m["bound_ms"],
        bound_by=m["bound_by"])),
        ("bin_disp_tile", d)]
    for name in ("knn_tile", "range_count", "distance_tile"):
        r = layer[name]
        r["err"] = max(r["err"], layer_worst[name])
        rows.append((name, r))
    rows.append(("rwkv_scan", lm))
    table = []
    for name, r in rows:
        src, replaces = KERNELS[name]
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
