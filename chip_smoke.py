#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port, ``jolineedle_tpu_torch``, on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--device-data-cache auto|on|off]
                          [--group kernels|serve|train|recipe|ddp|bench]

Phases, each of which raises (and the script exits non-zero) on a failure.
With no ``--group`` every phase runs and the script ends with the
``kernels`` line; ``--group`` runs one group of them (``GROUPS``, with a
phase of another group that one of its phases reads first: ``NEEDS``) and
ends with its launches by path. Each phase prints its seconds. The phases:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of ``jolineedle_tpu_torch/csrc`` with ``nvcc``,
   one process per source, into ``build/kernels/``;
3. kernels: each kernel at every shape the serving path gives it at 448 px,
   for N = 32 patches, in float32 and bfloat16 (dwblock also at N = 1, the
   B = 1 request, in bfloat16), against its plain PyTorch version (float32
   atol = rtol = 1e-4 with TF32 off; bfloat16 against the plain version in
   float32, atol 3e-2 and rtol 2e-2: the kernel rounds its output to
   bfloat16), with the median of 20 CUDA-event timings of the kernel, the
   plain version and a cuDNN yardstick (``F.conv2d`` with the same BN and
   SiLU ops, which the port never calls) beside the bound. dwblock is timed
   as the wrapper's whole call on the model's arguments (one launch: the
   kernel folds BN and reads the OIHW weight views through their strides).
   The supervised eval's largest calls are held too, in bfloat16: the
   embedder's shapes at N = 320 (the teacher-forced eval's 16 x 20
   patches) and the detector's at N = 240 (12 eval episodes of 20 patches);
   so are the full-prefix rollout's embedder calls of phase 7, at N = 80 in
   float32 (B = 4 x 20 patches) and N = 20 in bfloat16 (the B = 1 request);
4. reference: the float32 model on the card against the same model on the
   CPU (the plain versions of the kernels) on small inputs: the detector,
   the teacher-forced decoder and a greedy rollout (with a sharpened action
   head, so that the episodes walk); then the REINFORCE and the supervised
   losses with their gradients (below);
5. serve: the flagship config (gpt-nano, yolox-nano embedder and detector,
   concat embeddings, sinusoidal positions, grid position, STOP, 448 px
   patches, 20 steps, bfloat16) with weights made from ``--seed`` written
   to a model directory and loaded back as ``infer`` loads it; 4 requests
   of 2688x2688 images through ``infer.infer_image``, then one greedy
   batched ``eval_rollout`` at B = 32. The kernels' launch counters are set
   to 0 before and read after each, and must rise by exactly what the
   module tree implies. Then one request and the batched rollout run again
   under ``torch.profiler``: the device's busy share and the kernels that
   take the most device time;
6. jax files, with the port alone: the phase-5 model written as a JAX run
   directory (``checkpoint_best.msgpack`` by the port's flax writer, the same
   ``config.json``) serves 2 requests with the positions, boxes and raw
   detector outputs of the ``.pt`` directory, bit for bit; a second,
   differently seeded model's detector written as a ported-weights msgpack
   and loaded with ``--detection-checkpoint`` (``infer.load_model_dir``)
   gives that model's detector outputs exactly and leaves the decision
   weights; an upstream-layout state dict with an 80-class ``cls_preds``
   goes through ``scripts/port_yolox_weights.py`` and loads, every tensor
   but the 6 skipped ``cls_preds`` arriving;
7. full prefix (``--no-recurrent-embedding``): the float32 model with the
   sharpened head at B = 4, 448 px, 20 steps, full-prefix against KV-cache
   rollouts, greedy (positions, masks and actions equal, logits within
   ``REF_TOL``) and sampled from one generator (the same actions); then one
   bfloat16 request from a model directory whose ``config.json`` sets the
   flag. Each full-prefix rollout launches flash 3 x 20 times (one per layer
   per step, at [B, 3, 21, 16]) and the embedder's conv kernels 20 times
   over B x 20 patches, counted exactly;
8. smoke conv: ``python -m jolineedle_tpu_torch.scripts.smoke_conv`` run
   in-process (the driver of the plain 3x3 conv kernel), its error against
   ``F.conv2d`` checked;
9. pool: a toy dataset of 2688x2688 images (a 6x6 grid of 448 px patches)
   written by the port's generator, the data of phases 9-11; its training
   set as the device pool (``data/device_pool.py``) on the card, its bytes,
   decode and build times and peak memory, its pixels against the decoded
   images; the pool's gathers (``gather_pool_patches``, ``aug_canvases`` +
   ``gather_canvas_patches`` with rotation, translation and both) against
   the host's gather of the same ``build_supervised_batch`` rows from one
   seed at B = 16, and the REINFORCE images (``gather_pool_images``, and
   ``aug_canvases`` at ``out_hw`` = the fixed training shape) against the
   host's padded images, all bit for bit and each timed (median of 20 event
   pairs) beside its bound; then, in float32 at B = 4, one train step of
   each trainer fed from the pool and one fed streamed pixels, from one
   seed on copies of one model, with and without both augmentations: the
   losses, and REINFORCE's returns, equal within rtol 1e-6;
10. train: the train CLI (``jolineedle_tpu_torch.main``, REINFORCE) at the
   flagship config with batch 16, gradient accumulation 2, 4 iterations and
   its final test, under ``--device-data-cache auto`` (the default; the
   script's own ``--device-data-cache`` is passed on): it must train from
   the pool (stream, under ``off``); the
   losses must be finite, both optimizer groups and the detector's BN
   statistics must move (the embedder's must not), the checkpoint must be
   written, and a resumed run must take one more iteration. The launch
   counters must read exactly: per train step, the rollout's conv launches
   (the module tree's count) and 3 flash launches (one per layer of the one
   teacher-forced forward) and no conv launch in the differentiated
   forwards. Then two more steps on each route (the pool's batch, then the
   streamed one) give the phase times (upload, rollout, loss
   forward+backward, detection, optimizer, by CUDA events), the bytes each
   uploads, the peak memory, and a ``torch.profiler`` busy share and
   device operations of one step per route;
11. supervised: the train CLI with ``--training-mode supervised`` on the
   same toy dataset (from the pool, as in phase 10), batch 16, accumulation
   2, dropout 0.1: 4 iterations
   (``--max-iters 5``), a test of 16 sampled test images after the last, the
   final test, then a resumed run of one iteration. The losses and the test
   metrics must be finite; both optimizer groups and the BN statistics of
   the embedder and of the detector must move; the checkpoint must track
   ``map``. The launch counters must read exactly what
   ``sup_test_launches`` derives from the code: per step 3 flash launches
   and no conv launch (every conv of a train step runs under autograd);
   per test the conv kernels of the eval rollouts, of the eval detections
   and of the teacher-forced eval's embedder and detector, and its 3 flash
   launches per batch of 16 images. Then two more steps on each route give
   the phase times (upload, decision, detection, optimizer), the bytes each
   uploads, the peak memory and a ``torch.profiler`` busy share; the
   resumed run's final test is kept for phase 12;
11b. resume_jax: ``--resume-training`` on a JAX run directory. The
   supervised train CLI on phase 9's toy set, float32, accumulation 2,
   ``--lr-schedule cosine``, 3 iterations (its window half full) and its
   final test; that state written as a JAX run directory
   (``checkpoint.flax_train_state``: ``checkpoint.msgpack`` and
   ``config.json``); a trainer resumed from the ``.pt`` files and one from
   the msgpack (given the first's generator: the JAX file holds none) hold
   equal optimizer states (AdamW's moments and steps, the update count and
   the window bit for bit, the accumulated grads within 1e-6 relative),
   then train 2 iterations each: losses within rtol 1e-6, weights within
   1e-5, 3 flash launches an iteration; one test of the msgpack trainer
   launches what ``sup_test_launches`` derives and writes the port's files
   beside the unchanged msgpack, which they now take precedence over. Then
   phase 10's REINFORCE state (bf16, inside its window) through a JAX file
   with the clip level: the resumed trainer's optimizer state is the
   source's, its return window empty, and one iteration launches 240
   ``dwblock_bn_silu``, 20 ``conv3x3_bn_silu`` and 3 ``flash_attention``
   kernels with a finite loss. The phase's wall ms is printed;
11c. recipe: the port's ``run_sup_flagship.sh <dir> yolox-s 1 4`` through
   ``sh`` (its ``python -m jolineedle_tpu_torch.main``, bf16, B = 16, 8
   patches of 64 px, the yolox-s detector and the yolox-nano embedder) on
   16 + 10 images of 320 x 448 from ``make_toyds_big``'s generator: it
   exits 0, writes its run files with finite final-validation metrics, and
   the launches it prints at its end (``kernel launches: {...}``) are what
   its config implies: 3 flash launches in each of its 3 iterations, then
   its final test's (``sup_test_launches`` at episodes of 8 and the conv
   launches per embedder and detector call read from the run's model at
   64 px; its worst-images pass takes one image). Then ``dwblock_bn_silu``
   and ``conv3x3_bn_silu`` at every shape those tests launch them (the
   embedder's at one rollout chunk of 32 patches, the detector's at one
   detection chunk of 32 episodes of 8 patches) in float32 and bfloat16
   against their plain versions, and the recipe's train step with its CUDA
   graphs (``train/graphs.py``) against the eager step from one state on the
   same batches, in float32 and bfloat16 (losses within rtol 1e-6, weights
   within 1e-6 after 2 steps), with each one's wall ms in turns;
11d. rlft: the port's ``run_rl_finetune_stop.sh <dir> <11c's run> yolox-s
   4`` through ``sh`` on 11c's toy set: the supervised 8-action head
   grafted onto the 9-action STOP model, bf16, B = 16, episodes of 20
   patches of 64 px, accumulation 4 in chunks of 4, one window. It exits 0,
   writes its run files with finite final-validation metrics, and its
   launches are what its config implies: per iteration the sampled
   rollout's 20 embedder calls (240 ``dwblock_bn_silu``, 20
   ``conv3x3_bn_silu``; from the second iteration a CUDA graph's replay,
   counted at each replay) and 3 flash launches in the recompute, then its
   final test's (``rl_test_launches`` at the recipe's shapes). Then the
   embedder's kernels at the rollout's 16 patches against their plain
   versions, and the graphed REINFORCE step (rollout, the recompute's
   embedder and the detector as CUDA graphs, ``train/graphs.py``) against
   the eager one from one state over one window of 4 iterations and its
   update: float32 losses equal, and after the update every weight within
   2 learning rates and all but 1 % within 1e-7; bf16 losses within rtol
   1e-6; each run's launches as derived; each one's wall ms in turns and,
   in bf16, its busy share. Then the float32 comparison again under
   ``torch.use_deterministic_algorithms`` and cuDNN's deterministic
   algorithms (the graphs captured under them; the flags restored after,
   also on a failure): losses equal and every weight within 1e-7. The
   float32 passes, which time nothing, run while the CLI does (in its own
   process); the bf16 pass, timed, after it;
11e. shared: the recipes' default pairing (the yolox-nano detector's own
   backbone as the embedder, no ``--gpt-backbone``) at 11c's flags and then
   at 11d's, on 11c's toy set: one supervised step (no warm-up, so that its
   update is at the recipe's full learning rate; 8 steps, each with its
   update, under deterministic algorithms), then one fine-tune window
   of 4 iterations from an 8-action state of the pairing (weights and BN
   statistics from ``--seed``, grafted onto the STOP model), each graphed
   (the embedder as a forward-only CUDA graph of the shared backbone,
   ``TrainGraphs.shared_embedder``, beside the detector's and the
   rollout's; the embedder and the rollout run eagerly at their first
   step and are captured at the next, so the supervised graphed run starts
   after one graphed step that the state's restore undoes) against eager
   from one state on the same batches: float32
   losses equal, after the update every weight by 11d's rule and the BN
   buffers within 1e-6; bf16 losses within rtol 1e-6; under deterministic
   algorithms losses equal and weights and buffers within 1e-7. On each route a step with the detection loss off
   leaves no gradient on the shared backbone and one on the embedder's
   conv. Launches exact: 3 flash a supervised step (its train-mode convs
   are PyTorch's); a fine-tune iteration the rollout's 20 embedder calls
   and the recompute's one (252 ``dwblock_bn_silu``, 21
   ``conv3x3_bn_silu``) and 3 flash. These passes time nothing and run
   beside 11d's CLI. Then the embedder's kernels at the
   recompute's 16 x 20 patches against their plain versions. Then the key
   route (JAX's own random numbers): split, fold_in, bits, uniform,
   randint and bernoulli on the card bit-equal to the CPU's in this
   process, normal within 2 ulp, the augmentation of 16 x 8 patches within
   1e-6; and 2 supervised steps of the pairing on JAX's keys of ``--seed``,
   the TPU-precision option off and on, their losses printed (3 flash a
   step);
12. eval and report: a toy test set of 10 images of 3 x 3 patches (1344
   px), so that ``--failure-select-rate`` 0.1 picks one worst image.
   ``--measure-flops`` through the train CLI on the card and on the CPU
   gives the same report (printed), launches no kernel and takes no card
   memory beyond the model's weights in its FLOP pass (``meta`` tensors).
   Each trainer's ``test()`` of the 10 images runs the eval rollouts, the
   detections, the panels' inputs (6 picks of ``visual_rng``; the
   supervised oracle samples) and the worst-images pass on the kernels,
   with exact launch counts, and without matplotlib prints the panel line
   and hands no image to the logger; a fresh trainer's test gives the same
   metrics; a third at failure rate 0 gives the worst pass's share of the
   cycle's wall time. ``python -m jolineedle_tpu_torch.scripts.
   eval_checkpoint`` on phase 11's run (the port's ``.pt``: the metrics of
   that run's final test, exactly) and on phase 6's JAX-format run (``.msgpack``, on the
   phase's test set) prints ``FULL-TEST`` and changes neither directory.
   ``infer --output-dir`` without matplotlib raises before any launch (with
   it, writes ``result0.png``). ``nms_mask`` on the card gives the CPU's
   keep mask at N = 64 and 1000;
13. ddp: data-parallel training (``parallel/mesh.py``) on phase 9's toy
   dataset. (a) Two ranks sharing cuda:0 over gloo (``mesh.launch`` with
   ``backend="gloo"``: NCCL refuses two ranks on one card), W = 2 x B = 4
   against W = 1 x B = 8, float32 with TF32 off, accumulation 2, 4
   iterations of each mode with the geometric augmentations and, in the
   supervised mode, dropout: every rank's parameters, buffers, optimizer
   state and generator bit-equal to rank 0's after every iteration (state
   digests); every loss within rtol 1e-4, before the first update and
   after it; the weights by the aggregate rule of
   ``tests/test_dp_equivalence.py``; the BN statistics together within 1e-4
   relative. (b) Each rank's kernel launches of every iteration, which
   come back to this process, equal the W = 1 run's exactly; they make up
   the ``ddp`` path of the ``kernels`` line. (c) The train CLI as rank 0 of
   a group of 1 joined from torchrun's variables (NCCL), 2 iterations: its
   losses and launches equal the run without a group. (d) bf16, W = 2 x B =
   8 on the shared card, 3 iterations a mode: the wall ms per step (two
   processes share one card: not a multi-card time) beside W = 1 x B = 16,
   the gradient all-reduce's ms and bytes, the BN syncs per step. (e) With
   two cards or more, (a)'s runs again over NCCL, one rank on each visible
   card (W = 4 x B = 2 on four cards; two cards where their count does not
   divide the global batch of 8), with (a)'s checks against W = 1 x B = 8,
   and the train CLI with ``--devices 0 1 ...`` over those cards trains
   REINFORCE 2 iterations with a test on rank 0 (the ranks' state check
   and the barrier over NCCL): every rank reports the same losses and the
   digest they agreed on. With more than two cards, bf16 steps of B = 8 a
   rank at W = 1, 2 and all of them, one rank per card, 3 iterations a
   mode: the wall ms per step, images/s and the gradient all-reduce's ms
   and bytes. With one card, a line says (e) was not run. The two ranks of
   (a) and (d) run in one launch with phase 14's two-rank jobs, started
   first; this process runs W = 1 of (a) and (c) beside their untimed
   jobs, then times W = 1 of (d) while they wait, then lets them time (d)
   while it waits;
14. steps per dispatch: each trainer through the train CLI at
   ``--steps-per-dispatch`` 2 and 1, float32 at B = 4 on phase 9's toy
   set, accumulation 2, a test every 2 iterations, 5 iterations (a short
   last chunk): the per-iteration losses within rtol 1e-4, the weights by
   phase 13's rule, the BN statistics within 1e-4, REINFORCE's return mean
   and std within rtol 1e-4, each train step's kernel launches and each
   run's total equal; each CLI error for an N that does not divide raises
   before any launch; two ranks sharing the card over gloo at N = 2
   against N = 1 (REINFORCE, 4 iterations; run by phase 13's launch) by
   phase 13's comparison; bf16
   step times at B = 16, N = 1 and 2 in turns (1, 2, 2, 1, 1, 2);
15. oracle ceiling: ``python -m jolineedle_tpu_torch.scripts.
   eval_oracle_ceiling`` on phase 11's run on the card: its
   ``ORACLE-CEILING`` line, wall ms and the conv kernels' launches (one
   detector call per EVAL_DET_ROWS test images); then on the CPU
   (``device="cpu"``), every number within 1e-4; the run unchanged;
16. pyramid: ``NeedleEnv`` with 2 and 3 glimpse levels on float32 images of
   2688 px (B = 4, 448 px patches) on the card against the CPU: the
   pyramid, ``reset``, 20 ``step``s and ``get_patches`` within 1e-5; the
   pyramid build timed (median of 20 event pairs);
17. bench: ``python -m jolineedle_tpu_torch.bench``'s ``run`` in-process
   on the card at its full config (B = 128, grid 6, 448 px, 20 steps, bf16,
   and the yolox-s secondary) with ``BENCH_ITERS=5``, ``BENCH_REPEATS=2``,
   ``BENCH_SECONDARY_ITERS=2``, ``BENCH_BASELINE_MIN_S=0`` and its first
   nano pass profiled: its JSON line printed, every key of bench.py's line
   present, 0.974 GFLOP an env step, ``mfu_pct`` in (0, 100], and each timed
   rollout's launches exact (nano: 240 ``dwblock_bn_silu`` and 20
   ``conv3x3_bn_silu``; yolox-s: 20 x the stride-1 dense 3x3s of its
   backbone and PAFPN; no flash), each baseline iteration's flash launches
   ``steps x 3``; then ``bench_rollout_parts``, ``bench_attention``,
   ``bench_embedder_stages`` (nano and yolox-s), ``bench_pallas_embedder``
   at fewer reps and ``analyze_trace`` on the profiled pass, each of which
   must return.

Phase 3 also holds the flash-attention kernel against its plain versions
(output, log-sum-exp and gradients) at the decoder's shape [16, 3, 21, 16]
on the model's strided views of its c_attn output, a ragged multi-tile [2,
4, 200, 64] and the long-T [128, 4, 128, 64], and at the full-prefix
rollout's [4, 3, 21, 16] in float32 and [1, 3, 21, 16] in bfloat16 on the
model's views (phase 7's shapes), and at head dim 128 (``FLASH_D128_SHAPES``:
[16, 3, 21, 128] in the short regime, [2, 2, 256, 128], [128, 4, 128, 128],
[8, 8, 1024, 128] and [4, 16, 4096, 128]) in both dtypes, times each as the
wrapper's whole call (per launch and back to back), and checks under
``torch.profiler`` that one call on the model's views is one device
operation; it holds the plain 3x3 conv kernel at the smoke script's
default and at the nano stem, and ``conv3x3_bn_silu`` at every dense
stride-1 3x3 shape of a yolox-s detector at 448 px (rows beside the path,
outside the ``kernels`` line's totals); phase 4 also compares the REINFORCE
loss and its gradients on the card with the CPU, and the supervised loss
(CE + SimOTA, float32, dropout 0, un-augmented patches), its gradients and
the BN statistics its two train-mode forwards leave behind. The dense 3x3 kernels take
their filter as the wrappers prepare it (``conv3x3_filter``: in x's dtype,
so rounded to bf16 in bf16); their plain versions run on the caller's
float32 filter, so the bf16 tolerance also holds that rounding.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Every number printed carries the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
import warnings
from collections import Counter, defaultdict
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
N_PATCHES = 32  # EVAL_CHUNK of the JAX trainer (jolineedle_tpu/train/trainer.py:282)
REPS = 20
HBM_BYTES_PER_S = 3.35e12
# Peak operation rate by input type: bfloat16 on the tensor cores; float32
# on the CUDA cores (the plain versions' float32, TF32 off).
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Every kernel multiplies float32 as 3xTF32: three TF32 tensor-core
# products per float32 product, 495 / 3 TFLOP/s.
PEAK_3XTF32_OPS_PER_S = 495e12 / 3
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}
# Flash attention's lse is float32 in both dtypes, from products that are
# exact in float32 (bf16 inputs) or 3xTF32: held at the float32 limit.
LSE_TOL = (1e-4, 1e-4)
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

# The flagship serving config (bench.py's flags at full width).
PATCH, STEPS, GRID, MAX_DET_PATCHES = 448, 20, 6, 4
FLAGSHIP = [
    "--training-mode", "reinforce", "--dataset-dir", "/nonexistent",
    "--model-type", "gpt-nano", "--image-processor", "yolox-nano",
    "--gpt-backbone", "yolox-nano", "--concat-embeddings", "--decoder-pos-encoding",
    "--use-positional-embedding", "--enable-stop", "--max-seq-len", str(STEPS),
    "--patch-size", str(PATCH), "--minimum-image-size", "0",
    "--batch-size", str(N_PATCHES), "--dropout", "0.0", "--max-det-patches", str(MAX_DET_PATCHES),
    "--max-boxes", "4", "--devices", "0", "--compute-dtype", "bfloat16",
]
# Per call of the embedder (one per rollout step) and of the detector, the
# launches that the yolox-nano module tree implies: the stride-1 DWConvs of
# the PAFPN (1 + 4 + 5 + 2) and of the head (4 per level), and the Focus stem.
EXPECTED_PER_CALL = {
    "embedder": {"dwblock_bn_silu": 12, "conv3x3_bn_silu": 1},
    "detector": {"dwblock_bn_silu": 24, "conv3x3_bn_silu": 1},
}

# The toy datasets' box sides in pixels.
BOX_SIZE = (48, 200)
# The train phase: the flagship config at batch 16, gradient accumulation 2.
TRAIN_B, TRAIN_ACCUM, TRAIN_ITERS, N_LAYER = 16, 2, 4, 3
# The supervised train phase: the same, with dropout on and a test of
# SUP_TEST_IDS sampled test images after the last iteration (besides the
# final test on the whole test set). Its eval batches: the teacher-forced
# eval embeds TRAIN_B x STEPS patches in one call and detects on TRAIN_B x
# MAX_DET_PATCHES; the autoregressive eval's detections go EVAL_DET_ROWS
# episodes of STEPS patches at a time (Trainer.DET_EVAL_PATCHES // STEPS).
SUP_TEST_IDS, EVAL_CHUNK, DET_EVAL_PATCHES = 16, 32, 256
EVAL_DET_ROWS = min(EVAL_CHUNK, DET_EVAL_PATCHES // STEPS)
SUP_EMBED_N, SUP_DET_N = TRAIN_B * STEPS, EVAL_DET_ROWS * STEPS
# Flash attention: the decoder's teacher-forced shape at TRAIN_B (B, heads,
# T = STEPS + 1 with the class token, head dim; q, k, v as the model's views
# of its c_attn output), a ragged multi-tile one and the needle-scale long-T
# row of the JAX package's sweep (scripts/bench_attention.py:75).
FLASH_SHAPES = [(TRAIN_B, 3, STEPS + 1, 16), (2, 4, 200, 64), (128, 4, 128, 64)]
# Flash attention at head dim 128, the D of the JAX package's attention sweep
# (scripts/bench_attention.py:70-80, which the port's bench_attention runs):
# the decoder's short T, the sweep's small shape, two of its rows and its
# longest, contiguous, in both dtypes. Off every model path of the repo.
FLASH_D128_SHAPES = [(TRAIN_B, 3, STEPS + 1, 128), (2, 2, 256, 128), (128, 4, 128, 128),
                     (8, 8, 1024, 128), (4, 16, 4096, 128)]
# The full-prefix rollout (phase 7) at B = FULL_PREFIX_B in float32 and the
# B = 1 request in bfloat16: each step embeds B x STEPS patches and runs
# flash at [B, 3, STEPS + 1, 16] on the model's c_attn views.
FULL_PREFIX_B = 4
FULL_PREFIX_RUNS = [(FULL_PREFIX_B, torch.float32), (1, torch.bfloat16)]
# Device operations of one B = 16 train step when the flash wrapper still
# copied q, k and v in and o out (PERF.md section 5): 4 copies per layer.
TRAIN_STEP_OPS_WITH_COPIES = 28_328
# The float32 route-equality steps of the pool phase run at this batch.
ROUTE_B = 4
# The recipe phase: the port's run_sup_flagship.sh (yolox-s) for
# RECIPE_ITERS iterations on a toy set of the recipe's 320 x 448 images
# (make_toyds_big's generator) with RECIPE_TEST test images, so that the
# final test's worst-images pass (--failure-select-rate 0.1) takes one;
# then the graphed train step against the eager one, GRAPH_STEPS steps each.
RECIPE_SCRIPT = "jolineedle_tpu_torch/scripts/run_sup_flagship.sh"
RECIPE_ITERS, RECIPE_TRAIN, RECIPE_TEST, GRAPH_STEPS = 3, 16, 10, 2
# The graphed and the eager step's wall ms: GRAPH_TIMED_PASSES passes over
# the GRAPH_STEPS batches a turn (5 until the script had to fit 600 s).
GRAPH_TIMED_PASSES = 2
# A graphed step against the eager one from the same state: losses and
# weights (the same kernels on the same tensors; cuDNN's backward sums in
# its own order).
GRAPH_RTOL, GRAPH_ATOL = 1e-6, 1e-6
# The fine-tune phase: the port's run_rl_finetune_stop.sh (yolox-s) for
# RLFT_ITERS iterations (one accumulation window; two until the script had
# to fit 600 s: its launches are derived per iteration, and the window's
# update is held below) from the recipe phase's run on its toy set; then
# the graphed step against the eager one over one window of RLFT_WINDOW
# iterations: float32 losses equal; after the window's update (AdamW's
# first: it moves each weight by about lr along its gradient's sign, and
# the graphs' backward sums some gradients in another order, so a weight
# whose gradient is ~0 can step the other way) every weight within
# RLFT_STEP_TOL learning rates and all but RLFT_FLIP_SHARE of them within
# RLFT_ATOL; bf16 losses within GRAPH_RTOL.
RLFT_SCRIPT = "jolineedle_tpu_torch/scripts/run_rl_finetune_stop.sh"
RLFT_ITERS, RLFT_WINDOW = 4, 4
RLFT_STEP_TOL, RLFT_ATOL, RLFT_FLIP_SHARE = 2.0, 1e-7, 1e-2
# The same float32 comparison under torch.use_deterministic_algorithms and
# cuDNN's deterministic algorithms (the graphs captured under them): every
# weight within RLFT_DET_ATOL of the eager step's after the update.
RLFT_DET_ATOL = 1e-7
# The shared pairing's phase: its supervised steps (one update each) graphed
# against eager, SHARED_SUP_DET_STEPS of them under deterministic algorithms
# (the graphs replayed across updates: every weight must stay equal); its
# fine-tune runs one window of RLFT_WINDOW.
SHARED_SUP_STEPS, SHARED_SUP_DET_STEPS = 1, 8
# The key route (JAX's own random numbers, ``utils/jax_random.py``) on the
# card against the CPU in this process: every draw bit-equal but normal's,
# within KEY_NORMAL_ULPS (libm's log1p and sqrt on either side); the
# photometric augmentation of the recipe's B x 8 decision patches within
# KEY_AUG_ATOL. Then KEY_STEPS supervised steps of the shared pairing on the
# key route, with the TPU-precision option off and on.
KEY_NORMAL_ULPS, KEY_AUG_ATOL, KEY_STEPS = 2, 1e-6, 2
# The plain 3x3 conv: the smoke script's default and the nano stem.
PLAIN_CONV_SHAPES = [(8, 56, 56, 16, 32), (N_PATCHES, PATCH // 2, PATCH // 2, 12, 16)]
# The dense 3x3 convs of a wider variant, held and timed beside the path.
WIDE_VARIANT = "yolox-s"
KERNEL_NAMES = ("dwblock_bn_silu", "conv3x3_bn_silu", "flash_attention", "conv3x3")

CARD = ""  # "name, power limit" from nvidia-smi, set in main()
DEVICE = "cuda"  # where the pool phase puts its pool, batches and models


def say(text: str) -> None:
    print(f"{text}  [{CARD}]", flush=True)


# --- timing -----------------------------------------------------------------
def median_ms(fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` launches, by CUDA events.
    A sleep kernel first lets the host queue every launch ahead of the
    device, so the events time the device and not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def back_to_back_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time per launch of ``launches`` queued back to back between one
    pair of CUDA events (median of ``reps``): a launch's cost inside a stream
    of kernels, without the event pair that ``median_ms`` puts around each
    one (about 3 us a launch on the H100, an empty kernel's difference)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, dtype, peak=None) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (peak or PEAK_OPS_PER_S[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- the path's kernel shapes --------------------------------------------------
def module_kernel_calls(model, patch: int) -> dict:
    """{"embedder" | "detector": Counter((kernel, H, W, C, K))}: the kernel
    launches of one embedder call and one detector call on a ``patch`` px
    patch, read from the modules that take a kernel."""
    from jolineedle_tpu_torch.models.yolox import ConvBnAct, DWConv

    seen = []

    def hook(name):
        def record(module, inputs, output):
            _, C, H, W = inputs[0].shape
            seen.append((name, H, W, C, output.shape[1]))
        return record

    handles = []
    for m in model.modules():
        if isinstance(m, DWConv) and m.uses_dwblock_kernel:
            handles.append(m.register_forward_hook(hook("dwblock_bn_silu")))
        elif isinstance(m, ConvBnAct) and m.uses_conv3x3_kernel:
            handles.append(m.register_forward_hook(hook("conv3x3_bn_silu")))
    x = torch.zeros((1, patch, patch, 3), dtype=torch.uint8, device=model.device)
    out = {}
    with torch.no_grad():
        model.embed_patches(x[:, None])
        out["embedder"], seen[:] = Counter(seen), []
        model.yolox_outputs(x)
        out["detector"] = Counter(seen)
    for h in handles:
        h.remove()
    return out


def per_kernel(calls: Counter) -> dict:
    """{kernel: launches} of one call's Counter((kernel, H, W, C, K))."""
    out = Counter()
    for (name, *_), n in calls.items():
        out[name] += n
    return dict(out)


def path_shapes(model) -> dict:
    """``module_kernel_calls`` of the flagship at PATCH, each call's
    launches checked against EXPECTED_PER_CALL."""
    out = module_kernel_calls(model, PATCH)
    for call, counts in out.items():
        if per_kernel(counts) != EXPECTED_PER_CALL[call]:
            raise AssertionError(f"{call}: kernel calls {per_kernel(counts)},"
                                 f" expected {EXPECTED_PER_CALL[call]}")
    return out


def dense_conv_shapes(variant: str, embedder: bool = False) -> Counter:
    """Counter((H, W, C, K)): the ``conv3x3_bn_silu`` launches of one
    forward of a ``variant`` detector on a 448 px patch (with ``embedder``:
    of its backbone and PAFPN alone, what one embedder call runs), read
    from its module tree (every dense stride-1 3x3 ``ConvBnAct``)."""
    from jolineedle_tpu_torch.models.yolox import ConvBnAct, NeedleYOLOX

    model = NeedleYOLOX(variant, device=DEVICE).eval()
    seen = Counter()

    def record(module, inputs, output):
        _, C, H, W = inputs[0].shape
        seen[(H, W, C, output.shape[1])] += 1

    for m in model.modules():
        if isinstance(m, ConvBnAct) and m.uses_conv3x3_kernel:
            m.register_forward_hook(record)
    with torch.no_grad():
        x = torch.zeros((1, 3, PATCH, PATCH), device=DEVICE)
        model.backbone(x) if embedder else model(x)
    return seen


# --- phase 3: kernels against their plain versions -----------------------------
def _bn(gen, n):
    dev = gen.device
    return [torch.rand(n, generator=gen, device=dev) + 0.5,
            torch.randn(n, generator=gen, device=dev) * 0.1,
            torch.randn(n, generator=gen, device=dev) * 0.1,
            torch.rand(n, generator=gen, device=dev) + 0.5]


def measure_dwblock(kconv, H, W, C, K, dtype, gen, n=N_PATCHES):
    """The kernel is timed as the wrapper's whole call on the model's own
    arguments (HWIO views of OIHW weights, raw BN vectors; the fold happens
    in the kernel); the plain version runs on the same float32 weights."""
    dev = gen.device
    x = torch.randn((n, H, W, C), generator=gen, device=dev).to(dtype)
    dw = (torch.randn((C, 1, 3, 3), generator=gen, device=dev) * 0.2).permute(2, 3, 1, 0)
    pw = (torch.randn((K, C, 1, 1), generator=gen, device=dev) / C**0.5).permute(2, 3, 1, 0)
    bn1, bn2 = _bn(gen, C), _bn(gen, K)
    args = [dw, *bn1, pw, *bn2]
    got = kconv.dwblock_bn_silu(x, *args)
    want = kconv.dwblock_bn_silu_reference(x.float(), *args)

    s1, b1 = kconv.fold_bn(*bn1, 1e-3)
    s2, b2 = kconv.fold_bn(*bn2, 1e-3)
    xc = x.permute(0, 3, 1, 2)  # NCHW view in channels_last memory
    w_dw = dw.permute(3, 2, 0, 1).to(dtype)  # [C, 1, 3, 3]
    w_pw = pw.permute(3, 2, 0, 1).to(dtype)  # [K, C, 1, 1]
    s1c, b1c, s2c, b2c = (v.to(dtype)[:, None, None] for v in (s1, b1, s2, b2))

    def library():
        y = F.silu(F.conv2d(xc, w_dw, padding=1, groups=C) * s1c + b1c)
        return F.silu(F.conv2d(y, w_pw) * s2c + b2c)

    elt = x.element_size()
    n_bytes = n * H * W * (C + K) * elt + 4 * (9 * C + C * K + 4 * C + 4 * K)
    n_ops = n * H * W * (2 * 9 * C + 2 * C + 2 * C * K + 2 * K)
    r = _report(got, want, dtype, n_bytes, n_ops,
                lambda: kconv.dwblock_bn_silu(x, *args),
                lambda: kconv.dwblock_bn_silu_reference(x, *args), library,
                peak=PEAK_3XTF32_OPS_PER_S if dtype == torch.float32 else None)
    r["back_to_back_ms"] = back_to_back_ms(lambda: kconv.dwblock_bn_silu(x, *args))
    return r


def measure_conv3x3(kconv, H, W, C, K, dtype, gen, n=N_PATCHES):
    """The kernel is timed on the wrapper's own operands (the filter in x's
    dtype, BN folded); the plain version runs on the caller's float32
    filter."""
    dev = gen.device
    x = torch.randn((n, H, W, C), generator=gen, device=dev).to(dtype)
    w = torch.randn((3, 3, C, K), generator=gen, device=dev) / (9 * C) ** 0.5
    bn = _bn(gen, K)
    operands = kconv.conv3x3_bn_silu_operands(x, w, *bn)
    scale, bias = operands[1:]
    got = kconv.conv3x3_bn_silu(x, w, *bn)
    want = kconv.conv3x3_bn_silu_reference(x.float(), w, *bn)

    xc = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).to(dtype)
    sc, bc = (v.to(dtype)[:, None, None] for v in (scale, bias))

    def library():
        return F.silu(F.conv2d(xc, w_oihw, padding=1) * sc + bc)

    elt = x.element_size()
    n_bytes = n * H * W * (C + K) * elt + 9 * C * K * elt + 4 * 2 * K
    n_ops = n * H * W * (2 * 9 * C * K + 2 * K)
    return _report(got, want, dtype, n_bytes, n_ops,
                   lambda: kconv.conv3x3_bn_silu_launch(x, operands),
                   lambda: kconv.conv3x3_bn_silu_reference(x, w, *bn), library,
                   peak=PEAK_3XTF32_OPS_PER_S if dtype == torch.float32 else None)


def _report(got, want, dtype, n_bytes, n_ops, kernel_fn, plain_fn, library_fn, peak=None):
    torch.cuda.synchronize()
    atol, rtol = TOLS[dtype]
    err = (got.float() - want).abs().max().item()
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    bound_ms, bound_by = bound(n_bytes, n_ops, dtype, peak)
    return {
        "max_abs_err": err,
        "ms": median_ms(kernel_fn),
        "plain_ms": median_ms(plain_fn),
        "library_ms": median_ms(library_fn),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }


def flash_inputs(shape, dtype, gen, model_views):
    """q, k, v [B, H, T, D] on the card, as leaves of the autograd graph: the
    model's views of one [B, T, 3C] c_attn output (``models/gpt.py``'s
    split, reshape and transpose), or three contiguous tensors."""
    B, H, T, D = shape
    if model_views:
        x = torch.randn((B, T, 3 * H * D), generator=gen, device=gen.device).to(dtype)
        x.requires_grad_()
        return x, [t.reshape(B, T, H, D).transpose(1, 2) for t in x.split(H * D, dim=-1)]
    qkv = [torch.randn(shape, generator=gen, device=gen.device).to(dtype).requires_grad_()
           for _ in range(3)]
    return qkv, qkv


def measure_flash(kattn, shape, dtype, gen, model_views=False):
    """The flash kernel against its plain versions: output and lse against
    the plain forward on the same inputs, gradients (through the
    autograd.Function) against autograd of the float32 plain version; the
    forward timed as the wrapper's whole call, per launch and back to back."""
    dev = gen.device
    leaves, (qd, kd, vd) = flash_inputs(shape, dtype, gen, model_views)
    do = torch.randn(shape, generator=gen, device=dev)
    got = kattn.flash_attention(qd, kd, vd)
    got_grads = torch.autograd.grad(got, (qd, kd, vd), do.to(dtype))
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (qd, kd, vd))
    want = kattn.flash_attention_reference(qf, kf, vf)
    want_grads = torch.autograd.grad(want, (qf, kf, vf), do.to(dtype).float())
    x = [t.detach() for t in (qd, kd, vd)]
    o, lse = kattn.flash_attention_launch(*x)
    want_o, want_lse = kattn.flash_attention_forward_reference(*x)
    torch.cuda.synchronize()
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), atol=atol, rtol=rtol, msg="o")
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL[0], rtol=LSE_TOL[1], msg="lse")
    grad_err = 0.0
    for name, g, w in zip("qkv", got_grads, want_grads):
        torch.testing.assert_close(g.float(), w, atol=atol, rtol=rtol, msg=f"d{name}")
        grad_err = max(grad_err, (g.float() - w).abs().max().item())

    B, H, T, D = shape
    pairs = B * H * T * (T + 1) // 2  # causal (query, key) pairs
    n_bytes = 4 * B * H * T * D * qd.element_size() + 4 * B * H * T  # q, k, v, o; lse
    n_ops = 4 * D * pairs  # QK^T and PV on the visible pairs
    r = _report(got, want, dtype, n_bytes, n_ops,
                lambda: kattn.flash_attention(*x),
                lambda: kattn.flash_attention_reference(*x),
                lambda: F.scaled_dot_product_attention(*x, is_causal=True),
                peak=PEAK_3XTF32_OPS_PER_S if dtype == torch.float32 else None)
    r["back_to_back_ms"] = back_to_back_ms(lambda: kattn.flash_attention(*x))
    r["library_back_to_back_ms"] = back_to_back_ms(
        lambda: F.scaled_dot_product_attention(*x, is_causal=True))
    r["lse_max_abs_err"] = (lse - want_lse).abs().max().item()
    r["grad_max_abs_err"] = grad_err
    r["backward_ms"] = median_ms(lambda: kattn.flash_attention_backward(*x, o, lse, do.to(dtype)))
    return r


def flash_device_ops(kattn, gen):
    """One ``flash_attention`` call on the model's views at the decoder's
    shape, with gradients on (as in the train step), must run exactly one
    device operation: no copy in, none out."""
    shape = FLASH_SHAPES[0]
    _, (q, k, v) = flash_inputs(shape, torch.bfloat16, gen, model_views=True)
    kattn.flash_attention(q, k, v)  # warm
    n = len(device_spans(lambda: kattn.flash_attention(q, k, v).transpose(1, 2)
                         .reshape(shape[0], shape[2], shape[1] * shape[3])))
    require(n == 1, f"flash_attention on the model's views ran {n} device operations, not 1")
    say(f"flash_attention on the model's views {list(shape)} bfloat16 (with the caller's"
        f" transpose and reshape): {n} device operation")


def measure_plain_conv(kconv, B, H, W, C, K, dtype, gen):
    dev = gen.device
    x = torch.randn((B, H, W, C), generator=gen, device=dev).to(dtype)
    w = torch.randn((3, 3, C, K), generator=gen, device=dev) / (9 * C) ** 0.5
    wf = kconv.conv3x3_filter(w, x.dtype)  # the wrapper's own preparation
    got = kconv.conv3x3(x, w)
    want = kconv.conv3x3_reference(x.float(), w)
    xc, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(dtype)
    n_bytes = (B * H * W * (C + K) + 9 * C * K) * x.element_size()
    n_ops = B * H * W * 2 * 9 * C * K
    return _report(got, want, dtype, n_bytes, n_ops,
                   lambda: kconv.conv3x3_launch(x, wf),
                   lambda: kconv.conv3x3_reference(x, w),
                   lambda: F.conv2d(xc, w_oihw, padding=1),
                   peak=PEAK_3XTF32_OPS_PER_S if dtype == torch.float32 else None)


KERNELS = {
    "dwblock_bn_silu": dict(
        source="jolineedle_tpu_torch/csrc/dwblock_bn_silu.cu",
        replaces="jolineedle_tpu/ops/conv.py:125",
        measure=measure_dwblock,
    ),
    "conv3x3_bn_silu": dict(
        source="jolineedle_tpu_torch/csrc/conv3x3_bn_silu.cu",
        replaces="jolineedle_tpu/ops/conv.py:68",
        measure=measure_conv3x3,
    ),
    "flash_attention": dict(
        source="jolineedle_tpu_torch/csrc/flash_attention.cu",
        replaces="jolineedle_tpu/ops/attention.py:101",
    ),
    "conv3x3": dict(
        source="jolineedle_tpu_torch/csrc/conv3x3.cu",
        replaces="scripts/smoke_pallas_conv.py:67",
    ),
}


def kernel_phase(kconv, shapes, seed):
    """Every (kernel, shape) of the path in both dtypes at N = 32 patches,
    each dwblock shape of the B = 1 request (N = 1) in bfloat16, and the
    supervised eval's largest calls in bfloat16: the embedder's shapes at
    N = SUP_EMBED_N (the teacher-forced eval's B x T patches), the
    detector's at N = SUP_DET_N (a chunk of eval episodes); and the
    embedder's shapes of the full-prefix rollout (B x STEPS patches per step)
    at each of FULL_PREFIX_RUNS' batch and dtype; returns rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    per_call = shapes["embedder"] + shapes["detector"]
    runs = [(key, dtype, N_PATCHES) for key in sorted(per_call)
            for dtype in (torch.float32, torch.bfloat16)]
    runs += [(key, torch.bfloat16, 1) for key in sorted(per_call) if key[0] == "dwblock_bn_silu"]
    runs += [(key, torch.bfloat16, SUP_EMBED_N) for key in sorted(shapes["embedder"])]
    runs += [(key, torch.bfloat16, SUP_DET_N) for key in sorted(shapes["detector"])]
    runs += [(key, dtype, b * STEPS) for b, dtype in FULL_PREFIX_RUNS
             for key in sorted(shapes["embedder"])]
    rows = []
    for (name, H, W, C, K), dtype, n in runs:
        r = KERNELS[name]["measure"](kconv, H, W, C, K, dtype, gen, n=n)
        r.update(name=name, shape=[n, H, W, C, K], dtype=DTYPE_NAMES[dtype],
                 per_embedder_call=shapes["embedder"][(name, H, W, C, K)],
                 per_detector_call=shapes["detector"][(name, H, W, C, K)])
        rows.append(r)
        b2b = f" (back to back {r['back_to_back_ms']:.4f})" if "back_to_back_ms" in r else ""
        say(f"kernel {name} x[{n},{H},{W},{C}]->{K} {DTYPE_NAMES[dtype]}:"
            f" {r['ms']:.4f} ms{b2b}, plain {r['plain_ms']:.4f} ms,"
            f" cuDNN {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms"
            f" ({r['bound_by']}), max |err| {r['max_abs_err']:.3g}")
    return rows


def wide_variant_phase(kconv, seed):
    """conv3x3_bn_silu at every dense stride-1 3x3 shape of the wide
    variant's detector at 448 px, N = 32 patches, both dtypes: rows held
    like the path's, but not on the path."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    per_call = dense_conv_shapes(WIDE_VARIANT)
    rows = []
    for (H, W, C, K), n in sorted(per_call.items()):
        for dtype in (torch.float32, torch.bfloat16):
            r = measure_conv3x3(kconv, H, W, C, K, dtype, gen)
            r.update(name="conv3x3_bn_silu", variant=WIDE_VARIANT,
                     shape=[N_PATCHES, H, W, C, K], dtype=DTYPE_NAMES[dtype],
                     per_detector_call=n)
            rows.append(r)
            say(f"kernel conv3x3_bn_silu ({WIDE_VARIANT}, {n} per detector call)"
                f" x[{N_PATCHES},{H},{W},{C}]->{K} {DTYPE_NAMES[dtype]}: {r['ms']:.4f} ms,"
                f" plain {r['plain_ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms, bound"
                f" {r['bound_ms']:.4f} ms ({r['bound_by']}), max |err| {r['max_abs_err']:.3g}")
    return rows


def new_kernel_phase(port, seed):
    """The flash kernel and the plain 3x3 conv at their shapes, both dtypes;
    flash also at the full-prefix rollout's shapes, each in its own dtype,
    and at head dim 128 (``FLASH_D128_SHAPES``) in both."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    runs = [(shape, dtype, shape == FLASH_SHAPES[0]) for shape in FLASH_SHAPES
            for dtype in (torch.float32, torch.bfloat16)]
    runs += [((b, 3, STEPS + 1, 16), dtype, True) for b, dtype in FULL_PREFIX_RUNS]
    runs += [(shape, dtype, False) for shape in FLASH_D128_SHAPES
             for dtype in (torch.float32, torch.bfloat16)]
    rows = []
    for shape, dtype, views in runs:
        r = measure_flash(port.kattn, shape, dtype, gen, model_views=views)
        r.update(name="flash_attention", shape=list(shape), dtype=DTYPE_NAMES[dtype],
                 inputs="the model's c_attn views" if views else "contiguous")
        rows.append(r)
        say(f"kernel flash_attention {list(shape)} {DTYPE_NAMES[dtype]} ({r['inputs']}):"
            f" {r['ms']:.4f} ms (back to back {r['back_to_back_ms']:.4f}; backward,"
            f" PyTorch ops: {r['backward_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, SDPA"
            f" {r['library_ms']:.4f} ms (back to back {r['library_back_to_back_ms']:.4f}),"
            f" bound {r['bound_ms']:.6f} ms ({r['bound_by']}),"
            f" max |err| {r['max_abs_err']:.3g}, lse {r['lse_max_abs_err']:.3g},"
            f" gradients {r['grad_max_abs_err']:.3g}")
    flash_device_ops(port.kattn, gen)
    for shape in PLAIN_CONV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            r = measure_plain_conv(port.kconv, *shape, dtype, gen)
            r.update(name="conv3x3", shape=list(shape), dtype=DTYPE_NAMES[dtype])
            rows.append(r)
            say(f"kernel conv3x3 {list(shape)} {DTYPE_NAMES[dtype]}: {r['ms']:.4f} ms, plain"
                f" {r['plain_ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms, bound"
                f" {r['bound_ms']:.4f} ms ({r['bound_by']}), max |err| {r['max_abs_err']:.3g}")
    return rows


def kernels_json(rows, new_rows, wide_rows, recipe_rows, launches, by_path):
    """One entry per kernel. The fused conv blocks: their numbers summed over
    the launches of one detector call (bfloat16, the serving dtype), each
    shape in ``shapes``. Flash attention: one teacher-forced forward of the
    train step (3 launches at the decoder's shape, bfloat16). The plain 3x3
    conv: one call at the smoke script's default (bfloat16). dwblock's rows
    at N = 1 (the B = 1 request), the fused blocks' rows at the
    supervised eval's and the full-prefix rollout's N, and flash's rows at
    the full-prefix shapes are in ``shapes``, outside the totals.
    ``launches``
    sums every path's count, the data-parallel ranks' (``ddp``) included;
    ``launches_by_path`` splits it. The wide
    variant's rows go under conv3x3_bn_silu's ``wide_variant_shapes``, and
    the recipe's (64 px patches, phase 11c) under the fused blocks'
    ``recipe_shapes``, outside the totals."""
    keys = ("shape", "dtype", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    out = []
    for name, info in KERNELS.items():
        if name in ("dwblock_bn_silu", "conv3x3_bn_silu"):
            mine = [r for r in rows if r["name"] == name]
            main = [(r, r["per_detector_call"]) for r in mine
                    if r["dtype"] == "bfloat16" and r["shape"][0] == N_PATCHES]
            timed_as = f"one detector call's launches at N={N_PATCHES} patches of {PATCH} px, bfloat16"
            extra = ("per_embedder_call", "per_detector_call")
            if name == "dwblock_bn_silu":
                extra += ("back_to_back_ms",)
        else:
            mine = [r for r in new_rows if r["name"] == name]
            first = [r for r in mine if r["dtype"] == "bfloat16"][0]
            main = [(first, N_LAYER if name == "flash_attention" else 1)]
            timed_as = (f"one teacher-forced forward ({N_LAYER} launches) at {first['shape']},"
                        " bfloat16" if name == "flash_attention"
                        else f"one call at the smoke default {first['shape']}, bfloat16")
            extra = (("inputs", "back_to_back_ms", "library_back_to_back_ms", "lse_max_abs_err",
                      "grad_max_abs_err", "backward_ms") if name == "flash_attention" else ())
        total = lambda key: sum(r[key] * n for r, n in main)
        by = Counter()
        for r, n in main:
            by[r["bound_by"]] += r["bound_ms"] * n
        totals = ({"back_to_back_ms": total("back_to_back_ms")}
                  if name in ("dwblock_bn_silu", "flash_attention") else {})
        out.append({
            "name": name,
            "route": "cuda",
            "source": info["source"],
            "replaces": info["replaces"],
            "launches": launches[name],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r, _ in main),
            "ms": total("ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": by.most_common(1)[0][0],
            "library_ms": total("library_ms"),
            "timed_as": timed_as,
            **totals,
            "shapes": [{k: r[k] for k in keys + extra} for r in mine],
        })
        mine_recipe = [r for r in recipe_rows if r["name"] == name]
        if mine_recipe:
            out[-1]["recipe_shapes"] = [{k: r[k] for k in ("call",) + keys + ("per_call",)}
                                        for r in mine_recipe]
        if name == "conv3x3_bn_silu":
            out[-1]["wide_variant_shapes"] = [
                {k: r[k] for k in ("variant",) + keys + ("per_detector_call",)}
                for r in wide_rows]
    return out


# --- phase 4: the card against the CPU ------------------------------------------
REF_TOL = dict(atol=1e-3, rtol=1e-3)


def sharpen_head(state):
    """The state with a sharper action head and a damped STOP row, as the CPU
    tests use, so that greedy episodes walk with clear top-2 margins."""
    from jolineedle_tpu_torch.env.actions import Action

    state = dict(state)
    w = state["action_head.dense.weight"] * 50.0
    w[Action.STOP.value] *= 0.2
    state["action_head.dense.weight"] = w
    return state


def reference_phase(model_config, actions_info, state, seed):
    """The float32 model on the card against the same weights on the CPU."""
    from jolineedle_tpu_torch.models.gpt import GPT

    models = {}
    for dev in ("cuda", "cpu"):
        m = GPT.from_config(model_config, actions_info, compute_dtype="float32", device=dev)
        m.load_state_dict(sharpen_head(state))
        models[dev] = m.eval()
    rng = np.random.default_rng(seed)
    tol = REF_TOL

    patches = rng.integers(0, 256, (2, PATCH, PATCH, 3), dtype=np.uint8)
    with torch.no_grad():
        head = {d: m.yolox_outputs(torch.from_numpy(patches).to(d))[0] for d, m in models.items()}
    for key in ("boxes", "obj_logits", "cls_logits"):
        torch.testing.assert_close(head["cuda"][key].cpu(), head["cpu"][key], **tol, msg=key)

    B, T = 2, 3
    inputs = dict(
        patches=torch.from_numpy(rng.integers(0, 256, (B, T, PATCH, PATCH, 3), dtype=np.uint8)),
        actions=torch.from_numpy(rng.integers(0, 9, (B, T))),
        classes=torch.zeros(B, dtype=torch.long),
        positions=torch.from_numpy(rng.integers(0, GRID, (B, T, 2))),
    )
    with torch.no_grad():
        logits = {d: m(*(v.to(d) for v in inputs.values()))[0] for d, m in models.items()}
    torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"], **tol)
    say(f"reference: detector and decoder on the card match the CPU within {tol}")
    return models


def rollout_reference(models, train_config, seed):
    """A greedy rollout on the card against the CPU, step for step up to the
    first step whose action differs, which must be a near-tie (a top-2 logit
    gap within four times the logit tolerance may flip the argmax): logits,
    actions and positions until then. Near-ties whose action agrees are
    compared through."""
    from jolineedle_tpu_torch.train.rollout import eval_rollout, to_numpy

    rng = np.random.default_rng(seed + 1)
    images = rng.integers(0, 256, (2, 2 * PATCH, 3 * PATCH, 3), dtype=np.uint8)
    boxes = np.array([[[40, 40, 104, 88]], [[900, 500, 964, 548]]], np.float32)
    start = torch.tensor([[0, 0], [1, 2]])
    ro = {d: to_numpy(eval_rollout(m, images, boxes, train_config, positions=start,
                                   device=d, collect=("logits", "actions")))
          for d, m in models.items()}
    top2 = np.sort(ro["cpu"]["logits"], axis=-1)[..., -2:]
    margin = 4 * (REF_TOL["atol"] + REF_TOL["rtol"] * np.abs(top2[..., 1]))
    near = (top2[..., 1] - top2[..., 0]) < margin  # [B, T]
    differ = ro["cuda"]["actions"] != ro["cpu"]["actions"]
    flips = np.nonzero(differ.any(0))[0]
    t_end = int(flips[0]) if len(flips) else STEPS
    require(t_end == STEPS or near[differ[:, t_end], t_end].all(),
            f"reference rollout: the card's action differs from the CPU's at step {t_end}"
            " without a near-tie")
    np.testing.assert_allclose(ro["cuda"]["logits"][:, : t_end + 1],
                               ro["cpu"]["logits"][:, : t_end + 1], **REF_TOL)
    np.testing.assert_array_equal(ro["cuda"]["positions"][:, : t_end + 1],
                                  ro["cpu"]["positions"][:, : t_end + 1])
    say(f"reference: greedy rollout on the card matches the CPU for {t_end} of {STEPS} steps"
        f" ({int(near[:, :t_end].any(0).sum())} of them near-ties)")


def train_reference(models, state, train_config, seed):
    """The REINFORCE loss and its gradients on the card against the CPU, on
    one sampled rollout record of the CPU model (2 images of 2x3 patches, 3
    steps): the flash kernel's backward and the autograd convs of the
    recompute forward. Each gradient leaf within 1e-3 of its largest entry;
    and the train-mode detector's SimOTA loss within ``REF_TOL``."""
    from jolineedle_tpu_torch.env.batched_env import NeedleEnv
    from jolineedle_tpu_torch.ops.augment import detection_augment
    from jolineedle_tpu_torch.ops.simota import yolox_losses
    from jolineedle_tpu_torch.train.reinforce import reinforce_loss
    from jolineedle_tpu_torch.train.rollout import rollout

    for m in models.values():  # the unsharpened head: softmax gradients of size
        m.load_state_dict(state)
    rng = np.random.default_rng(seed + 2)
    images = rng.integers(0, 256, (2, 2 * PATCH, 3 * PATCH, 3), dtype=np.uint8)
    boxes = np.array([[[40, 40, 300, 88]], [[500, 500, 964, 548]]], np.float32)
    envs = {d: NeedleEnv(images, boxes, PATCH, 3, 1, True, device=m.device)
            for d, m in models.items()}
    ro = rollout(models["cpu"], envs["cpu"], sample=True,
                 generator=torch.Generator().manual_seed(seed), collect=("actions",))
    ro.pop("final_state")
    grads, losses = {}, {}
    for d, m in models.items():
        m.zero_grad(set_to_none=True)
        loss, _ = reinforce_loss(m, envs[d], {k: v.to(m.device) for k, v in ro.items()}, 0.2, 1.3,
                                 train_config.entropy_weight)
        loss.backward()
        losses[d] = loss.item()
        grads[d] = {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                    if p.grad is not None}
    require(grads["cuda"].keys() == grads["cpu"].keys(), "train reference: gradient keys")
    require(abs(losses["cuda"] - losses["cpu"]) <= 1e-4 + 1e-4 * abs(losses["cpu"]),
            f"train reference: loss {losses['cuda']} on the card, {losses['cpu']} on the CPU")
    worst = 0.0
    for n, want in grads["cpu"].items():
        err = (grads["cuda"][n] - want).abs().max().item()
        limit = 1e-3 * want.abs().max().item() + 1e-6
        require(err <= limit, f"train reference: d{n} off by {err} (limit {limit})")
        worst = max(worst, err / limit)
    patches, targets, valid = envs["cpu"].get_detection_batch(
        torch.Generator().manual_seed(seed), 4)
    det = detection_augment(torch.Generator().manual_seed(seed), patches)
    det_loss = {}
    for d, m in models.items():
        head, _ = m.yolox_outputs(det.reshape((-1,) + det.shape[2:]).to(m.device), train=True)
        det_loss[d] = yolox_losses(head, targets.reshape((-1,) + targets.shape[2:]).to(m.device),
                                   valid.reshape(-1).to(m.device))["total_loss"].item()
    require(abs(det_loss["cuda"] - det_loss["cpu"])
            <= REF_TOL["atol"] + REF_TOL["rtol"] * abs(det_loss["cpu"]),
            f"train reference: detection loss {det_loss}")
    say(f"reference: REINFORCE loss {losses['cuda']:.6f} (CPU {losses['cpu']:.6f}) and its"
        f" {len(grads['cpu'])} gradients match the CPU (the worst at {worst:.2f} of its limit);"
        f" detection loss {det_loss['cuda']:.4f} (CPU {det_loss['cpu']:.4f})")


def supervised_batch(rng):
    """A fixed supervised batch as ``build_supervised_batch`` shapes it, made
    with numpy: 2 episodes of 3 steps with live prefixes, STOP among the
    labels, 2 x MAX_DET_PATCHES detector patches of which one is padding
    (zero pixels, not valid), a box in each valid one."""
    B, T, K = 2, 3, MAX_DET_PATCHES
    masks = np.ones((B, T), np.float32)
    masks[1, T - 1] = 0
    ref = rng.integers(0, 9, (B, T))
    ref[0, 1] = 8  # STOP
    valid = np.ones((B, K), bool)
    valid[-1, -1] = False
    det = rng.integers(0, 256, (B, K, PATCH, PATCH, 3), dtype=np.uint8)
    det[~valid] = 0
    boxes = np.zeros((B, K, 4, 6), np.float32)
    boxes[:, :, 0] = [0, 40, 60, 300, 200, 1]
    boxes[~valid] = 0
    return {
        "patches": rng.integers(0, 256, (B, T, PATCH, PATCH, 3), dtype=np.uint8),
        "current_actions": rng.integers(0, 9, (B, T)),
        "class_id": np.zeros((B,), np.int64),
        "positions": rng.integers(0, GRID, (B, T, 2)),
        "reference_actions": ref,
        "masks": masks,
        "patches_yolox": det,
        "bboxes_yolox": boxes,
        "yolox_valid": valid,
    }


def supervised_reference(models, state, seed):
    """The supervised loss on the card against the CPU, on one fixed,
    un-augmented batch (2 episodes of 3 steps, 2 x 4 detector patches; the
    float32 model, dropout 0, a STOP class weight of 2): the decision CE of
    the train-mode teacher-forced forward plus the train-mode detector's
    SimOTA loss (``train/supervised.py``'s ``decision_loss`` then
    ``detection_loss``), held as the REINFORCE check holds its loss and
    gradients; and the BN running statistics both forwards leave behind
    (the embedder's, then the detector's, updated in place), within
    ``REF_TOL``."""
    from jolineedle_tpu_torch.train.supervised import decision_loss, detection_loss

    batch = supervised_batch(np.random.default_rng(seed + 3))
    weight = torch.ones(9)
    weight[8] = 2.0
    losses, grads, stats = {}, {}, {}
    for d, m in models.items():
        m.load_state_dict(state)  # the REINFORCE check moved the detector's statistics
        m.zero_grad(set_to_none=True)
        dev = {k: torch.from_numpy(v).to(m.device) for k, v in batch.items()}
        unit = lambda x: x.float() / 255.0  # the augmentation's output range
        al, _ = decision_loss(m, unit(dev["patches"]), dev, weight.to(m.device))
        ylo = detection_loss(m, unit(dev["patches_yolox"]), dev)
        loss = al + ylo["total_loss"]
        loss.backward()
        losses[d] = (loss.item(), al.item(), ylo["total_loss"].item())
        grads[d] = {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                    if p.grad is not None}
        stats[d] = {k: v.detach().cpu() for k, v in m.state_dict().items() if "running_" in k}
    (loss_c, al_c, yl_c), (loss_h, al_h, yl_h) = losses["cuda"], losses["cpu"]
    require(abs(loss_c - loss_h) <= 1e-4 + 1e-4 * abs(loss_h),
            f"supervised reference: loss {losses['cuda']} on the card, {losses['cpu']} on the CPU")
    require(grads["cuda"].keys() == grads["cpu"].keys(), "supervised reference: gradient keys")
    worst = 0.0
    for n, want in grads["cpu"].items():
        err = (grads["cuda"][n] - want).abs().max().item()
        limit = 1e-3 * want.abs().max().item() + 1e-6
        require(err <= limit, f"supervised reference: d{n} off by {err} (limit {limit})")
        worst = max(worst, err / limit)
    moved = 0
    for k, want in stats["cpu"].items():
        torch.testing.assert_close(stats["cuda"][k], want, **REF_TOL, msg=k)
        moved += not torch.equal(want, state[k].cpu())
    require(moved == len(stats["cpu"]), f"supervised reference: {len(stats['cpu']) - moved}"
            " BN statistics did not move")
    say(f"reference: supervised loss {loss_c:.6f} (CPU {loss_h:.6f}; CE {al_c:.6f}, SimOTA"
        f" {yl_c:.4f}) and its {len(grads['cpu'])} gradients match the CPU (the worst at"
        f" {worst:.2f} of its limit); the {moved} BN statistics the two forwards updated"
        f" match within {REF_TOL}")


# --- phase 5: serve ----------------------------------------------------------------
def randomize_bn(model, seed):
    """Non-trivial BN running statistics and affine terms, from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.3)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)


def require(ok, what: str) -> None:
    """A check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def read_launches(port) -> dict:
    """The four wrappers' counters (``counted``: their launches on the card)."""
    return {k: getattr(w, counted()) for k, w in (
        ("dwblock_bn_silu", port.kconv.dwblock_bn_silu),
        ("conv3x3_bn_silu", port.kconv.conv3x3_bn_silu), ("conv3x3", port.kconv.conv3x3),
        ("flash_attention", port.kattn.flash_attention))}


def reset_launches(port) -> None:
    port.kconv.reset_counts()
    port.kattn.reset_counts()


def check_launches(port, what, expected):
    """The four counters against ``expected`` (kernels it omits: 0)."""
    expected = {name: expected.get(name, 0) for name in KERNEL_NAMES}
    got = read_launches(port)
    if got != expected:
        raise AssertionError(f"{what}: kernel launches {got}, expected {expected}")
    say(f"{what}: kernel launches {got} as expected")
    return got


def serve_phase(port, model_dir, seed):
    from jolineedle_tpu_torch.infer import infer_image, load_model_dir
    from jolineedle_tpu_torch.train.rollout import eval_rollout

    train_config, _, model = load_model_dir(model_dir)  # on the card
    per = EXPECTED_PER_CALL  # path_shapes checked the module tree against it
    rng = np.random.default_rng(seed)
    side = GRID * PATCH
    images, targets = [], []
    for _ in range(4):
        images.append(rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
        xy = rng.integers(0, side - 80, (2, 2))
        targets.append(np.concatenate([xy, xy + [64, 48]], 1).astype(np.float32))

    infer_image(model, train_config, images[0], targets[0], seed=0)  # warm-up
    torch.cuda.synchronize()
    reset_launches(port)
    request_ms = []
    for i, (image, boxes) in enumerate(zip(images, targets)):
        out = infer_image(model, train_config, image, boxes, seed=i)
        request_ms.append(out["request_ms"])
        ro = out["rollout"]
        require(out["positions"].shape == (STEPS + 1, 2), f"request {i}: positions shape")
        require(all(np.isfinite(ro[k]).all() for k in ("rewards", "logprobs", "entropies")),
                f"request {i}: non-finite rollout values")
        if out["preds"] is not None:
            require(out["preds"].shape[1] == 7 and np.isfinite(out["preds"]).all(),
                    f"request {i}: malformed detections")
        say(f"request {i}: {out['request_ms']:.2f} ms ({out['rollout_ms']:.2f} ms rollout),"
            f" {out['positions'].shape[0]} steps ({out['n_valid']} before STOP),"
            f" {out['obj_count']} objects found, returns {out['metrics']['returns']:.4f}")
    n = len(images)
    launches = Counter(check_launches(port, f"{n} requests", {
        k: n * (STEPS * per["embedder"][k] + per["detector"][k]) for k in per["embedder"]}))

    # One greedy batched rollout at B = 32 over images made on the card.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = torch.randint(0, 256, (N_PATCHES, side, side, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    xy = rng.integers(0, side - 80, (N_PATCHES, 2, 2))
    boxes = np.concatenate([xy, xy + [64, 48]], -1).astype(np.float32)
    def run():  # greedy; the generator draws the reset positions
        reset = torch.Generator(device="cuda").manual_seed(seed)
        return eval_rollout(model, batch, boxes, train_config, generator=reset)

    run()  # warm-up
    torch.cuda.synchronize()
    reset_launches(port)
    start = time.perf_counter()
    ro = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches += check_launches(port, f"batched rollout B={N_PATCHES}", {
        k: STEPS * per["embedder"][k] for k in per["embedder"]})
    require(ro["positions"].shape == (N_PATCHES, STEPS + 1, 2), "batched rollout: positions shape")
    require(bool(torch.isfinite(ro["logprobs"]).all() and torch.isfinite(ro["rewards"]).all()),
            "batched rollout: non-finite values")
    require(bool(((ro["positions"] >= 0) & (ro["positions"] < GRID)).all()),
            "batched rollout: a position left the grid")
    say(f"batched rollout B={N_PATCHES}: {seconds * 1e3:.2f} ms for {STEPS} steps,"
        f" {N_PATCHES * STEPS / seconds:.1f} env steps/s")

    # Where the time goes, traced after the counted runs.
    profile_run("request 0", request_ms[0],
                lambda: infer_image(model, train_config, images[0], targets[0], seed=0))
    profile_run(f"batched rollout B={N_PATCHES}", seconds * 1e3, run)
    return launches


# The device symbols of the port's kernels (the tile's second template
# argument is its BN + SiLU flag), for their totals in a profile.
PORT_KERNEL_SYMBOLS = {
    "conv3x3_bn_silu": "conv3x3_tile_kernel<__nv_bfloat16, true",
    "conv3x3": "conv3x3_tile_kernel<__nv_bfloat16, false",
    "dwblock_bn_silu": "dwblock_kernel<",
    "flash_attention": "flash_fwd_kernel<",
}


def device_spans(fn) -> list:
    """(start, end, name) of every device operation (kernels, copies,
    fills) that ``fn`` runs, by ``torch.profiler``, in start order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA)


def profile_run(what, untraced_ms, fn, top=8, unit=("rollout step", STEPS)):
    """``fn`` once under ``torch.profiler``: the device's busy time (the
    union of the traced kernel and copy intervals) against ``untraced_ms``,
    the same work's wall time without the profiler (which adds host time of
    its own), the device operations per ``unit``, the ``top`` kernels by
    device time, and the bf16 port kernels' totals. Returns the device
    operations per ``unit`` and a Counter of their names (None, None when
    nothing was traced)."""
    spans = device_spans(fn)
    if not spans:
        say(f"profile {what}: the profiler traced no device time; busy share not measured")
        return None, None
    busy_us, end = 0.0, -math.inf
    by_name = defaultdict(lambda: [0, 0.0])
    for s, e, name in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
        by_name[name][0] += 1
        by_name[name][1] += e - s
    copies = [e - s for s, e, name in spans if name.startswith("Memcpy")]
    say(f"profile {what}: device busy {busy_us / 1e3:.2f} ms of {untraced_ms:.2f} ms"
        f" untraced wall ({busy_us / 1e3 / untraced_ms:.1%}),"
        f" {len(spans) / unit[1]:.0f} device operations per {unit[0]} ({len(copies) / unit[1]:.0f}"
        f" of them memory copies, {sum(copies) / 1e3 / unit[1]:.2f} ms)")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        say(f"  {us / 1e3:9.3f} ms {n:6d}x {name[:100]}")
    for kernel, pattern in PORT_KERNEL_SYMBOLS.items():
        hits = [v for name, v in by_name.items() if pattern in name]
        if hits:
            say(f"  port kernel {kernel}: {sum(us for _, us in hits) / 1e3:.3f} ms in"
                f" {sum(n for n, _ in hits)} launches")
    return len(spans) / unit[1], Counter({name: n for name, (n, _) in by_name.items()})


# --- phase 6: the JAX package's files ------------------------------------------------
def _same_preds(a, b) -> bool:
    return (a is None and b is None) or (a is not None and b is not None
                                         and np.array_equal(a, b))


def jax_files_phase(port, model_dir, seed):
    """Serving what the JAX package writes, with the port alone: a run
    directory whose best checkpoint is flax msgpack, a ported-weights
    detector through ``--detection-checkpoint``, and the port's weight
    script on an upstream-layout state dict. Returns the launch counts."""
    from jolineedle_tpu_torch import checkpoint as ckpt
    from jolineedle_tpu_torch.env.oracle import gather_patches
    from jolineedle_tpu_torch.infer import infer_image, load_model_dir
    from jolineedle_tpu_torch.models.bridge import torch_to_flax, yolox_torch_to_flax
    from jolineedle_tpu_torch.scripts import port_yolox_weights

    per = EXPECTED_PER_CALL
    root = model_dir.parent / "jax_files"
    shutil.rmtree(root, ignore_errors=True)
    train_config, model_config, model = load_model_dir(model_dir)
    state = model.state_dict()

    # A JAX run directory: the same weights as flax msgpack, the same config.
    run_dir = root / "run"
    run_dir.mkdir(parents=True)
    shutil.copy(model_dir / "config.json", run_dir / "config.json")
    ckpt.write_msgpack(run_dir / ckpt.FLAX_BEST, torch_to_flax(state, model))
    _, _, jmodel = load_model_dir(run_dir)
    require(all(torch.equal(jmodel.state_dict()[k], v) for k, v in state.items()
                if not k.endswith("num_batches_tracked")),
            "jax files: the msgpack run directory did not load the .pt weights bit for bit")
    rng = np.random.default_rng(seed + 5)
    side = GRID * PATCH
    images = [rng.integers(0, 256, (side, side, 3), dtype=np.uint8) for _ in range(2)]
    targets = [np.concatenate([xy, xy + [64, 48]], 1).astype(np.float32)
               for xy in (rng.integers(0, side - 80, (2, 2)) for _ in images)]
    def heads(models, image, out):
        """Each model's raw detector outputs on the request's visited patches."""
        patches = torch.from_numpy(gather_patches(image, out["positions"][: out["n_valid"]],
                                                  PATCH)).cuda()
        with torch.no_grad():
            return [m.yolox_outputs(patches)[0] for m in models]

    reset_launches(port)
    for i, (image, boxes) in enumerate(zip(images, targets)):
        want = infer_image(model, train_config, image, boxes, seed=i)
        got = infer_image(jmodel, train_config, image, boxes, seed=i)
        require(np.array_equal(got["positions"], want["positions"])
                and got["n_valid"] == want["n_valid"] and _same_preds(got["preds"], want["preds"]),
                f"jax files: request {i} from the msgpack directory differs from the .pt one")
        h_pt, h_msgpack = heads((model, jmodel), image, want)
        require(all(torch.equal(h_pt[k], h_msgpack[k]) for k in ("boxes", "obj_logits",
                                                                 "cls_logits")),
                f"jax files: request {i}: the detector's outputs differ")
        say(f"jax files: request {i} from checkpoint_best.msgpack = from checkpoint_best.pt:"
            f" positions, {want['n_valid']} steps before STOP, {want['obj_count']} boxes and the"
            " detector's raw outputs on the visited patches equal")

    # --detection-checkpoint: the detector of another model, as a ported-weights file.
    torch.manual_seed(seed + 1)
    other = port.GPT.from_config(model_config, port.get_actions_info(train_config)).eval()
    randomize_bn(other, seed + 1)
    det_path = ckpt.write_msgpack(root / "detector.msgpack",
                                  yolox_torch_to_flax(other.yolox.state_dict(), other.yolox))
    dtrain, _, dmodel = load_model_dir(model_dir, detection_checkpoint=det_path)
    dstate = dmodel.state_dict()
    require(all(torch.equal(dstate[k], v) for k, v in state.items() if not k.startswith("yolox.")),
            "jax files: --detection-checkpoint changed a decision weight")
    out = infer_image(dmodel, dtrain, images[0], targets[0], seed=0)
    got, want = heads((dmodel, other), images[0], out)
    for key in ("boxes", "obj_logits", "cls_logits"):
        require(torch.equal(got[key], want[key]),
                f"jax files: {key} of the loaded detector differ from the other model's")
    launches = check_launches(port, "jax files (5 requests, 6 detector calls)", {
        k: 5 * (STEPS * per["embedder"][k] + per["detector"][k]) + 6 * per["detector"][k]
        for k in per["embedder"]})
    say(f"jax files: --detection-checkpoint gave the other model's detector outputs on the"
        f" {out['n_valid']} visited patches exactly; the decision weights stayed")

    # Upstream (Megvii) weights with COCO's 80 classes through the port's script.
    upstream = {k: v.cpu().clone() for k, v in other.yolox.state_dict().items()}
    cls_keys = [k for k in upstream if ".cls_preds." in k]
    gen = torch.Generator().manual_seed(seed + 2)
    for k in cls_keys:
        upstream[k] = torch.randn((80,) + tuple(upstream[k].shape[1:]), generator=gen)
    pth = root / "yolox_coco.pth"
    torch.save({"model": upstream}, pth)
    skipped = port_yolox_weights.main(["--checkpoint", str(pth), "--variant",
                                       model_config.image_processor, "--output",
                                       str(root / "ported.msgpack")])
    require(sorted(skipped) == sorted(cls_keys) and len(cls_keys) == 6,
            f"jax files: the script skipped {skipped}")
    ckpt.load_detection_params(root / "ported.msgpack", dmodel)
    got = dmodel.yolox.state_dict()
    arrived = [k for k in upstream if k not in cls_keys and not k.endswith("num_batches_tracked")]
    require(all(torch.equal(got[k].cpu(), upstream[k]) for k in arrived),
            "jax files: a tensor of the upstream checkpoint did not arrive")
    require(all(got[k].shape[0] == 1 for k in cls_keys), "jax files: cls_preds class count")
    say(f"jax files: scripts/port_yolox_weights.py ported {len(arrived)} tensors of an 80-class"
        f" upstream state dict and skipped the {len(skipped)} cls_preds tensors")
    return Counter(launches)


# --- phase 7: the full-prefix rollout -------------------------------------------------
def full_prefix_phase(port, model_dir, state, seed):
    """``--no-recurrent-embedding`` on the card: the float32 model with the
    sharpened head, full-prefix against KV-cache rollouts at B = 4 (greedy:
    the same positions and masks, logits within REF_TOL; sampled from one
    generator: the same actions), then one bf16 request served from a model
    directory whose config.json sets the flag. Each full-prefix rollout
    launches the flash kernel once per layer per step (at [B, 3, STEPS + 1,
    16]) and the embedder's conv kernels once per step, over B x STEPS
    patches. Returns the launch counts of the full-prefix runs."""
    from jolineedle_tpu_torch.infer import infer_image, load_model_dir
    from jolineedle_tpu_torch.train.rollout import eval_rollout, to_numpy

    per = EXPECTED_PER_CALL
    train_config, model_config = port.tconfig.config_from_file(model_dir / "config.json")
    model = port.GPT.from_config(model_config, port.get_actions_info(train_config),
                                 compute_dtype="float32").eval()
    model.load_state_dict(sharpen_head(state))
    rng = np.random.default_rng(seed + 6)
    side = GRID * PATCH
    images = torch.from_numpy(rng.integers(0, 256, (FULL_PREFIX_B, side, side, 3),
                                           dtype=np.uint8)).cuda()
    xy = rng.integers(0, side - 80, (FULL_PREFIX_B, 2, 2))
    boxes = np.concatenate([xy, xy + [64, 48]], -1).astype(np.float32)
    start = torch.from_numpy(rng.integers(0, GRID, (FULL_PREFIX_B, 2)))
    rollout_launches = {"flash_attention": N_LAYER * STEPS,
                        **{k: STEPS * per["embedder"][k] for k in per["embedder"]}}

    def run(full_prefix, sample):
        model.no_recurrent_embedding = full_prefix
        gen = torch.Generator(device="cuda").manual_seed(seed)
        reset_launches(port)
        start_s = time.perf_counter()
        ro = to_numpy(eval_rollout(model, images, boxes, train_config, sample=sample,
                                   generator=gen, positions=start,
                                   collect=("logits", "actions")))
        ms = (time.perf_counter() - start_s) * 1e3
        if full_prefix:
            counts = check_launches(port, f"full-prefix rollout B={FULL_PREFIX_B}"
                                    f" ({'sampled' if sample else 'greedy'})", rollout_launches)
        else:
            counts = check_launches(port, f"KV-cache rollout B={FULL_PREFIX_B}",
                                    {k: STEPS * per["embedder"][k] for k in per["embedder"]})
        return ro, ms, Counter(counts) if full_prefix else Counter()

    run(False, False)  # warm-ups
    run(True, False)
    cached, cached_ms, _ = run(False, False)
    full, full_ms, launches = run(True, False)
    for key in ("positions", "masks", "actions"):
        require(np.array_equal(full[key], cached[key]),
                f"full prefix: greedy {key} differ from the KV-cache rollout's")
    err = float(np.abs(full["logits"] - cached["logits"]).max())
    np.testing.assert_allclose(full["logits"], cached["logits"], **REF_TOL)
    moved = int((np.abs(np.diff(full["positions"], axis=1)).sum(-1) > 0).sum())
    say(f"full prefix: greedy B={FULL_PREFIX_B} float32 rollout = the KV-cache rollout"
        f" (positions, masks, actions equal; logits max |diff| {err:.3g}; {moved} moves of"
        f" {FULL_PREFIX_B * STEPS}); {full_ms:.2f} ms against {cached_ms:.2f} ms")
    s_cached, _, _ = run(False, True)
    s_full, s_ms, counts = run(True, True)
    launches += counts
    for key in ("actions", "positions", "masks"):
        require(np.array_equal(s_full[key], s_cached[key]),
                f"full prefix: sampled {key} differ from the KV-cache rollout's")
    say(f"full prefix: sampled B={FULL_PREFIX_B} rollout from one generator takes the KV-cache"
        f" rollout's actions ({s_ms:.2f} ms; {int((s_full['actions'] != full['actions']).sum())}"
        f" of {FULL_PREFIX_B * STEPS} differ from the greedy ones)")
    for full_prefix, ms in ((False, cached_ms), (True, full_ms)):
        profile_run(f"{'full-prefix' if full_prefix else 'KV-cache'} rollout B={FULL_PREFIX_B}"
                    " float32", ms, lambda: run(full_prefix, False))

    # One bf16 request from a model directory whose config.json sets the flag.
    fp_dir = model_dir.parent / "full_prefix"
    fp_dir.mkdir(parents=True, exist_ok=True)
    config = json.loads((model_dir / "config.json").read_text())
    config["model"]["no_recurrent_embedding"] = True
    (fp_dir / "config.json").write_text(json.dumps(config, indent=4))
    shutil.copy(model_dir / "checkpoint_best.pt", fp_dir / "checkpoint_best.pt")
    fp_train, _, fp_model = load_model_dir(fp_dir)
    require(fp_model.no_recurrent_embedding and fp_model.compute_dtype == torch.bfloat16,
            "full prefix: the served model")
    image = images[0].cpu().numpy()
    infer_image(fp_model, fp_train, image, boxes[0], seed=0)  # warm-up
    torch.cuda.synchronize()
    reset_launches(port)
    out = infer_image(fp_model, fp_train, image, boxes[0], seed=0)
    launches += Counter(check_launches(port, "full-prefix request (bf16)", {
        "flash_attention": N_LAYER * STEPS,
        **{k: STEPS * per["embedder"][k] + per["detector"][k] for k in per["embedder"]}}))
    require(out["positions"].shape == (STEPS + 1, 2)
            and np.isfinite(out["rollout"]["logprobs"]).all(), "full prefix: the request")
    say(f"full prefix: bf16 request {out['request_ms']:.2f} ms ({out['rollout_ms']:.2f} ms"
        f" rollout), {out['n_valid']} steps before STOP, {out['obj_count']} objects found")
    return launches


# --- phase 8: the smoke-conv script ------------------------------------------------
def smoke_conv_phase(port):
    """``python -m jolineedle_tpu_torch.scripts.smoke_conv`` in-process, at
    its defaults: the path of the plain 3x3 conv kernel."""
    from jolineedle_tpu_torch.scripts import smoke_conv

    reset_launches(port)
    result = smoke_conv.main()
    iters = int(os.environ.get("SMOKE_ITERS", 50))
    # one checked call, one warm-up, then the timed calls
    counts = check_launches(port, "smoke_conv", {"conv3x3": iters + 2})
    require(result["max_abs_err"] <= TOLS[torch.bfloat16][0],
            f"smoke_conv: max error {result['max_abs_err']} against F.conv2d")
    say(f"smoke_conv {result['shape']}: kernel {result['kernel_us']} us, cuDNN"
        f" {result['cudnn_us']} us, max |err| {result['max_abs_err']:.3g}")
    return counts


# --- phase 9: the device data pool ----------------------------------------------------
def train_flags(data_dir, work_dir, seed, cache="auto"):
    flags = list(FLAGSHIP)
    flags[flags.index("--dataset-dir") + 1] = str(data_dir)
    flags[flags.index("--batch-size") + 1] = str(TRAIN_B)
    return flags + [
        "--work-dir", str(work_dir), "--seed", str(seed), "--env-name", "train",
        "--gradient-accumulation", str(TRAIN_ACCUM), "--max-iters", str(TRAIN_ITERS),
        "--test-every", "1000", "--test-samples", "2", "--num-workers", "4",
        "--device-data-cache", cache,
    ]


def with_augs(dataset, augs):
    """A shallow copy of ``dataset`` with the geometric augmentations
    ``augs`` (a subset of {"rotate", "translate"}) on."""
    dataset = copy.copy(dataset)
    dataset.rotations, dataset.translations = "rotate" in augs, "translate" in augs
    return dataset


def env_batch(port, dataset, config, indices, seed, with_pixels):
    """``ReinforceTrainer._build_env_batch`` of ``dataset`` without a
    trainer: it reads only the config, the dataset and the fixed shape."""
    owner = SimpleNamespace(config=config, train_dataset=dataset,
                            fixed_shape=port.fixed_training_shape(dataset, PATCH))
    return port.ReinforceTrainer._build_env_batch(owner, indices, seed, with_pixels=with_pixels)


def to_card(batch):
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def same_on_card(what, got, want):
    """uint8 device pixels against the host's, bit for bit."""
    want = torch.from_numpy(np.array(want)).to(DEVICE)  # a writable copy
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"{what}: {got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}")
    n_diff = int((got != want).sum())
    require(n_diff == 0, f"{what}: {n_diff} of {want.numel()} bytes differ from the host's")


def timed_gather(what, fn, out):
    """The median of 20 event-pair timings of ``fn`` beside its bound: each
    output byte read once from its source and written once."""
    ms = median_ms(fn)
    bound_ms = 2 * out.numel() * out.element_size() / HBM_BYTES_PER_S * 1e3
    say(f"  {what}: {ms:.4f} ms on the card, bound"
        f" {bound_ms:.4f} ms (bytes, {2 * out.numel() / 1e6:.1f} MB)")
    return ms


def pool_phase(port, seed, toy):
    """The device pool of the toy training set on the card: its bytes,
    decode and build times and peak memory; the three gathers against the
    host's gather of the same ``build_supervised_batch`` rows from one seed
    (B = TRAIN_B; augmentations off, rotate, translate and both) and
    ``aug_canvases`` at REINFORCE's fixed training shape against the host's
    padded images, all bit for bit and each timed; then, in float32, one
    train step of each trainer fed from the pool against one fed streamed
    pixels, from one seed on copies of one model, with and without the
    augmentations: equal losses (and REINFORCE returns) within rtol 1e-6."""
    from jolineedle_tpu_torch.data import device_pool as dp
    from jolineedle_tpu_torch.train.batching import build_supervised_batch

    flags = train_flags(toy, toy.parent / "pool", seed)
    train_config, model_config = port.tconfig.args_to_config(port.tconfig.get_args(flags))
    dataset, _ = port.build_both_datasets(train_config, model_config, toy)
    start = time.perf_counter()
    for i in range(len(dataset)):
        dataset.load_image(i)
    decode_s = time.perf_counter() - start
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    pool = dp.DeviceImagePool.build(dataset, DEVICE)
    build_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() - base
    side = GRID * PATCH
    require(tuple(pool.images.shape) == (len(dataset), side, side, 3)
            and pool.images.device.type == DEVICE and pool.images.dtype == torch.uint8,
            f"pool: {pool.images.dtype} {tuple(pool.images.shape)} on {pool.images.device}")
    for i in range(len(dataset)):
        same_on_card(f"pool image {i}", pool.images[i], dataset.load_image(i))
    say(f"pool: {len(dataset)} images, {pool.nbytes / 1e6:.1f} MB on the card, built in"
        f" {build_s * 1e3:.1f} ms after {decode_s * 1e3:.1f} ms of decoding; peak memory"
        f" +{peak / 2**30:.3f} GiB")

    indices = [i % len(dataset) for i in range(TRAIN_B)]
    for augs in ((), ("rotate",), ("translate",), ("rotate", "translate")):
        ds = with_augs(dataset, augs)
        with_px = build_supervised_batch(ds, indices, train_config, np.random.default_rng(seed))
        no_px = build_supervised_batch(ds, indices, train_config, np.random.default_rng(seed),
                                       with_pixels=False)
        dev = to_card(no_px)
        name = "+".join(augs) or "no augmentation"
        if augs:
            canvas = lambda: dp.aug_canvases(pool.images, dev["image_idx"], dev.get("aug_rot"),
                                             dev.get("aug_shift"), dev.get("base_hw"))
            canvases = canvas()
            gather = lambda pos: dp.gather_canvas_patches(canvases, dev[pos], PATCH)
        else:
            gather = lambda pos: dp.gather_pool_patches(pool.images, dev["image_idx"], dev[pos],
                                                        PATCH)
        patches = gather("positions")
        same_on_card(f"{name}: decision patches", patches, with_px["patches"])
        det = gather("yolox_positions") * dev["yolox_valid"][:, :, None, None, None].to(torch.uint8)
        same_on_card(f"{name}: detector patches", det, with_px["patches_yolox"])
        say(f"pool gathers, supervised B={TRAIN_B}, {name}: the decision and the detector"
            " patches bit-equal to the host's gather of the same rows")
        if augs:
            timed_gather(f"aug_canvases {tuple(canvases.shape)}", canvas, canvases)
        timed_gather(f"decision patches {tuple(patches.shape)}", lambda: gather("positions"),
                     patches)
        timed_gather(f"detector patches {tuple(det.shape)}", lambda: gather("yolox_positions"),
                     det)

    for augs in ((), ("rotate", "translate")):
        ds = with_augs(dataset, augs)
        fixed = port.fixed_training_shape(ds, PATCH)
        with_px = env_batch(port, ds, train_config, indices, seed, with_pixels=True)
        no_px = env_batch(port, ds, train_config, indices, seed, with_pixels=False)
        require(np.array_equal(with_px["bboxes"], no_px["bboxes"]), "REINFORCE pool batch: boxes")
        dev = to_card(no_px)
        name = "+".join(augs) or "no augmentation"
        if augs or tuple(pool.images.shape[1:3]) != fixed:
            images = lambda: dp.aug_canvases(pool.images, dev["image_idx"], dev.get("aug_rot"),
                                             dev.get("aug_shift"), dev.get("base_hw"),
                                             out_hw=fixed)
            how = f"aug_canvases at out_hw {fixed}"
        else:
            images = lambda: dp.gather_pool_images(pool.images, dev["image_idx"])
            how = "gather_pool_images"
        out = images()
        same_on_card(f"REINFORCE, {name}: {how}", out, with_px["image"])
        say(f"pool images, REINFORCE B={TRAIN_B}, {name}: {how} bit-equal to the host's"
            " padded images of the same rows")
        timed_gather(f"{how} {tuple(out.shape)}", images, out)
        upload_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            torch.from_numpy(with_px["image"]).to(DEVICE)
            torch.cuda.synchronize()
            upload_ms.append((time.perf_counter() - start) * 1e3)
        say(f"  the streamed route's upload of the same {with_px['image'].nbytes / 1e6:.1f} MB"
            f" from pageable memory: {statistics.median(upload_ms):.2f} ms (median of 3)")
    del canvases, patches, det, out
    route_equality(port, seed, toy, pool)
    return pool.nbytes


def route_equality(port, seed, toy, pool):
    """One float32 train step of each trainer fed from ``pool`` and one fed
    streamed pixels, from one seed on copies of one model, without and with
    both augmentations: the losses (and REINFORCE's returns) equal within
    rtol 1e-6. Each route's step wall time is printed beside the other's."""
    from jolineedle_tpu_torch.train.batching import build_supervised_batch

    indices = list(range(ROUTE_B))
    for mode, cls in (("supervised", port.SupervisedTrainer), ("reinforce", port.ReinforceTrainer)):
        flags = train_flags(toy, toy.parent / "route", seed)
        for flag, value in (("--training-mode", mode), ("--compute-dtype", "float32"),
                            ("--batch-size", ROUTE_B), ("--env-name", "route")):
            flags[flags.index(flag) + 1] = str(value)
        train_config, model_config = port.tconfig.args_to_config(port.tconfig.get_args(flags))
        dataset, test_dataset = port.build_both_datasets(train_config, model_config, toy)
        for augs in ((), ("rotate", "translate")):
            ds = with_augs(dataset, augs)
            torch.manual_seed(seed)
            model = port.GPT.from_config(model_config, port.get_actions_info(train_config),
                                         device=DEVICE)
            results = {}
            for route in ("pool", "stream"):
                trainer = cls(train_config, copy.deepcopy(model), None, ds, test_dataset,
                              device=DEVICE)
                trainer.pool = pool if route == "pool" else None
                if mode == "supervised":
                    batch = build_supervised_batch(ds, indices, train_config,
                                                   np.random.default_rng(seed),
                                                   with_pixels=route == "stream")
                else:
                    batch = trainer._build_env_batch(indices, seed, with_pixels=route == "stream")
                torch.cuda.synchronize()
                start = time.perf_counter()
                metrics = trainer.train_step(batch)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - start) * 1e3
                results[route] = ({k: float(metrics[k]) for k in ("loss", "returns")
                                   if k in metrics}, wall_ms)
                del trainer
            (got, got_ms), (want, want_ms) = results["pool"], results["stream"]
            name = f"{mode} B={ROUTE_B} float32, {'+'.join(augs) or 'no augmentation'}"
            for k, v in want.items():
                require(math.isfinite(v) and math.isclose(got[k], v, rel_tol=1e-6, abs_tol=0.0),
                        f"route equality, {name}: {k} {got[k]!r} from the pool, {v!r} streamed")
            say(f"route equality, {name}: " + ", ".join(
                f"{k} {got[k]:.6f} from the pool, {v:.6f} streamed" for k, v in want.items())
                + f" (first-step wall {got_ms:.2f} / {want_ms:.2f} ms)")
            del model


def timed_routes(port, trainer, batches, what, per_step, upload_bytes, rounds=3):
    """``rounds`` rounds of two steps (one that accumulates, one that
    updates) on each route's batch in turn (``batches``: route -> host
    batch), each step ending in a device sync: wall ms, device-clock phases,
    the bytes it uploads, peak memory and exact launches, and each route's
    median wall; then one profiled accumulating step of each route. Returns
    {route: device operations per step}."""
    if trainer.optimizer.mini_step:
        trainer.train_step(next(iter(batches.values())))  # start on an accumulating step
    walls = defaultdict(list)
    for _ in range(rounds):
        for route, batch in batches.items():
            for _ in range(2):
                trainer.phase_events = []
                updates = trainer.optimizer.updates
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches(port)
                start = time.perf_counter()
                trainer.train_step(batch)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - start) * 1e3
                walls[route].append(step_ms)
                check_launches(port, f"one {what} ({route})", per_step)
                marks = trainer.phase_events
                trainer.phase_events = None
                phases = {name: a.elapsed_time(b) for (_, a), (name, b) in zip(marks, marks[1:])}
                kind = "update" if trainer.optimizer.updates > updates else "accumulate"
                say(f"{what} ({route}, {kind}): {step_ms:.2f} ms wall; device-clock phases "
                    + ", ".join(f"{k} {v:.2f} ms" for k, v in phases.items())
                    + f" (uploads {upload_bytes(batch) / 1e6:.4f} MB); peak memory"
                    f" {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    say(f"{what}: median wall " + ", ".join(
        f"{route} {statistics.median(t):.2f} ms (of {len(t)})" for route, t in walls.items()))
    ops, names = {}, {}
    for route, batch in batches.items():
        ops[route], names[route] = profile_run(
            f"{what} ({route}, accumulate)", statistics.median(walls[route]),
            lambda: trainer.train_step(batch), unit=("train step", 1))
        trainer.train_step(batch)  # the update that ends the accumulation
    if len(names) == 2 and all(n is not None for n in names.values()):
        diff = names["stream"]
        diff.subtract(names["pool"])
        say(f"{what}: device operations the streamed step adds (+) or drops (-) against the"
            " pool's: " + "; ".join(f"{n:+d}x {name[:80]}" for name, n in
                                    sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:6] if n))
    return ops


# --- phase 10: train ----------------------------------------------------------------


def toy_dataset(port, seed) -> Path:
    """The port's toy generator: 8 + 2 images of 2688 px (a 6 x 6 grid of
    448 px patches), the data of both train phases."""
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    start = time.perf_counter()
    port.generate_toy_dataset(root / "toy", n_train=8, n_test=2, image_size=(GRID * PATCH,) * 2,
                              seed=seed, box_size=BOX_SIZE)
    say(f"train: toy dataset of 8 + 2 images {GRID * PATCH}x{GRID * PATCH} in"
        f" {time.perf_counter() - start:.1f} s")
    return root / "toy"


def require_route(trainer, cache, what):
    """The route ``--device-data-cache cache`` must take on the toy set,
    which fits the budget: the pool, unless ``off``."""
    if cache == "off":
        require(trainer.pool is None, f"{what}: --device-data-cache off built a pool")
        say(f"{what}: streamed the pixels (--device-data-cache off)")
    else:
        require(trainer.pool is not None and trainer.pool.images.device.type == DEVICE,
                f"{what}: --device-data-cache {cache} did not train from the device pool")
        say(f"{what}: trained from the device pool ({list(trainer.pool.images.shape)} uint8,"
            f" {trainer.pool.nbytes / 1e6:.1f} MB on the card; --device-data-cache {cache})")


def rl_step_launches() -> dict:
    """The kernel launches of one REINFORCE train step: the rollout's STEPS
    embedder calls, then N_LAYER flash launches in the teacher-forced
    forward (its convs run under autograd, on PyTorch)."""
    return {k: STEPS * n for k, n in EXPECTED_PER_CALL["embedder"].items()} | {
        "flash_attention": N_LAYER}


def train_phase(port, seed, toy, cache):
    """The train CLI (REINFORCE) at the flagship config on the toy dataset;
    returns the launch counts of its runs (train, then resume)."""
    root = toy.parent
    flags = train_flags(toy, root / "out", seed, cache)
    train_config, model_config = port.tconfig.args_to_config(port.tconfig.get_args(flags))
    torch.manual_seed(seed)  # as the CLI seeds the model's init
    init = port.GPT.from_config(model_config, port.get_actions_info(train_config),
                                device="cpu").state_dict()
    per_step = rl_step_launches()

    reset_launches(port)
    start = time.perf_counter()
    trainer = port.train_main(port.tconfig.get_args(flags))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    main_counts = read_launches(port)
    metrics = {k: float(v) for k, v in trainer.last_train_metrics.items()}
    say(f"train: {TRAIN_ITERS} iterations of B={TRAIN_B} (accumulation {TRAIN_ACCUM}) and the"
        f" final test in {seconds:.1f} s; last step: loss {metrics['loss']:.4f}, action"
        f" {metrics['action_loss']:.4f}, entropy {metrics['entropy_loss']:.4f}, yolo"
        f" {metrics['yolo_loss']:.4f} ({metrics['yolo_num_fg']:.0f} fg anchors), returns"
        f" {metrics['returns']:.4f}")
    require(all(math.isfinite(v) for v in metrics.values()), f"train: non-finite metrics {metrics}")
    require(trainer.step == TRAIN_ITERS and trainer.optimizer.updates == TRAIN_ITERS // TRAIN_ACCUM,
            "train: step and update counts")
    require_route(trainer, cache, "train")
    test_metrics = json.loads((trainer.checkpoint_dir / "metrics.json").read_text())
    require(all(math.isfinite(v) for v in test_metrics.values()), "train: non-finite test metrics")

    # The launch counts: one test alone, then the run against it.
    reset_launches(port)
    trainer.test()
    test_counts = read_launches(port)
    require(test_counts["flash_attention"] == 0 and test_counts["dwblock_bn_silu"] > 0,
            f"train: the test's launches {test_counts}")
    expected = {k: TRAIN_ITERS * per_step.get(k, 0) + test_counts[k] for k in KERNEL_NAMES}
    if main_counts != expected:
        raise AssertionError(f"train run: kernel launches {main_counts}, expected {expected}"
                             f" ({TRAIN_ITERS} x {per_step} + the test's {test_counts})")
    say(f"train run: kernel launches {main_counts} = {TRAIN_ITERS} x {per_step} per step"
        f" + {test_counts} in the test, as expected")

    # What moved: both optimizer groups and the detector's BN statistics;
    # the embedder's statistics stay (it never runs in train mode).
    state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    changed = lambda pred: [k for k in state if pred(k) and not torch.equal(state[k], init[k])]
    is_stat = lambda k: "running_" in k
    for prefix in ("h.", "gpt_backbone_net.", "action_head.", "yolox.head.", "yolox.backbone."):
        require(changed(lambda k: k.startswith(prefix) and not is_stat(k)),
                f"train: no parameter under {prefix} moved")
    require(changed(lambda k: k.startswith("yolox.") and is_stat(k)),
            "train: the detector's BN statistics did not move")
    require(not changed(lambda k: k.startswith("gpt_backbone_net.") and is_stat(k)),
            "train: the embedder's BN statistics moved")
    files = {p.name for p in trainer.checkpoint_dir.iterdir()}
    require({"checkpoint.pt", "checkpoint_best.pt", "train_state.pt", "config.json",
             "metrics.json"} <= files, f"train: checkpoint files {sorted(files)}")
    say("train: both optimizer groups and the detector's BN statistics moved, the embedder's"
        f" statistics did not; checkpoint written ({sorted(files)})")

    # Phase times of more steps on each route: the pool's batch (indices
    # and geometry) and the streamed one (the padded images).
    indices = [i % len(trainer.train_dataset) for i in range(TRAIN_B)]
    routes = ("pool", "stream") if trainer.pool is not None else ("stream",)
    batches = {r: trainer._build_env_batch(indices, seed, with_pixels=r == "stream")
               for r in routes}
    ops = timed_routes(port, trainer, batches, f"train step B={TRAIN_B}", per_step,
                       lambda b: sum(v.nbytes for v in b.values()))
    for route, n in ops.items():
        if n is not None:
            say(f"train step B={TRAIN_B} ({route}): {n:.0f} device operations, against"
                f" {TRAIN_STEP_OPS_WITH_COPIES:,} when the flash wrapper copied q, k, v and o"
                f" ({n - TRAIN_STEP_OPS_WITH_COPIES:+.0f}; {-4 * N_LAYER} expected)")

    # One resumed iteration from the checkpoint on disk.
    run_dir = trainer.checkpoint_dir
    del trainer
    reset_launches(port)
    resumed = port.train_main(port.tconfig.get_args(
        flags + ["--resume-training", str(run_dir), "--max-iters", "1"]))
    torch.cuda.synchronize()
    resume_counts = check_launches(port, "the resumed run", {
        k: per_step.get(k, 0) + test_counts[k] for k in KERNEL_NAMES})
    require(resumed.step == TRAIN_ITERS + 1, f"resume: step {resumed.step}")
    require(resumed.optimizer.updates == TRAIN_ITERS // TRAIN_ACCUM
            and resumed.optimizer.mini_step == 1, "resume: optimizer state")
    say(f"train: resumed from {run_dir.name} at step {TRAIN_ITERS}, took step {resumed.step}")
    return Counter(main_counts) + Counter(resume_counts)


def conv_launches(calls: dict, per_call=EXPECTED_PER_CALL) -> dict:
    """The conv kernels' launches of ``calls`` embedder and detector calls,
    each launching ``per_call[call]``."""
    return {k: sum(calls[c] * per_call[c].get(k, 0) for c in calls)
            for k in ("dwblock_bn_silu", "conv3x3_bn_silu")}


def sup_test_launches(n_ids: int, n_worst: int = 0, steps: int = STEPS,
                      per_call=EXPECTED_PER_CALL) -> dict:
    """The kernel launches of one supervised ``test()`` on ``n_ids`` test
    images of one shape, from ``train/supervised.py`` and
    ``train/trainer.py``: two starts per image (multistart), so ``2 n_ids``
    rollout rows in chunks of at most EVAL_CHUNK, each chunk ``steps`` - 1
    steps of one embedder call; their detections in chunks of
    ``DET_EVAL_PATCHES // steps`` episodes (at most EVAL_CHUNK), one detector
    call each; the same for the ``n_worst`` images of the worst-images pass
    (a second ``eval_envs``); and per TRAIN_B images the teacher-forced
    eval's one forward (an embedder call and N_LAYER flash launches) and
    one detector call. ``per_call``: each call's conv launches."""
    det_rows = min(EVAL_CHUNK, DET_EVAL_PATCHES // steps)
    sup_batches = math.ceil(n_ids / TRAIN_B)
    calls = Counter({"embedder": sup_batches, "detector": sup_batches})
    for n in (n_ids, n_worst):
        if n:
            calls += Counter({"embedder": math.ceil(2 * n / EVAL_CHUNK) * (steps - 1),
                              "detector": math.ceil(2 * n / det_rows)})
    out = conv_launches(calls, per_call)
    out["flash_attention"] = N_LAYER * sup_batches
    return out


def rl_test_launches(n_ids: int, n_worst: int = 0, steps: int = STEPS,
                     max_det: int = MAX_DET_PATCHES, per_call=EXPECTED_PER_CALL) -> dict:
    """The kernel launches of one REINFORCE ``test()`` on ``n_ids`` test
    images of one shape, from ``train/reinforce.py`` and
    ``train/trainer.py``: the eval rollouts in chunks of at most EVAL_CHUNK
    rows, STEPS embedder calls each; the trajectories' detections (STEPS + 1
    patches an episode) in chunks of DET_EVAL_PATCHES // (STEPS + 1)
    episodes and the positive patches' (MAX_DET_PATCHES an image) in chunks
    of EVAL_CHUNK images, one detector call each; and per worst image its
    own rollout, trajectory detection and positive-patch detection (every
    toy image holds a box, so it has a positive patch). ``steps``,
    ``max_det`` and ``per_call``: another config's episode length, detector
    patches an image and conv launches per call."""
    calls = {"embedder": (math.ceil(n_ids / EVAL_CHUNK) + n_worst) * steps,
             "detector": math.ceil(n_ids / (DET_EVAL_PATCHES // (steps + 1)))
             + math.ceil(n_ids / min(EVAL_CHUNK, DET_EVAL_PATCHES // max_det))
             + 2 * n_worst}
    return conv_launches(calls, per_call)


def sup_train_phase(port, seed, toy, cache):
    """The train CLI with ``--training-mode supervised`` at the flagship
    config (dropout 0.1) on the toy dataset: TRAIN_ITERS iterations (the
    supervised loop runs ``--max-iters`` - 1), a test of SUP_TEST_IDS
    sampled test images after the last, the final test on the whole test
    set, then a resumed run of one iteration and its final test. Returns
    the launch counts of both runs."""
    from jolineedle_tpu_torch.train.batching import build_supervised_batch
    from jolineedle_tpu_torch.train.supervised import upload_keys

    root = toy.parent
    flags = train_flags(toy, root / "out", seed, cache)
    for flag, value in (("--training-mode", "supervised"), ("--dropout", "0.1"),
                        ("--env-name", "sup"), ("--max-iters", TRAIN_ITERS + 1),
                        ("--test-every", TRAIN_ITERS), ("--test-samples", SUP_TEST_IDS)):
        flags[flags.index(flag) + 1] = str(value)
    train_config, model_config = port.tconfig.args_to_config(port.tconfig.get_args(flags))
    torch.manual_seed(seed)  # as the CLI seeds the model's init
    init = port.GPT.from_config(model_config, port.get_actions_info(train_config),
                                device="cpu").state_dict()
    per_step = {"flash_attention": N_LAYER}

    reset_launches(port)
    start = time.perf_counter()
    trainer = port.train_main(port.tconfig.get_args(flags))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    main_counts = read_launches(port)
    n_test = len(trainer.test_dataset)
    metrics = {k: float(v) for k, v in trainer.last_train_metrics.items()}
    say(f"supervised train: {TRAIN_ITERS} iterations of B={TRAIN_B} (accumulation"
        f" {TRAIN_ACCUM}), a test of {SUP_TEST_IDS} images and the final test in"
        f" {seconds:.1f} s; last step: loss {metrics['loss']:.4f}, action"
        f" {metrics['action_loss']:.4f} (accuracy {metrics['action_accuracy']:.3f}, episode"
        f" length {metrics['episode_length']:.2f}), yolo {metrics['yolo_loss']:.4f}"
        f" ({metrics['yolo_num_fg']:.0f} fg anchors)")
    require(all(math.isfinite(v) for v in metrics.values()),
            f"supervised train: non-finite metrics {metrics}")
    require(trainer.step == TRAIN_ITERS and trainer.optimizer.updates == TRAIN_ITERS // TRAIN_ACCUM,
            f"supervised train: step {trainer.step}, updates {trainer.optimizer.updates}")
    require_route(trainer, cache, "supervised train")
    test_metrics = json.loads((trainer.checkpoint_dir / "metrics.json").read_text())
    require(all(math.isfinite(v) for v in test_metrics.values())
            and {"map", "supervised_action_loss", "supervised_map"} <= set(test_metrics),
            f"supervised train: test metrics {test_metrics}")
    say("supervised test metrics: " + ", ".join(
        f"{k} {test_metrics[k]:.4f}" for k in ("map", "action_accuracy", "prop_patches_found",
                                               "supervised_action_loss", "supervised_map")))

    # The launch counts, derived from the code: per step, per test, the run.
    expected = Counter({k: TRAIN_ITERS * n for k, n in per_step.items()})
    expected += Counter(sup_test_launches(SUP_TEST_IDS)) + Counter(sup_test_launches(n_test))
    expected = {k: expected.get(k, 0) for k in KERNEL_NAMES}
    if main_counts != expected:
        raise AssertionError(f"supervised run: kernel launches {main_counts}, expected"
                             f" {expected} ({TRAIN_ITERS} x {per_step} + the tests'"
                             f" {sup_test_launches(SUP_TEST_IDS)} and"
                             f" {sup_test_launches(n_test)})")
    say(f"supervised run: kernel launches {main_counts} = {TRAIN_ITERS} x {per_step} per step"
        f" + {sup_test_launches(SUP_TEST_IDS)} in the test of {SUP_TEST_IDS} images +"
        f" {sup_test_launches(n_test)} in the final test, as derived")
    reset_launches(port)
    trainer.test()
    check_launches(port, f"one supervised test ({n_test} images)", sup_test_launches(n_test))

    # What moved: both optimizer groups, and the BN statistics of both the
    # embedder and the detector (each runs in train mode in a step).
    state = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    changed = lambda pred: [k for k in state if pred(k) and not torch.equal(state[k], init[k])]
    is_stat = lambda k: "running_" in k
    for group in trainer.optimizer.adamw.param_groups:
        names = {id(p) for p in group["params"]}
        moved = [n for n, p in trainer.model.named_parameters()
                 if id(p) in names and not torch.equal(state[n], init[n])]
        require(moved, f"supervised train: no parameter of the {group['label']} group moved")
        say(f"supervised train: {len(moved)} of {len(names)} parameters of the"
            f" {group['label']} group moved")
    for prefix in ("h.", "gpt_backbone_net.", "action_head.", "project_concat.", "yolox.head.",
                   "yolox.backbone."):
        require(changed(lambda k: k.startswith(prefix) and not is_stat(k)),
                f"supervised train: no parameter under {prefix} moved")
    for prefix in ("gpt_backbone_net.", "yolox."):
        require(changed(lambda k: k.startswith(prefix) and is_stat(k)),
                f"supervised train: the BN statistics under {prefix} did not move")
    files = {p.name for p in trainer.checkpoint_dir.iterdir()}
    require({"checkpoint.pt", "checkpoint_best.pt", "train_state.pt", "config.json",
             "metrics.json", "best_model.txt"} <= files,
            f"supervised train: checkpoint files {sorted(files)}")
    require("map:" in (trainer.checkpoint_dir / "best_model.txt").read_text(),
            "supervised train: best_model.txt does not track map")
    say("supervised train: the embedder's and the detector's BN statistics moved; checkpoint"
        f" written ({sorted(files)})")

    # Phase times of more steps on each route: the pool's batch (indices,
    # geometry, labels) and the streamed one (the uint8 patches).
    indices = [i % len(trainer.train_dataset) for i in range(TRAIN_B)]
    routes = ("pool", "stream") if trainer.pool is not None else ("stream",)
    batches = {r: build_supervised_batch(trainer.train_dataset, indices, trainer.config,
                                         np.random.default_rng(seed), with_pixels=r == "stream")
               for r in routes}
    ops = timed_routes(port, trainer, batches, f"supervised train step B={TRAIN_B}", per_step,
                       lambda b: sum(b[k].nbytes for k in upload_keys(b)))
    for route, n in ops.items():
        if n is not None:
            say(f"supervised train step B={TRAIN_B} ({route}): {n:.0f} device operations")

    # One resumed iteration from the checkpoint on disk, and its final test.
    run_dir = trainer.checkpoint_dir
    del trainer
    reset_launches(port)
    resumed = port.train_main(port.tconfig.get_args(
        flags + ["--resume-training", str(run_dir), "--max-iters", "2"]))
    torch.cuda.synchronize()
    resume_counts = check_launches(port, "the resumed supervised run", dict(
        Counter(per_step) + Counter(sup_test_launches(n_test))))
    require(resumed.step == TRAIN_ITERS + 1, f"supervised resume: step {resumed.step}")
    require(resumed.optimizer.updates == TRAIN_ITERS // TRAIN_ACCUM
            and resumed.optimizer.mini_step == 1, "supervised resume: optimizer state")
    say(f"supervised train: resumed from {run_dir.name} at step {TRAIN_ITERS}, took step"
        f" {resumed.step}")
    # The resumed run's final test (its first): the best checkpoint on the
    # whole test set, which the eval phase's eval_checkpoint must reproduce.
    full_test = {k: float(np.mean(v)) for k, v in resumed.last_test_metrics.items()}
    return Counter(main_counts) + Counter(resume_counts), (run_dir, full_test)


# --- phase 11b: resume a JAX run --------------------------------------------------------
def same_optimizer_state(what, got, want, acc_rtol=1e-6):
    """Two ``Optimizer.state_dict()``s: AdamW's moments and steps, the update
    count and the window bit for bit, the accumulated grads within
    ``acc_rtol`` of their largest entry."""
    a, b = got["adamw"]["state"], want["adamw"]["state"]
    require(a.keys() == b.keys() and (got["updates"], got["mini_step"])
            == (want["updates"], want["mini_step"]),
            f"{what}: {len(a)} AdamW states, updates {got['updates']}, window {got['mini_step']};"
            f" expected {len(b)}, {want['updates']}, {want['mini_step']}")
    for i in b:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            require(torch.equal(a[i][key].cpu(), b[i][key].cpu()), f"{what}: {key} of {i} differs")
    worst = 0.0
    for g, w in zip(got["acc_grads"], want["acc_grads"], strict=True):
        require((g is None) == (w is None), f"{what}: a grad is missing on one side")
        if w is not None:
            worst = max(worst, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    require(worst <= acc_rtol, f"{what}: accumulated grads {worst:.3g} apart (relative)")
    return worst


def resume_jax_phase(port, seed, toy, cache):
    """``--resume-training`` on a JAX run directory, at the flagship config.
    (a) The supervised train CLI, float32, ``--gradient-accumulation 2
    --lr-schedule cosine``, 3 iterations (the window half full) and its
    final test; (b) its state written as a JAX run directory
    (``checkpoint.flax_train_state``, ``config.json``); (c) a trainer
    resumed from the ``.pt`` files and one from the msgpack (given the
    other's generator, which the JAX file does not hold): equal optimizer
    states, then 2 iterations each with equal losses and weights, 3 flash
    launches an iteration, and one test of the msgpack trainer, which
    writes the port's files beside the msgpack; (d) phase 10's REINFORCE
    state (bf16, inside its window) through a JAX file with the clip level,
    resumed for one iteration: 240 dwblock, 20 stem and 3 flash launches.
    The two resumes of (c) are built and trained under deterministic
    algorithms (:func:`deterministic`, with ``CUBLAS_WORKSPACE_CONFIG`` set
    in ``main``): with the card's default ones the trainers' second
    iterations once lost 2,474.2 and 2,535.8 (SimOTA amplifies an ulp),
    against the losses' rtol of 1e-6. Returns the phase's launch counts."""
    from jolineedle_tpu_torch import checkpoint as ckpt
    from jolineedle_tpu_torch.parallel import mesh

    start = time.perf_counter()
    root = toy.parent / "resume_jax"
    shutil.rmtree(root, ignore_errors=True)
    flags = train_flags(toy, root, seed, cache)
    for flag, value in (("--training-mode", "supervised"), ("--env-name", "port"),
                        ("--compute-dtype", "float32"), ("--max-iters", 4)):
        flags[flags.index(flag) + 1] = str(value)
    flags += ["--lr-schedule", "cosine"]
    iters = 3  # the supervised loop runs --max-iters - 1
    per_iter = {"flash_attention": N_LAYER}

    # (a) the port's run, its window half full
    reset_launches(port)
    trainer = port.train_main(port.tconfig.get_args(flags))
    torch.cuda.synchronize()
    n_test = len(trainer.test_dataset)
    counts = Counter(check_launches(port, "resume_jax: the supervised run", dict(
        Counter({k: iters * n for k, n in per_iter.items()}) + Counter(sup_test_launches(n_test)))))
    opt = trainer.optimizer
    require((trainer.step, opt.updates, opt.mini_step) == (iters, 1, 1),
            f"resume_jax: step {trainer.step}, updates {opt.updates}, window {opt.mini_step}")

    # (b) that state as a JAX run directory
    jax_dir = root / "jax"
    ckpt.write_msgpack(jax_dir / ckpt.FLAX_LAST,
                       ckpt.flax_train_state(trainer.model, opt, trainer.step))
    shutil.copy(trainer.checkpoint_dir / "config.json", jax_dir / "config.json")
    jax_bytes = (jax_dir / ckpt.FLAX_LAST).read_bytes()
    say(f"resume_jax: {ckpt.FLAX_LAST} of step {trainer.step} written"
        f" ({len(jax_bytes) / 1e6:.1f} MB)")
    pt_dir = trainer.checkpoint_dir
    del trainer, opt

    # (c) the two resumes, side by side
    def resumed(directory, env_name):
        config, model_config = port.tconfig.args_to_config(port.tconfig.get_args(
            flags + ["--resume-training", str(directory), "--env-name", env_name]))
        return port.build_trainer(mesh.single(DEVICE), config, model_config, str(toy), log=False)

    with deterministic() as warned:
        from_pt, from_jax = resumed(pt_dir, "port"), resumed(jax_dir, "jax")
        from_jax.generator.set_state(from_pt.generator.get_state())
        require(from_jax.step == from_pt.step == iters, "resume_jax: the resumed steps")
        acc_err = same_optimizer_state("resume_jax: the msgpack resume against the .pt one",
                                       from_jax.optimizer.state_dict(),
                                       from_pt.optimizer.state_dict())
        reset_launches(port)
        for t in (from_pt, from_jax):
            t.train_loop([1, 2])
        torch.cuda.synchronize()
    ops = sorted({str(w.message).split(" does not have a deterministic")[0]
                  for w in warned if "deterministic" in str(w.message)})
    counts += Counter(check_launches(port, "resume_jax: 2 iterations of each resumed trainer",
                                     {k: 4 * n for k, n in per_iter.items()}))
    losses = [[float(v) for v in t.loss_history] for t in (from_pt, from_jax)]
    require(all(math.isfinite(v) for v in losses[0]) and np.allclose(
        losses[1], losses[0], rtol=1e-6, atol=0),
        f"resume_jax: losses {losses[1]} from the msgpack, {losses[0]} from the .pt")
    params = dict(from_pt.model.named_parameters())
    weight_err = max(float((p - params[n]).abs().max())
                     for n, p in from_jax.model.named_parameters())
    require(weight_err <= 1e-5, f"resume_jax: weights {weight_err:.3g} apart after 2 iterations")
    require((from_jax.step, from_jax.optimizer.updates, from_jax.optimizer.mini_step)
            == (iters + 2, 2, 1), "resume_jax: counts after 2 iterations")
    reset_launches(port)
    from_jax.test()
    torch.cuda.synchronize()
    counts += Counter(check_launches(port, f"resume_jax: one test ({n_test} images)",
                                     sup_test_launches(n_test)))
    require((jax_dir / ckpt.FLAX_LAST).read_bytes() == jax_bytes and ckpt.resumed_here(jax_dir)
            and ckpt.model_file(jax_dir, best=False) == jax_dir / ckpt.CKPT_LAST,
            "resume_jax: the port's files beside the msgpack")
    say(f"resume_jax: the msgpack resume holds the .pt resume's optimizer state (grads"
        f" {acc_err:.3g} apart); 2 iterations under deterministic algorithms: losses"
        f" {losses[1]} (the .pt's {losses[0]}), weights {weight_err:.3g} apart (ops with no"
        f" deterministic version: {ops}); its test wrote {ckpt.CKPT_LAST} beside the"
        " unchanged msgpack, which takes precedence there now")
    del from_pt, from_jax
    torch.cuda.empty_cache()

    # (d) REINFORCE in bf16: phase 10's state through a JAX file
    rl_flags = train_flags(toy, toy.parent / "out", seed, cache)
    rl_config, rl_model = port.tconfig.args_to_config(port.tconfig.get_args(
        rl_flags + ["--resume-training", str(toy.parent / "out" / "train")]))
    source = port.build_trainer(mesh.single(DEVICE), rl_config, rl_model, str(toy), log=False)
    require(source.optimizer.mini_step == 1 and source.optimizer.clip_value == 1.0,
            "resume_jax: phase 10's state is not inside its window")
    rl_dir = root / "jax_rl"
    tree = ckpt.flax_train_state(source.model, source.optimizer, source.step)
    require(set(tree["opt_state"]["inner_opt_state"]) == {"0", "1"},
            "resume_jax: the REINFORCE file has no clip level")
    ckpt.write_msgpack(rl_dir / ckpt.FLAX_LAST, tree)
    want = source.optimizer.state_dict()
    del source
    rl_config, rl_model = port.tconfig.args_to_config(port.tconfig.get_args(
        rl_flags + ["--resume-training", str(rl_dir), "--work-dir", str(root),
                    "--env-name", "jax_rl", "--max-iters", "1"]))
    rl = port.build_trainer(mesh.single(DEVICE), rl_config, rl_model, str(toy), log=False)
    same_optimizer_state("resume_jax: the REINFORCE msgpack resume", rl.optimizer.state_dict(),
                         want)
    require(rl._window_stats == [], "resume_jax: the return window is not empty")
    reset_launches(port)
    rl.train_loop([1])
    torch.cuda.synchronize()
    counts += Counter(check_launches(port, "resume_jax: one resumed REINFORCE iteration",
                                     rl_step_launches()))
    loss = float(rl.loss_history[-1])
    require(math.isfinite(loss) and rl.optimizer.updates == want["updates"] + 1
            and rl.optimizer.mini_step == 0, f"resume_jax: REINFORCE loss {loss}, counts")
    say(f"resume_jax: REINFORCE resumed from a JAX file at step {rl.step - 1}, loss {loss:.4f}")
    del rl
    torch.cuda.empty_cache()
    say(f"resume_jax: the phase took {(time.perf_counter() - start) * 1e3:.1f} ms")
    return counts


# --- phase 12: eval and report --------------------------------------------------------
# The test set of the phase's test cycles: EVAL_TEST images of EVAL_GRID x
# EVAL_GRID patches, enough for --failure-select-rate 0.1 (the default) to
# pick int(0.1 * EVAL_TEST) worst images.
EVAL_TEST, EVAL_GRID, FAILURE_RATE = 10, 3, 0.1
NMS_SIZES = (64, 1000)


# --- phase 11c: the recipe ---------------------------------------------------------------
def recipe_kernel_rows(port, calls, steps, seed, sizes=None):
    """Each kernel at every shape the recipe's tests launch it, both dtypes,
    against its plain version: the embedder's at EVAL_CHUNK patches (one
    eval rollout step) and the detector's at one eval detection chunk
    (``DET_EVAL_PATCHES // steps`` episodes of ``steps`` patches); or at
    ``sizes``, ``[(row label, call, patches)]``."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    det_n = min(EVAL_CHUNK, DET_EVAL_PATCHES // steps) * steps
    rows = []
    for label, call, n in sizes or (("embedder", "embedder", EVAL_CHUNK),
                                    ("detector", "detector", det_n)):
        for (name, H, W, C, K), per in sorted(calls[call].items()):
            for dtype in (torch.float32, torch.bfloat16):
                r = KERNELS[name]["measure"](port.kconv, H, W, C, K, dtype, gen, n=n)
                r.update(name=name, call=label, shape=[n, H, W, C, K],
                         dtype=DTYPE_NAMES[dtype], per_call=per)
                rows.append(r)
                say(f"recipe kernel {name} ({label}, {per} a call) x[{n},{H},{W},{C}]->{K}"
                    f" {DTYPE_NAMES[dtype]}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
                    f" cuDNN {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms"
                    f" ({r['bound_by']}), max |err| {r['max_abs_err']:.3g}")
    return rows


def graphed_against_eager(port, run_dir, toy, seed):
    """The recipe's train step with its CUDA graphs (``train/graphs.py``)
    against the eager step, from one state on the same batches, in float32
    and bfloat16: losses within GRAPH_RTOL and weights within GRAPH_ATOL
    after GRAPH_STEPS steps; then the wall ms of a step each way, in turns."""
    from jolineedle_tpu_torch.parallel import mesh

    flags_train, flags_model = port.tconfig.config_from_file(run_dir / "config.json")
    for dtype in ("float32", "bfloat16"):
        train_config, model_config = copy.deepcopy(flags_train), copy.deepcopy(flags_model)
        model_config.compute_dtype = dtype
        train_config.work_dir = str(toy.parent / "graphs")
        trainer = port.build_trainer(mesh.single(torch.device(DEVICE)), train_config,
                                     model_config, toy, log=False)
        trainer.pool = trainer.build_pool()
        rng = np.random.default_rng(seed)
        n_train = len(trainer.train_dataset)
        batches = [trainer.build_batch(rng.integers(0, n_train, TRAIN_B).tolist(), seed + i)
                   for i in range(GRAPH_STEPS)]
        start_state = copy.deepcopy(trainer.model.state_dict())
        start_opt = copy.deepcopy(trainer.optimizer.state_dict())
        start_gen = trainer.generator.get_state()

        def run(graphed):
            trainer.model.load_state_dict(start_state)
            trainer.optimizer.load_state_dict(copy.deepcopy(start_opt))
            trainer.generator.set_state(start_gen)
            eager = mock.patch.object(trainer, "step_graphs", lambda: None)
            with eager if not graphed else contextlib.nullcontext():
                losses = [float(trainer.train_step(b)["loss"]) for b in batches]
            return losses, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}

        eager_losses, eager_state = run(False)
        graphed_losses, graphed_state = run(True)
        require(trainer.graphs is not None
                and trainer.graphs.captures
                == {"embedder": 1, "shared_embedder": 0, "detector": 1, "rollout": 0},
                f"graphed step ({dtype}): captures {trainer.graphs and trainer.graphs.captures}")
        np.testing.assert_allclose(graphed_losses, eager_losses, rtol=GRAPH_RTOL, atol=0)
        err = max((graphed_state[k].double() - eager_state[k].double()).abs().max().item()
                  for k in eager_state)
        require(err <= GRAPH_ATOL, f"graphed step ({dtype}): weights {err} from the eager step's")
        walls = defaultdict(list)
        for graphed in (False, True, True, False):
            eager = mock.patch.object(trainer, "step_graphs", lambda: None)
            with eager if not graphed else contextlib.nullcontext():
                trainer.train_step(batches[0])
                torch.cuda.synchronize()
                start = time.perf_counter()
                for b in batches * GRAPH_TIMED_PASSES:
                    trainer.train_step(b)
                torch.cuda.synchronize()
            walls["graphed" if graphed else "eager"].append(
                (time.perf_counter() - start) * 1e3 / (GRAPH_TIMED_PASSES * len(batches)))
        say(f"recipe train step B={TRAIN_B} {dtype}: graphed losses {graphed_losses} = eager"
            f" {eager_losses} (rtol {GRAPH_RTOL}), weights {err:.3g} apart; wall ms a step, in"
            f" turns (eager, graphed, graphed, eager): eager {walls['eager']}, graphed"
            f" {walls['graphed']}")
        if dtype == "bfloat16":  # the recipe's dtype: the device's share of each step
            for graphed in (False, True):
                eager = mock.patch.object(trainer, "step_graphs", lambda: None)
                with eager if not graphed else contextlib.nullcontext():
                    kind = "graphed" if graphed else "eager"
                    profile_run(f"recipe train step B={TRAIN_B} bf16 ({kind})",
                                statistics.median(walls[kind]),
                                lambda: trainer.train_step(batches[0]), unit=("train step", 1))
        del trainer
        torch.cuda.empty_cache()


def recipe_phase(port, seed):
    """The port's ``run_sup_flagship.sh <dir> yolox-s 1 <RECIPE_ITERS + 1>``
    through ``sh`` on a toy set from ``make_toyds_big``'s generator
    (RECIPE_TRAIN + RECIPE_TEST images of 320 x 448): it must exit 0, write
    the run's files with finite metrics, and report the launches derived
    from its config: per iteration N_LAYER flash launches, then its final
    test's conv and flash launches (``sup_test_launches`` at the recipe's
    episode length and its per-call launches: the yolox-nano embedder and
    the yolox-s detector on 64 px patches, read from the run's model).
    Then the kernels at those shapes and the graphed step. Returns the
    run's launches."""
    from jolineedle_tpu_torch.scripts.make_toyds_big import make_toyds_big

    phase_start = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_recipe"
    shutil.rmtree(root, ignore_errors=True)
    toy = make_toyds_big(root / "toy", n_train=RECIPE_TRAIN, n_test=RECIPE_TEST)
    env = {**os.environ, "DATASET_DIR": str(toy), "SEED": str(seed), "PYTHONUNBUFFERED": "1"}
    start = time.perf_counter()
    proc = subprocess.run(["sh", RECIPE_SCRIPT, str(root / "out"), "yolox-s", "1",
                           str(RECIPE_ITERS + 1)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    seconds = time.perf_counter() - start
    require(proc.returncode == 0, f"recipe: {RECIPE_SCRIPT} exited {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    counts = json.loads([ln for ln in lines if ln.startswith("kernel launches: ")][-1]
                        .split(": ", 1)[1])
    peak = [ln for ln in lines if ln.startswith("peak device memory: ")][-1]
    run_dir = root / "out" / "r3_sup_yolox-s"
    files = {p.name for p in run_dir.iterdir()}
    require({"config.json", "checkpoint.pt", "train_state.pt", "metrics.json",
             "best_model.txt"} <= files, f"recipe: run files {sorted(files)}")
    metrics = json.loads((run_dir / "metrics.json").read_text())
    require(all(math.isfinite(v) for v in metrics.values())
            and {"map", "map_multistart_2", "supervised_map"} <= set(metrics),
            f"recipe: final validation metrics {metrics}")

    train_config, model_config = port.tconfig.config_from_file(run_dir / "config.json")
    require((model_config.image_processor, model_config.gpt_backbone, model_config.patch_size,
             train_config.batch_size, model_config.compute_dtype)
            == ("yolox-s", "yolox-nano", 64, TRAIN_B, "bfloat16"),
            f"recipe: config {model_config.image_processor}, {model_config.gpt_backbone}")
    steps = model_config.block_size
    model = port.GPT.from_config(model_config, port.get_actions_info(train_config)).eval()
    calls = module_kernel_calls(model, model_config.patch_size)
    del model
    per_call = {call: per_kernel(c) for call, c in calls.items()}
    n_worst = int(train_config.failure_select_rate * RECIPE_TEST)
    expected = Counter({"flash_attention": RECIPE_ITERS * N_LAYER})
    expected += Counter(sup_test_launches(RECIPE_TEST, n_worst, steps, per_call))
    expected = {k: expected.get(k, 0) for k in KERNEL_NAMES}
    require(counts == expected, f"recipe: kernel launches {counts}, expected {expected}")
    say(f"recipe: {RECIPE_SCRIPT} <dir> yolox-s 1 {RECIPE_ITERS + 1} in {seconds:.1f} s"
        f" ({RECIPE_ITERS} iterations of B={TRAIN_B}, {steps} patches of"
        f" {model_config.patch_size} px, bf16, and the final test of {RECIPE_TEST} images);"
        f" {peak}; kernel launches {counts} = {RECIPE_ITERS} x {N_LAYER} flash + the final"
        f" test's {sup_test_launches(RECIPE_TEST, n_worst, steps, per_call)} (per call:"
        f" {per_call}), as derived; final validation: " + ", ".join(
            f"{k} {metrics[k]:.4f}" for k in ("map", "map_multistart_2", "supervised_map")))
    rows = recipe_kernel_rows(port, calls, steps, seed)
    graphed_against_eager(port, run_dir, toy, seed)
    say(f"recipe: the phase took {time.perf_counter() - phase_start:.1f} s")
    return Counter(counts), rows, (run_dir, toy)


# --- phases 11d-11e: the fine-tune, and the shared pairing ---------------------------------
#: 11d's passes that hold no time, which run beside 11d's CLI, and the one
#: that times the steps, with the card to itself; 11e's, all beside the CLI.
UNTIMED_PASSES = (("float32", False), ("float32", True))
TIMED_PASSES = (("bfloat16", False),)
SHARED_PASSES = (("float32", False), ("bfloat16", False), ("float32", True))


@contextlib.contextmanager
def deterministic():
    """Inside: ``torch.use_deterministic_algorithms(True)`` (an op with no
    deterministic version warns; the warnings are yielded) and cuDNN's
    deterministic algorithms with no benchmarking. The global flags are
    restored at the exit, also on an exception."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        try:
            torch.use_deterministic_algorithms(True, warn_only=True)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
            yield warned
        finally:
            torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]


def backbone_gets_no_gradient(trainer, batch, what):
    """One train step of ``trainer`` on ``batch`` with the detection loss
    off: when the optimizer is handed the gradients, the shared detector
    backbone holds none (the decision or REINFORCE loss stops at its FPN;
    only the detector's loss trains it), while the embedder's own conv
    holds one. Returns the two largest gradients."""
    model, cfg, step = trainer.model, trainer.config, trainer.optimizer.step
    seen = []

    def largest(params):
        return max(0.0 if p.grad is None else p.grad.abs().max().item() for p in params)

    def record():
        seen.append((largest(model.yolox.backbone.parameters()),
                     largest([model.embed_fpn_conv.weight])))
        step()

    detection = cfg.detection_enabled
    cfg.detection_enabled = False
    try:
        with mock.patch.object(trainer.optimizer, "step", record):
            trainer.train_step(batch)
    finally:
        cfg.detection_enabled = detection
    backbone, head = seen[-1]
    require(backbone == 0.0 and head > 0.0,
            f"{what}: gradients on the shared backbone {backbone}, on the embedder's conv {head}")
    return backbone, head


def graphed_window(port, flags_train, flags_model, toy, seed, per_iter, dtype, warned,
                   what="rlft", steps=RLFT_WINDOW, captures=None, shared=False, timed=True,
                   warm=False):
    """``steps`` train steps (whole accumulation windows) of the trainer
    that the flags build, graphed against eager from one state on the same
    batches, in ``dtype``, each run launching ``per_iter`` a step; the
    graphs captured as ``captures`` says (default: the fine-tune's
    ``gpt_backbone`` pairing). float32: losses equal, and after the
    windows' updates every weight within RLFT_STEP_TOL learning rates and
    all but RLFT_FLIP_SHARE of them within RLFT_ATOL; bfloat16: losses
    within GRAPH_RTOL; then, when ``timed`` (nothing else on the card), the
    wall ms of a step each way, in turns, and in bfloat16 each one's busy
    share. Under :func:`deterministic`
    (``warned`` is then its list of warnings) every weight within
    RLFT_DET_ATOL and no timing. ``shared`` (the shared pairing): the BN
    buffers within GRAPH_ATOL (RLFT_DET_ATOL under :func:`deterministic`),
    and on each route :func:`backbone_gets_no_gradient`. ``warm``: the
    graphed run starts after one graphed step that the restores undo, so
    that its steps are all replays of graphs captured eager-first
    (``TrainGraphs._eager_then_graph``). Returns the launches of the eager
    and the graphed run."""
    from jolineedle_tpu_torch.parallel import mesh

    exact = warned is not None
    captures = captures or {"embedder": 1, "shared_embedder": 0, "detector": 1, "rollout": 1}
    train_config, model_config = copy.deepcopy(flags_train), copy.deepcopy(flags_model)
    model_config.compute_dtype = dtype
    train_config.work_dir = str(toy.parent / f"{what.replace(' ', '_')}_graphs")
    trainer = port.build_trainer(mesh.single(torch.device(DEVICE)), train_config,
                                 model_config, toy, log=False)
    trainer.pool = trainer.train_pool()
    every_k = trainer.optimizer.every_k
    require(trainer.pool is not None and steps % every_k == 0,
            f"{what} ({dtype}): the pool and whole windows of {every_k} in {steps} steps")
    rng = np.random.default_rng(seed)
    n_train = len(trainer.train_dataset)
    batches = [trainer.build_batch(rng.integers(0, n_train, TRAIN_B).tolist(), seed + i)
               for i in range(steps)]
    start_state = copy.deepcopy(trainer.model.state_dict())
    start_opt = copy.deepcopy(trainer.optimizer.state_dict())
    start_gen = trainer.generator.get_state()
    eager = lambda graphed: (contextlib.nullcontext() if graphed
                             else mock.patch.object(trainer, "step_graphs", lambda: None))
    launches = Counter()

    def run(graphed):
        kind = "graphed" if graphed else "eager"
        if graphed and warm:
            trainer.train_step(batches[0])
        trainer.model.load_state_dict(start_state)
        trainer.optimizer.load_state_dict(copy.deepcopy(start_opt))
        trainer.generator.set_state(start_gen)
        reset_launches(port)
        with eager(graphed):
            losses = [float(trainer.train_step(b)["loss"]) for b in batches]
        torch.cuda.synchronize()
        launches.update(check_launches(port, f"{what}: {steps} {kind} steps ({dtype})",
                                       {k: steps * n for k, n in per_iter.items()}))
        require(trainer.optimizer.updates == start_opt["updates"] + steps // every_k
                and trainer.optimizer.mini_step == 0, f"{what}: {kind} windows' updates")
        return losses, {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}

    eager_losses, eager_state = run(False)
    graphed_losses, graphed_state = run(True)
    require(trainer.graphs is not None and trainer.graphs.captures == captures,
            f"{what} ({dtype}): captures {trainer.graphs and trainer.graphs.captures},"
            f" expected {captures}")
    params = {name for name, _ in trainer.model.named_parameters()}
    diffs = {k: (graphed_state[k].double() - eager_state[k].double()).abs()
             for k in eager_state}
    err = max(d.max().item() for d in diffs.values())
    lr = max(g["lr"] for g in trainer.optimizer.adamw.param_groups)
    step_err = max(diffs[k].max().item() for k in params) / lr
    apart = sum(int((diffs[k] > RLFT_ATOL).sum()) for k in params)
    share = apart / sum(diffs[k].numel() for k in params)
    state_err = max(d.max().item() for k, d in diffs.items() if k not in params)
    no_grad = ""
    if shared:
        require(state_err <= (RLFT_DET_ATOL if exact else GRAPH_ATOL),
                f"{what} ({dtype}): BN buffers {state_err:.3g} apart")
        grads = []
        for graphed in (False, True):
            with eager(graphed):
                grads.append(backbone_gets_no_gradient(
                    trainer, batches[0], f"{what} ({dtype}, {'graphed' if graphed else 'eager'})"))
        no_grad = (f"; with the detection loss off the shared backbone's gradients are"
                   f" {grads[0][0]} / {grads[1][0]} (eager / graphed; the embedder's conv:"
                   f" {grads[0][1]:.3g} / {grads[1][1]:.3g})")
    if exact:
        ops = sorted({str(w.message).split(" does not have a deterministic")[0]
                      for w in warned if "deterministic" in str(w.message)})
        require(graphed_losses == eager_losses and step_err * lr <= RLFT_DET_ATOL,
                f"{what} (float32, deterministic): graphed losses {graphed_losses}, eager"
                f" {eager_losses}; weights up to {step_err * lr:.3g} apart (at most"
                f" {RLFT_DET_ATOL}); ops with no deterministic version: {ops}")
        say(f"{what} train step B={TRAIN_B} float32 under deterministic algorithms: graphed"
            f" losses {graphed_losses} = eager {eager_losses}; after the windows' updates"
            f" the weights up to {step_err * lr:.3g} apart (at most {RLFT_DET_ATOL}), the"
            f" buffers {state_err:.3g}, {apart} weights beyond {RLFT_ATOL}; ops with no"
            f" deterministic version: {ops}{no_grad}")
        del trainer
        torch.cuda.empty_cache()
        return launches
    if dtype == "float32":
        require(graphed_losses == eager_losses and step_err <= RLFT_STEP_TOL
                and share <= RLFT_FLIP_SHARE,
                f"{what} (float32): graphed losses {graphed_losses}, eager {eager_losses};"
                f" weights up to {step_err:.3g} lr apart (at most {RLFT_STEP_TOL}), {share:.3g}"
                f" of them beyond {RLFT_ATOL} (at most {RLFT_FLIP_SHARE})")
    else:
        np.testing.assert_allclose(graphed_losses, eager_losses, rtol=GRAPH_RTOL, atol=0)
    if not timed:
        say(f"{what} train step B={TRAIN_B} {dtype}: graphed losses {graphed_losses} = eager"
            f" {eager_losses}; after the windows' updates the state {err:.3g} apart (the"
            f" buffers {state_err:.3g}), the weights up to {step_err:.3g} lr ({lr:g}), {apart}"
            f" of them ({share:.3g}) beyond {RLFT_ATOL}{no_grad}; not timed (beside a CLI run)")
        del trainer
        torch.cuda.empty_cache()
        return launches
    walls = defaultdict(list)
    for graphed in (False, True, True, False):
        with eager(graphed):
            trainer.train_step(batches[0])
            torch.cuda.synchronize()
            start = time.perf_counter()
            for b in batches:
                trainer.train_step(b)
            torch.cuda.synchronize()
        walls["graphed" if graphed else "eager"].append(
            (time.perf_counter() - start) * 1e3 / len(batches))
    say(f"{what} train step B={TRAIN_B} {dtype}: graphed losses {graphed_losses} = eager"
        f" {eager_losses}; after the windows' updates the state {err:.3g} apart (the buffers"
        f" {state_err:.3g}), the weights up to {step_err:.3g} lr ({lr:g}), {apart} of them"
        f" ({share:.3g}) beyond {RLFT_ATOL}{no_grad}; wall ms a step, in turns (eager,"
        f" graphed, graphed, eager): eager {walls['eager']}, graphed {walls['graphed']}")
    if dtype == "bfloat16":  # the recipe's dtype: the device's share of each step
        for graphed in (False, True):
            kind = "graphed" if graphed else "eager"
            with eager(graphed):
                profile_run(f"{what} train step B={TRAIN_B} bf16 ({kind})",
                            statistics.median(walls[kind]),
                            lambda: trainer.train_step(batches[0]), unit=("train step", 1))
    del trainer
    torch.cuda.empty_cache()
    return launches


def read_config(path: Path, proc) -> tuple:
    """The flags of the ``config.json`` that the CLI ``proc`` writes as it
    starts, once it is there whole."""
    from jolineedle_tpu_torch import config as tconfig

    while True:
        try:
            json.loads(path.read_text())
            break
        except (FileNotFoundError, json.JSONDecodeError):
            require(proc.poll() is None, f"the CLI exited {proc.returncode} before {path}")
            time.sleep(0.1)
    return tconfig.config_from_file(path)


def rlft_passes(port, flags, toy, seed, per_iter, passes, timed):
    """Phase 11d's graphed step against the eager one (:func:`graphed_window`)
    in each of ``passes``."""
    for dtype, exact in passes:
        with deterministic() if exact else contextlib.nullcontext() as warned:
            graphed_window(port, *flags, toy, seed, per_iter, dtype, warned, timed=timed)


def rlft_phase(port, seed, sup_run, toy):
    """The port's ``run_rl_finetune_stop.sh <dir> <sup_run> yolox-s
    RLFT_ITERS`` through ``sh`` from phase 11c's supervised run on its toy
    set: the 8-action head grafted onto the 9-action STOP model, bf16, B =
    16, episodes of 20 patches of 64 px, accumulation 4 in chunks of 4. It
    must exit 0, write the run's files with finite metrics, and report the
    launches derived from its config: per iteration the rollout's 20
    embedder calls and N_LAYER flash launches in the recompute (replays
    counted), then its final test's (``rl_test_launches`` at the recipe's
    episode length, detector patches and per-call launches). While the CLI
    runs (in a process of its own; its ``config.json``, written as it
    starts, gives the flags), this process runs the UNTIMED_PASSES of 11d's
    graphed step against the eager one (:func:`rlft_passes`) and phase
    11e's SHARED_PASSES (:func:`shared_passes`); then, alone on the card, the embedder's
    kernels at the rollout's TRAIN_B patches against their plain versions
    and 11d's TIMED_PASSES. Returns the run's launches, the kernel rows and
    11e's flags with its launches so far."""
    phase_start = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_rlft"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = {**os.environ, "DATASET_DIR": str(toy), "PYTHONUNBUFFERED": "1"}
    run_dir = root / "out" / "r3_rlft_yolox-s"
    start = time.perf_counter()
    with open(root / "cli.txt", "w") as out, open(root / "cli_err.txt", "w") as err:
        proc = subprocess.Popen(["sh", RLFT_SCRIPT, str(root / "out"), str(sup_run), "yolox-s",
                                 str(RLFT_ITERS)], cwd=ROOT, env=env, stdout=out, stderr=err,
                                text=True)
    try:
        flags = read_config(run_dir / "config.json", proc)
        train_config, model_config = flags
        require((model_config.image_processor, model_config.gpt_backbone,
                 model_config.patch_size, train_config.batch_size, model_config.compute_dtype,
                 train_config.max_seq_len, train_config.stop_enabled,
                 train_config.gradient_accumulation, train_config.steps_per_dispatch)
                == ("yolox-s", "yolox-nano", 64, TRAIN_B, "bfloat16", STEPS, True, RLFT_WINDOW,
                    RLFT_WINDOW), f"rlft: config {model_config}, {train_config}")
        steps = model_config.block_size
        model = port.GPT.from_config(model_config, port.get_actions_info(train_config),
                                     device=DEVICE).eval()
        calls = module_kernel_calls(model, model_config.patch_size)
        del model
        per_call = {call: per_kernel(c) for call, c in calls.items()}
        per_iter = {k: steps * n for k, n in per_call["embedder"].items()} | {
            "flash_attention": N_LAYER}
        rlft_passes(port, flags, toy, seed, per_iter, UNTIMED_PASSES, timed=False)
        shared = shared_flags(port, seed, sup_run, run_dir)
        shared["launches"] = shared_passes(port, seed, toy, shared)
        shared["toy"] = toy
        beside = time.perf_counter() - start
        proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - start
    stdout, stderr = (root / "cli.txt").read_text(), (root / "cli_err.txt").read_text()
    require(proc.returncode == 0, f"rlft: {RLFT_SCRIPT} exited {proc.returncode}:\n"
            f"{stdout[-3000:]}\n{stderr[-3000:]}")
    lines = stdout.splitlines()
    require(any(ln.startswith(f"Warm-starting params from {sup_run}/") for ln in lines),
            "rlft: no warm start from the supervised run")
    counts = json.loads([ln for ln in lines if ln.startswith("kernel launches: ")][-1]
                        .split(": ", 1)[1])
    peak = [ln for ln in lines if ln.startswith("peak device memory: ")][-1]
    files = {p.name for p in run_dir.iterdir()}
    require({"config.json", "checkpoint.pt", "train_state.pt", "metrics.json",
             "best_model.txt"} <= files, f"rlft: run files {sorted(files)}")
    metrics = json.loads((run_dir / "metrics.json").read_text())
    require(all(math.isfinite(v) for v in metrics.values())
            and {"map", "yolo_map", "stop_used", "stop_misused", "episode_length"}
            <= set(metrics), f"rlft: final validation metrics {metrics}")
    n_worst = int(train_config.failure_select_rate * RECIPE_TEST)
    test = rl_test_launches(RECIPE_TEST, n_worst, steps, train_config.max_det_patches, per_call)
    expected = Counter({k: RLFT_ITERS * n for k, n in per_iter.items()}) + Counter(test)
    expected = {k: expected.get(k, 0) for k in KERNEL_NAMES}
    require(counts == expected, f"rlft: kernel launches {counts}, expected {expected}")
    say(f"rlft: {RLFT_SCRIPT} <dir> <11c run> yolox-s {RLFT_ITERS} in {seconds:.1f} s"
        f" ({RLFT_ITERS} iterations of B={TRAIN_B}, {steps} patches of"
        f" {model_config.patch_size} px, bf16, accumulation {RLFT_WINDOW}, and the final test"
        f" of {RECIPE_TEST} images; beside it this process ran 11d's and 11e's untimed passes"
        f" in {beside:.1f} s); {peak}; kernel launches {counts} = {RLFT_ITERS} x"
        f" {per_iter} + the final test's {test}, as derived; final validation: " + ", ".join(
            f"{k} {metrics[k]:.4f}" for k in ("map", "yolo_map", "stop_used", "episode_length")))
    rows = recipe_kernel_rows(port, calls, steps, seed, sizes=(("rollout", "embedder", TRAIN_B),))
    rlft_passes(port, flags, toy, seed, per_iter, TIMED_PASSES, timed=True)
    say(f"rlft: the phase took {time.perf_counter() - phase_start:.1f} s")
    return Counter(counts), rows, shared


def shared_config(port, run_dir):
    """The flags of ``run_dir``'s ``config.json`` with the recipes' default
    pairing: the yolox-nano detector's backbone as the embedder (no
    ``--gpt-backbone``)."""
    train_config, model_config = port.tconfig.config_from_file(run_dir / "config.json")
    model_config.image_processor, model_config.gpt_backbone = "yolox-nano", None
    return train_config, model_config


def shared_flags(port, seed, sup_run, rlft_run) -> dict:
    """Phase 11e's two configurations: 11c's (``sup_run``) and 11d's
    (``rlft_run``) flags in the shared pairing, the supervised one with no
    warm-up (its update at the recipe's full learning rate, not at 0) and
    the fine-tune warm-started from an 8-action state of the pairing
    (weights and BN statistics from ``seed``) written as a supervised run;
    the launches of a fine-tune iteration (the rollout's ``max_seq_len``
    embedder calls, the recompute's one and N_LAYER flash) and the
    embedder's kernel calls."""
    root = ROOT / "build" / "chip_smoke_shared"
    shutil.rmtree(root, ignore_errors=True)
    sup_train, sup_model = shared_config(port, sup_run)
    sup_train.lr_warmup_iters = 0
    torch.manual_seed(seed)
    model = port.GPT.from_config(sup_model, port.get_actions_info(sup_train),
                                 device=DEVICE).eval()
    randomize_bn(model, seed)
    port.save_model(model, root / "sup", best=True)
    calls = module_kernel_calls(model, sup_model.patch_size)
    del model
    rl_train, rl_model = shared_config(port, rlft_run)
    rl_train.init_from = str(root / "sup")
    steps = rl_model.block_size
    embedder = per_kernel(calls["embedder"])
    per_iter = {k: (steps + 1) * n for k, n in embedder.items()} | {"flash_attention": N_LAYER}
    say(f"shared: a fine-tune iteration launches {per_iter}: the rollout's {steps} embedder"
        f" calls and the recompute's one, {embedder} each, and {N_LAYER} flash")
    return {"sup": (sup_train, sup_model), "rl": (rl_train, rl_model), "per_iter": per_iter,
            "calls": calls, "steps": steps}


def shared_passes(port, seed, toy, shared) -> Counter:
    """Phase 11e's checks, the recipes' default shared yolox-nano pairing
    (the detector's own backbone as the embedder, no ``--gpt-backbone``) on
    11c's toy set at 11c's and 11d's flags (:func:`shared_flags`):
    SHARED_SUP_STEPS supervised steps (SHARED_SUP_DET_STEPS under
    :func:`deterministic`), then one fine-tune window, each graphed (the
    embedder as a forward-only graph of the shared backbone,
    ``TrainGraphs.shared_embedder``, captured at its second step: the
    supervised runs take :func:`graphed_window`'s ``warm`` step, the
    window's first iteration runs it eagerly) against eager by :func:`graphed_window`
    with ``shared`` in each of SHARED_PASSES: float32 losses equal, the
    weights by 11d's rule and the BN buffers within GRAPH_ATOL, under
    :func:`deterministic` both within RLFT_DET_ATOL; bf16 losses within
    GRAPH_RTOL; no gradient on the shared backbone from the decision or
    REINFORCE loss. The launches a step: N_LAYER flash in the supervised
    step (its train-mode convs are PyTorch's); in a fine-tune iteration the
    rollout's and the recompute's embedder calls and N_LAYER flash. None is
    timed: they run beside 11d's CLI (:func:`rlft_phase`). Returns their
    launches."""
    launches = Counter()
    parts = (("shared sup", shared["sup"], {"flash_attention": N_LAYER},
              (SHARED_SUP_STEPS, SHARED_SUP_DET_STEPS), True,
              {"embedder": 0, "shared_embedder": 1, "detector": 1, "rollout": 0}),
             ("shared rlft", shared["rl"], shared["per_iter"], (RLFT_WINDOW, RLFT_WINDOW), False,
              {"embedder": 0, "shared_embedder": 1, "detector": 1, "rollout": 1}))
    for what, flags, per_iter, (default_steps, exact_steps), warm, captures in parts:
        for dtype, exact in SHARED_PASSES:
            steps = exact_steps if exact else default_steps
            with deterministic() if exact else contextlib.nullcontext() as warned:
                launches += graphed_window(port, *flags, toy, seed, per_iter, dtype, warned,
                                           what=what, steps=steps, captures=captures,
                                           shared=True, timed=False, warm=warm)
    return launches


def key_route_draws(seed):
    """The key route's draws on the card against the same draws on the CPU:
    split, fold_in, bits, uniform, randint and bernoulli bit-equal, normal
    within KEY_NORMAL_ULPS, the augmentation within KEY_AUG_ATOL."""
    from jolineedle_tpu_torch.ops.augment import detection_augment
    from jolineedle_tpu_torch.utils import jax_random as jr

    start = time.perf_counter()
    worst = 0
    for s in (seed, seed + 1, 123456789):
        cpu, card = jr.to_device(jr.prng_key(s), "cpu"), jr.to_device(jr.prng_key(s), DEVICE)
        draws = {"split": lambda k: jr.split(k, 5), "fold_in": lambda k: jr.fold_in(k, 7)}
        for shape in ((), (7,), (4, 5), (TRAIN_B * 8, 64, 64, 3)):
            draws |= {f"{name} {shape}": (lambda k, f=f, shape=shape: f(k, shape)) for name, f in (
                ("bits", jr.random_bits), ("uniform", lambda k, sh: jr.uniform(k, sh, 0.1, 2.0)),
                ("randint", lambda k, sh: jr.randint(k, sh, 0, 24)),
                ("bernoulli", lambda k, sh: jr.bernoulli(k, 0.9, sh)))}
            a, b = jr.normal(cpu, shape), jr.normal(card, shape).cpu()
            if a.numel():
                worst = max(worst, int((a.view(torch.int32).long() - b.view(torch.int32).long())
                                       .abs().max()))
        for name, draw in draws.items():
            require(torch.equal(draw(cpu), draw(card).cpu()),
                    f"key route: the card's {name} draw of seed {s} differs from the CPU's")
    require(worst <= KEY_NORMAL_ULPS, f"key route: the card's normal is {worst} ulp from the CPU's")
    images = torch.randint(0, 256, (TRAIN_B, 8, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(seed))
    cpu = detection_augment(jr.prng_key(seed), images)
    err = float((detection_augment(jr.prng_key(seed), images.to(DEVICE)).cpu() - cpu).abs().max())
    require(err <= KEY_AUG_ATOL, f"key route: the card's augmentation is {err} from the CPU's")
    say(f"key route: split, fold_in, bits, uniform, randint and bernoulli on the card equal the"
        f" CPU's bit for bit, normal within {worst} ulp (up to {TRAIN_B * 8 * 64 * 64 * 3}"
        f" draws), the augmentation of {TRAIN_B} x 8 patches within {err:.3g};"
        f" {time.perf_counter() - start:.1f} s")


def key_route_steps(port, seed, shared) -> Counter:
    """KEY_STEPS supervised steps of the shared pairing (11e's flags) on the
    key route from one state on the same batches, with the TPU-precision
    option off and on: the same step keys, finite losses that the option
    moves, N_LAYER flash launches a step. Returns the launches."""
    from jolineedle_tpu_torch.parallel import mesh
    from jolineedle_tpu_torch.utils.jax_random import KeyStream

    start = time.perf_counter()
    train_config, model_config = copy.deepcopy(shared["sup"][0]), shared["sup"][1]
    train_config.work_dir = str(shared["toy"].parent / "key_route")
    trainer = port.build_trainer(mesh.single(torch.device(DEVICE)), train_config, model_config,
                                 shared["toy"], log=False)
    trainer.pool = trainer.train_pool()
    rng = np.random.default_rng(seed)
    batches = [trainer.build_batch(rng.integers(0, len(trainer.train_dataset), TRAIN_B).tolist(),
                                   seed + i) for i in range(KEY_STEPS)]
    state = copy.deepcopy(trainer.model.state_dict())
    opt = copy.deepcopy(trainer.optimizer.state_dict())
    launches, losses = Counter(), {}
    for option in (False, True):
        trainer.model.load_state_dict(state)
        trainer.optimizer.load_state_dict(copy.deepcopy(opt))
        trainer.step, trainer.key_stream = 0, KeyStream(seed)
        trainer.model.tpu_default_precision = option
        reset_launches(port)
        losses[option] = [float(trainer.train_step(b)["loss"]) for b in batches]
        torch.cuda.synchronize()
        launches.update(check_launches(port, f"key route: {KEY_STEPS} steps (TPU precision"
                                       f" {option})", {"flash_attention": KEY_STEPS * N_LAYER}))
    trainer.model.tpu_default_precision = False
    require(all(math.isfinite(v) for v in losses[False] + losses[True])
            and losses[False] != losses[True], f"key route: losses {losses}")
    say(f"key route: {KEY_STEPS} supervised steps of the shared pairing"
        f" ({model_config.compute_dtype}, B={TRAIN_B}) on JAX's keys of seed {seed}: losses"
        f" {losses[False]}, with the TPU-precision option {losses[True]};"
        f" {time.perf_counter() - start:.1f} s")
    return launches


def shared_phase(port, seed, shared):
    """Phase 11e's kernels, alone on the card: the embedder's at the
    recompute's TRAIN_B x ``max_seq_len`` patches against their plain
    versions; then the key route (:func:`key_route_draws`,
    :func:`key_route_steps`). Returns the launches of :func:`shared_passes`
    (run by :func:`rlft_phase`) and the key route's steps, and the kernel
    rows."""
    phase_start = time.perf_counter()
    rows = recipe_kernel_rows(port, shared["calls"], shared["steps"], seed,
                              sizes=(("recompute", "embedder", TRAIN_B * shared["steps"]),))
    key_route_draws(seed)
    launches = shared["launches"] + key_route_steps(port, seed, shared)
    say(f"shared: the phase took {time.perf_counter() - phase_start:.1f} s")
    return launches, rows


def run_dir_state(run_dir: Path) -> dict:
    """Every file under ``run_dir`` with its size and mtime."""
    return {str(p.relative_to(run_dir)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(run_dir.rglob("*"))}


def flops_check(port, flags):
    """``--measure-flops`` through the train CLI on the card and on the CPU:
    the same report, no kernel launch, and no card memory beyond the
    model's weights in the FLOP pass itself."""
    from jolineedle_tpu_torch.utils.flops import measure_flops

    reset_launches(port)
    trainer = port.train_main(port.tconfig.get_args(flags), device="cuda")
    check_launches(port, "--measure-flops on the card", {})
    cpu = port.train_main(port.tconfig.get_args(flags), device="cpu")
    require(trainer.flops_report == cpu.flops_report,
            f"--measure-flops: the card's report {trainer.flops_report} differs from the CPU's"
            f" {cpu.flops_report}")
    require(not (trainer.checkpoint_dir / "checkpoint.pt").exists(),
            "--measure-flops trained and wrote a checkpoint")
    model = trainer.model
    weights = sum(t.numel() * t.element_size()
                  for t in list(model.parameters()) + list(model.buffers()))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train_config, model_config = port.tconfig.args_to_config(port.tconfig.get_args(flags))
    measure_flops(trainer, model_config, train_config)
    grown = torch.cuda.max_memory_allocated() - base
    require(grown < weights, f"--measure-flops: the FLOP pass took {grown} bytes of card memory,"
            f" the model's weights are {weights}")
    check_launches(port, "--measure-flops on the card, twice", {})
    report = trainer.flops_report
    seq = max(report["seq_len"])  # 16 at the flagship's 20 steps
    say(f"--measure-flops: the card's report equals the CPU's; complete model at seq len {seq}:"
        f" {report['seq_len'][seq]:.6g} FLOPs ({report['seq_len'][seq] / 1e9:.3f} GFLOP), backbone"
        f" on one {PATCH} px patch {report['backbone']:.6g}, YOLOX on one patch"
        f" {report['yolox']:.6g}, on {8 * PATCH}x{8 * PATCH} {report['yolox_image']:.6g};"
        f" params {report['params']}; the FLOP pass took {grown} bytes of card memory"
        f" (the weights: {weights}), no kernel launch")


def timed_test(port, trainer):
    """One ``trainer.test()``: its wall ms (ending in a device sync), its
    launch counts and the panels it handed to ``log_eval``."""
    panels = {}
    log_eval = trainer.log_eval

    def capture(metrics, mode_panels, mode):
        panels.update(mode_panels)
        log_eval(metrics, mode_panels, mode)

    trainer.log_eval = capture
    torch.cuda.synchronize()
    reset_launches(port)
    start = time.perf_counter()
    trainer.test()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3
    metrics = {k: float(np.mean(v)) for k, v in trainer.last_test_metrics.items()}
    return ms, read_launches(port), panels, metrics


def panels_check(port, mode, make_trainer, expected_launches):
    """``test()`` of a fresh trainer three times: twice at
    ``--failure-select-rate`` FAILURE_RATE (the same metrics, the expected
    launches, the panels' inputs built and, without matplotlib, the panel
    line printed and no image handed over), once at 0 (the worst pass's
    share of the cycle). Returns the launch counts."""
    from jolineedle_tpu_torch.utils.plotting import matplotlib_available

    n_worst = int(FAILURE_RATE * EVAL_TEST)
    launches = Counter()
    runs = []
    for rate in (FAILURE_RATE, FAILURE_RATE, 0.0):
        trainer = make_trainer(rate)
        ms, counts, panels, metrics = timed_test(port, trainer)
        want = {k: expected_launches(EVAL_TEST, n_worst if rate else 0).get(k, 0)
                for k in KERNEL_NAMES}
        if counts != want:
            raise AssertionError(f"{mode} test (failure rate {rate}): kernel launches {counts},"
                                 f" expected {want}")
        launches += Counter(counts)
        n_panels = {k: len(v) for k, v in panels.items()}
        want_panels = {"model_images": min(6, EVAL_TEST)}
        if mode == "supervised":
            want_panels["sample_images"] = min(6, EVAL_TEST)
        if rate:
            want_panels["worst_images"] = n_worst
        require(n_panels == want_panels, f"{mode} test: panels {n_panels}, expected {want_panels}")
        require(all(p["patches"].shape[1] == PATCH for v in panels.values() for p in v),
                f"{mode} test: a panel's patches are not {PATCH} px")
        images = trainer.logger.visdom.images
        if matplotlib_available():
            require(len(images) == len(want_panels), f"{mode} test: drawn windows {list(images)}")
        else:
            require(trainer._said_no_matplotlib and not images,
                    f"{mode} test: without matplotlib the panel line was not printed, or images"
                    " reached the logger")
        runs.append((rate, ms, metrics))
        say(f"{mode} test of {EVAL_TEST} images (failure rate {rate}): {ms:.1f} ms wall,"
            f" launches {counts} as expected, panels {n_panels}")
    (_, _, first), (_, ms_with, second), (_, ms_without, _) = runs
    if first != second:
        diff = {k: (first.get(k), second.get(k)) for k in set(first) | set(second)
                if first.get(k) != second.get(k)}
        raise AssertionError(f"{mode} test: a fresh trainer's metrics differ: {diff}")
    say(f"{mode} test: a fresh trainer's test gave the same metrics; the worst pass"
        f" ({n_worst} image) is {ms_with - ms_without:.1f} ms of {ms_with:.1f} ms"
        f" ({(ms_with - ms_without) / ms_with:.1%}), {ms_without:.1f} ms without it")
    return launches


def eval_checkpoint_check(port, run_dir, extra, expected, want=None):
    """``scripts/eval_checkpoint.py`` on ``run_dir``: a FULL-TEST line, the
    expected launches, ``want``'s metrics where given, and the run directory
    left as it was. Returns the launch counts."""
    import contextlib
    import io

    from jolineedle_tpu_torch.scripts import eval_checkpoint

    before = run_dir_state(run_dir)
    reset_launches(port)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = eval_checkpoint.main([str(run_dir)] + extra)
    lines = [line for line in out.getvalue().splitlines() if line.startswith("FULL-TEST: ")]
    require(len(lines) == 1 and json.loads(lines[0][len("FULL-TEST: "):]) == got,
            f"eval_checkpoint {run_dir.name}: no FULL-TEST line")
    counts = check_launches(port, f"eval_checkpoint {run_dir.name}", expected)
    require(run_dir_state(run_dir) == before, f"eval_checkpoint changed {run_dir}")
    if want is not None:
        require(got == want, f"eval_checkpoint {run_dir.name}: {got}, the run's own full test"
                f" gave {want}")
    print(lines[0])
    say(f"eval_checkpoint {run_dir.name}: FULL-TEST printed ({len(got)} metrics"
        + (", equal to the run's own final test" if want is not None else "")
        + f"), {run_dir.name} unchanged ({len(before)} files, sizes and mtimes)")
    return counts


def nms_check(seed):
    """``nms_mask`` on the card against the CPU on seeded boxes."""
    from jolineedle_tpu_torch.ops.nms import nms_mask

    rng = np.random.default_rng(seed + 9)
    for n in NMS_SIZES:
        xy = rng.uniform(0, GRID * PATCH, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(16, 400, (n, 2))], 1).astype(np.float32)
        scores = rng.uniform(size=n).astype(np.float32)
        scores[rng.integers(0, n, n // 8)] = 0.5  # ties
        valid = rng.uniform(size=n) > 0.1
        args = [torch.from_numpy(a) for a in (boxes, scores, valid)]
        want = nms_mask(*args, 0.5)
        torch.cuda.synchronize()
        start = time.perf_counter()
        got = nms_mask(*(a.cuda() for a in args), 0.5)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        require(torch.equal(got.cpu(), want), f"nms_mask N={n}: the card's keep mask differs")
        say(f"nms_mask N={n}: the card's keep mask equals the CPU's ({int(want.sum())} kept),"
            f" {ms:.2f} ms wall on the card (first call)")


def eval_phase(port, seed, model_dir, sup_run):
    """The eval and report surface: ``--measure-flops``, both trainers'
    ``test()`` with their panels' work, ``eval_checkpoint`` on the
    supervised train phase's run (``sup_run``: its directory and its final
    test's metrics) and on phase 6's JAX-format run, ``infer --output-dir``
    and ``nms_mask``. Returns the launch counts of its test cycles and
    validations."""
    from jolineedle_tpu_torch.infer import get_infer_args, infer
    from jolineedle_tpu_torch.observe.logger import Logger
    from jolineedle_tpu_torch.utils.plotting import matplotlib_available

    root = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    start = time.perf_counter()
    toy = port.generate_toy_dataset(root / "toy", n_train=2, n_test=EVAL_TEST,
                                    image_size=(EVAL_GRID * PATCH,) * 2, seed=seed + 3,
                                    box_size=BOX_SIZE)
    say(f"eval: toy dataset of 2 + {EVAL_TEST} images {EVAL_GRID * PATCH}x{EVAL_GRID * PATCH} in"
        f" {time.perf_counter() - start:.1f} s; matplotlib"
        f" {'installed' if matplotlib_available() else 'not installed'}")
    flags = train_flags(toy, root / "out", seed)
    flags[flags.index("--env-name") + 1] = "eval"

    flops_flags = flags + ["--measure-flops"]
    flops_flags[flops_flags.index("--env-name") + 1] = "flops"
    flops_check(port, flops_flags)

    def make(mode):
        mode_flags = flags + ["--training-mode", mode]
        train_config, model_config = port.tconfig.args_to_config(port.tconfig.get_args(mode_flags))
        train_ds, test_ds = port.build_both_datasets(train_config, model_config, str(toy))
        torch.manual_seed(seed)
        model = port.GPT.from_config(model_config, port.get_actions_info(train_config)).eval()
        trainer_class = port.ReinforceTrainer if mode == "reinforce" else port.SupervisedTrainer

        def make_trainer(rate):
            train_config.failure_select_rate = rate
            trainer = trainer_class(train_config, model, Logger(train_config, model_config),
                                    train_ds, test_ds)
            trainer.test_env_ids = list(range(len(test_ds)))
            return trainer
        return make_trainer

    launches = panels_check(port, "reinforce", make("reinforce"), rl_test_launches)
    launches += panels_check(port, "supervised", make("supervised"), sup_test_launches)

    run_dir, full_test = sup_run
    recorded = Path(json.loads((run_dir / "config.json").read_text())["train"]["dataset_dir"])
    n_run_test = len((recorded / "test.txt").read_text().splitlines())
    launches += eval_checkpoint_check(port, run_dir, [], sup_test_launches(n_run_test),
                                      want=full_test)
    jax_run = model_dir.parent / "jax_files" / "run"
    launches += eval_checkpoint_check(
        port, jax_run, ["--dataset-dir", str(toy)],
        rl_test_launches(EVAL_TEST, int(FAILURE_RATE * EVAL_TEST)))

    image = sorted((toy / "images").glob("test_*.png"))[0]
    args = get_infer_args(["--model-dir", str(model_dir), "--input-images", str(image),
                           "--output-dir", str(root / "infer")])
    reset_launches(port)
    if matplotlib_available():
        infer(args)
        require((root / "infer" / "result0.png").exists(), "infer --output-dir: no result0.png")
        say("infer --output-dir: result0.png written")
        launches += Counter(read_launches(port))
    else:
        try:
            infer(args)
        except ImportError as e:
            require("matplotlib" in str(e), f"infer --output-dir: {e}")
            check_launches(port, "infer --output-dir without matplotlib (raised first)", {})
            say(f"infer --output-dir raised before any rollout: {e}")
        else:
            raise AssertionError("infer --output-dir ran without matplotlib")

    nms_check(seed)
    say(f"eval: the phase took {time.perf_counter() - start:.1f} s")
    return launches


# --- phase 13: data-parallel training ------------------------------------------------------
# Two ranks of DDP_B rows against one of 2 DDP_B, DDP_ITERS iterations of each
# mode (accumulation TRAIN_ACCUM: updates after 2 and 4), float32; then the
# bf16 timing at 2 x DDP_TIME_B, DDP_TIME_ITERS iterations a mode.
DDP_B, DDP_ITERS, DDP_TIME_B, DDP_TIME_ITERS, DDP_NCCL_ITERS = 4, 4, 8, 3, 2


def counted() -> str:
    """The wrappers' counter the phase reads: their launches on the card,
    their calls in a rehearsal on the CPU (where nothing launches)."""
    return "launches" if DEVICE == "cuda" else "calls"


def ddp_flags(toy, work_dir, seed, mode, batch, dtype="float32", augment=True):
    """The flagship train flags in ``mode`` at ``batch`` rows a rank, with
    no test; the geometric augmentations on when ``augment``."""
    flags = train_flags(toy, work_dir, seed)
    for flag, value in (("--training-mode", mode), ("--batch-size", batch),
                        ("--compute-dtype", dtype), ("--env-name", f"ddp_{mode}"),
                        ("--num-workers", 2)):
        flags[flags.index(flag) + 1] = str(value)
    if mode == "supervised":
        flags[flags.index("--dropout") + 1] = "0.1"
    return flags + (["--augment-rotate", "--augment-translate"] if augment else [])


def ddp_compare(what, one, ranks_out, ranks_mod):
    """A W = 2 run's ranks against the W = 1 run at the global batch by
    ``parallel/ranks.compare_runs`` (every rank's state bit-equal to rank
    0's after every iteration; losses; weights; BN statistics; the kernel
    launches of every iteration exactly W = 1's). Returns its numbers."""
    misses, numbers = ranks_mod.compare_runs(one, ranks_out, TRAIN_ACCUM, lambda name: 1e-4)
    require(not misses, f"{what}: {misses[:5]}")
    return numbers["loss_before"], numbers["loss_after"], numbers["stats"]


def ddp_cards() -> list:
    """The cards of (e): every visible one, or two where their count does
    not divide the global batch of 2 DDP_B rows; none with fewer than two."""
    n = torch.cuda.device_count() if DEVICE == "cuda" else 0
    if n < 2:
        return []
    return [torch.device("cuda", i) for i in range(n if (2 * DDP_B) % n == 0 else 2)]


def ddp_cli_check(port, toy, root, seed, cards):
    """(e)'s train CLI with ``--devices`` over ``cards``: one rank on each
    card (``mesh.rank_devices``), REINFORCE for DDP_NCCL_ITERS iterations
    with a test on rank 0 after the last, behind the state check
    (``check_agree``) and the barrier, then the final test. Every rank
    reports the digest they agreed on and the same losses; rank 0 wrote the
    checkpoint."""
    flags = ddp_flags(toy, root / "cli", seed, "reinforce", 2 * DDP_B // len(cards))
    at = flags.index("--devices")
    flags[at + 1:at + 2] = [str(i) for i in range(len(cards))]
    for flag, value in (("--max-iters", DDP_NCCL_ITERS), ("--test-every", DDP_NCCL_ITERS)):
        flags[flags.index(flag) + 1] = str(value)
    summaries = port.train_main(port.tconfig.get_args(flags))
    devices = [str(c) for c in cards]
    require([(s["rank"], s["device"]) for s in summaries] == list(enumerate(devices)),
            f"ddp nccl cli: ranks {[(s['rank'], s['device']) for s in summaries]}")
    a = summaries[0]
    require(a["digest"] is not None and len(a["losses"]) == DDP_NCCL_ITERS
            and all(math.isfinite(x) for x in a["losses"])
            and all(b["digest"] == a["digest"] and b["losses"] == a["losses"]
                    for b in summaries[1:]),
            f"ddp nccl cli: the ranks' summaries {summaries}")
    require((root / "cli" / "ddp_reinforce" / "checkpoint.pt").is_file(),
            "ddp nccl cli: rank 0 wrote no checkpoint")
    say(f"ddp nccl cli: --devices {' '.join(flags[at + 1:at + 1 + len(cards)])} trained on"
        f" {devices} over NCCL, tested on rank 0 behind the state check and the barrier:"
        f" losses {a['losses']} on every rank, digests equal")


def ddp_scaling(seed, toy, root, cards, ranks_mod, mesh):
    """bf16 steps at DDP_TIME_B rows a rank, one rank per card, at W = 1,
    2 and len(cards): the wall ms per step, images/s and the gradient
    all-reduce's ms and bytes, DDP_TIME_ITERS iterations a mode."""
    modes = ("supervised", "reinforce")
    jobs = [dict(flags=ddp_flags(toy, root / "scaling", seed, m, DDP_TIME_B, dtype="bfloat16",
                                 augment=False), iters=DDP_TIME_ITERS, time=True)
            for m in modes]
    widths = sorted({1, 2, len(cards)})
    for w in widths:
        runs = ([ranks_mod.train_rank_steps(mesh.single(cards[0]), jobs)] if w == 1
                else mesh.launch(ranks_mod.train_rank_steps, (jobs,), cards[:w]))
        for i, mode in enumerate(modes):
            recs = [r[i] for r in runs]
            require(all(r["digests"] == recs[0]["digests"] for r in recs),
                    f"ddp scaling {mode} W={w}: the ranks disagree")
            step_ms = statistics.median(x for r in recs for x in r["step_ms"])
            sync = (f"; gradient all-reduce (NCCL) {recs[0]['sync_ms']:.2f} ms for"
                    f" {recs[0]['sync_bytes']:,} bytes" if w > 1 else "")
            say(f"ddp scaling {mode} bf16: W={w} x B={DDP_TIME_B}, one rank per card,"
                f" {step_ms:.2f} ms wall per step, {1e3 * w * DDP_TIME_B / step_ms:.1f} images/s"
                f"{sync}; losses {[round(x, 4) for x in recs[0]['losses']]}")


def spd_rank_jobs(toy, root, seed):
    """Phase 14's jobs for two ranks sharing the card: REINFORCE at
    ``--steps-per-dispatch`` 1 and SPD_N (float32, untimed)."""
    return [dict(flags=ddp_flags(toy, root / f"spd{spd}", seed, "reinforce", DDP_B)
                 + ["--steps-per-dispatch", str(spd)], iters=DDP_ITERS, tf32=False)
            for spd in (1, SPD_N)]


def launch_beside(fn, args, devices, backend):
    """``mesh.launch(fn, args, devices, backend)`` on a thread of its own,
    started now; returns a function that waits for it and returns what it
    returned (or raises what it raised)."""
    from jolineedle_tpu_torch.parallel import mesh

    box = {}

    def target():
        try:
            box["out"] = mesh.launch(fn, args, devices, backend=backend)
        except BaseException as err:  # handed to the caller at the join
            box["err"] = err

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    join.alive = thread.is_alive
    return join


def wait_for(path, rank: int, timeout: float = 900.0, every: float = 0.05) -> None:
    """Write ``<path>.ready<rank>``, then wait until ``path`` exists (a
    TimeoutError after ``timeout`` seconds)."""
    Path(f"{path}.ready{rank}").touch()
    deadline = time.monotonic() + timeout
    while not Path(path).exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank}: {path} did not appear in {timeout} s")
        time.sleep(every)


def held_rank_steps(world, jobs, held, go) -> list:
    """``ranks.train_rank_steps`` on ``jobs``, then on ``held`` once ``go``
    exists (:func:`wait_for`), so that this process can hold the ranks'
    timed jobs until the card is otherwise idle. ``mesh.launch`` pickles it
    by name: each spawned rank imports this script as its main module."""
    from jolineedle_tpu_torch.parallel import ranks

    done = ranks.train_rank_steps(world, jobs)
    wait_for(go, world.rank)
    return done + ranks.train_rank_steps(world, held)


def wait_ready(go: Path, n_ranks: int, alive, timeout: float = 900.0) -> None:
    """Wait until each of ``n_ranks`` ranks has written ``<go>.ready<rank>``
    (:func:`wait_for`: it has finished its jobs before the held ones), or
    raise when the launch (``alive``) ended first or ``timeout`` passed."""
    deadline = time.monotonic() + timeout
    while not all(Path(f"{go}.ready{r}").exists() for r in range(n_ranks)):
        require(alive() and time.monotonic() < deadline,
                f"the ranks did not reach {go.name} (the launch ended or {timeout} s passed)")
        time.sleep(0.05)


def ddp_phase(port, seed, toy):
    """Data-parallel training (``parallel/mesh.py``): (a) two ranks sharing
    the card over gloo against one rank at the global batch, each mode; (b)
    their kernel launches per iteration; (c) the train CLI as the one rank
    of an NCCL group from torchrun's variables against the same run without
    a group; (d) bf16 step times at W = 2 on the shared card; (e) NCCL
    across every visible card when there are two or more, the train CLI
    over them and, past two, bf16 step times at W = 1, 2 and all.

    The two ranks of (a) and (d) run in one launch that also takes phase
    14's two-rank jobs (:func:`spd_rank_jobs`), started first: while the
    ranks run their untimed jobs, this process runs its own untimed ones
    (W = 1 of (a), then (c)); then it waits for the ranks to finish those,
    times W = 1 of (d) while they wait, and lets them run (d) while it
    waits. So no timed run shares the card. Returns the launches of the
    ranks' runs and of (c)'s grouped run, and the ranks' results of phase
    14's jobs."""
    from jolineedle_tpu_torch.parallel import ranks as ranks_mod
    from jolineedle_tpu_torch.parallel import mesh

    start = time.perf_counter()
    root = toy.parent / "ddp"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    modes = ("supervised", "reinforce")
    jobs = lambda batch, **kw: [dict(flags=ddp_flags(toy, root, seed, m, batch, **kw), **(
        {"iters": DDP_TIME_ITERS, "time": True} if kw else {"iters": DDP_ITERS}), tf32=False)
        for m in modes]
    bf16 = dict(dtype="bfloat16", augment=False)
    card = torch.device("cuda", 0) if DEVICE == "cuda" else torch.device(DEVICE)

    # (a), (b), (d) and phase 14's ranks: the two ranks run every job in one
    # launch, (d)'s held until this process lets them go
    go = root / "timed.go"
    n = len(modes)
    launch_start = time.perf_counter()
    two = launch_beside(held_rank_steps,
                        (jobs(DDP_B) + spd_rank_jobs(toy, root, seed), jobs(DDP_TIME_B, **bf16),
                         str(go)), [card, card], "gloo")
    try:
        one = ranks_mod.train_rank_steps(mesh.single(card), jobs(2 * DDP_B))
        grouped_counts, a = ddp_nccl_check(port, toy, root, seed)
        beside = time.perf_counter() - launch_start
        wait_ready(go, 2, two.alive)
        untimed = time.perf_counter() - launch_start
        one_timed = ranks_mod.train_rank_steps(mesh.single(card), jobs(2 * DDP_TIME_B, **bf16))
    finally:
        go.touch()  # on a failure too: the ranks then finish and exit
    two = two()
    say(f"ddp: two ranks on cuda:0 over gloo ran {n} x 2 jobs and phase 14's 2 in"
        f" {time.perf_counter() - launch_start:.1f} s (process start and kernel loads"
        f" included); beside them this process ran W=1 of (a) and (c) in {beside:.1f} s, the"
        f" ranks' untimed jobs ended at {untimed:.1f} s, then W=1 of (d) and the ranks' (d)"
        f" ran in turns, each alone on the card")
    launches = Counter()
    for rank in two:
        for job in rank[:n] + rank[n + 2:]:
            for counts in job[counted()]:
                launches.update(counts)
    for i, mode in enumerate(modes):
        before, after, stat_rel = ddp_compare(f"ddp {mode}", one[i], [r[i] for r in two],
                                              ranks_mod)
        per_it = one[i][counted()]
        say(f"ddp {mode}: W=2 x B={DDP_B} (gloo, one card) against W=1 x B={2 * DDP_B}, float32,"
            f" {DDP_ITERS} iterations: losses {[round(x, 6) for x in two[0][i]['losses']]}"
            f" against {[round(x, 6) for x in one[i]['losses']]} (largest relative difference"
            f" {before:.2e} before the first update, {after:.2e} after), BN statistics"
            f" {stat_rel:.2e} apart, every rank's state bit-equal to rank 0's after each"
            f" iteration; launches per iteration and rank {per_it[0]}, exactly W=1's")
        require(all(c["flash_attention"] == N_LAYER for c in per_it),
                f"ddp {mode}: flash launches {per_it}")
        require(mode == "supervised" or all(c["dwblock_bn_silu"] > 0 for c in per_it),
                f"ddp {mode}: conv launches {per_it}")
    for i, mode in enumerate(modes):
        t = [r[n + 2 + i] for r in two]
        require(t[0]["digests"] == t[1]["digests"], f"ddp {mode} bf16: the ranks disagree")
        step_ms = statistics.median(t[0]["step_ms"] + t[1]["step_ms"])
        one_ms = statistics.median(one_timed[i]["step_ms"])
        bn = statistics.median(c.get("bn", 0) for c in t[0]["collectives"])
        say(f"ddp {mode} bf16: W=2 x B={DDP_TIME_B} on ONE card shared by both ranks (not a"
            f" multi-card time) {step_ms:.2f} ms wall per step, against W=1 x B={2 * DDP_TIME_B}"
            f" {one_ms:.2f} ms; gradient all-reduce (gloo, through the host) {t[0]['sync_ms']:.2f}"
            f" ms for {t[0]['sync_bytes']:,} bytes; {bn:.0f} BN syncs per step; losses"
            f" {[round(x, 4) for x in t[0]['losses']]}")

    launches.update(grouped_counts)
    say(f"ddp nccl: the train CLI as rank 0 of 1 under torchrun's variables (NCCL): losses {a},"
        f" equal to the run without a group; launches {grouped_counts} as there")

    # (e): NCCL across every visible card
    cards = ddp_cards()
    if cards:
        w = len(cards)
        nccl = mesh.launch(ranks_mod.train_rank_steps, (jobs(2 * DDP_B // w),), cards)
        for i, mode in enumerate(modes):
            before, after, stat_rel = ddp_compare(f"ddp nccl {mode}", one[i],
                                                  [r[i] for r in nccl], ranks_mod)
            say(f"ddp nccl {mode}: W={w} x B={2 * DDP_B // w} on {[str(c) for c in cards]}"
                f" against W=1: largest relative loss difference {before:.2e} / {after:.2e},"
                f" BN statistics {stat_rel:.2e}; states bit-equal across ranks")
        for rank in nccl:
            for job in rank:
                for counts in job[counted()]:
                    launches.update(counts)
        ddp_cli_check(port, toy, root, seed, cards)
        if w > 2:
            ddp_scaling(seed, toy, root, cards, ranks_mod, mesh)
    else:
        say("ddp: one card visible, so NCCL across cards (13e) was not run")
    say(f"ddp: the phase took {time.perf_counter() - start:.1f} s")
    return launches, [rank[n:n + 2] for rank in two]


def ddp_nccl_check(port, toy, root, seed):
    """(c): the train CLI as the one rank of an NCCL group from torchrun's
    variables, against the same run without a group: equal losses and
    launches. Returns the grouped run's launches and losses."""
    from jolineedle_tpu_torch.parallel import mesh

    card = torch.device("cuda", 0) if DEVICE == "cuda" else torch.device(DEVICE)
    flags = ddp_flags(toy, root / "nccl", seed, "reinforce", DDP_B, dtype="bfloat16",
                      augment=False)
    flags[flags.index("--max-iters") + 1] = str(DDP_NCCL_ITERS)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        free_port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(free_port)}
    reset_launches(port)
    os.environ.update(env)
    try:
        grouped = port.train_main(port.tconfig.get_args(flags))
    finally:
        for key in env:
            del os.environ[key]
    grouped_counts = read_launches(port)
    require(grouped.world.backend == mesh.default_backend(card) and grouped.world.grouped
            and not torch.distributed.is_initialized(),
            f"ddp nccl: the run's world {grouped.world}")
    reset_launches(port)
    alone = port.train_main(port.tconfig.get_args(flags))
    alone_counts = read_launches(port)
    a = [float(v) for v in grouped.loss_history]
    b = [float(v) for v in alone.loss_history]
    require(len(a) == DDP_NCCL_ITERS and a == b,
            f"ddp nccl: losses {a} as one rank of an NCCL group, {b} without a group")
    require(grouped_counts == alone_counts, f"ddp nccl: launches {grouped_counts} / {alone_counts}")
    return grouped_counts, a


# --- phase 14: --steps-per-dispatch ----------------------------------------------------------
# Each mode at N = SPD_N and 1: SPD_ITERS iterations of SPD_B rows, float32, a
# test every SPD_N; the bf16 step times at TRAIN_B over SPD_TIME_ITERS
# iterations, from the third on (8 until the script had to fit 600 s).
SPD_N, SPD_B, SPD_ITERS, SPD_TIME_ITERS = 2, 4, 5, 6


def per_step_counts(port, fn):
    """``fn()`` with each trainer's ``train_step`` recording its kernel
    launches; returns (fn's result, the launches of every step in order)."""
    record, classes = [], (port.ReinforceTrainer, port.SupervisedTrainer)
    originals = {cls: cls.train_step for cls in classes}

    def recording(step):
        def train_step(self, batch):
            before = read_launches(port)
            out = step(self, batch)
            record.append(dict(Counter(read_launches(port)) - Counter(before)))
            return out
        return train_step

    for cls in classes:
        cls.train_step = recording(originals[cls])
    try:
        return fn(), record
    finally:
        for cls, step in originals.items():
            cls.train_step = step


def spd_flags(toy, work_dir, seed, mode, spd, extra=()):
    """Phase 13's float32 flags in ``mode`` at SPD_B rows, with
    ``--steps-per-dispatch spd``, a test every SPD_N and SPD_ITERS
    iterations (the supervised loop runs ``--max-iters`` - 1)."""
    flags = ddp_flags(toy, work_dir, seed, mode, SPD_B)
    max_iters = SPD_ITERS + (mode == "supervised")
    for flag, value in (("--max-iters", max_iters), ("--test-every", SPD_N),
                        ("--env-name", f"spd_{mode}_{spd}")):
        flags[flags.index(flag) + 1] = str(value)
    return flags + ["--steps-per-dispatch", str(spd), *extra]


def spd_refused(port, flags, what):
    """The train CLI on ``flags`` must raise JAX's ValueError before any
    launch."""
    before = read_launches(port)
    try:
        port.train_main(port.tconfig.get_args(flags))
    except ValueError as err:
        message = str(err)
    else:
        raise AssertionError(f"spd: {what} trained")
    require("steps-per-dispatch" in message and read_launches(port) == before,
            f"spd: {what}: {message!r}, launches {read_launches(port)} after {before}")
    say(f"spd: {what} refused before any launch: {message}")


def spd_step_ms(port, flags, spd):
    """The wall ms per bf16 train iteration at ``--steps-per-dispatch spd``
    through ``Trainer.train_loop`` (the CLI's trainer, no test), from the
    third iteration's start to the device's end of the last."""
    from jolineedle_tpu_torch.main import build_trainer
    from jolineedle_tpu_torch.parallel import mesh

    args = port.tconfig.get_args(flags + ["--steps-per-dispatch", str(spd)])
    train_config, model_config = port.tconfig.args_to_config(args)
    trainer = build_trainer(mesh.single(DEVICE), train_config, model_config, args.dataset_dir,
                            log=False)
    starts, step = [], trainer.train_step
    trainer.train_step = lambda batch: (starts.append(time.perf_counter()), step(batch))[1]
    trainer.train_loop(range(1, SPD_TIME_ITERS + 1))
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - starts[2]) / (SPD_TIME_ITERS - 2)
    del trainer
    return ms


def spd_phase(port, seed, toy, two=None):
    """``--steps-per-dispatch``: each mode through the train CLI at SPD_N
    and at 1 (float32): equal losses, weights, statistics, REINFORCE
    return window and launches; the CLI's errors; two ranks at SPD_N
    against 1 (``two``: the ranks' results of :func:`spd_rank_jobs`, which
    phase 13's launch ran; None: launched here); bf16 step times. Returns
    the launches of its runs."""
    from jolineedle_tpu_torch.parallel import mesh, ranks as ranks_mod

    start = time.perf_counter()
    root = toy.parent / "spd"
    shutil.rmtree(root, ignore_errors=True)
    launches = Counter()
    for mode in ("supervised", "reinforce"):
        runs = {}
        for spd in (1, SPD_N):
            reset_launches(port)
            trainer, steps = per_step_counts(port, lambda: port.train_main(
                port.tconfig.get_args(spd_flags(toy, root, seed, mode, spd))))
            total = read_launches(port)
            launches.update(total)
            runs[spd] = (trainer, steps, total)
        (one, one_steps, one_total), (many, many_steps, many_total) = runs[1], runs[SPD_N]
        a = np.array([float(v) for v in one.loss_history])
        b = np.array([float(v) for v in many.loss_history])
        require(len(a) == len(b) == SPD_ITERS and np.allclose(b, a, rtol=1e-4, atol=0),
                f"spd {mode}: losses {b.tolist()} at N={SPD_N}, {a.tolist()} at N=1")
        require((many.step, many.optimizer.updates, many.iter_num)
                == (one.step, one.optimizer.updates, one.iter_num),
                f"spd {mode}: step, updates, iteration")
        one_state = {k: v.cpu() for k, v in one.model.state_dict().items()}
        many_state = {k: v.cpu() for k, v in many.model.state_dict().items()}
        misses = ranks_mod.weights_disagree(one_state, many_state, lambda name: 1e-4)
        stat_rel = ranks_mod.stats_relative(one_state, many_state)
        require(not misses and stat_rel < 1e-4, f"spd {mode}: {misses[:5]}, BN {stat_rel:.3g}")
        require(many_steps == one_steps and len(one_steps) == SPD_ITERS
                and many_total == one_total,
                f"spd {mode}: launches per step {many_steps} against {one_steps}, totals"
                f" {many_total} against {one_total}")
        window = ""
        if mode == "reinforce":
            got = [many.last_return_mean, many.last_return_std]
            want = [one.last_return_mean, one.last_return_std]
            require(np.allclose(got, want, rtol=1e-4, atol=0)
                    and len(many._window_stats) == len(one._window_stats) == 1,
                    f"spd reinforce: return window {got} against {want}")
            window = f", return mean and std {got} against {want}"
        say(f"spd {mode}: the train CLI at --steps-per-dispatch {SPD_N} against 1, float32,"
            f" B={SPD_B}, {SPD_ITERS} iterations (the last chunk short), a test every {SPD_N}:"
            f" largest relative loss difference {float(np.max(np.abs(b - a) / np.abs(a))):.2e},"
            f" weights agree, BN statistics {stat_rel:.2e} apart{window}; launches per step"
            f" {one_steps[0]}, the run's {one_total}, equal")
        del one, many, runs

    refused = root / "refused"
    spd_refused(port, spd_flags(toy, refused, seed, "supervised", 3),
                "supervised N=3, test every 2")
    spd_refused(port, spd_flags(toy, refused, seed, "reinforce", 3), "reinforce N=3, test every 2")
    spd_refused(port, spd_flags(toy, refused, seed, "reinforce", 2,
                                ["--gradient-accumulation", "3"]), "reinforce N=2, accumulation 3")

    # two ranks sharing the card over gloo, at SPD_N against 1
    if two is None:
        card = torch.device("cuda", 0) if DEVICE == "cuda" else torch.device(DEVICE)
        two = mesh.launch(ranks_mod.train_rank_steps, (spd_rank_jobs(toy, root, seed),),
                          [card, card], backend="gloo")
    require(two[0][0]["digests"] == two[1][0]["digests"], "spd ddp: the N=1 ranks disagree")
    before, after, stat_rel = ddp_compare(f"spd ddp reinforce N={SPD_N}", two[0][0],
                                          [r[1] for r in two], ranks_mod)
    for rank in two:
        for job in rank:
            for counts in job[counted()]:
                launches.update(counts)
    say(f"spd ddp reinforce: W=2 x B={DDP_B} (gloo, one card) at N={SPD_N} against N=1,"
        f" {DDP_ITERS} iterations: largest relative loss difference {before:.2e} before the"
        f" first update, {after:.2e} after, BN statistics {stat_rel:.2e}; every rank's state"
        f" bit-equal to rank 0's, launches per iteration equal")

    # bf16 step times, N = 1 and SPD_N in turns
    for mode in ("supervised", "reinforce"):
        flags = ddp_flags(toy, root / "timed", seed, mode, TRAIN_B, dtype="bfloat16",
                          augment=False)
        times = {1: [], SPD_N: []}
        for spd in (1, SPD_N, SPD_N, 1, 1, SPD_N):
            times[spd].append(spd_step_ms(port, flags, spd))
        say(f"spd {mode} bf16 B={TRAIN_B}: {statistics.mean(times[SPD_N]):.2f} ms per iteration"
            f" at --steps-per-dispatch {SPD_N} ({', '.join(f'{t:.2f}' for t in times[SPD_N])}),"
            f" {statistics.mean(times[1]):.2f} at 1 ({', '.join(f'{t:.2f}' for t in times[1])});"
            f" iterations 3-{SPD_TIME_ITERS} of runs in the order 1, {SPD_N}, {SPD_N}, 1, 1,"
            f" {SPD_N}")
    say(f"spd: the phase took {time.perf_counter() - start:.1f} s")
    return launches


# --- phase 15: the oracle ceiling -----------------------------------------------------------
def oracle_phase(port, run_dir):
    """``scripts/eval_oracle_ceiling.py`` on ``run_dir`` on the card (its
    line, wall ms and exact conv launches), then on the CPU: every number
    within 1e-4; the run left as it was. Returns the card run's launches."""
    import contextlib
    import io

    from jolineedle_tpu_torch.scripts import eval_oracle_ceiling

    before = run_dir_state(run_dir)
    reset_launches(port)
    out = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        got = eval_oracle_ceiling.main([str(run_dir)])
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - start)
    lines = [line for line in out.getvalue().splitlines() if line.startswith("ORACLE-CEILING: ")]
    require(len(lines) == 1 and json.loads(lines[0][len("ORACLE-CEILING: "):]) == got,
            f"oracle ceiling: no ORACLE-CEILING line in {out.getvalue()[-500:]!r}")
    calls = -(-got["n_images"] // EVAL_DET_ROWS)
    counts = check_launches(port, f"oracle ceiling ({got['n_images']} images, {calls} detector"
                            " calls)", conv_launches({"detector": calls}))
    print(lines[0])
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = eval_oracle_ceiling.main([str(run_dir)], device="cpu")
    cpu_ms = 1e3 * (time.perf_counter() - start)
    require(cpu.keys() == got.keys() and all(
        abs(cpu[k] - v) <= 1e-4 if isinstance(v, float) else cpu[k] == v for k, v in got.items()),
        f"oracle ceiling: the card's {got}, the CPU's {cpu}")
    require(read_launches(port) == counts, "oracle ceiling: the CPU run launched a kernel")
    require(run_dir_state(run_dir) == before, f"oracle ceiling changed {run_dir}")
    say(f"oracle ceiling on {run_dir.name}: map {got['map']:.6f}, prop_patches_found"
        f" {got['prop_patches_found']:.6f}, stopped_inside_bbox {got['stopped_inside_bbox']:.6f},"
        f" ep_len {got['ep_len']}, over {got['n_images']} images in {wall_ms:.1f} ms wall on the"
        f" card (its CPU run {cpu_ms:.1f} ms, every number within 1e-4); {run_dir.name} unchanged")
    return Counter(counts)


# --- phase 16: the glimpse pyramid ---------------------------------------------------------
PYRAMID_B, PYRAMID_TOL = 4, 1e-5


def pyramid_phase(seed):
    """``NeedleEnv`` with 2 and 3 glimpse levels on float32 images of GRID x
    PATCH px on the card against the CPU; the pyramid build timed."""
    from jolineedle_tpu_torch.env.batched_env import NeedleEnv, build_glimpse_pyramid

    rng = np.random.default_rng(seed)
    side = GRID * PATCH
    images = rng.random((PYRAMID_B, side, side, 3), dtype=np.float32)
    boxes = np.zeros((PYRAMID_B, 4, 4), np.float32)
    boxes[:, 0] = [PATCH // 3, PATCH // 2, 2 * PATCH, PATCH + PATCH // 2]
    boxes[:, 1] = [3 * PATCH + 10, 4 * PATCH + 20, 3 * PATCH + 90, 4 * PATCH + 60]
    start = rng.integers(0, GRID, (PYRAMID_B, 2))
    actions = rng.integers(0, 9, (STEPS, PYRAMID_B))
    far = lambda a, b: float((a.cpu() - b).abs().max())
    for levels in (2, 3):
        envs = [NeedleEnv(images, boxes, PATCH, STEPS, levels, stop_enabled=True, device=d)
                for d in (DEVICE, "cpu")]
        errs = [far(envs[0].pyramid, envs[1].pyramid)]
        (card, card_patches, _), (cpu, cpu_patches, _) = (
            env.reset(positions=torch.from_numpy(start)) for env in envs)
        errs.append(far(card_patches, cpu_patches))
        for t in range(STEPS):
            a = torch.from_numpy(actions[t])
            got, want = envs[0].step(card, a.to(DEVICE)), envs[1].step(cpu, a)
            card, cpu = got[0], want[0]
            for x, y in zip(tuple(card) + got[2:5], tuple(cpu) + want[2:5]):
                require(torch.equal(x.cpu(), y) if x.dtype != torch.float32
                        else far(x, y) <= 1e-6, f"pyramid L={levels}: step {t} state")
            errs.append(far(got[1], want[1]))
        errs.append(far(envs[0].get_patches(card), envs[1].get_patches(cpu)))
        require(tuple(got[1].shape) == (PYRAMID_B, levels, PATCH, PATCH, 3)
                and max(errs) <= PYRAMID_TOL, f"pyramid L={levels}: patches {max(errs):.3g} apart")
        images_dev = envs[0].images
        ms = (median_ms(lambda: build_glimpse_pyramid(images_dev, PATCH, levels))
              if DEVICE == "cuda" else float("nan"))
        n_bytes = images.nbytes * (1 + levels)  # the images read, the L levels written
        say(f"pyramid L={levels}: [{PYRAMID_B}, {side}, {side}, 3] float32 on the card against"
            f" the CPU: pyramid, reset, {STEPS} steps and get_patches within {max(errs):.2e}"
            f" (limit {PYRAMID_TOL}); build {ms:.4f} ms (median of {REPS}), against"
            f" {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms to move its {n_bytes:,} bytes once")
        del envs


# The bench (phase 17): python -m jolineedle_tpu_torch.bench at its full
# config with fewer iterations and passes (2 passes: 3 until the script had
# to fit 600 s; the phase checks the line's keys and launches, not its
# spread), its first timed pass profiled; the part benches at fewer reps.
BENCH_ENV = {"BENCH_ITERS": "5", "BENCH_REPEATS": "2", "BENCH_SECONDARY_ITERS": "2",
             "BENCH_BASELINE_MIN_S": "0"}
# The keys of bench.py's JSON line (bench.py:420-486) and of its secondary block.
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "passes", "spread_pct",
              "gflops_per_env_step", "tflops_per_sec", "peak_tflops_measured", "mfu_pct",
              "baseline_env_steps_per_sec", "baseline_window_s", "secondary")
BENCH_SECONDARY_KEYS = ("metric", "value", "passes", "gflops_per_env_step", "tflops_per_sec",
                        "mfu_pct")
# bench.py's nano pairing: 0.974 GFLOP an env step (the JAX package's
# traced_flops of its rollout, 19,488,468,768 at B = 1 over 20 steps).
BENCH_GFLOPS_PER_ENV_STEP = 0.974
# The part benches' reps (10, 5 and 5 until the script had to fit 600 s).
PARTS_ITERS, ATTN_ITERS, STAGE_REPS = "5", "3", "3"


def bench_phase(port):
    """``bench.run`` in-process at the full config (``BENCH_ENV``), its line
    checked against bench.py's keys, its FLOPs and MFU, and the launches of
    every timed part; then each part bench once at fewer reps, and
    ``analyze_trace`` on the bench's profiled pass. Returns the launches of
    the bench's run (warm-ups included; the part benches' aside)."""
    from jolineedle_tpu_torch import bench
    from jolineedle_tpu_torch.scripts import (analyze_trace, bench_attention,
                                              bench_embedder_stages, bench_pallas_embedder,
                                              bench_rollout_parts)

    start = time.perf_counter()
    profile_dir = ROOT / "build" / "chip_smoke" / "bench_profile"
    shutil.rmtree(profile_dir, ignore_errors=True)
    reset_launches(port)
    result = bench.run(small=False, device=DEVICE,
                       env={**BENCH_ENV, "BENCH_PROFILE_DIR": str(profile_dir)})
    launches = Counter(read_launches(port))
    print(json.dumps(result), flush=True)
    say(f"bench: python -m jolineedle_tpu_torch.bench at {BENCH_ENV} (first nano pass"
        f" profiled) in {time.perf_counter() - start:.1f} s on {result['device']}")
    missing = [k for k in BENCH_KEYS if k not in result]
    missing += [f"secondary.{k}" for k in BENCH_SECONDARY_KEYS
                if k not in result.get("secondary", {})]
    require(not missing, f"bench: the line lacks {missing}")
    require(result["gflops_per_env_step"] == BENCH_GFLOPS_PER_ENV_STEP,
            f"bench: {result['gflops_per_env_step']} GFLOP an env step, not"
            f" {BENCH_GFLOPS_PER_ENV_STEP}")
    for line in (result, result["secondary"]):
        require(0 < line["mfu_pct"] <= 100, f"bench: mfu_pct {line['mfu_pct']}")

    counts = result["kernel_counts"]
    s_convs = sum(dense_conv_shapes("yolox-s", embedder=True).values())
    per_embed = EXPECTED_PER_CALL["embedder"]
    for part, per, want in (
            ("rollout", "rollouts", {**{k: STEPS * n for k, n in per_embed.items()},
                                     "flash_attention": 0}),
            ("secondary", "rollouts", {"dwblock_bn_silu": 0, "conv3x3_bn_silu": STEPS * s_convs,
                                       "flash_attention": 0}),
            ("baseline", "iterations", {"flash_attention": counts["baseline"]["steps"] * N_LAYER})):
        got = counts[part]
        for name, n in want.items():
            require(got[name] == got[per] * n, f"bench {part}: {got[name]} {name} launches over"
                    f" {got[per]} {per}, not {n} each")
        say(f"bench {part}: launches {got} (exactly {want} each of {got[per]} {per})")

    with mock.patch.dict(os.environ, BENCH_PARTS_ITERS=PARTS_ITERS, BENCH_ATTN_ITERS=ATTN_ITERS):
        for what, call in (
                ("bench_rollout_parts", lambda: bench_rollout_parts.main([], device=DEVICE)),
                ("bench_attention", lambda: bench_attention.main([], device=DEVICE)),
                ("bench_embedder_stages", lambda: bench_embedder_stages.main(
                    ["--reps", STAGE_REPS], device=DEVICE)),
                ("bench_embedder_stages yolox-s", lambda: bench_embedder_stages.main(
                    ["--reps", STAGE_REPS, "--variant", "yolox-s"], device=DEVICE)),
                ("bench_pallas_embedder", lambda: bench_pallas_embedder.main(
                    ["--iters", STAGE_REPS], device=DEVICE)),
                ("analyze_trace", lambda: analyze_trace.main([str(profile_dir)]))):
            t0 = time.perf_counter()
            out = call()
            if what == "analyze_trace":
                require(out["by_class"].get("port kernels", 0) > 0,
                        "analyze_trace: no port kernel in the profiled pass")
                say(f"analyze_trace: the profiled nano pass (1 of {BENCH_ENV['BENCH_REPEATS']},"
                    f" {BENCH_ENV['BENCH_ITERS']}"
                    f" rollouts): device busy {out['busy_pct']:.1f} % of"
                    f" {out['window_ms']:.1f} ms; by class (ms) "
                    + json.dumps({k: round(v, 3) for k, v in out["by_class"].items()}))
            say(f"{what}: exit 0 in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    say(f"bench: the phase took {time.perf_counter() - start:.1f} s")
    return launches


def import_port():
    """The port's modules this script drives. In a directory that holds
    this script and nothing else of the repo, this raises ImportError."""
    from jolineedle_tpu_torch import config as tconfig
    from jolineedle_tpu_torch.checkpoint import save_model
    from jolineedle_tpu_torch.data.toy import generate_toy_dataset
    from jolineedle_tpu_torch.env.actions import get_actions_info
    from jolineedle_tpu_torch.main import build_both_datasets, build_trainer
    from jolineedle_tpu_torch.main import main as train_main
    from jolineedle_tpu_torch.models.gpt import GPT
    from jolineedle_tpu_torch.ops import attention as kattn
    from jolineedle_tpu_torch.ops import conv as kconv
    from jolineedle_tpu_torch.ops.kernels import build_kernels
    from jolineedle_tpu_torch.train.reinforce import ReinforceTrainer, fixed_training_shape
    from jolineedle_tpu_torch.train.supervised import SupervisedTrainer

    return SimpleNamespace(tconfig=tconfig, save_model=save_model,
                           generate_toy_dataset=generate_toy_dataset,
                           get_actions_info=get_actions_info, train_main=train_main, GPT=GPT,
                           kattn=kattn, kconv=kconv, build_kernels=build_kernels,
                           build_both_datasets=build_both_datasets,
                           build_trainer=build_trainer,
                           ReinforceTrainer=ReinforceTrainer, SupervisedTrainer=SupervisedTrainer,
                           fixed_training_shape=fixed_training_shape)


#: The phases by group, in the order a whole run takes them; ``--group``
#: runs one group, and a phase another group's phase feeds first (``NEEDS``).
GROUPS = {
    "kernels": ("kernels", "reference"),
    "serve": ("serve", "jax_files", "full_prefix", "smoke_conv"),
    "train": ("pool", "train", "supervised", "resume_jax", "eval", "oracle"),
    "recipe": ("recipe", "rlft", "shared"),
    "ddp": ("ddp", "spd"),
    "bench": ("pyramid", "bench"),
}
NEEDS = {"eval": ("jax_files",)}


def phases_of(group):
    """The phases that ``--group group`` runs (all of them for None)."""
    if group is None:
        return [p for phases in GROUPS.values() for p in phases]
    own = list(GROUPS[group])
    needed = [n for p in own for n in NEEDS.get(p, ()) if n not in own]
    return list(dict.fromkeys(needed + own))


def main(argv=None) -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device-data-cache", choices=("auto", "on", "off"), default="auto",
                        help="the train CLI's flag in both train phases (off: stream the pixels)")
    parser.add_argument("--group", choices=sorted(GROUPS), default=None,
                        help="run one group of phases (and what it needs); default: every"
                        " phase, with the kernels line")
    args = parser.parse_args(argv)
    script_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    port = import_port()
    # cuBLAS's deterministic workspace, read when its first handle is made:
    # phase 11d's deterministic pass needs it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    CARD = smi
    print(smi, flush=True)
    say(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible;"
        f" torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    start = time.perf_counter()
    built = port.build_kernels()
    say(f"build: {sorted(built)} in {time.perf_counter() - start:.2f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # The flagship model, with weights from the seed, written as a model dir.
    work_dir = ROOT / "build" / "chip_smoke"
    train_config, model_config = port.tconfig.args_to_config(
        port.tconfig.get_args(FLAGSHIP + ["--work-dir", str(work_dir), "--seed", str(args.seed)]))
    actions_info = port.get_actions_info(train_config)
    torch.manual_seed(args.seed)
    model = port.GPT.from_config(model_config, actions_info).eval()
    randomize_bn(model, args.seed)
    port.tconfig.save_config(model_config, train_config)
    model_dir = work_dir / train_config.env_name
    port.save_model(model, model_dir, best=True)
    shapes = path_shapes(model)
    state = model.state_dict()
    del model

    seed, cache = args.seed, args.device_data_cache
    done, by_path, rows = {}, {}, {}

    def toy():  # phases 9-11b and 13-14's toy set, written once
        if "toy" not in done:
            done["toy"] = toy_dataset(port, seed)
        return done["toy"]

    def kernels():  # 3. the kernels against their plain versions
        rows["path"] = kernel_phase(port.kconv, shapes, seed)
        rows["new"] = new_kernel_phase(port, seed)
        rows["wide"] = wide_variant_phase(port.kconv, seed)

    def reference():  # 4. the card against the CPU
        models = reference_phase(model_config, actions_info, state, seed)
        rollout_reference(models, train_config, seed)
        train_reference(models, state, train_config, seed)
        supervised_reference(models, state, seed)

    def supervised():
        by_path["supervised"], done["sup_run"] = sup_train_phase(port, seed, toy(), cache)

    def recipe():
        by_path["recipe"], rows["recipe"], done["recipe_run"] = recipe_phase(port, seed)

    def rlft():
        by_path["rlft"], rlft_rows, done["shared"] = rlft_phase(port, seed, *done["recipe_run"])
        rows["recipe"] = rows["recipe"] + rlft_rows

    def shared():
        by_path["shared"], shared_rows = shared_phase(port, seed, done["shared"])
        rows["recipe"] = rows["recipe"] + shared_rows

    def ddp():
        by_path["ddp"], done["spd_ranks"] = ddp_phase(port, seed, toy())

    run = {
        "kernels": kernels,
        "reference": reference,
        # 5-8. the paths, each read on its own
        "serve": lambda: by_path.update(serve=serve_phase(port, model_dir, seed)),
        "jax_files": lambda: by_path.update(jax_files=jax_files_phase(port, model_dir, seed)),
        "full_prefix": lambda: by_path.update(
            full_prefix=full_prefix_phase(port, model_dir, state, seed)),
        "smoke_conv": lambda: by_path.update(smoke_conv=Counter(smoke_conv_phase(port))),
        # 9-12, 15. the device pool, the trainers, the eval surface
        "pool": lambda: pool_phase(port, seed, toy()),
        "train": lambda: by_path.update(train=train_phase(port, seed, toy(), cache)),
        "supervised": supervised,
        "resume_jax": lambda: by_path.update(
            resume_jax=resume_jax_phase(port, seed, toy(), cache)),
        "eval": lambda: by_path.update(
            eval=eval_phase(port, seed, model_dir, done["sup_run"])),
        "oracle": lambda: by_path.update(oracle=oracle_phase(port, done["sup_run"][0])),
        # 11c-11e. the recipes, and their default shared pairing
        "recipe": recipe,
        "rlft": rlft,
        "shared": shared,
        # 13-14. data parallelism and steps per dispatch
        "ddp": ddp,
        "spd": lambda: by_path.update(spd=spd_phase(port, seed, toy(), done.get("spd_ranks"))),
        # 16-17. the pyramid and the bench
        "pyramid": lambda: pyramid_phase(seed),
        "bench": lambda: by_path.update(bench=bench_phase(port)),
    }
    seconds = {}
    for phase in phases_of(args.group):
        start = time.perf_counter()
        run[phase]()
        torch.cuda.empty_cache()
        seconds[phase] = round(time.perf_counter() - start, 1)
        say(f"phase {phase}: {seconds[phase]} s")
    launches = sum(by_path.values(), Counter())
    say(f"chip_smoke: every phase passed in {time.perf_counter() - script_start:.1f} s;"
        f" by phase {json.dumps(seconds)}")
    if args.group is None:
        for name in KERNEL_NAMES:
            require(launches[name] > 0, f"{name} was launched no time on its path")
        print(json.dumps({"kernels": kernels_json(rows["path"], rows["new"], rows["wide"],
                                                  rows["recipe"], launches, by_path)}),
              flush=True)
    else:
        print(json.dumps({"group": args.group, "launches_by_path": by_path}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
