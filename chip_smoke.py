#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port, ``jolineedle_tpu_torch``, on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises (and the script exits non-zero) on a failure:

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
9. train: a toy dataset of 2688x2688 images (a 6x6 grid of 448 px patches)
   written by the port's generator, then the train CLI
   (``jolineedle_tpu_torch.main``, REINFORCE) at the flagship config with
   batch 16, gradient accumulation 2, 4 iterations and its final test; the
   losses must be finite, both optimizer groups and the detector's BN
   statistics must move (the embedder's must not), the checkpoint must be
   written, and a resumed run must take one more iteration. The launch
   counters must read exactly: per train step, the rollout's conv launches
   (the module tree's count) and 3 flash launches (one per layer of the one
   teacher-forced forward) and no conv launch in the differentiated
   forwards. Then two more steps give the phase times (rollout, loss
   forward+backward, detection, optimizer, by CUDA events), the peak
   memory, and a ``torch.profiler`` busy share of one step;
10. supervised: the train CLI with ``--training-mode supervised`` on the
   same toy dataset, batch 16, accumulation 2, dropout 0.1: 4 iterations
   (``--max-iters 5``), a test of 16 sampled test images after the last, the
   final test, then a resumed run of one iteration. The losses and the test
   metrics must be finite; both optimizer groups and the BN statistics of
   the embedder and of the detector must move; the checkpoint must track
   ``map``. The launch counters must read exactly what
   ``sup_test_launches`` derives from the code: per step 3 flash launches
   and no conv launch (every conv of a train step runs under autograd);
   per test the conv kernels of the eval rollouts, of the eval detections
   and of the teacher-forced eval's embedder and detector, and its 3 flash
   launches per batch of 16 images. Then two more steps give the phase
   times (upload, decision, detection, optimizer), the peak memory and a
   ``torch.profiler`` busy share.

Phase 3 also holds the flash-attention kernel against its plain versions
(output, log-sum-exp and gradients) at the decoder's shape [16, 3, 21, 16]
on the model's strided views of its c_attn output, a ragged multi-tile [2,
4, 200, 64] and the long-T [128, 4, 128, 64], and at the full-prefix
rollout's [4, 3, 21, 16] in float32 and [1, 3, 21, 16] in bfloat16 on the
model's views (phase 7's shapes), times each as the wrapper's
whole call (per launch and back to back), and checks under
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
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path
from types import SimpleNamespace

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
# The full-prefix rollout (phase 7) at B = FULL_PREFIX_B in float32 and the
# B = 1 request in bfloat16: each step embeds B x STEPS patches and runs
# flash at [B, 3, STEPS + 1, 16] on the model's c_attn views.
FULL_PREFIX_B = 4
FULL_PREFIX_RUNS = [(FULL_PREFIX_B, torch.float32), (1, torch.bfloat16)]
# Device operations of one B = 16 train step when the flash wrapper still
# copied q, k and v in and o out (PERF.md section 5): 4 copies per layer.
TRAIN_STEP_OPS_WITH_COPIES = 28_328
# The plain 3x3 conv: the smoke script's default and the nano stem.
PLAIN_CONV_SHAPES = [(8, 56, 56, 16, 32), (N_PATCHES, PATCH // 2, PATCH // 2, 12, 16)]
# The dense 3x3 convs of a wider variant, held and timed beside the path.
WIDE_VARIANT = "yolox-s"
KERNEL_NAMES = ("dwblock_bn_silu", "conv3x3_bn_silu", "flash_attention", "conv3x3")

CARD = ""  # "name, power limit" from nvidia-smi, set in main()


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
def path_shapes(model) -> dict:
    """{"embedder" | "detector": Counter((kernel, H, W, C, K))}: the kernel
    launches of one embedder call and one detector call on a 448 px patch,
    read from the modules that take a kernel."""
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
    patch = torch.zeros((1, PATCH, PATCH, 3), dtype=torch.uint8, device=model.device)
    out = {}
    with torch.no_grad():
        model.embed_patches(patch[:, None])
        out["embedder"], seen[:] = Counter(seen), []
        model.yolox_outputs(patch)
        out["detector"] = Counter(seen)
    for h in handles:
        h.remove()
    for call, counts in out.items():
        per_kernel = Counter()
        for (name, *_), n in counts.items():
            per_kernel[name] += n
        if dict(per_kernel) != EXPECTED_PER_CALL[call]:
            raise AssertionError(f"{call}: kernel calls {dict(per_kernel)},"
                                 f" expected {EXPECTED_PER_CALL[call]}")
    return out


def dense_conv_shapes(variant: str) -> Counter:
    """Counter((H, W, C, K)): the ``conv3x3_bn_silu`` launches of one
    forward of a ``variant`` detector on a 448 px patch, read from its
    module tree (every dense stride-1 3x3 ``ConvBnAct``)."""
    from jolineedle_tpu_torch.models.yolox import ConvBnAct, NeedleYOLOX

    model = NeedleYOLOX(variant, device="cuda").eval()
    seen = Counter()

    def record(module, inputs, output):
        _, C, H, W = inputs[0].shape
        seen[(H, W, C, output.shape[1])] += 1

    for m in model.modules():
        if isinstance(m, ConvBnAct) and m.uses_conv3x3_kernel:
            m.register_forward_hook(record)
    with torch.no_grad():
        model(torch.zeros((1, 3, PATCH, PATCH), device="cuda"))
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
    flash also at the full-prefix rollout's shapes, each in its own dtype."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    runs = [(shape, dtype, shape == FLASH_SHAPES[0]) for shape in FLASH_SHAPES
            for dtype in (torch.float32, torch.bfloat16)]
    runs += [((b, 3, STEPS + 1, 16), dtype, True) for b, dtype in FULL_PREFIX_RUNS]
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


def kernels_json(rows, new_rows, wide_rows, launches, by_path):
    """One entry per kernel. The fused conv blocks: their numbers summed over
    the launches of one detector call (bfloat16, the serving dtype), each
    shape in ``shapes``. Flash attention: one teacher-forced forward of the
    train step (3 launches at the decoder's shape, bfloat16). The plain 3x3
    conv: one call at the smoke script's default (bfloat16). dwblock's rows
    at N = 1 (the B = 1 request), the fused blocks' rows at the
    supervised eval's and the full-prefix rollout's N, and flash's rows at
    the full-prefix shapes are in ``shapes``, outside the totals.
    ``launches``
    sums every path's count; ``launches_by_path`` splits it. The wide
    variant's rows go under conv3x3_bn_silu's ``wide_variant_shapes``,
    outside its totals."""
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
    return {"dwblock_bn_silu": port.kconv.dwblock_bn_silu.launches,
            "conv3x3_bn_silu": port.kconv.conv3x3_bn_silu.launches,
            "conv3x3": port.kconv.conv3x3.launches,
            "flash_attention": port.kattn.flash_attention.launches}


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
    operations per ``unit`` (None when nothing was traced)."""
    spans = device_spans(fn)
    if not spans:
        say(f"profile {what}: the profiler traced no device time; busy share not measured")
        return None
    busy_us, end = 0.0, -math.inf
    by_name = defaultdict(lambda: [0, 0.0])
    for s, e, name in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
        by_name[name][0] += 1
        by_name[name][1] += e - s
    say(f"profile {what}: device busy {busy_us / 1e3:.2f} ms of {untraced_ms:.2f} ms"
        f" untraced wall ({busy_us / 1e3 / untraced_ms:.1%}),"
        f" {len(spans) / unit[1]:.0f} device operations per {unit[0]}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        say(f"  {us / 1e3:9.3f} ms {n:6d}x {name[:100]}")
    for kernel, pattern in PORT_KERNEL_SYMBOLS.items():
        hits = [v for name, v in by_name.items() if pattern in name]
        if hits:
            say(f"  port kernel {kernel}: {sum(us for _, us in hits) / 1e3:.3f} ms in"
                f" {sum(n for n, _ in hits)} launches")
    return len(spans) / unit[1]


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


# --- phase 9: train ----------------------------------------------------------------
def train_flags(data_dir, work_dir, seed):
    flags = list(FLAGSHIP)
    flags[flags.index("--dataset-dir") + 1] = str(data_dir)
    flags[flags.index("--batch-size") + 1] = str(TRAIN_B)
    return flags + [
        "--work-dir", str(work_dir), "--seed", str(seed), "--env-name", "train",
        "--gradient-accumulation", str(TRAIN_ACCUM), "--max-iters", str(TRAIN_ITERS),
        "--test-every", "1000", "--test-samples", "2", "--num-workers", "4",
    ]


def toy_dataset(port, seed) -> Path:
    """The port's toy generator: 8 + 2 images of 2688 px (a 6 x 6 grid of
    448 px patches), the data of both train phases."""
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    start = time.perf_counter()
    port.generate_toy_dataset(root / "toy", n_train=8, n_test=2, image_size=(GRID * PATCH,) * 2,
                              seed=seed, box_size=(48, 200))
    say(f"train: toy dataset of 8 + 2 images {GRID * PATCH}x{GRID * PATCH} in"
        f" {time.perf_counter() - start:.1f} s")
    return root / "toy"


def train_phase(port, seed, toy):
    """The train CLI (REINFORCE) at the flagship config on the toy dataset;
    returns the launch counts of its runs (train, then resume)."""
    root = toy.parent
    flags = train_flags(toy, root / "out", seed)
    train_config, model_config = port.tconfig.args_to_config(port.tconfig.get_args(flags))
    torch.manual_seed(seed)  # as the CLI seeds the model's init
    init = port.GPT.from_config(model_config, port.get_actions_info(train_config),
                                device="cpu").state_dict()
    per_step = {"dwblock_bn_silu": STEPS * EXPECTED_PER_CALL["embedder"]["dwblock_bn_silu"],
                "conv3x3_bn_silu": STEPS * EXPECTED_PER_CALL["embedder"]["conv3x3_bn_silu"],
                "flash_attention": N_LAYER}

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

    # Phase times of two more steps (the second applies an update).
    batch = trainer._build_env_batch([i % len(trainer.train_dataset) for i in range(TRAIN_B)],
                                     seed)
    for i in range(2):
        trainer.phase_events = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(port)
        start = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - start) * 1e3
        check_launches(port, f"one train step B={TRAIN_B}", per_step)
        marks = trainer.phase_events
        trainer.phase_events = None
        phases = {name: a.elapsed_time(b) for (_, a), (name, b) in zip(marks, marks[1:])}
        say(f"train step B={TRAIN_B} ({'update' if i else 'accumulate'}): {step_ms:.2f} ms wall;"
            " device-clock phases " + ", ".join(f"{k} {v:.2f} ms" for k, v in phases.items())
            + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    ops = profile_run(f"train step B={TRAIN_B}", step_ms, lambda: trainer.train_step(batch),
                      unit=("train step", 1))
    if ops is not None:
        say(f"train step B={TRAIN_B}: {ops:.0f} device operations, against"
            f" {TRAIN_STEP_OPS_WITH_COPIES:,} when the flash wrapper copied q, k, v and o"
            f" ({ops - TRAIN_STEP_OPS_WITH_COPIES:+.0f}; {-4 * N_LAYER} expected)")

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


def sup_test_launches(n_ids: int) -> dict:
    """The kernel launches of one supervised ``test()`` on ``n_ids`` test
    images of one shape, from ``train/supervised.py`` and
    ``train/trainer.py``: two starts per image (multistart), so ``2 n_ids``
    rollout rows in chunks of at most EVAL_CHUNK, each chunk STEPS - 1 steps
    of one embedder call; their detections in chunks of EVAL_DET_ROWS
    episodes, one detector call each; and per TRAIN_B images the
    teacher-forced eval's one forward (an embedder call and N_LAYER flash
    launches) and one detector call."""
    rows = 2 * n_ids
    sup_batches = math.ceil(n_ids / TRAIN_B)
    calls = {"embedder": math.ceil(rows / EVAL_CHUNK) * (STEPS - 1) + sup_batches,
             "detector": math.ceil(rows / EVAL_DET_ROWS) + sup_batches}
    out = {k: sum(calls[c] * EXPECTED_PER_CALL[c][k] for c in calls)
           for k in EXPECTED_PER_CALL["embedder"]}
    out["flash_attention"] = N_LAYER * sup_batches
    return out


def sup_train_phase(port, seed, toy):
    """The train CLI with ``--training-mode supervised`` at the flagship
    config (dropout 0.1) on the toy dataset: TRAIN_ITERS iterations (the
    supervised loop runs ``--max-iters`` - 1), a test of SUP_TEST_IDS
    sampled test images after the last, the final test on the whole test
    set, then a resumed run of one iteration and its final test. Returns
    the launch counts of both runs."""
    from jolineedle_tpu_torch.train.batching import build_supervised_batch
    from jolineedle_tpu_torch.train.supervised import TRAIN_KEYS

    root = toy.parent
    flags = train_flags(toy, root / "out", seed)
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

    # Phase times of two more steps (the second applies an update).
    batch = build_supervised_batch(
        trainer.train_dataset, [i % len(trainer.train_dataset) for i in range(TRAIN_B)],
        trainer.config, np.random.default_rng(seed))
    upload_mb = sum(batch[k].nbytes for k in TRAIN_KEYS) / 1e6
    for i in range(2):
        trainer.phase_events = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(port)
        start = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - start) * 1e3
        check_launches(port, f"one supervised train step B={TRAIN_B}", per_step)
        marks = trainer.phase_events
        trainer.phase_events = None
        phases = {name: a.elapsed_time(b) for (_, a), (name, b) in zip(marks, marks[1:])}
        say(f"supervised train step B={TRAIN_B} ({'update' if i else 'accumulate'}):"
            f" {step_ms:.2f} ms wall; device-clock phases "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in phases.items())
            + f" (upload of {upload_mb:.1f} MB from pageable memory:"
            f" {upload_mb / phases['upload']:.2f} GB/s); peak memory"
            f" {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    ops = profile_run(f"supervised train step B={TRAIN_B}", step_ms,
                      lambda: trainer.train_step(batch), unit=("train step", 1))
    if ops is not None:
        say(f"supervised train step B={TRAIN_B}: {ops:.0f} device operations")

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
    return Counter(main_counts) + Counter(resume_counts)


def import_port():
    """The port's modules this script drives. In a directory that holds
    this script and nothing else of the repo, this raises ImportError."""
    from jolineedle_tpu_torch import config as tconfig
    from jolineedle_tpu_torch.checkpoint import save_model
    from jolineedle_tpu_torch.data.toy import generate_toy_dataset
    from jolineedle_tpu_torch.env.actions import get_actions_info
    from jolineedle_tpu_torch.main import main as train_main
    from jolineedle_tpu_torch.models.gpt import GPT
    from jolineedle_tpu_torch.ops import attention as kattn
    from jolineedle_tpu_torch.ops import conv as kconv
    from jolineedle_tpu_torch.ops.kernels import build_kernels

    return SimpleNamespace(tconfig=tconfig, save_model=save_model,
                           generate_toy_dataset=generate_toy_dataset,
                           get_actions_info=get_actions_info, train_main=train_main, GPT=GPT,
                           kattn=kattn, kconv=kconv, build_kernels=build_kernels)


def main(argv=None) -> int:
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 1
    port = import_port()

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

    # 3. kernels
    shapes = path_shapes(model)
    rows = kernel_phase(port.kconv, shapes, args.seed)
    new_rows = new_kernel_phase(port, args.seed)
    wide_rows = wide_variant_phase(port.kconv, args.seed)

    # 4. reference
    state = model.state_dict()
    models = reference_phase(model_config, actions_info, state, args.seed)
    rollout_reference(models, train_config, args.seed)
    train_reference(models, state, train_config, args.seed)
    supervised_reference(models, state, args.seed)
    del models, model

    # 5-10. the paths, each read on its own
    toy = toy_dataset(port, args.seed)
    by_path = {"serve": serve_phase(port, model_dir, args.seed),
               "jax_files": jax_files_phase(port, model_dir, args.seed),
               "full_prefix": full_prefix_phase(port, model_dir, state, args.seed),
               "smoke_conv": Counter(smoke_conv_phase(port)),
               "train": train_phase(port, args.seed, toy)}
    torch.cuda.empty_cache()
    by_path["supervised"] = sup_train_phase(port, args.seed, toy)
    launches = sum(by_path.values(), Counter())
    for name in KERNEL_NAMES:
        require(launches[name] > 0, f"{name} was launched no time on its path")

    print(json.dumps({"kernels": kernels_json(rows, new_rows, wide_rows, launches, by_path)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
