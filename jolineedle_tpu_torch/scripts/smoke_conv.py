"""Smoke test of the plain 3x3 conv kernel on the card, against cuDNN.

The port of ``scripts/smoke_pallas_conv.py``: one yolox-nano-like dense 3x3
SAME conv (no bias, no epilogue) in bfloat16, through ``ops.conv.conv3x3``
(the CUDA kernel ``csrc/conv3x3.cu``), checked against ``F.conv2d`` and timed
beside it. cuDNN is a yardstick only: the port never calls it. Run on a
machine with an NVIDIA GPU:

    python -m jolineedle_tpu_torch.scripts.smoke_conv

Knobs, as the original script's: ``SMOKE_B`` (8), ``SMOKE_HW`` (56),
``SMOKE_C`` (16), ``SMOKE_K`` (32), ``SMOKE_ITERS`` (50). Prints one JSON
line: the shape, the max error against ``F.conv2d`` computed in float32 on
the same bf16 inputs (TF32 off), and the kernel's and cuDNN's device
microseconds per call (CUDA events around ``SMOKE_ITERS`` calls queued
behind a sleep kernel) with their GFLOP/s.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.nn.functional as F

from ..ops.conv import conv3x3


def _per_call_us(fn, iters: int) -> float:
    """Device time per call: a sleep kernel first lets the host queue all
    ``iters`` calls (wrapper included) before the device reaches them, so
    the events time the kernels and not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("smoke_conv needs an NVIDIA GPU: the kernel is CUDA-only")
    B = int(os.environ.get("SMOKE_B", 8))
    H = W = int(os.environ.get("SMOKE_HW", 56))
    C = int(os.environ.get("SMOKE_C", 16))
    K = int(os.environ.get("SMOKE_K", 32))
    iters = int(os.environ.get("SMOKE_ITERS", 50))
    dtype = torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device={torch.cuda.get_device_name(0)} B={B} HW={H} C={C} K={K}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, H, W, C), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((3, 3, C, K), generator=gen, device="cuda") * 0.1).to(dtype)
    x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)

    got = conv3x3(x, w).float()
    want = F.conv2d(x_nchw.float(), w_oihw.float(), padding=1).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"max |kernel - F.conv2d| = {err:.4f}", flush=True)

    t_kernel = _per_call_us(lambda: conv3x3(x, w), iters)
    print(f"kernel: {t_kernel:.1f} us/call", flush=True)
    t_cudnn = _per_call_us(lambda: F.conv2d(x_nchw, w_oihw, padding=1), iters)
    print(f"cudnn:  {t_cudnn:.1f} us/call", flush=True)

    flops = 2 * B * H * W * 9 * C * K
    result = {
        "shape": [B, H, W, C, K],
        "max_abs_err": err,
        "kernel_us": round(t_kernel, 1),
        "cudnn_us": round(t_cudnn, 1),
        "ratio_kernel_over_cudnn": round(t_kernel / t_cudnn, 3),
        "kernel_gflops": round(flops / t_kernel / 1e3, 1),
        "cudnn_gflops": round(flops / t_cudnn / 1e3, 1),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    try:
        main()
    except RuntimeError as exc:
        print(f"smoke_conv: {exc}", file=sys.stderr)
        sys.exit(1)
