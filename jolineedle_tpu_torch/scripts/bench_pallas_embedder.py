"""The fused ``dwblock_bn_silu`` kernel against the cuDNN composition at the
rollout embedder's stride-1 DWConv stage shapes (yolox-nano, 448 px
patches, B = 128, bf16): the counterpart of
``scripts/bench_pallas_embedder.py``. Prints one JSON line a stage.

The kernel (``csrc/dwblock_bn_silu.cu``, through its wrapper as the model
calls it) computes depthwise 3x3 + eval BN + SiLU + pointwise 1x1 + eval BN +
SiLU in one pass; the cuDNN composition is the same math as PyTorch ops
(``F.conv2d`` depthwise, BN, SiLU, ``F.conv2d`` pointwise, BN, SiLU in
bf16), timed here and called nowhere in the port. Each time is the median of
``--iters`` CUDA event pairs (the host clock on the CPU, where the wrapper
runs its plain version); ``max_abs_err`` is the kernel's against its plain
version in float32 on the same inputs.

    python -m jolineedle_tpu_torch.scripts.bench_pallas_embedder
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.conv import dwblock_bn_silu, dwblock_bn_silu_reference, fold_bn
from ..utils.timing import card, median_ms

#: The nano embedder's DWConv shapes at 448 px (CSPDarknet stages at stride
#: 4 / 8 / 16 / 32 with base width 16: C = 32 / 64 / 128 / 256).
STAGES = [(112, 32), (56, 64), (28, 128), (14, 256)]


def _bn(gen, n):
    dev = gen.device
    return [torch.rand(n, generator=gen, device=dev) + 0.5,
            torch.randn(n, generator=gen, device=dev) * 0.1,
            torch.randn(n, generator=gen, device=dev) * 0.1,
            torch.rand(n, generator=gen, device=dev) + 0.5]


def cudnn_dwblock(x, dw, bn1, pw, bn2, eps=1e-3):
    """The block as PyTorch ops on NHWC ``x`` (an NCHW view in channels_last
    memory) and HWIO weights, in x's dtype."""
    C, dt = x.shape[-1], x.dtype
    s1, b1 = (v.to(dt)[:, None, None] for v in fold_bn(*bn1, eps))
    s2, b2 = (v.to(dt)[:, None, None] for v in fold_bn(*bn2, eps))
    xc = x.permute(0, 3, 1, 2)
    y = F.silu(F.conv2d(xc, dw.permute(3, 2, 0, 1).to(dt), padding=1, groups=C) * s1 + b1)
    return F.silu(F.conv2d(y, pw.permute(3, 2, 0, 1).to(dt)) * s2 + b2)


def main(argv=None, device=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    where = card(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, rows = args.batch, []
    for HW, C in STAGES:
        K = C
        x = torch.randn((B, HW, HW, C), generator=gen, device=dev).to(torch.bfloat16)
        dw = torch.randn((3, 3, 1, C), generator=gen, device=dev) * 0.2
        pw = torch.randn((1, 1, C, K), generator=gen, device=dev) * 0.2
        bn1, bn2 = _bn(gen, C), _bn(gen, K)
        args_ = (x, dw, *bn1, pw, *bn2)
        err = (dwblock_bn_silu(*args_).float()
               - dwblock_bn_silu_reference(x.float(), *args_[1:])).abs().max().item()
        t_k = median_ms(lambda: dwblock_bn_silu(*args_), args.iters, dev) / 1e3
        t_c = median_ms(lambda: cudnn_dwblock(x, dw, bn1, pw, bn2), args.iters, dev) / 1e3
        flops = 2 * B * HW * HW * (9 * C + C * K)
        row = {"stage": f"{HW}x{HW}x{C}", "kernel_us": round(t_k * 1e6, 1),
               "cudnn_us": round(t_c * 1e6, 1), "ratio": round(t_k / t_c, 3),
               "kernel_gflops": round(flops / t_k / 1e9, 1), "max_abs_err": err, "card": where}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
