"""Each stage of the rollout embedder at the bench's workload (B = 128, 448 px
patches, bf16), timed on the card as the port runs it in eval, beside the
cuDNN composition of the same stage and the stage's bytes bound (the
counterpart of ``scripts/bench_embedder_stages.py``, with its stage lists).

A stage runs as the model's own module does without autograd
(``models/yolox.py``): the kernel where the model launches one (the Focus
stem and yolox-s's other stride-1 dense 3x3s on ``conv3x3_bn_silu``, the
stride-1 DWConvs on ``dwblock_bn_silu``), otherwise PyTorch's conv, the
folded BN and SiLU. The cuDNN composition (``F.conv2d`` in bf16 with the BN
scale and bias and ``F.silu``; for a DWConv both convs) is timed beside it
and called nowhere in the port. The bound: the stage's input, output and
weights read or written once, over 3.35 TB/s. Each time is the median of
``--reps`` CUDA event pairs (the host clock on the CPU, where the kernels'
plain versions run). Prints one JSON line a stage and one with the sums,
each with the card's name and power limit.

    python -m jolineedle_tpu_torch.scripts.bench_embedder_stages [--variant yolox-s]
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models.yolox import ConvBnAct, DWConv
from ..ops.conv import fold_bn
from ..utils.timing import card, median_ms

HBM_BYTES_PER_S = 3.35e12
DT = torch.bfloat16

# (name, (H, C, K, kind, stride), count per embed): the JAX script's lists.
# count: how many times that op shape runs per embed (backbone: dark2 n=1,
# dark3/4 n=3, dark5 n=1; PAFPN: 4 CSP n=1 + 2 bottom-up downsamples; the CSP
# 1x1s approximated by 3 representative shapes each).
NANO_STAGES = [
    ("null 112x32 (loop overhead)", (112, 32, 32, "null", 1), 0),
    ("focus_conv 224x12->16", (224, 12, 16, "dense3x3", 1), 1),
    ("down2 224x16->32", (224, 16, 32, "dwblock", 2), 1),
    ("down3 112x32->64", (112, 32, 64, "dwblock", 2), 1),
    ("down4 56x64->128", (56, 64, 128, "dwblock", 2), 1),
    ("down5 28x128->256", (28, 128, 256, "dwblock", 2), 1),
    ("csp2_dw 112x32", (112, 32, 32, "dwblock", 1), 1),
    ("csp3_dw 56x64", (56, 64, 64, "dwblock", 1), 3),
    ("csp4_dw 28x128", (28, 128, 128, "dwblock", 1), 3),
    ("csp5_dw 14x256", (14, 256, 256, "dwblock", 1), 1),
    ("csp2_1x1 112x32->16", (112, 32, 16, "pw1x1", 1), 3),
    ("csp3_1x1 56x64->32", (56, 64, 32, "pw1x1", 1), 3),
    ("csp4_1x1 28x128->64", (28, 128, 64, "pw1x1", 1), 3),
    ("csp5_1x1 14x256->128", (14, 256, 128, "pw1x1", 1), 3),
    ("pafpn_dw 56x64", (56, 64, 64, "dwblock", 1), 2),
    ("pafpn_dw 28x128", (28, 128, 128, "dwblock", 1), 2),
    ("pafpn_down 56x64->64", (56, 64, 64, "dwblock", 2), 1),
    ("pafpn_down 28x128->128", (28, 128, 128, "dwblock", 2), 1),
]
# yolox-s (width 0.5, dense): the bench's secondary pairing's embedder.
S_STAGES = [
    ("null (loop overhead)", (112, 32, 32, "null", 1), 0),
    ("focus_conv 224x12->32", (224, 12, 32, "dense3x3", 1), 1),
    ("down2 224x32->64 s2", (224, 32, 64, "dense3x3", 2), 1),
    ("csp2_3x3 112x32->32", (112, 32, 32, "dense3x3", 1), 1),
    ("csp2_1x1 112x64->32", (112, 64, 32, "pw1x1", 1), 3),
    ("down3 112x64->128 s2", (112, 64, 128, "dense3x3", 2), 1),
    ("csp3_3x3 56x64->64", (56, 64, 64, "dense3x3", 1), 3),
    ("csp3_1x1 56x128->64", (56, 128, 64, "pw1x1", 1), 3),
    ("down4 56x128->256 s2", (56, 128, 256, "dense3x3", 2), 1),
    ("csp4_3x3 28x128->128", (28, 128, 128, "dense3x3", 1), 3),
    ("csp4_1x1 28x256->128", (28, 256, 128, "pw1x1", 1), 3),
    ("down5 28x256->512 s2", (28, 256, 512, "dense3x3", 2), 1),
    ("csp5_3x3 14x256->256", (14, 256, 256, "dense3x3", 1), 1),
    ("csp5_1x1 14x512->256", (14, 512, 256, "pw1x1", 1), 3),
    ("pafpn_3x3 56x64->64", (56, 64, 64, "dense3x3", 1), 2),
    ("pafpn_3x3 28x128->128", (28, 128, 128, "dense3x3", 1), 2),
    ("pafpn_down 56x64->64 s2", (56, 64, 64, "dense3x3", 2), 1),
    ("pafpn_down 28x128->128 s2", (28, 128, 128, "dense3x3", 2), 1),
]
STAGES = {"yolox-nano": NANO_STAGES, "yolox-s": S_STAGES}


def _randomize_bn(module, gen):
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            n = m.num_features
            m.weight.data = torch.rand(n, generator=gen, device=gen.device) + 0.5
            m.bias.data = torch.randn(n, generator=gen, device=gen.device) * 0.1
            m.running_mean = torch.randn(n, generator=gen, device=gen.device) * 0.1
            m.running_var = torch.rand(n, generator=gen, device=gen.device) + 0.5


def _cudnn_conv_bn_silu(block: ConvBnAct):
    """The stage's conv, BN and SiLU as one cuDNN conv and two bf16 ops."""
    c = block.conv
    w = c.weight.to(DT)
    scale, bias = (v.to(DT)[:, None, None] for v in fold_bn(
        block.bn.weight, block.bn.bias, block.bn.running_mean, block.bn.running_var, block.bn.eps))
    return lambda x: F.silu(F.conv2d(x, w, None, c.stride, c.padding, 1, c.groups) * scale + bias)


def make_stage(B, H, C, K, kind, stride, gen):
    """(x, the port's eval call, the cuDNN composition, route, bytes, FLOPs
    of a dense or pointwise conv, else None)."""
    dev = gen.device
    x = torch.randn((B, C, H, H), generator=gen, device=dev).to(DT).contiguous(
        memory_format=torch.channels_last)
    Ho = H // stride
    if kind == "null":
        w0 = torch.zeros((1,), dtype=DT, device=dev)
        fn = lambda x: x[:, :1, :1, :1] * w0[0]
        return x, fn, fn, "pytorch", 0, None
    if kind == "dwblock":
        block = DWConv(C, K, 3, stride).to(dev).eval()
        _randomize_bn(block, gen)
        route = "kernel" if block.uses_dwblock_kernel else "pytorch"
        dw, pw = _cudnn_conv_bn_silu(block.dconv), _cudnn_conv_bn_silu(block.pconv)
        cudnn = lambda x: pw(dw(x))
        weight_bytes, flops = (9 * C + C * K) * 2, None
    else:
        k = 3 if kind == "dense3x3" else 1
        block = ConvBnAct(C, K, k, stride).to(dev).eval()
        _randomize_bn(block, gen)
        route = "kernel" if block.uses_conv3x3_kernel else "pytorch"
        cudnn = _cudnn_conv_bn_silu(block)
        weight_bytes = k * k * C * K * 2
        flops = 2 * B * Ho * Ho * k * k * C * K
    n_bytes = (B * H * H * C + B * Ho * Ho * K) * 2 + weight_bytes
    return x, lambda x: block(x, False, False), cudnn, route, n_bytes, flops


@torch.no_grad()
def main(argv=None, device=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", default="yolox-nano", choices=sorted(STAGES))
    ap.add_argument("--batch", type=int, default=128, help="patches a stage call (bench: 128)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    where = card(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    total = total_cudnn = 0.0
    rows = []
    for name, (H, C, K, kind, stride), count in STAGES[args.variant]:
        x, port, cudnn, route, n_bytes, flops = make_stage(args.batch, H, C, K, kind, stride, gen)
        t = median_ms(lambda: port(x), args.reps, dev) / 1e3
        tc = median_ms(lambda: cudnn(x), args.reps, dev) / 1e3
        total += t * count
        total_cudnn += tc * count
        rec = {"stage": name, "route": route, "us": round(t * 1e6, 1),
               "cudnn_us": round(tc * 1e6, 1), "bound_us": round(n_bytes / HBM_BYTES_PER_S * 1e6, 1),
               "count": count, "total_us": round(t * count * 1e6, 1)}
        if flops:
            rec["tflops_per_s"] = round(flops / t / 1e12, 1)
        rec["card"] = where
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {"sum_us": round(total * 1e6, 1), "cudnn_sum_us": round(total_cudnn * 1e6, 1),
               "variant": args.variant, "batch": args.batch, "card": where}
    print(json.dumps(summary), flush=True)
    return rows + [summary]


if __name__ == "__main__":
    main()
