"""The flash-attention kernel against ``F.scaled_dot_product_attention`` over
the JAX package's shape sweep (the counterpart of
``scripts/bench_attention.py``): from the needle-scale [128, 4, 128, 64] to
[4, 16, 4096, 128], in bf16.

Each row: the kernel's ms (the wrapper's whole call) and TF/s, the same for
``F.scaled_dot_product_attention(is_causal=True)`` (a yardstick timed here
and called nowhere in the port), the kernel's max |err| against its plain
version (``causal_attention_reference``) on the same inputs, and the speedup
(SDPA's ms over the kernel's); each time the median of ``BENCH_ATTN_ITERS``
reps, each rep between a pair of CUDA events (the host clock on the CPU,
where the wrapper runs the plain version). Every row carries the card's
name and power limit.

    python -m jolineedle_tpu_torch.scripts.bench_attention

``BENCH_ATTN_SMALL=1`` runs only [2, 2, 256, 128] (a CPU smoke size).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.attention import causal_attention_reference, flash_attention
from ..utils.timing import card, median_ms

SHAPES = [
    # (B, H, T, D): needle-scale first, then tile-aligned scale.
    (128, 4, 128, 64),
    (128, 4, 128, 128),
    (8, 8, 512, 128),
    (8, 8, 1024, 128),
    (8, 8, 2048, 128),
    (4, 16, 4096, 128),
]
SMALL_SHAPES = [(2, 2, 256, 128)]


def main(argv=None, device=None) -> list:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve_device(device)
    small = os.environ.get("BENCH_ATTN_SMALL", "") == "1"
    iters = int(os.environ.get("BENCH_ATTN_ITERS", "20"))
    where = card(dev)
    print(f"device: {where}", flush=True)
    rng = np.random.default_rng(0)
    results = []
    for b, h, t, d in SMALL_SHAPES if small else SHAPES:
        q, k, v = (torch.from_numpy(rng.normal(size=(b, h, t, d)).astype(np.float32))
                   .to(dev).to(torch.bfloat16) for _ in range(3))
        err = (flash_attention(q, k, v).float()
               - causal_attention_reference(q, k, v).float()).abs().max().item()
        tf = median_ms(lambda: flash_attention(q, k, v), iters, dev) / 1e3
        tr = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                       iters, dev) / 1e3
        # Causal attention FLOPs: 2 matmuls over the lower triangle.
        flops = 2 * 2 * b * h * t * t * d / 2
        print(f"B{b} H{h} T{t} D{d}: flash {tf*1e3:8.3f} ms ({flops/tf/1e12:6.2f} TF/s)"
              f" | sdpa {tr*1e3:8.3f} ms ({flops/tr/1e12:6.2f} TF/s) | max|err| {err:.4f}"
              f" | speedup {tr/tf:5.2f}x  [{where}]", flush=True)
        results.append({"shape": [b, h, t, d], "flash_ms": tf * 1e3,
                        "flash_tflops_per_s": flops / tf / 1e12, "sdpa_ms": tr * 1e3,
                        "sdpa_tflops_per_s": flops / tr / 1e12, "max_abs_err": err,
                        "speedup": tr / tf, "card": where})
    return results


if __name__ == "__main__":
    main()
