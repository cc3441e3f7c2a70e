"""Where the flash-attention kernel's time goes, on the card: the kernel
built again with parts of its work switched off, each variant timed in
bfloat16.

    python -m jolineedle_tpu_torch.scripts.flash_ablation

Variants of ``csrc/flash_attention.cu`` (``VARIANTS``): ``full``; ``empty``
(returns at once: the launch alone); ``loads_only`` (Q and the K/V tiles
loaded, no product); ``qk_only`` (S = QK^T, no softmax and no PV);
``no_pv`` (S and the online softmax, no PV); and a tuning variant, ``lb5``
(at most 102 registers, for 5 blocks per SM). Each is timed at every shape of ``SHAPES``, the
decoder's on the model's strided views (the split of one c_attn output),
per launch (an event pair around each, median of 20) and back to back (20
launches between one pair of events).
A variant that skips work writes wrong outputs; only ``full`` is held
against the plain version.

Each variant is built with the package's nvcc flags into
``build/ablation/flash/``. Prints one JSON line: the card, the shapes and
the milliseconds.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch

from ..ops import attention as kattn
from ..ops.kernels import BUILD_DIR
from ..utils.timing import back_to_back_ms, card, median_ms
from .conv_ablation import REPS, _build

_ATTEND = ("  scores<T, D>(s, r, ks, n16, lane);\n"
           "  softmax_step<T, D>(s, r, n16, key0, q0, key0 + 16 * n16 - 1 > q0, scale_log2, lane);\n"
           "  pv<T, D>(r, s, vs, n16, lane);\n")
VARIANTS = {
    "full": [],
    "empty": [("  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n",
               "  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;\n"
               "  if (p.T > 0) return;\n")],
    # Q's fragments and one element of each tile feed the output: the loads stay.
    "loads_only": [(_ATTEND, "  r.acc[0][0] += __uint_as_float(r.qa[0][0]) + to_f32(ks[lane])"
                             " + to_f32(vs[lane]);\n")],
    "qk_only": [(_ATTEND, "  scores<T, D>(s, r, ks, n16, lane);\n  fold_scores<T, D>(s, r);\n")],
    "no_pv": [("  pv<T, D>(r, s, vs, n16, lane);\n", "")],
    # Tuning: at most 102 registers, for 5 blocks of 128 threads per SM (the
    # float32 instantiations spill; only bf16 is timed).
    "lb5": [("__global__ void __launch_bounds__(kThreads) flash_fwd_kernel",
             "__global__ void __launch_bounds__(kThreads, 5) flash_fwd_kernel")],
}
# The decoder's teacher-forced shape (B = 16, gpt-nano's 3 heads, T = 21,
# head dim 16), a ragged multi-tile one and the needle-scale long-T row of
# the JAX package's sweep (scripts/bench_attention.py:75).
PATH_SHAPE = (16, 3, 21, 16)
SHAPES = [PATH_SHAPE, (2, 4, 200, 64), (128, 4, 128, 64)]
# o at the bf16 limit; lse, float32 in both dtypes, at the float32 limit.
O_TOL, LSE_TOL = (3e-2, 2e-2), (1e-4, 1e-4)


def _inputs(shape, gen, model_views):
    """bf16 q, k, v on the card: the model's views of one [B, T, 3C] c_attn
    output, or contiguous [B, H, T, D] tensors."""
    B, H, T, D = shape
    if model_views:
        x = torch.randn((B, T, 3 * H * D), generator=gen, device="cuda").bfloat16()
        return [t.reshape(B, T, H, D).transpose(1, 2) for t in x.split(H * D, dim=-1)]
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3)]


def _check(o, lse, q, k, v, what):
    want_o, want_lse = kattn.flash_attention_forward_reference(q, k, v)
    torch.testing.assert_close(o.float(), want_o.float(), atol=O_TOL[0], rtol=O_TOL[1], msg=what)
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL[0], rtol=LSE_TOL[1], msg=what)


def _times(call):
    return {"ms": median_ms(call, REPS, "cuda"), "back_to_back_ms": back_to_back_ms(call)}


def _call(fn, args, stream, name):
    def call():
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    return call


def variants(root: Path, gen) -> dict:
    fns = _build(root, "flash_attention.cu", "flash_attention", VARIANTS)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for shape in SHAPES:
        q, k, v = _inputs(shape, gen, model_views=shape == PATH_SHAPE)
        o, lse, args = kattn.flash_attention_args(q, k, v)
        row = {}
        for name, fn in fns.items():
            call = _call(fn, args, stream, name)
            if name == "full":
                call()
                _check(o, lse, q, k, v, f"full {shape}")
            row[name] = _times(call)
        out[str(list(shape))] = row
    return out


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_ablation needs an NVIDIA GPU: the kernel is CUDA-only")
    root = BUILD_DIR.parent / "ablation" / "flash"
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"kernel": "flash_attention", "card": card("cuda"), "dtype": "bfloat16",
           "variants": variants(root, gen)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
