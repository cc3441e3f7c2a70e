"""Where the conv kernels' time goes, on the card: a kernel built again
with parts of its work switched off, each variant timed in bfloat16.

    python -m jolineedle_tpu_torch.scripts.conv_ablation [--kernel tile|dwblock|both]

``tile``: ``csrc/conv3x3_tile.cuh`` (the ``conv3x3_bn_silu`` library) with
the source edits listed in ``VARIANTS``, timed at the yolox-nano stem.
``pixel_copies`` loads the halo pixel by pixel with cp.async (as shapes
without packed rows do), in place of the TMA box of rows.

``dwblock``: ``csrc/dwblock_bn_silu.cu`` with the edits of ``DW_VARIANTS``,
timed at each dwblock shape of one yolox-nano detector call at 448 px (N =
32 patches) through the wrapper's arguments (the model's OIHW weight views,
raw BN vectors), and summed over the call's 24 launches; also timed back
to back (20 launches between one pair of events), which leaves out the
event pair's own cost around each launch.

Each variant is built with the package's nvcc flags into
``build/ablation/`` and timed with CUDA events (median of 20 launches
queued behind a sleep kernel). A variant that skips work writes wrong
outputs; only ``full`` and ``pixel_copies`` are held against the plain
version. Prints one JSON line per kernel: the card, the shapes and the
milliseconds of each variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
from pathlib import Path

import torch

from ..ops import conv as kconv
from ..ops.kernels import BUILD_DIR, CSRC, NVCC_FLAGS, SIGNATURES, _nvcc
from ..utils.timing import back_to_back_ms, card, median_ms

# The yolox-nano stem of a B=32 rollout step at 448 px: [B, H, W, C -> K].
STEM = (32, 224, 224, 12, 16)
REPS = 20  # event pairs per timing, their median taken
_NO_MMA = ("const int ksteps = p.cc / MmaDepth<T>::value;", "const int ksteps = 0;")
_NO_STORES = ("      auto store_pair = [](T* o, float v0, float v1) {",
              "      auto store_pair = [](T* o, float v0, float v1) {\n"
              "        if (v0 != 12345.0f) return;")
# Only the ring's first stages load; later TMA stages arrive on their
# barrier with no bytes.
_NO_LOADS = ("        stage_halo<T, kBlock, kHP>(halo",
             "        if (issued < p.nstages) stage_halo<T, kBlock, kHP>(halo")
_NO_TMA_LOADS = ("        if (threadIdx.x == 0)\n          tma_halo(",
                 "        if (threadIdx.x == 0 && issued >= p.nstages)\n"
                 '          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"'
                 ' ::"r"(smem_u32(bar + ld.buf)) : "memory");\n'
                 "        else if (threadIdx.x == 0)\n          tma_halo(")
# The halo copied pixel by pixel (8-byte cp.async at C = 12), not by TMA.
_PIXEL_COPIES = ("      if (packed_rows(x, W, C))", "      if (false && packed_rows(x, W, C))")
_NO_EPILOGUE = ("    if (cu.chunk == p.nchunks - 1) {  // the epilogue",
                "    if (cu.chunk == p.nchunks + 1) {  // the epilogue")
VARIANTS = {
    "full": [],
    "pixel_copies": [_PIXEL_COPIES],
    "no_stores": [_NO_STORES],
    "no_halo_loads": [_NO_LOADS, _NO_TMA_LOADS],
    "loads_only": [_NO_MMA, _NO_STORES],  # halo loads, loop and epilogue math
    "mma_and_epilogue_only": [_NO_LOADS, _NO_TMA_LOADS, _NO_STORES],
    "loop_only": [_NO_MMA, _NO_LOADS, _NO_TMA_LOADS, _NO_EPILOGUE],  # barriers, cursors, launch
}


# The dwblock kernel's parts. The halo: past the ring's first two items
# nothing loads (a TMA item's barrier is arrived on with no bytes).
_DW_NO_LOADS = [
    ("        tma_load_4d(full + (j & 1), dst, tmap,",
     "        if (j >= 2)\n"
     '          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"'
     ' ::"r"(smem_u32(full + (j & 1))) : "memory");\n'
     "        else\n        tma_load_4d(full + (j & 1), dst, tmap,"),
    ("      stage_halo<T>(dst, full + (j & 1), p, b, ty0, tx0, lane);",
     "      if (j < 2) stage_halo<T>(dst, full + (j & 1), p, b, ty0, tx0, lane);\n"
     '      else asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"'
     ' ::"r"(smem_u32(full + (j & 1))) : "memory");'),
]
# p.K < 0 never holds and p.K > 0 always does, but the compiler cannot
# tell: the code stays.
_DW_NO_DEPTHWISE = [("    if (nr > 0)\n      depthwise<T>(", "    if (nr > 0 && p.K < 0)\n      depthwise<T>(")]
_DW_NO_POINTWISE = [("      if (gy >= p.H) break;", "      if (gy >= p.H || p.K > 0) break;")]
_DW_NO_STORES = [("          if (tx0 + px < p.W && e0 < kw)", "          if (tx0 + px < p.W && e0 < kw && p.K < 0)")]
# The kernel returns at once: launch and timing overhead alone.
_DW_EMPTY = [("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n\n  // This block's",
              "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
              "  if (p.K > 0) return;\n\n  // This block's")]
# No BN fold, taps or pw staged.
_DW_NO_PROLOGUE = [("  for (int c = tid; c < p.C; c += kBlock) {\n    float d[9];",
                    "  for (int c = tid; c < p.C && p.K < 0; c += kBlock) {\n    float d[9];"),
                   ("  load_pw_batch(batch, tid, p, n0, kw, pw_pitch);",
                    "  load_pw_batch(batch, tid, p, n0, p.K < 0 ? kw : 0, pw_pitch);"),
                   ("  const int pw_total = kw * (pw_by4(p) ? p.C / 4 : p.C);",
                    "  const int pw_total = p.K < 0 ? kw * (pw_by4(p) ? p.C / 4 : p.C) : 0;"),
                   ("  for (int n = tid; n < kw; n += kBlock) {\n    const int k = n0 + n;",
                    "  for (int n = tid; n < kw && p.K < 0; n += kBlock) {\n    const int k = n0 + n;")]
# Tuning: at most 64 registers (4 blocks of 256 threads per SM) for slices
# up to 64 wide; tiles of at most 8 rows.
_DW_LB4 = [("__launch_bounds__(kBlock)\n    dwblock_kernel",
            "__launch_bounds__(kBlock, kNT <= 64 ? 4 : 1)\n    dwblock_kernel")]
_DW_ROWS8 = [("constexpr int kMaxRows = 16;", "constexpr int kMaxRows = 8;")]
# bf16 SiLU without its tanh (one multiply in its place): the special
# function unit's share.
_DW_NO_TANH = [('    asm("tanh.approx.f32 %0, %1;\\n" : "=f"(t) : "f"(u));', "    t = u * 0.5f;")]
_DW_LB3 = [("__launch_bounds__(kBlock)\n    dwblock_kernel",
            "__launch_bounds__(kBlock, kNT <= 64 ? 3 : 1)\n    dwblock_kernel")]
DW_VARIANTS = {
    "full": [],
    "lb4": _DW_LB4,
    "lb3": _DW_LB3,
    "no_tanh": _DW_NO_TANH,
    "rows8": _DW_ROWS8,
    "empty": _DW_EMPTY,
    "no_prologue": _DW_NO_PROLOGUE,
    "no_stores": _DW_NO_STORES,
    "loads_only": _DW_NO_DEPTHWISE + _DW_NO_POINTWISE,  # halo loads, prologue, loop
    "depthwise_only": _DW_NO_LOADS + _DW_NO_POINTWISE,
    "mma_and_epilogue_only": _DW_NO_LOADS + _DW_NO_DEPTHWISE + _DW_NO_STORES,
    "loop_only": _DW_NO_LOADS + _DW_NO_DEPTHWISE + _DW_NO_POINTWISE,  # prologue, barriers, launch
}
# The dwblock shapes of one yolox-nano detector call at 448 px: (H, W, C,
# K) and launches per call.
DW_SHAPES = [((112, 112, 16, 16), 1), ((56, 56, 32, 32), 4), ((56, 56, 64, 64), 4),
             ((28, 28, 64, 64), 9), ((14, 14, 64, 64), 4), ((14, 14, 128, 128), 2)]
DW_N = 32


def _build(root: Path, edited: str, library: str, variants: dict) -> dict:
    """Every variant of ``csrc/<edited>`` built with the other sources
    into ``root/<variant>/lib.so``; returns the ctypes entry points."""
    procs = {}
    for name, edits in variants.items():
        src = (CSRC / edited).read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: {edited} no longer holds {old!r}")
            src = src.replace(old, new)
        d = root / name
        d.mkdir(parents=True)
        for f in [*CSRC.glob("*.cuh"), CSRC / f"{library}.cu"]:
            shutil.copy(f, d / f.name)
        (d / edited).write_text(src)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / f"{library}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{log}")
        fn = getattr(ctypes.CDLL(str(root / name / "lib.so")), library)
        fn.argtypes, fn.restype = SIGNATURES[library], ctypes.c_int
        fns[name] = fn
    return fns


def _bn(gen, n):
    return [torch.rand(n, generator=gen, device="cuda") + 0.5,
            torch.randn(n, generator=gen, device="cuda") * 0.1,
            torch.randn(n, generator=gen, device="cuda") * 0.1,
            torch.rand(n, generator=gen, device="cuda") + 0.5]


def tile_ablation(root: Path) -> dict:
    fns = _build(root / "tile", "conv3x3_tile.cuh", "conv3x3_bn_silu", VARIANTS)
    B, H, W, C, K = STEM
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, H, W, C), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((3, 3, C, K), generator=gen, device="cuda") / (9 * C) ** 0.5
    bn = _bn(gen, K)
    operands = kconv.conv3x3_bn_silu_operands(x, w, *bn)
    out = torch.empty((B, H, W, K), dtype=x.dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for name, fn in fns.items():
        def call(fn=fn):
            err = fn(x.data_ptr(), *(t.data_ptr() for t in operands), out.data_ptr(),
                     B, H, W, C, K, 1, stream)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
        if name in ("full", "pixel_copies"):
            call()
            want = kconv.conv3x3_bn_silu_reference(x.float(), w, *bn)
            torch.testing.assert_close(out.float(), want, atol=3e-2, rtol=2e-2)
        ms[name] = median_ms(call, REPS, "cuda")
    return {"kernel": "conv3x3_tile", "card": card("cuda"), "shape": list(STEM), "dtype": "bfloat16",
            "ms": ms}


def dwblock_ablation(root: Path) -> dict:
    fns = _build(root / "dwblock", "dwblock_bn_silu.cu", "dwblock_bn_silu", DW_VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    ms = {name: [] for name in fns}
    b2b = {name: [] for name in fns}
    for (H, W, C, K), _ in DW_SHAPES:
        x = torch.randn((DW_N, H, W, C), generator=gen, device="cuda").to(torch.bfloat16)
        # The model's arguments: HWIO views of OIHW weights, raw BN vectors.
        dw = (torch.randn((C, 1, 3, 3), generator=gen, device="cuda") * 0.2).permute(2, 3, 1, 0)
        pw = (torch.randn((K, C, 1, 1), generator=gen, device="cuda") / C**0.5).permute(2, 3, 1, 0)
        args = [dw, *_bn(gen, C), pw, *_bn(gen, K)]
        out = torch.empty((DW_N, H, W, K), dtype=x.dtype, device="cuda")
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(x.data_ptr(), *(t.data_ptr() for t in args), out.data_ptr(),
                         DW_N, H, W, C, K, dw.stride(0), dw.stride(1), dw.stride(3),
                         pw.stride(2), pw.stride(3), 1, 1e-3, stream)
                if err != 0:
                    raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
            if name == "full":
                call()
                want = kconv.dwblock_bn_silu_reference(x.float(), *args)
                torch.testing.assert_close(out.float(), want, atol=3e-2, rtol=2e-2)
            ms[name].append(median_ms(call, REPS, "cuda"))
            b2b[name].append(back_to_back_ms(call))
    per_call = {name: sum(t * n for t, (_, n) in zip(v, DW_SHAPES)) for name, v in ms.items()}
    return {"kernel": "dwblock_bn_silu", "card": card("cuda"), "n": DW_N, "dtype": "bfloat16",
            "shapes": [[DW_N, *shape] for shape, _ in DW_SHAPES],
            "launches_per_detector_call": [n for _, n in DW_SHAPES], "ms": ms,
            "detector_call_ms": per_call, "back_to_back_ms": b2b,
            "back_to_back_detector_call_ms": {
                name: sum(t * n for t, (_, n) in zip(v, DW_SHAPES)) for name, v in b2b.items()}}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=("tile", "dwblock", "both"), default="both")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_ablation needs an NVIDIA GPU: the kernels are CUDA-only")
    root = BUILD_DIR.parent / "ablation"
    shutil.rmtree(root, ignore_errors=True)
    results = []
    for kernel, run in (("tile", tile_ablation), ("dwblock", dwblock_ablation)):
        if args.kernel in (kernel, "both"):
            results.append(run(root))
            print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
