"""Where the dense 3x3 tile's time goes, on the card: the
``conv3x3_bn_silu`` kernel built again with parts of its work switched off,
each variant timed at the yolox-nano stem in bfloat16.

    python -m jolineedle_tpu_torch.scripts.conv_ablation

Each variant is ``csrc/conv3x3_tile.cuh`` with the source edits listed in
``VARIANTS``, built with the package's nvcc flags into ``build/ablation/``
and timed with CUDA events (median of 20 launches queued behind a sleep
kernel). ``pixel_copies`` loads the halo pixel by pixel with cp.async
(as shapes without packed rows do), in place of the TMA box of rows. A variant that skips work writes wrong
outputs; only ``full`` and ``pixel_copies`` are held against the plain
version. Prints one JSON line: the card, the shape
and the milliseconds of each variant.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import conv as kconv
from ..ops.kernels import BUILD_DIR, CSRC, NVCC_FLAGS, SIGNATURES, _nvcc

# The yolox-nano stem of a B=32 rollout step at 448 px: [B, H, W, C -> K].
STEM = (32, 224, 224, 12, 16)
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


def _build(root: Path) -> dict:
    procs = {}
    for name, edits in VARIANTS.items():
        src = (CSRC / "conv3x3_tile.cuh").read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: the tile source no longer holds {old!r}")
            src = src.replace(old, new)
        d = root / name
        d.mkdir(parents=True)
        (d / "conv3x3_tile.cuh").write_text(src)
        for f in ("common.cuh", "conv3x3_bn_silu.cu"):
            shutil.copy(CSRC / f, d / f)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "conv3x3_bn_silu.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{log}")
        fn = ctypes.CDLL(str(root / name / "lib.so")).conv3x3_bn_silu
        fn.argtypes, fn.restype = SIGNATURES["conv3x3_bn_silu"], ctypes.c_int
        fns[name] = fn
    return fns


def _median_ms(fn, reps: int = 20) -> float:
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


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("conv_ablation needs an NVIDIA GPU: the kernel is CUDA-only")
    root = BUILD_DIR.parent / "ablation"
    shutil.rmtree(root, ignore_errors=True)
    fns = _build(root)

    B, H, W, C, K = STEM
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((B, H, W, C), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((3, 3, C, K), generator=gen, device="cuda") / (9 * C) ** 0.5
    bn = [torch.rand(K, generator=gen, device="cuda") + 0.5,
          torch.randn(K, generator=gen, device="cuda") * 0.1,
          torch.randn(K, generator=gen, device="cuda") * 0.1,
          torch.rand(K, generator=gen, device="cuda") + 0.5]
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
        ms[name] = _median_ms(call)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    result = {"card": card, "shape": list(STEM), "dtype": "bfloat16", "ms": ms}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
