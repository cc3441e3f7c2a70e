"""Build and bind the package's CUDA kernels: ``nvcc`` by hand, ``ctypes``.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into its own shared library
under ``build/kernels/`` of the checkout, at first use; the file name carries
a digest of the sources and flags, so an edited source builds anew. The C
entry point of each library has the source's name, takes every pointer and
the stream as ``void*`` and returns ``cudaGetLastError()``.

Nothing here runs when the module is imported: the CPU tests import every
module of the package on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

#: Where a wrapper computes its plain version instead of launching: a CPU
#: tensor, or a meta tensor (shapes only; nothing runs, as in a FLOP count).
#: On any other device it launches its kernel or raises.
PLAIN_DEVICES = ("cpu", "meta")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
#: C signature of each kernel library's entry point.
SIGNATURES = {
    # x, dw, gamma1, beta1, mean1, var1, pw, gamma2, beta2, mean2, var2, out,
    # B, H, W, C, K, dw strides (dy, dx, c), pw strides (c, k), is_bf16, eps, stream
    "dwblock_bn_silu": [_P] * 12 + [_I] * 11 + [_F, _P],
    # x, w[9C,K], scale, bias, out, B, H, W, C, K, is_bf16, stream
    "conv3x3_bn_silu": [_P] * 5 + [_I] * 6 + [_P],
    # x, w[9C,K], out, B, H, W, C, K, is_bf16, stream
    "conv3x3": [_P] * 3 + [_I] * 6 + [_P],
    # q, k, v, o, lse[B,H,T], B, H, T, D, (b, h, t) strides of q, k, v, o,
    # vec, heads_per_block, grid, is_bf16, scale, stream
    "flash_attention": [_P] * 5 + [_I] * 4 + [_L] * 12 + [_I] * 4 + [_F, _P],
}

_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the kernels are built from jolineedle_tpu_torch/csrc"
        " at first use and need the CUDA toolkit (put nvcc on PATH or set"
        " CUDA_HOME)"
    )


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, Tuple[Path, str]]:
    """Compile the named kernels (default: all of ``csrc/*.cu``) that are
    not built yet, one ``nvcc`` process per source, all started together.

    Returns ``{name: (library path, compiler log)}``; the log holds
    ``ptxas -v``'s registers, shared memory and spills (empty when the
    library was already built). Raises with the compiler's output if any
    source fails to build.
    """
    names = sorted(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built: Dict[str, Tuple[Path, str]] = {}
    running = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            built[name] = (out, "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = (out, log)
    if failures:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failures))
    return built


def kernel(name: str):
    """The ctypes entry point of kernel ``name``, building it if needed."""
    fn = _loaded.get(name)
    if fn is None:
        path, _ = build_kernels([name])[name]
        fn = getattr(ctypes.CDLL(str(path)), name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
