"""The port's conv kernels (jolineedle_tpu_torch/ops/conv.py) against the JAX
package's Pallas kernels (the two fused blocks, and the smoke script's plain
3x3 conv), and the CUDA kernels against their plain versions.

On the CPU a wrapper computes its plain version; the JAX side runs the
Pallas kernels in interpret mode, as tests/test_pallas_conv.py does. JAX is
imported inside the tests that use it, so that the CUDA tests of this file
also run on a machine that has a GPU and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_conv.py
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jolineedle_tpu_torch.ops import conv as tconv

# (B, H, W, C, K): the shapes of tests/test_pallas_conv.py:18,40 and a
# nano-like one (28x28, 16 -> 16).
DW_SHAPES = [(2, 10, 10, 8, 12), (2, 28, 28, 16, 16)]
CONV_SHAPES = [(2, 12, 12, 8, 16), (2, 28, 28, 12, 16)]


def _bn(rng, n):
    return [
        rng.uniform(0.5, 1.5, n).astype(np.float32),
        rng.normal(size=n).astype(np.float32),
        (rng.normal(size=n) * 0.1).astype(np.float32),
        rng.uniform(0.5, 1.5, n).astype(np.float32),
    ]


def _dw_inputs(shape, seed):
    B, H, W, C, K = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    dw = (rng.normal(size=(3, 3, 1, C)) * 0.2).astype(np.float32)
    pw = (rng.normal(size=(1, 1, C, K)) * 0.2).astype(np.float32)
    return [x, dw, *_bn(rng, C), pw, *_bn(rng, K)]


def _conv_inputs(shape, seed):
    B, H, W, C, K = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, K)) * 0.1).astype(np.float32)
    return [x, w, *_bn(rng, K)]


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_dwblock_matches_jax(shape):
    import jax.numpy as jnp

    from jolineedle_tpu.ops.conv import dwblock_bn_silu as jax_dwblock

    args = _dw_inputs(shape, 1)
    want = np.asarray(jax_dwblock(*[jnp.asarray(a) for a in args]))
    targs = [torch.from_numpy(a) for a in args]
    calls = tconv.dwblock_bn_silu.calls
    got = tconv.dwblock_bn_silu(*targs)
    assert tconv.dwblock_bn_silu.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref = tconv.dwblock_bn_silu_reference(*targs)
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_matches_jax(shape):
    import jax.numpy as jnp

    from jolineedle_tpu.ops.conv import conv3x3_bn_silu as jax_conv

    args = _conv_inputs(shape, 0)
    want = np.asarray(jax_conv(*[jnp.asarray(a) for a in args]))
    targs = [torch.from_numpy(a) for a in args]
    calls = tconv.conv3x3_bn_silu.calls
    got = tconv.conv3x3_bn_silu(*targs)
    assert tconv.conv3x3_bn_silu.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref = tconv.conv3x3_bn_silu_reference(*targs)
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-5)


def _smoke_pallas_conv():
    """scripts/smoke_pallas_conv.py, loaded by path (scripts/ is no package)."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "smoke_pallas_conv.py"
    spec = importlib.util.spec_from_file_location("smoke_pallas_conv", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape", [(2, 12, 12, 8, 16), (1, 14, 14, 16, 32)])
def test_plain_conv3x3_matches_smoke_pallas_conv(shape):
    """The plain version of the port's ``conv3x3`` against the smoke
    script's Pallas ``pallas_conv3x3`` (interpret mode on the CPU)."""
    import jax.numpy as jnp

    B, H, W, C, K = shape
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(3, 3, C, K)) * 0.1).astype(np.float32)
    want = np.asarray(_smoke_pallas_conv().pallas_conv3x3(jnp.asarray(x), jnp.asarray(w)))
    calls = tconv.conv3x3.calls
    got = tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(w))
    assert tconv.conv3x3.calls == calls + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref = tconv.conv3x3_reference(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_path_does_not_launch():
    """A CPU tensor goes to the plain version and never counts a launch."""
    tconv.reset_counts()
    tconv.dwblock_bn_silu(*[torch.from_numpy(a) for a in _dw_inputs(DW_SHAPES[0], 2)])
    conv_args = [torch.from_numpy(a) for a in _conv_inputs(CONV_SHAPES[0], 2)]
    tconv.conv3x3_bn_silu(*conv_args)
    tconv.conv3x3(*conv_args[:2])
    assert tconv.dwblock_bn_silu.calls == tconv.conv3x3_bn_silu.calls == tconv.conv3x3.calls == 1
    assert (tconv.dwblock_bn_silu.launches == tconv.conv3x3_bn_silu.launches
            == tconv.conv3x3.launches == 0)


def test_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU launches or raises: here, a "meta"
    tensor is refused before any pointer is passed."""
    args = [torch.from_numpy(a).to("meta") for a in _conv_inputs(CONV_SHAPES[0], 3)]
    with pytest.raises(ValueError, match="runs on CUDA"):
        tconv.conv3x3_bn_silu(*args)
    with pytest.raises(ValueError, match="runs on CUDA"):
        tconv.conv3x3(*args[:2])


def test_module_imports_without_nvcc_or_triton():
    code = (
        "import sys, shutil; sys.modules['triton'] = None;"
        " shutil.which = lambda *a, **k: None;"
        " import jolineedle_tpu_torch.ops.conv as c;"
        " assert 'triton' not in sys.modules or sys.modules['triton'] is None;"
        " import jolineedle_tpu_torch.ops.attention as a;"
        " print(c.dwblock_bn_silu.launches, c.conv3x3_bn_silu.launches,"
        " c.conv3x3.launches, a.flash_attention.launches)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True
    )
    assert out.stdout.split() == ["0", "0", "0", "0"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA-only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# f32: sums in another order than the plain version (FMA, tap-major);
# bf16: the kernel output rounds to bf16 (2^-8 relative) against an f32
# plain version.
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}

GPU_DW = DW_SHAPES + [(3, 14, 14, 128, 128), (2, 13, 9, 64, 32)]
GPU_CONV = CONV_SHAPES + [(2, 33, 17, 12, 16), (1, 10, 10, 40, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GPU_DW)
def test_dwblock_kernel_matches_plain(cuda, shape, dtype):
    args = [torch.from_numpy(a).to(cuda) for a in _dw_inputs(shape, 4)]
    x = args[0].to(dtype)
    launches = tconv.dwblock_bn_silu.launches
    got = tconv.dwblock_bn_silu(x, *args[1:])
    torch.cuda.synchronize()
    assert tconv.dwblock_bn_silu.launches == launches + 1
    want = tconv.dwblock_bn_silu_reference(x.float(), *args[1:])
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GPU_CONV)
def test_conv3x3_kernel_matches_plain(cuda, shape, dtype):
    args = [torch.from_numpy(a).to(cuda) for a in _conv_inputs(shape, 5)]
    x = args[0].to(dtype)
    launches = tconv.conv3x3_bn_silu.launches
    got = tconv.conv3x3_bn_silu(x, *args[1:])
    torch.cuda.synchronize()
    assert tconv.conv3x3_bn_silu.launches == launches + 1
    want = tconv.conv3x3_bn_silu_reference(x.float(), *args[1:])
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


# The smoke script's default (B=8, 56x56, 16 -> 32), the nano stem, a
# ragged one and a K that takes two 64-wide slices.
GPU_PLAIN_CONV = [(8, 56, 56, 16, 32), (2, 224, 224, 12, 16), (2, 33, 17, 12, 16),
                  (1, 10, 10, 40, 130)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GPU_PLAIN_CONV)
def test_plain_conv3x3_kernel_matches_plain(cuda, shape, dtype):
    x, w = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(shape, 6)[:2])
    x = x.to(dtype)
    launches = tconv.conv3x3.launches
    got = tconv.conv3x3(x, w)
    torch.cuda.synchronize()
    assert tconv.conv3x3.launches == launches + 1
    want = tconv.conv3x3_reference(x.float(), w)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
