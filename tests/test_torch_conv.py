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

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

# (B, H, W, C, K): the shapes of tests/test_pallas_conv.py:18,40, a
# nano-like one (28x28, 16 -> 16), the widest nano shape (14x14, 128) and a
# ragged one with K != C (13x9, 64 -> 32).
DW_SHAPES = [(2, 10, 10, 8, 12), (2, 28, 28, 16, 16), (1, 14, 14, 128, 128), (2, 13, 9, 64, 32)]
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


def _oihw_views(args):
    """The dwblock arguments with dw and pw as the model passes them: HWIO
    views (``models/yolox.py::_hwio``) of contiguous OIHW weights."""
    dw, pw = args[1], args[6]
    dw_oihw = dw.permute(3, 2, 0, 1).contiguous()  # [C, 1, 3, 3]
    pw_oihw = pw.permute(3, 2, 0, 1).contiguous()  # [K, C, 1, 1]
    views = list(args)
    views[1], views[6] = dw_oihw.permute(2, 3, 1, 0), pw_oihw.permute(2, 3, 1, 0)
    assert not views[1].is_contiguous() and not views[6].is_contiguous()
    assert torch.equal(views[1], dw) and torch.equal(views[6], pw)
    return views


@pytest.mark.parametrize("shape", DW_SHAPES[:2])
def test_dwblock_oihw_views_match_contiguous(shape):
    """The wrapper gives the same result for the model's permuted OIHW
    weight views as for contiguous HWIO copies (on the card the kernel reads
    the views through their strides)."""
    args = [torch.from_numpy(a) for a in _dw_inputs(shape, 7)]
    want = tconv.dwblock_bn_silu(*args)
    got = tconv.dwblock_bn_silu(*_oihw_views(args))
    assert torch.equal(got, want)


def test_kernel_entry_points_match_signatures():
    """Each csrc/*.cu ``extern "C"`` entry point takes as many parameters as
    ``ops/kernels.py::SIGNATURES`` gives ctypes: a mismatch would only
    crash on the card."""
    import re

    from jolineedle_tpu_torch.ops.kernels import CSRC, SIGNATURES

    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            assert name == path.stem, (path.name, name)
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert found == {name: len(sig) for name, sig in SIGNATURES.items()}


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


# bf16: the kernels multiply the filter rounded to bf16 (conv3x3_filter);
# its error, and the output's rounding to bf16, stay inside the tolerance
# the card is held to.
BF16_TOLS = dict(atol=3e-2, rtol=2e-2)
BF16_SHAPES = [(2, 28, 28, 12, 16), (1, 10, 10, 40, 130)]


@pytest.mark.parametrize("kernel", ["conv3x3_bn_silu", "conv3x3"])
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_bf16_filter_matches_jax(shape, kernel):
    """The plain versions fed the filter as the bf16 kernels take it
    (rounded to bf16) against the JAX Pallas kernels with the float32
    filter: the rounding stays inside the bf16 tolerance."""
    import jax.numpy as jnp

    x, w, *bn = _conv_inputs(shape, 8)
    C, K = shape[3:]
    wk = tconv.conv3x3_filter(torch.from_numpy(w), torch.bfloat16).float().reshape(3, 3, C, K)
    assert not torch.equal(wk, torch.from_numpy(w))  # the rounding is real
    tx = torch.from_numpy(x)
    if kernel == "conv3x3_bn_silu":
        from jolineedle_tpu.ops.conv import conv3x3_bn_silu as jax_conv

        want = np.asarray(jax_conv(*[jnp.asarray(a) for a in (x, w, *bn)]))
        got = tconv.conv3x3_bn_silu_reference(tx, wk, *[torch.from_numpy(a) for a in bn])
    else:
        want = np.asarray(_smoke_pallas_conv().pallas_conv3x3(jnp.asarray(x), jnp.asarray(w)))
        got = tconv.conv3x3_reference(tx, wk)
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOLS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BF16_SHAPES)
def test_conv3x3_operands(shape, dtype):
    """What the wrappers hand the dense 3x3 kernels, without a launch: the
    filter as a contiguous [9C, K] in x's dtype (from the HWIO view of an
    OIHW weight, as the model passes it) and BN folded in float32."""
    x, w, *bn = [torch.from_numpy(a) for a in _conv_inputs(shape, 9)]
    B, H, W, C, K = shape
    x = x.to(dtype)
    w_hwio = w.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)  # not contiguous
    launches = tconv.conv3x3_bn_silu.launches, tconv.conv3x3.launches
    wf, scale, bias = tconv.conv3x3_bn_silu_operands(x, w_hwio, *bn)
    assert wf.shape == (9 * C, K) and wf.dtype == dtype and wf.is_contiguous()
    assert torch.equal(wf, w.to(dtype).reshape(9 * C, K))
    assert torch.equal(tconv.conv3x3_filter(w_hwio, x.dtype), wf)
    assert scale.dtype == bias.dtype == torch.float32 and scale.shape == bias.shape == (K,)
    want_scale, want_bias = tconv.fold_bn(*bn, 1e-3)
    assert torch.equal(scale, want_scale) and torch.equal(bias, want_bias)
    assert (tconv.conv3x3_bn_silu.launches, tconv.conv3x3.launches) == launches


def test_conv_ablation_edits_match_the_tile_source():
    """Every source edit of the ablation script still finds its text in
    csrc/conv3x3_tile.cuh (the script itself runs only on the card)."""
    from jolineedle_tpu_torch.ops.kernels import CSRC
    from jolineedle_tpu_torch.scripts.conv_ablation import VARIANTS

    src = (CSRC / "conv3x3_tile.cuh").read_text()
    for name, edits in VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)


def test_dwblock_ablation_edits_match_the_source():
    """Likewise for the ablation's variants of csrc/dwblock_bn_silu.cu."""
    from jolineedle_tpu_torch.ops.kernels import CSRC
    from jolineedle_tpu_torch.scripts.conv_ablation import DW_VARIANTS

    src = (CSRC / "dwblock_bn_silu.cu").read_text()
    for name, edits in DW_VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)


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


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """A CUDA tensor launches or raises, never computing the plain version:
    here fake CUDA tensors (``FakeTensorMode``: shapes and a device, no
    memory) reach the launch, whose ``kernel`` is a stub that raises, or
    fail earlier on a build without CUDA. Only CPU and meta tensors take
    the plain version (a meta one: shapes only, ``tests/test_torch_flops.py``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_kernel(name):
        raise RuntimeError(f"kernel stub: {name} would launch")

    monkeypatch.setattr(tconv, "kernel", no_kernel)
    tconv.reset_counts()
    shapes = [a.shape for a in _conv_inputs(CONV_SHAPES[0], 3)]
    with FakeTensorMode():
        args = [torch.empty(shape, device="cuda") for shape in shapes]
        with pytest.raises(RuntimeError):
            tconv.conv3x3_bn_silu(*args)
        with pytest.raises(RuntimeError):
            tconv.conv3x3(*args[:2])
    assert tconv.conv3x3_bn_silu.launches == tconv.conv3x3.launches == 0


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


# f32: sums in another order than the plain version (3xTF32 products for
# the dense 3x3); bf16: the kernel output rounds to bf16 (2^-8 relative)
# against an f32 plain version on the caller's float32 filter (the dense
# 3x3 kernels multiply it rounded to bf16).
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}

# (shape, offset, views): the shapes the dwblock tiling (rows x 16 pixels,
# K slices of 16..128, a TMA halo where x is 16-byte aligned and C * esize a
# multiple of 16) makes risky: every nano path shape at B = 1; a ragged tile
# (13 x 9) and an image smaller than a tile (5 x 7); K != C (64 -> 32,
# 16 -> 40); K = 130 (an odd slice tail); C = 12 and 3 (no TMA; 8-byte and
# scalar copies); C = 256; 14 x 14 x 128 at B = 3 (two slices or short
# tiles). offset: x starts that many elements into a flat buffer (1: a bf16
# x only 2-byte aligned, which takes scalar copies; 8: 16-byte aligned bf16
# at an offset, still TMA). views: dw and pw as the model's permuted OIHW
# views, not contiguous HWIO tensors.
NANO_DW_PATH = [(1, 112, 112, 16, 16), (1, 56, 56, 32, 32), (1, 56, 56, 64, 64),
                (1, 28, 28, 64, 64), (1, 14, 14, 64, 64), (1, 14, 14, 128, 128)]
GPU_DW = [(shape, 0, False) for shape in DW_SHAPES + NANO_DW_PATH] + [
    ((3, 14, 14, 128, 128), 0, False), ((2, 5, 7, 16, 16), 0, False),
    ((2, 20, 20, 16, 40), 0, False), ((1, 10, 10, 32, 130), 0, False),
    ((2, 12, 12, 12, 16), 0, False), ((2, 9, 11, 3, 8), 0, False),
    ((1, 14, 14, 256, 256), 0, False), ((2, 13, 9, 64, 32), 1, False),
    ((2, 13, 9, 64, 32), 8, False), ((1, 28, 28, 64, 64), 0, True),
    ((2, 13, 9, 64, 32), 0, True),
]
# (shape, offset): the shapes the dense 3x3 tiling (16 pixels wide; K slices
# of 16/32/64, channel chunks) makes risky: ragged tiles, B = 1, an image
# smaller than a tile, C = 3 and 12 (no 16-byte pixel), C = 48 at K = 16
# (two channel chunks in a 32-row tile), K = 130 (three slices, an odd
# tail), one yolox-s width per level (64 at 56², 128 at 28², 256 at 14²).
# bf16 at C = 4 or 12, K <= 16 and W * C * 2 a multiple of 16 takes the
# TMA box of packed rows (28², 9 x 10 x 4, and 8² at an offset that keeps
# 16-byte alignment); at odd W, or K > 16 (20² x 130, 30 x 36 x 32), the
# pixel copies.
# offset: x is the batch slice x_big[1:] of a contiguous buffer, so at an
# odd H*W*C a bf16 x is only 2-byte aligned.
RISKY_CONV = [
    ((2, 33, 17, 12, 16), False), ((1, 10, 10, 40, 130), False),
    ((1, 28, 28, 12, 16), False), ((2, 5, 7, 12, 16), False), ((2, 12, 12, 3, 16), False),
    ((1, 12, 12, 48, 16), False), ((1, 20, 20, 12, 130), False),
    ((2, 30, 36, 12, 32), False), ((2, 9, 10, 4, 16), False), ((2, 8, 8, 12, 16), True),
    ((1, 20, 20, 16, 130), False), ((2, 5, 7, 3, 16), True), ((2, 9, 7, 5, 40), True),
    ((1, 56, 56, 64, 64), False), ((1, 28, 28, 128, 128), False),
    ((1, 14, 14, 256, 256), False),
]
GPU_CONV = [(shape, False) for shape in CONV_SHAPES] + RISKY_CONV


def _gpu_conv_operands(shape, seed, dtype, offset, device):
    """x (in ``dtype``; with ``offset``, a batch slice one image into a
    contiguous buffer) and the float32 arguments."""
    B, H, W, C, K = shape
    x, *args = [torch.from_numpy(a).to(device) for a in _conv_inputs(shape, seed)]
    x = x.to(dtype)
    if offset:
        x_big = torch.zeros((B + 1, H, W, C), dtype=dtype, device=device)
        x_big[1:] = x
        x = x_big[1:]
        assert x.is_contiguous() and x.storage_offset() == H * W * C
    return x, args


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, offset, views", GPU_DW)
def test_dwblock_kernel_matches_plain(cuda, shape, offset, views, dtype):
    """The kernel against the plain version on the caller's float32
    weights (contiguous HWIO), whatever layout the kernel was handed."""
    args = [torch.from_numpy(a).to(cuda) for a in _dw_inputs(shape, 4)]
    x = args[0].to(dtype)
    if offset:
        flat = torch.zeros(x.numel() + offset, dtype=dtype, device=cuda)
        flat[offset:] = x.flatten()
        x = flat[offset:].view(x.shape)
        assert x.is_contiguous() and x.data_ptr() % 16 == (offset * x.element_size()) % 16
    kernel_args = _oihw_views(args)[1:] if views else args[1:]
    launches = tconv.dwblock_bn_silu.launches
    got = tconv.dwblock_bn_silu(x, *kernel_args)
    torch.cuda.synchronize()
    assert tconv.dwblock_bn_silu.launches == launches + 1
    want = tconv.dwblock_bn_silu_reference(x.float(), *args[1:])
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, offset", GPU_CONV)
def test_conv3x3_kernel_matches_plain(cuda, shape, offset, dtype):
    x, args = _gpu_conv_operands(shape, 5, dtype, offset, cuda)
    launches = tconv.conv3x3_bn_silu.launches
    got = tconv.conv3x3_bn_silu(x, *args)
    torch.cuda.synchronize()
    assert tconv.conv3x3_bn_silu.launches == launches + 1
    want = tconv.conv3x3_bn_silu_reference(x.float(), *args)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


# The smoke script's default (B=8, 56x56, 16 -> 32), the nano stem, and the
# shapes the tiling makes risky.
GPU_PLAIN_CONV = [((8, 56, 56, 16, 32), False), ((2, 224, 224, 12, 16), False)] + RISKY_CONV


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, offset", GPU_PLAIN_CONV)
def test_plain_conv3x3_kernel_matches_plain(cuda, shape, offset, dtype):
    x, (w, *_) = _gpu_conv_operands(shape, 6, dtype, offset, cuda)
    launches = tconv.conv3x3.launches
    got = tconv.conv3x3(x, w)
    torch.cuda.synchronize()
    assert tconv.conv3x3.launches == launches + 1
    want = tconv.conv3x3_reference(x.float(), w)
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
