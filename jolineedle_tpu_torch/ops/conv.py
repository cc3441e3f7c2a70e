"""The YOLOX embedder's fused eval-mode conv blocks: Hopper kernels and their
plain PyTorch versions.

Three wrappers, each the counterpart of a Pallas TPU kernel of the JAX
package and with its public layout (NHWC activations, HWIO weights, BN
vectors):

- ``dwblock_bn_silu`` replaces ``jolineedle_tpu/ops/conv.py:125``
  ``dwblock_bn_silu`` (kernel ``csrc/dwblock_bn_silu.cu``);
- ``conv3x3_bn_silu`` replaces ``jolineedle_tpu/ops/conv.py:68``
  ``conv3x3_bn_silu`` (kernel ``csrc/conv3x3_bn_silu.cu``);
- ``conv3x3`` replaces ``scripts/smoke_pallas_conv.py:67`` ``pallas_conv3x3``
  (kernel ``csrc/conv3x3.cu``, the same tiled body with no epilogue).

On a CPU tensor (or a meta tensor, which carries shapes only) a wrapper
computes its plain version (``*_reference``, the same arithmetic in PyTorch
ops); on a CUDA tensor it launches its kernel or raises — there is no
fallback. BatchNorm is folded to a per-channel scale
and bias in float32, as ``_fold_bn`` does in the JAX package: here for the
dense 3x3 kernels, inside the kernel for ``dwblock_bn_silu``. ``x`` and
the output are float32 or bfloat16; the kernels accumulate in float32. The
dense 3x3 kernels take their filter in x's dtype (:func:`conv3x3_filter`).

Each wrapper counts, as plain integers on the function object, ``calls``
(every call) and ``launches`` (kernel launches only).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels import PLAIN_DEVICES, kernel

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: The widest C and K that ``dwblock_bn_silu``'s kernel takes.
DWBLOCK_MAX_CHANNELS = 256


def fold_bn(gamma, beta, mean, var, eps):
    """BatchNorm(eval) as y = x * scale + bias (per channel), in float32."""
    scale = gamma.float() / torch.sqrt(var.float() + eps)
    return scale, beta.float() - mean.float() * scale


def _taps(x):
    """The nine 3x3 SAME taps of NHWC ``x`` (zero border), tap-major."""
    H, W = x.shape[1:3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, dy : dy + H, dx : dx + W, :] for dy in range(3) for dx in range(3)]


def dwblock_bn_silu_reference(
    x, dw, gamma1, beta1, mean1, var1, pw, gamma2, beta2, mean2, var2, eps=1e-3
):
    """Plain version of :func:`dwblock_bn_silu`: the kernel's arithmetic in
    float32 PyTorch ops (nine shifted taps, then a matmul)."""
    C, K = x.shape[-1], pw.shape[-1]
    s1, b1 = fold_bn(gamma1, beta1, mean1, var1, eps)
    s2, b2 = fold_bn(gamma2, beta2, mean2, var2, eps)
    dwf = dw.float().reshape(9, C)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i, tap in enumerate(_taps(x.float())):
        acc = acc + tap * dwf[i]
    mid = F.silu(acc * s1 + b1)
    out = F.silu((mid @ pw.float().reshape(C, K)) * s2 + b2)
    return out.to(x.dtype)


def _conv3x3_f32(x, w):
    """im2col over the nine taps and one ``[HW, 9C] @ [9C, K]`` matmul, in
    float32."""
    C, K = x.shape[-1], w.shape[-1]
    return torch.cat(_taps(x.float()), dim=-1) @ w.float().reshape(9 * C, K)


def conv3x3_bn_silu_reference(x, w, gamma, beta, mean, var, eps=1e-3):
    """Plain version of :func:`conv3x3_bn_silu`: the float32 conv, BN and
    SiLU."""
    scale, bias = fold_bn(gamma, beta, mean, var, eps)
    return F.silu(_conv3x3_f32(x, w) * scale + bias).to(x.dtype)


def conv3x3_reference(x, w):
    """Plain version of :func:`conv3x3`: the float32 conv, output in x's
    dtype."""
    return _conv3x3_f32(x, w).to(x.dtype)


def _check_launch(name, x, tensors, shapes):
    """Refuse what the kernel does not take, before a pointer is passed."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x lies on {x.device}; the kernel runs on CUDA")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: x is {x.dtype}; the kernel takes float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous NHWC tensor")
    for label, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {label} lies on {t.device}, x on {x.device}")
        if tuple(t.shape) != shapes[label]:
            raise ValueError(
                f"{name}: {label} has shape {tuple(t.shape)}, expected {shapes[label]}"
            )
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *tensors.values())
    ):
        raise NotImplementedError(f"{name}: the kernel has no backward (eval only)")


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def dwblock_bn_silu(
    x, dw, gamma1, beta1, mean1, var1, pw, gamma2, beta2, mean2, var2, eps=1e-3
):
    """The nano DWConv block fused: depthwise 3x3 (stride 1, SAME) + eval
    BN + SiLU, then pointwise 1x1 + eval BN + SiLU.

    x: [B, H, W, C]; dw: [3, 3, 1, C]; pw: [1, 1, C, K]; BN vectors [C]
    and [K]. Returns [B, H, W, K] in x's dtype.

    Replaces ``jolineedle_tpu/ops/conv.py:125`` (Pallas, one image per
    program in VMEM). On the H100 the block is bound by bytes: at the nano
    widths (C = K = 16..128) it does 2*(9+K) flops per input value. The
    kernel (``csrc/dwblock_bn_silu.cu``) reads x once and writes the output
    once: persistent blocks walk tiles of up to 8 x 16 pixels, each tile's
    halo arriving by TMA (zeros outside the image: the SAME border) while
    the previous tile computes; the depthwise, BN1 and SiLU run in float32
    registers into a ``mid`` tile in shared memory, which the tensor cores
    multiply by ``pw`` (bf16 products with float32 sums in bf16, 3xTF32 in
    float32) before BN2 and SiLU — ``mid`` never reaches HBM, which is the
    point of the fusion on both machines.

    A CUDA call is one device operation: the kernel folds BN itself and
    reads the float32 ``dw`` and ``pw`` through their strides, so the
    model's permuted OIHW weight views pass with no copy. It takes C and K
    up to 256, any B, H, W >= 1 and a contiguous x at any storage offset.
    """
    dwblock_bn_silu.calls += 1
    if x.device.type in PLAIN_DEVICES:
        return dwblock_bn_silu_reference(
            x, dw, gamma1, beta1, mean1, var1, pw, gamma2, beta2, mean2, var2, eps
        )
    C, K = x.shape[-1], pw.shape[-1]
    _check_launch(
        "dwblock_bn_silu",
        x,
        dict(dw=dw, gamma1=gamma1, beta1=beta1, mean1=mean1, var1=var1, pw=pw,
             gamma2=gamma2, beta2=beta2, mean2=mean2, var2=var2),
        dict(dw=(3, 3, 1, C), gamma1=(C,), beta1=(C,), mean1=(C,), var1=(C,),
             pw=(1, 1, C, K), gamma2=(K,), beta2=(K,), mean2=(K,), var2=(K,)),
    )
    if C > DWBLOCK_MAX_CHANNELS or K > DWBLOCK_MAX_CHANNELS:
        raise ValueError(
            f"dwblock_bn_silu: C={C}, K={K}; the kernel takes at most"
            f" {DWBLOCK_MAX_CHANNELS} channels in and out"
        )
    if min(x.shape[1:3]) < 1:
        raise ValueError(f"dwblock_bn_silu: x has shape {tuple(x.shape)}; H and W must be >= 1")
    for label, t in (("dw", dw), ("gamma1", gamma1), ("beta1", beta1), ("mean1", mean1),
                     ("var1", var1), ("pw", pw), ("gamma2", gamma2), ("beta2", beta2),
                     ("mean2", mean2), ("var2", var2)):
        if t.dtype != torch.float32:
            raise TypeError(f"dwblock_bn_silu: {label} is {t.dtype}; the kernel takes float32")
        if t.dim() == 1 and t.stride(0) != 1:
            raise ValueError(f"dwblock_bn_silu: {label} must be contiguous")
    return dwblock_bn_silu_launch(
        x, dw, gamma1, beta1, mean1, var1, pw, gamma2, beta2, mean2, var2, eps
    )


def dwblock_bn_silu_launch(
    x, dw, gamma1, beta1, mean1, var1, pw, gamma2, beta2, mean2, var2, eps=1e-3
):
    """The dwblock kernel alone, on the arguments that
    :func:`dwblock_bn_silu` has checked: one launch, no other device
    operation but the output's allocation."""
    B, H, W, C = x.shape
    K = pw.shape[-1]
    out = torch.empty((B, H, W, K), dtype=x.dtype, device=x.device)
    err = kernel("dwblock_bn_silu")(
        x.data_ptr(), dw.data_ptr(), gamma1.data_ptr(), beta1.data_ptr(),
        mean1.data_ptr(), var1.data_ptr(), pw.data_ptr(), gamma2.data_ptr(),
        beta2.data_ptr(), mean2.data_ptr(), var2.data_ptr(), out.data_ptr(),
        B, H, W, C, K, dw.stride(0), dw.stride(1), dw.stride(3), pw.stride(2),
        pw.stride(3), int(x.dtype == torch.bfloat16), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on("dwblock_bn_silu", err)
    dwblock_bn_silu.launches += 1
    return out


def conv3x3_bn_silu(x, w, gamma, beta, mean, var, eps=1e-3):
    """Dense 3x3 stride-1 SAME conv + eval BN + SiLU.

    x: [B, H, W, C]; w: [3, 3, C, K] (HWIO). Returns [B, H, W, K] in x's
    dtype.

    Replaces ``jolineedle_tpu/ops/conv.py:68`` (Pallas im2col of a whole
    image in VMEM, which could not hold the Focus stem's 224x224x12 input).
    On the H100 this is an implicit GEMM on the tensor cores with M =
    pixels, N = K and depth 9C (``csrc/conv3x3_tile.cuh``): bf16 products
    with float32 sums in bf16, 3xTF32 in float32. At the stem (C=12, K=16)
    it is bound by bytes in bf16. Persistent blocks walk tiles 16 pixels
    wide (32 rows at the stem, else 8); each loads the next tiles' halo
    while this tile's MMAs run (at the stem as one TMA box of contiguous
    rows, elsewhere with cp.async pixel by pixel), masks the SAME border and
    pads C and K with zeros in shared memory (no padded copy, no im2col in
    HBM), and applies BN and SiLU to the float32 sums in registers.

    The kernel takes the filter in x's dtype (:func:`conv3x3_filter`): a
    bf16 conv multiplies a bf16-rounded filter, as flax's
    ``nn.Conv(dtype=bfloat16)`` does.
    """
    conv3x3_bn_silu.calls += 1
    if x.device.type in PLAIN_DEVICES:
        return conv3x3_bn_silu_reference(x, w, gamma, beta, mean, var, eps)
    C, K = x.shape[-1], w.shape[-1]
    _check_launch(
        "conv3x3_bn_silu",
        x,
        dict(w=w, gamma=gamma, beta=beta, mean=mean, var=var),
        dict(w=(3, 3, C, K), gamma=(K,), beta=(K,), mean=(K,), var=(K,)),
    )
    operands = conv3x3_bn_silu_operands(x, w, gamma, beta, mean, var, eps)
    return conv3x3_bn_silu_launch(x, operands)


def conv3x3_filter(w, dtype):
    """The filter as the conv kernels take it: HWIO ``w`` as a contiguous
    ``[9C, K]`` tensor in ``dtype`` (x's)."""
    C, K = w.shape[2:]
    wf = torch.empty(w.shape, dtype=dtype, device=w.device)
    return wf.copy_(w).view(9 * C, K)  # one cast-and-copy


def conv3x3_bn_silu_operands(x, w, gamma, beta, mean, var, eps=1e-3):
    """The kernel's operands of :func:`conv3x3_bn_silu`: the filter in x's
    dtype (:func:`conv3x3_filter`) and BN folded to float32 scale and
    bias."""
    return (conv3x3_filter(w, x.dtype), *fold_bn(gamma, beta, mean, var, eps))


def conv3x3_bn_silu_launch(x, operands):
    """The conv3x3_bn_silu kernel alone, on a checked CUDA ``x`` and the
    ``operands`` (w [9C, K] in x's dtype, float32 scale and bias) that
    :func:`conv3x3_bn_silu_operands` prepares."""
    B, H, W, C = x.shape
    K = operands[0].shape[1]
    out = torch.empty((B, H, W, K), dtype=x.dtype, device=x.device)
    err = kernel("conv3x3_bn_silu")(
        x.data_ptr(), *(t.data_ptr() for t in operands), out.data_ptr(),
        B, H, W, C, K, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on("conv3x3_bn_silu", err)
    conv3x3_bn_silu.launches += 1
    return out


def conv3x3(x, w):
    """Dense 3x3 stride-1 SAME conv, no bias and no epilogue.

    x: [B, H, W, C]; w: [3, 3, C, K] (HWIO). Returns [B, H, W, K] in x's
    dtype, accumulated in float32.

    Replaces ``scripts/smoke_pallas_conv.py:67`` ``pallas_conv3x3`` (Pallas,
    one padded image per program, im2col in VMEM). The kernel is the
    tensor-core implicit GEMM of :func:`conv3x3_bn_silu`
    (``csrc/conv3x3_tile.cuh``) with the identity epilogue, on the filter
    in x's dtype: no padded copy and no im2col in HBM.
    """
    conv3x3.calls += 1
    if x.device.type in PLAIN_DEVICES:
        return conv3x3_reference(x, w)
    C, K = x.shape[-1], w.shape[-1]
    _check_launch("conv3x3", x, dict(w=w), dict(w=(3, 3, C, K)))
    return conv3x3_launch(x, conv3x3_filter(w, x.dtype))


def conv3x3_launch(x, wf):
    """The conv3x3 kernel alone, on a checked CUDA ``x`` and the filter
    ``wf`` [9C, K] in x's dtype that :func:`conv3x3_filter` prepares."""
    B, H, W, C = x.shape
    K = wf.shape[1]
    out = torch.empty((B, H, W, K), dtype=x.dtype, device=x.device)
    err = kernel("conv3x3")(
        x.data_ptr(), wf.data_ptr(), out.data_ptr(),
        B, H, W, C, K, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on("conv3x3", err)
    conv3x3.launches += 1
    return out


def reset_counts() -> None:
    """Set every wrapper's ``calls`` and ``launches`` to 0."""
    for fn in (dwblock_bn_silu, conv3x3_bn_silu, conv3x3):
        fn.calls = 0
        fn.launches = 0


reset_counts()
