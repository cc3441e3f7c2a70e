"""Causal self-attention over [B, H, T, D]: a Hopper kernel and its plain
PyTorch version.

The counterpart of ``jolineedle_tpu/ops/attention.py``:

- ``flash_attention_reference`` (alias ``causal_attention_reference``) is
  ``attention.py:36-48``, the jnp oracle: masks with -1e30, takes the softmax
  in float32 and casts the probabilities to q's dtype before the PV product;
- ``flash_attention`` replaces the Pallas ``flash_attention``
  (``attention.py:101``, kernel ``_flash_kernel``) with ``csrc/
  flash_attention.cu``: both products on the tensor cores, the online
  softmax in float32, and, in bfloat16, the probabilities rounded to q's
  dtype before the PV product (as the jnp oracle rounds them); the output is
  rounded once to q's dtype. ``flash_attention_forward_reference`` is its
  plain version, with the same rounding.

``causal_attention`` is what the teacher-forced decoder calls: on a CPU
tensor the plain version, on a CUDA tensor the kernel (or it raises: there is
no fallback). The JAX package sends this call to the jnp reference on the TPU
(``attention.py:138-158``); the port runs the kernel on the card. The KV-cache
decode (one query per step) does not come here.

The wrapper counts, as plain integers on the function object, ``calls``
(every call), ``launches`` (kernel launches) and ``backward_calls``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .kernels import PLAIN_DEVICES, kernel

NEG_INF = -1e30
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: The kernel's blocks: 4 warps of 16 query rows; T up to SHORT_T takes the
#: short regime (heads packed per block, whole K/V loaded once), longer T
#: one 64-row q tile per block.
WARPS, WARP_ROWS, SHORT_T, Q_TILE = 4, 16, 64, 64


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] causal attention; masks with -1e30 and takes the
    softmax in float32 (``attention.py:36-48``)."""
    d, t = q.shape[-1], q.shape[2]
    att = torch.einsum("bhqd,bhkd->bhqk", q, k) / torch.tensor(
        math.sqrt(d), dtype=q.dtype, device=q.device
    )
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    att = att.masked_fill(~causal, NEG_INF)
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


causal_attention_reference = flash_attention_reference


def flash_attention_forward_reference(q, k, v):
    """The kernel's two outputs in float32 PyTorch ops, with its rounding:
    the attention in q's dtype (the scale applied to the float32 scores; in
    bfloat16 the probabilities rounded to bfloat16 before the PV product)
    and the per-row natural-log log-sum-exp of the scaled scores,
    ``[B, H, T]`` float32."""
    d, t = q.shape[-1], q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(q.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype), lse


def flash_attention_backward(q, k, v, o, lse, do):
    """dq, dk, dv of causal attention from the saved forward (``o`` and the
    log-sum-exp ``lse``), the standard flash-attention gradient in float32
    PyTorch ops:

        P  = exp(S - lse)             S = Q K^T / sqrt(D), causal
        dV = P^T dO
        dS = P * (dO V^T - rowsum(dO * O))
        dQ = dS K / sqrt(D),   dK = dS^T Q / sqrt(D)

    Each gradient is returned in its input's dtype."""
    d, t = q.shape[-1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(s - lse[..., None]).masked_fill(~causal, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_launch(q, k, v):
    """Refuse what the kernel does not take, before a pointer is passed."""
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"flash_attention: q is {q.dtype}; the kernel takes float32 or bfloat16")
    if q.ndim != 4:
        raise ValueError(f"flash_attention: expected [B, H, T, D], got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention: {name} is {tuple(t.shape)} {t.dtype} on {t.device},"
                f" q is {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {q.shape[-1]}; the kernel takes {KERNEL_HEAD_DIMS}"
        )
    if q.numel() == 0:
        raise ValueError(f"flash_attention: empty input {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(
                f"flash_attention: {name}'s head dim has stride {t.stride(-1)}; the kernel"
                " reads D contiguous (no copy is made)"
            )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: q lies on {q.device}; the kernel runs on CUDA")


class FlashPlan(NamedTuple):
    """How the kernel covers ``bh`` heads of ``t`` rows: ``heads_per_block``
    heads of ``warps_per_head`` 16-row warps each in the short regime (0 at
    long T, where a block is one 64-row q tile of 4 warps), and ``grid``
    blocks."""

    short: bool
    heads_per_block: int
    warps_per_head: int
    grid: int


def launch_plan(bh: int, t: int) -> FlashPlan:
    """The launch of ``csrc/flash_attention.cu`` for ``bh`` = B * H heads of
    ``t`` rows. Short T (at most ``SHORT_T``): ceil(t / 16) warps per head,
    as many heads per 4-warp block as fit. Long T: one block per (head,
    64-row q tile), the longest q tiles (the last) first."""
    if t <= SHORT_T:
        wph = -(-t // WARP_ROWS)
        hpb = WARPS // wph
        return FlashPlan(True, hpb, wph, -(-bh // hpb))
    return FlashPlan(False, 0, WARPS, -(-t // Q_TILE) * bh)


def _vector_bytes(tensors, esize: int) -> int:
    """The widest copy (16, 8 or 4 bytes) that every tensor's address and its
    (b, h, t) strides in bytes allow (dims of size 1 aside); else one
    element."""
    for v in (16, 8, 4):
        if all(
            t.data_ptr() % v == 0
            and all(s * esize % v == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)
            for t in tensors
        ):
            return v
    return esize


def flash_attention_args(q, k, v):
    """The output tensors and the C entry point's arguments for checked
    [B, H, T, D] q, k, v (D contiguous, any (b, h, t) strides): o is a
    [B, H, T, D] view of [B, T, H, D] storage, so that the caller's
    ``transpose(1, 2).reshape(B, T, H * D)`` is free; lse is [B, H, T]
    float32. Returns (o, lse, args without the stream)."""
    B, H, T, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    plan = launch_plan(B * H, T)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, T, D, *strides, _vector_bytes((q, k, v), q.element_size()),
        plan.heads_per_block, plan.grid, int(q.dtype == torch.bfloat16), 1.0 / D**0.5,
    )
    return o, lse, args


def flash_attention_launch(q, k, v):
    """The kernel alone on checked CUDA tensors, read through their strides:
    one device operation. Returns (o [B, H, T, D] in q's dtype, a view of
    [B, T, H, D] storage; lse [B, H, T] float32)."""
    o, lse, args = flash_attention_args(q, k, v)
    err = kernel("flash_attention")(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return o, lse


class FlashAttention(torch.autograd.Function):
    """Causal attention whose forward is the flash kernel (or, for CPU
    tensors, its plain form ``flash_attention_forward_reference``)
    and whose backward is :func:`flash_attention_backward`, PyTorch ops on
    the saved q, k, v, o and log-sum-exp. The Pallas kernel has no backward
    either: the JAX package differentiates its jnp attention with XLA. The
    backward never calls the plain forward version."""

    @staticmethod
    def forward(ctx, q, k, v):
        if q.device.type in PLAIN_DEVICES:
            o, lse = flash_attention_forward_reference(q, k, v)
        else:
            o, lse = flash_attention_launch(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        flash_attention.backward_calls += 1
        return flash_attention_backward(*ctx.saved_tensors, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal softmax(QK^T / sqrt(D)) V over ``[B, H, T, D]``, any T, D in
    {16, 32, 64, 128}, float32 or bfloat16; differentiable.

    Replaces ``jolineedle_tpu/ops/attention.py:101`` (Pallas, K and V whole
    in VMEM, T a multiple of the block). On a CPU or meta tensor it computes
    :func:`flash_attention_reference`; on a CUDA tensor it launches
    ``csrc/flash_attention.cu`` through :class:`FlashAttention` or raises.
    The kernel reads q, k and v through their strides (D contiguous, else it
    raises) and returns a view of [B, T, H, D] storage: one device operation
    for the model's transposed ``c_attn`` views, in and out.
    """
    flash_attention.calls += 1
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_reference(q, k, v)
    _check_launch(q, k, v)
    return FlashAttention.apply(q, k, v)


causal_attention = flash_attention


def reset_counts() -> None:
    """Set the wrapper's ``calls``, ``launches`` and ``backward_calls`` to 0."""
    flash_attention.calls = 0
    flash_attention.launches = 0
    flash_attention.backward_calls = 0


reset_counts()
