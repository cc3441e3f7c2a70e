"""The port's causal attention (jolineedle_tpu_torch/ops/attention.py) against
the JAX package's Pallas ``flash_attention`` and its jnp reference, its
hand-written backward against autograd, and the CUDA kernel against its
plain version.

On the CPU the JAX side runs the Pallas kernel in interpret mode, as
tests/test_ops.py does. JAX is imported inside the tests that use it, so that
the CUDA tests of this file also run on a machine that has a GPU and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_attention.py
"""

import numpy as np
import pytest
import torch

from jolineedle_tpu_torch.ops import attention as tattn
from jolineedle_tpu_torch.ops.kernels import CSRC, SIGNATURES

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


# (block_q, block_k, shape): the Pallas kernel's tilings at D = 64 (ids as
# before), then D = 128, the head dim of the JAX package's attention sweep
# (scripts/bench_attention.py), at one and two 128-row blocks.
PALLAS_CASES = [pytest.param(bq, bk, (1, 2, 128, 64), id=f"{bq}-{bk}")
                for bq, bk in [(128, 128), (128, 64), (64, 128)]] + [
    pytest.param(128, 128, (1, 2, 128, 128), id="128-128-D128"),
    pytest.param(128, 128, (2, 2, 256, 128), id="128-128-T256-D128"),
]


@pytest.mark.parametrize("block_q, block_k, shape", PALLAS_CASES)
def test_plain_matches_pallas_flash(block_q, block_k, shape):
    import jax.numpy as jnp

    from jolineedle_tpu.ops.attention import flash_attention as jax_flash

    q, k, v = _qkv(shape, 0)
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                block_q=block_q, block_k=block_k, interpret=True))
    got = tattn.flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the wrapper takes the plain version on the CPU, counting no launch
    calls, launches = tattn.flash_attention.calls, tattn.flash_attention.launches
    got = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert (tattn.flash_attention.calls, tattn.flash_attention.launches) == (calls + 1, launches)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("T, D, atol", [pytest.param(T, 16, 1e-6, id=str(T)) for T in (21, 37)]
                         + [pytest.param(T, 128, 1e-5, id=f"{T}-D128") for T in (21, 37)])
def test_plain_at_ragged_T_matches_jax_reference(T, D, atol):
    """T that no block divides: the Pallas kernel refuses it, the jnp
    reference (what the JAX decoder runs) takes it. At D = 128 the scores are
    128-term float32 sums, summed in another order by the two einsums (1.3e-6
    seen): held at 1e-5, the D = 128 limit against the Pallas kernel."""
    import jax.numpy as jnp

    from jolineedle_tpu.ops.attention import causal_attention_reference as jax_ref

    q, k, v = _qkv((2, 3, T, D), T)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, k, v))))
    got = tattn.flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    o, lse = tattn.flash_attention_forward_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(o.numpy(), want, atol=atol, rtol=0)
    assert lse.shape == (2, 3, T) and lse.dtype == torch.float32
    assert D in tattn.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("shape", [(2, 3, 21, 16), (1, 2, 70, 64)])
def test_backward_matches_autograd_of_plain(shape):
    """The autograd.Function (on the CPU: the float32 plain forward and the
    hand-written backward) against autograd through the plain version."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(shape, 1))
    do = torch.from_numpy(_qkv(shape, 2)[0])
    out = tattn.FlashAttention.apply(q, k, v)
    backward_calls = tattn.flash_attention.backward_calls
    got = torch.autograd.grad(out, (q, k, v), do)
    assert tattn.flash_attention.backward_calls == backward_calls + 1
    want_out = tattn.flash_attention_reference(q, k, v)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    torch.testing.assert_close(out, want_out, atol=1e-6, rtol=1e-5)
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5, msg=f"d{name}")


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """A CUDA tensor launches or raises, never computing the plain version:
    here fake CUDA tensors (``FakeTensorMode``: shapes and a device, no
    memory) reach the launch, whose ``kernel`` is a stub that raises, or
    fail earlier on a build without CUDA; an unsupported head dim is refused
    before that. Only CPU and meta tensors take the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_kernel(name):
        raise RuntimeError(f"kernel stub: {name} would launch")

    monkeypatch.setattr(tattn, "kernel", no_kernel)
    tattn.reset_counts()
    with FakeTensorMode():
        q = torch.empty((1, 1, 8, 16), device="cuda")
        with pytest.raises(RuntimeError):
            tattn.flash_attention(q, q, q)
        with pytest.raises(RuntimeError):
            tattn.causal_attention(q, q, q)
        q = torch.empty((1, 1, 8, 24), device="cuda")
        with pytest.raises(ValueError, match="head dim 24"):
            tattn.flash_attention(q, q, q)
    assert tattn.flash_attention.launches == 0


@pytest.mark.parametrize("T", [1, 21, 33])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_plain_bf16_forward_matches_jax_reference(D, T):
    """The kernel's plain version in bfloat16 (probabilities rounded to bf16
    before the PV product) against the JAX oracle in bfloat16 on the same
    bf16 inputs. Tolerance 2e-2 absolute and relative: JAX also rounds the
    scores, their scaling and each einsum's output to bf16 (the port keeps
    the scores in float32), so single outputs differ by a bf16 ulp (2^-8 to
    2^-7 relative; 0.0156 at |o| in [2, 4) on these inputs)."""
    import jax.numpy as jnp

    from jolineedle_tpu.ops.attention import causal_attention_reference as jax_ref

    q, k, v = _qkv((2, 3, T, D), 10 + D + T)
    want = np.asarray(jax_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))),
                      dtype=np.float32)
    o, lse = tattn.flash_attention_forward_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("T", [1, 21, 70])
def test_plain_lse_matches_numpy_logsumexp(T):
    """The plain version's log-sum-exp (what the backward reads) against numpy's
    of the scaled, masked scores in float64, at 1e-5 (float32 sums)."""
    q, k, v = _qkv((2, 2, T, 32), 20 + T)
    _, lse = tattn.flash_attention_forward_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(32)
    s = np.where(np.tril(np.ones((T, T), bool)), s, -1e30)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)


def plan_tiles(plan, bh, t):
    """Per block, in launch order, the (head, first q row) of each warp that
    works, as csrc/flash_attention.cu maps ``blockIdx`` and its warp index
    onto them (a copy of the kernel's index math; keep the two alike)."""
    blocks = []
    for i in range(plan.grid):
        warps = []
        for w in range(tattn.WARPS):
            if plan.short:
                slot = w // plan.warps_per_head
                head = i * plan.heads_per_block + slot
                if slot < plan.heads_per_block and head < bh:
                    warps.append((head, (w % plan.warps_per_head) * tattn.WARP_ROWS))
            else:
                q_tiles = -(-t // tattn.Q_TILE)
                q0 = (q_tiles - 1 - i // bh) * tattn.Q_TILE + w * tattn.WARP_ROWS
                if q0 < t:
                    warps.append((i % bh, q0))
        blocks.append(warps)
    return blocks


@pytest.mark.parametrize("bh", [1, 3, 5, 48, 512])
@pytest.mark.parametrize("T", [1, 16, 17, 21, 64, 65, 200])
def test_launch_plan_covers_every_tile_once(T, bh):
    """The host's plan gives every (head, 16-row q tile) to exactly one warp;
    short T packs heads into 4-warp blocks, long T lists its q tiles longest
    (latest) first."""
    plan = tattn.launch_plan(bh, T)
    blocks = plan_tiles(plan, bh, T)
    assert len(blocks) == plan.grid
    work = [tile for warps in blocks for tile in warps]
    want = [(h, q0) for h in range(bh) for q0 in range(0, T, 16)]
    assert sorted(work) == want and len(work) == len(set(work))
    assert all(warps for warps in blocks)  # no block without work
    if T <= tattn.SHORT_T:
        assert plan.short and plan.heads_per_block * plan.warps_per_head <= tattn.WARPS
        for warps in blocks:  # a block's warps cover whole heads
            heads = {h for h, _ in warps}
            assert all(sum(1 for h, _ in warps if h == x) == -(-T // 16) for x in heads)
    else:
        assert not plan.short and plan.heads_per_block == 0
        first_rows = [min(q0 for _, q0 in warps) for warps in blocks]
        assert first_rows == sorted(first_rows, reverse=True)
        assert first_rows[0] == (T - 1) // 64 * 64


def _model_views(B, T, H, D, offset=0, dtype=torch.float32):
    """q, k, v as ``CausalSelfAttention`` hands them over: the split of one
    [B, T, 3C] c_attn output, reshaped and transposed to [B, H, T, D]."""
    C = H * D
    flat = torch.arange(offset + B * T * 3 * C, dtype=torch.float32).to(dtype)
    x = flat[offset:].view(B, T, 3 * C)
    return [t.reshape(B, T, H, D).transpose(1, 2) for t in x.split(C, dim=-1)], flat


@pytest.mark.parametrize("offset", [0, 1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_args_read_the_model_views_through_strides(dtype, offset):
    """The wrapper's arguments for the model's c_attn views: the strides it
    passes address element (b, h, t, d) of each view, the copy width divides
    every address and stride, and o is a [B, H, T, D] view whose caller-side
    ``transpose(1, 2).reshape(B, T, C)`` makes no copy."""
    B, T, H, D = 2, 21, 3, 16
    (q, k, v), flat = _model_views(B, T, H, D, offset, dtype)
    o, lse, args = tattn.flash_attention_args(q, k, v)
    ptrs, (b_, h_, t_, d_), strides = args[:5], args[5:9], args[9:21]
    vec, hpb, grid, is_bf16, scale = args[21:]
    assert (b_, h_, t_, d_) == (B, H, T, D)
    assert ptrs == (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    esize, base = flat.element_size(), flat.data_ptr()
    for i, (name, t) in enumerate((("q", q), ("k", k), ("v", v))):
        sb, sh, st = strides[3 * i:3 * i + 3]
        for b, h, tt, d in [(0, 0, 0, 0), (1, 2, 20, 15), (1, 0, 7, 3), (0, 1, 13, 9)]:
            index = (ptrs[i] - base) // esize + b * sb + h * sh + tt * st + d
            assert flat[index].item() == t[b, h, tt, d].item(), (name, b, h, tt, d)
    # every stride is a multiple of 16 bytes: the views' addresses decide
    assert vec == (16 if offset % 8 == 0 else esize)
    assert all(p % vec == 0 for p in ptrs[:3])
    assert all(s * esize % vec == 0 for s in strides[:9])
    plan = tattn.launch_plan(B * H, T)
    assert (hpb, grid) == (plan.heads_per_block, plan.grid)
    assert is_bf16 == int(dtype == torch.bfloat16) and scale == pytest.approx(D ** -0.5)
    assert o.shape == (B, H, T, D) and o.dtype == dtype and o.stride(-1) == 1
    assert tuple(strides[9:]) == o.stride()[:3]
    y = o.transpose(1, 2).reshape(B, T, H * D)
    assert y.data_ptr() == o.data_ptr() and y._base is not None and y.is_contiguous()
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32 and lse.is_contiguous()
    assert len(args) + 1 == len(SIGNATURES["flash_attention"])  # + the stream


@pytest.mark.parametrize("variant", ["empty", "loads_only", "qk_only", "no_pv", "lb5"])
def test_flash_ablation_edits_match_the_source(variant):
    """Each source edit of the flash ablation's variants finds its text in
    csrc/flash_attention.cu exactly once (a stale edit would only fail on the
    card)."""
    from jolineedle_tpu_torch.scripts.flash_ablation import VARIANTS

    src = (CSRC / "flash_attention.cu").read_text()
    assert VARIANTS[variant]
    for old, _ in VARIANTS[variant]:
        assert src.count(old) == 1, (variant, old)


def test_launch_refuses_strided_head_dim():
    """A head dim that is not contiguous is refused, never copied (checked
    before any pointer is passed, so a fake CUDA tensor of
    ``FakeTensorMode`` shows it); on the CPU the plain version takes any
    strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty_strided((1, 1, 8, 16), (256, 256, 32, 2), device="cuda")
        with pytest.raises(ValueError, match="head dim has stride 2"):
            tattn.flash_attention(q, q, q)
    q = torch.zeros((1, 1, 8, 32))[..., ::2]
    assert tattn.flash_attention(q, q, q).shape == (1, 1, 8, 16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# f32: sums in another order than the plain version (3xTF32 products); bf16:
# the kernel rounds its probabilities and its output (and the backward its
# gradients) to bf16, against a float32 plain version.
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}
# lse is float32 in both dtypes, from products that are exact in float32 (bf16
# inputs) or 3xTF32: held at the float32 limit, not at the bf16 output's.
LSE_TOL = (1e-4, 1e-4)
# The decoder's shape (B=16, gpt-nano's 3 heads, T = 21, head dim 16), a
# ragged multi-tile one, one of each head dim, the needle-scale long-T shape,
# and T on both sides of each tile edge (16-row warps, the 64-row short/long
# boundary) for each head dim; at D = 128 also the attention sweep's smallest
# and needle-scale rows (scripts/bench_attention.py), the decoder's T at that
# D and a ragged long T (one block per SM in float32).
GPU_SHAPES = [(16, 3, 21, 16), (2, 4, 200, 64), (1, 2, 64, 32), (3, 1, 1, 16), (1, 1, 129, 64),
              (128, 4, 128, 64)] + [(2, 3, T, D) for D in (16, 32, 64, 128)
                                    for T in (16, 17, 33, 64, 65)] + [
    (2, 2, 256, 128), (128, 4, 128, 128), (16, 3, 21, 128), (1, 2, 200, 128)]


def _check_kernel(qd, kd, vd, do, dtype):
    """Output, lse and gradients of the kernel on qd, kd, vd against the
    plain versions: the output and lse against the kernel's plain forward on
    the same inputs, the gradients against autograd of the float32 plain
    version."""
    launches = tattn.flash_attention.launches
    got = tattn.flash_attention(qd, kd, vd)
    got_grads = torch.autograd.grad(got, (qd, kd, vd), do.to(dtype))
    _, lse = tattn.flash_attention_launch(qd.detach(), kd.detach(), vd.detach())
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == launches + 2
    atol, rtol = TOLS[dtype]
    want_o, want_lse = tattn.flash_attention_forward_reference(qd.detach(), kd.detach(), vd.detach())
    torch.testing.assert_close(got.float(), want_o.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=LSE_TOL[0], rtol=LSE_TOL[1])
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (qd, kd, vd))
    want = tattn.flash_attention_reference(qf, kf, vf)
    want_grads = torch.autograd.grad(want, (qf, kf, vf), do.to(dtype).float())
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    for name, g, w in zip("qkv", got_grads, want_grads):
        torch.testing.assert_close(g.float(), w, atol=atol, rtol=rtol, msg=f"d{name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(shape, 4))
    do = torch.from_numpy(_qkv(shape, 5)[0]).to(cuda)
    _check_kernel(*(t.to(dtype).requires_grad_() for t in (q, k, v)), do, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, H, D, offset", [
    (16, 21, 3, 16, 0),   # gpt-nano's teacher-forced forward: 16-byte copies
    (16, 21, 3, 16, 1),   # 2-byte aligned (bf16 scalar copies, float32 4-byte)
    (2, 70, 4, 32, 2),    # long T, 4-byte aligned in bf16
    (2, 33, 2, 64, 4),    # 8-byte aligned in bf16
    (2, 21, 2, 128, 0),   # D = 128, short T: 16-byte copies
    (2, 70, 2, 128, 2),   # D = 128, long T, 4-byte aligned in bf16
])
def test_kernel_reads_model_views(cuda, B, T, H, D, offset, dtype):
    """q, k, v as strided views of one [B, T, 3C] c_attn output (at a storage
    offset that breaks 16-byte alignment), as the model passes them: no copy
    in, o a view of [B, T, H, D] storage out, and the same results."""
    C = H * D
    rng = np.random.default_rng(6)
    flat = torch.from_numpy(rng.normal(size=offset + B * T * 3 * C).astype(np.float32))
    base = flat.to(cuda).to(dtype).requires_grad_()
    x = base[offset:].view(B, T, 3 * C)
    q, k, v = (t.reshape(B, T, H, D).transpose(1, 2) for t in x.split(C, dim=-1))
    o = tattn.flash_attention(q, k, v)
    assert o.transpose(1, 2).is_contiguous()
    do = torch.from_numpy(rng.normal(size=(B, H, T, D)).astype(np.float32)).to(cuda)
    _check_kernel(q, k, v, do, dtype)
