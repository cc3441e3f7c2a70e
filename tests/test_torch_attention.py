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


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("block_q, block_k", [(128, 128), (128, 64), (64, 128)])
def test_plain_matches_pallas_flash(block_q, block_k):
    import jax.numpy as jnp

    from jolineedle_tpu.ops.attention import flash_attention as jax_flash

    q, k, v = _qkv((1, 2, 128, 64), 0)
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                block_q=block_q, block_k=block_k, interpret=True))
    got = tattn.flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the wrapper takes the plain version on the CPU, counting no launch
    calls, launches = tattn.flash_attention.calls, tattn.flash_attention.launches
    got = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert (tattn.flash_attention.calls, tattn.flash_attention.launches) == (calls + 1, launches)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("T", [21, 37])
def test_plain_at_ragged_T_matches_jax_reference(T):
    """T that no block divides: the Pallas kernel refuses it, the jnp
    reference (what the JAX decoder runs) takes it."""
    import jax.numpy as jnp

    from jolineedle_tpu.ops.attention import causal_attention_reference as jax_ref

    q, k, v = _qkv((2, 3, T, 16), T)
    want = np.asarray(jax_ref(*(jnp.asarray(a) for a in (q, k, v))))
    got = tattn.flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    o, lse = tattn.flash_attention_forward_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(o.numpy(), want, atol=1e-6, rtol=0)
    assert lse.shape == (2, 3, T) and lse.dtype == torch.float32


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


def test_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU launches or raises: a "meta" tensor is
    refused before any pointer is passed, and an unsupported head dim too."""
    q, k, v = (torch.from_numpy(a).to("meta") for a in _qkv((1, 1, 8, 16), 3))
    with pytest.raises(ValueError, match="runs on CUDA"):
        tattn.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="runs on CUDA"):
        tattn.causal_attention(q, k, v)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel is CUDA-only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# f32: sums in another order than the plain version; bf16: the kernel rounds
# its output (and the backward its gradients) to bf16, against a float32
# plain version.
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (3e-2, 2e-2)}
# The decoder's shape (B=16, gpt-nano's 3 heads, T = 21, head dim 16), a
# ragged multi-tile one, and one of each head dim.
GPU_SHAPES = [(16, 3, 21, 16), (2, 4, 200, 64), (1, 2, 64, 32), (3, 1, 1, 16), (1, 1, 129, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _qkv(shape, 4))
    do = torch.from_numpy(_qkv(shape, 5)[0]).to(cuda)
    qd, kd, vd = (t.to(dtype).requires_grad_() for t in (q, k, v))
    launches = tattn.flash_attention.launches
    got = tattn.flash_attention(qd, kd, vd)
    got_grads = torch.autograd.grad(got, (qd, kd, vd), do.to(dtype))
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == launches + 1
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (qd, kd, vd))
    want = tattn.flash_attention_reference(qf, kf, vf)
    want_grads = torch.autograd.grad(want, (qf, kf, vf), do.to(dtype).float())
    atol, rtol = TOLS[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    for name, g, w in zip("qkv", got_grads, want_grads):
        torch.testing.assert_close(g.float(), w, atol=atol, rtol=rtol, msg=f"d{name}")
