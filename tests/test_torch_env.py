"""The port's batched env (jolineedle_tpu_torch/env/batched_env.py) against
the JAX NeedleEnv: the same images, boxes, reset positions and action
sequences give the same positions, visited masks, rewards, termination and
patches, with STOP and frozen (masked) steps included; with the glimpse
pyramid (2 and 3 levels, float images) the levels' patches within
``PYRAMID_TOL``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu.env.batched_env import build_glimpse_pyramid as jax_pyramid
from jolineedle_tpu_torch.env.batched_env import NeedleEnv as TorchEnv
from jolineedle_tpu_torch.env.batched_env import build_glimpse_pyramid

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, NV, NH, B, T = 32, 2, 3, 3, 6
STOP = 8
# The pyramid's levels: the port's taps and jax.image.resize weight by the
# same float32 triangle and sum in another order (observed 6e-7 here, 3.6e-6
# at [2, 256, 320, 3] with P = 64).
PYRAMID_TOL = dict(atol=1e-5, rtol=0)


def _scene(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, NV * P, NH * P, 3), dtype=np.uint8)
    boxes = np.zeros((B, 3, 4), np.float32)  # the third row stays padding
    boxes[:, 0] = [5, 5, 40, 20]  # spans patches (0, 0) and (0, 1)
    boxes[:, 1] = [70, 40, 90, 60]  # patch (1, 2)
    boxes[2, 1] = 0  # one image with a single box
    return images, boxes


# Per step: actions [B] and frozen [B]; moves off the grid are clipped.
ACTIONS = np.array([
    [1, 3, 0],
    [3, 1, STOP],
    [1, 2, 7],
    [STOP, 7, 1],
    [0, STOP, 4],
    [5, 1, 2],
])
FROZEN = np.array([
    [0, 0, 0],
    [0, 0, 0],
    [0, 1, 0],
    [0, 0, 1],
    [1, 0, 0],
    [1, 1, 0],
], bool)


def _check(jout, tout, step, patch_tol=None):
    jstate, jpatches, jrew, jterm, jtrunc = jout
    tstate, tpatches, trew, tterm, ttrunc = tout
    msg = f"step {step}"
    np.testing.assert_array_equal(tstate.positions.numpy(), np.asarray(jstate.positions), msg)
    np.testing.assert_array_equal(tstate.visited.numpy(), np.asarray(jstate.visited), msg)
    np.testing.assert_array_equal(tstate.steps.numpy(), np.asarray(jstate.steps), msg)
    np.testing.assert_array_equal(tstate.has_stopped.numpy(), np.asarray(jstate.has_stopped), msg)
    np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm), msg)
    np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc), msg)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-6, rtol=0, err_msg=msg)
    if patch_tol is None:
        np.testing.assert_array_equal(tpatches.numpy(), np.asarray(jpatches), msg)
    else:
        assert tpatches.shape == np.asarray(jpatches).shape, msg
        np.testing.assert_allclose(tpatches.numpy(), np.asarray(jpatches), **patch_tol,
                                   err_msg=msg)


@pytest.mark.parametrize(
    "stop_enabled,terminate_on_all_found,stop_bonus_scale",
    [(True, True, 1.0), (True, True, 0.25), (False, True, 1.0), (False, False, 1.0)],
)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("copied", [False, True], ids=["built", "copied"])
def test_env_matches_jax(stop_enabled, terminate_on_all_found, stop_bonus_scale, masked, copied):
    """``copied``: the port's env is the ``static_copy`` of an env of
    another batch (other pixels, the boxes in another order) that this
    batch's env was copied into (``copy_data_``), as a graphed rollout runs
    (``train/graphs.py::RolloutGraph``)."""
    images, boxes = _scene(0)
    kw = dict(stop_enabled=stop_enabled, terminate_on_all_found=terminate_on_all_found,
              stop_bonus_scale=stop_bonus_scale)
    jenv = JaxEnv(jnp.asarray(images), jnp.asarray(boxes), P, T, 1, **kw)
    tenv = TorchEnv(images, boxes, P, T, 1, device="cpu", **kw)
    if copied:
        other = _scene(1)[0], boxes[::-1].copy()
        static = TorchEnv(*other, P, T, 1, device="cpu", **kw).static_copy()
        static.copy_data_(tenv)
        assert all(getattr(static, n).data_ptr() != getattr(tenv, n).data_ptr()
                   for n in TorchEnv.DATA)
        for got, want in zip(*(env.get_detection_batch(torch.Generator().manual_seed(0), 4)
                               for env in (static, tenv))):
            assert torch.equal(got, want)
        tenv = static
    np.testing.assert_array_equal(tenv.bbox_masks.numpy(), np.asarray(jenv.bbox_masks))

    start = np.array([[0, 0], [1, 2], [0, 2]], np.int32)
    jstate, jpatches, _ = jenv.reset(positions=jnp.asarray(start))
    tstate, tpatches, _ = tenv.reset(positions=torch.from_numpy(start))
    np.testing.assert_array_equal(tpatches.numpy(), np.asarray(jpatches))
    assert tpatches.shape == (B, 1, P, P, 3) and tpatches.dtype == torch.float32

    for t, (actions, frozen) in enumerate(zip(ACTIONS, FROZEN)):
        ja = jnp.asarray(actions, jnp.int32)
        ta = torch.from_numpy(actions)
        if masked:
            jout = jenv.masked_step(jstate, ja, jnp.asarray(frozen))
            tout = tenv.masked_step(tstate, ta, torch.from_numpy(frozen))
        else:
            jout = jenv.step(jstate, ja)
            tout = tenv.step(tstate, ta)
        _check(jout[:5], tout[:5], t)
        jstate, tstate = jout[0], tout[0]
        np.testing.assert_allclose(tenv.prop_patches_found(tstate).numpy(),
                                   np.asarray(jenv.prop_patches_found(jstate)), rtol=1e-6)
        np.testing.assert_array_equal(tenv.prop_bboxes_found(tstate).numpy(),
                                      np.asarray(jenv.prop_bboxes_found(jstate)))


def test_random_reset_and_pyramid():
    images, boxes = _scene(1)
    env = TorchEnv(images, boxes, P, T, device="cpu")
    state, _, _ = env.reset(generator=torch.Generator().manual_seed(0))
    assert (state.positions[:, 0] < NV).all() and (state.positions[:, 1] < NH).all()
    assert state.visited.flatten(1).sum(1).tolist() == [1] * B
    # a pyramid resizes floats: uint8 storage keeps one level, as JAX asserts
    with pytest.raises(ValueError, match="uint8 image storage requires n_glimps_levels == 1"):
        TorchEnv(images, boxes, P, T, n_glimps_levels=2, device="cpu")
    with pytest.raises(AssertionError, match="n_glimps_levels == 1"):
        JaxEnv(jnp.asarray(images), jnp.asarray(boxes), P, T, 2)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("levels", [2, 3])
def test_pyramid_env_matches_jax(levels, masked):
    """Float images with ``n_glimps_levels`` 2 and 3: the pyramid, and
    ``reset``, ``step`` (or ``masked_step``) and ``get_patches`` as in
    :func:`test_env_matches_jax`, every level's patch within
    ``PYRAMID_TOL``; the detection batch reads level 0."""
    images, boxes = _scene(2)
    images = images.astype(np.float32) / 255.0
    jenv = JaxEnv(jnp.asarray(images), jnp.asarray(boxes), P, T, levels, stop_enabled=True)
    tenv = TorchEnv(images, boxes, P, T, levels, stop_enabled=True, device="cpu")
    assert tenv.pyramid.shape == (B, levels, NV * P, NH * P, 3)
    np.testing.assert_allclose(tenv.pyramid.numpy(), np.asarray(jenv.images), **PYRAMID_TOL)
    torch.testing.assert_close(tenv.pyramid[:, 0], torch.from_numpy(images), rtol=0, atol=0)
    # jax.image.resize's linear filter is PyTorch's bilinear interpolation
    # with antialias=True (within the tolerance), and the tolerance tells it
    # from the one without, which misses by far more
    padded = torch.nn.functional.pad(torch.from_numpy(images).permute(0, 3, 1, 2), (P,) * 4,
                                     mode="reflect")
    level1 = np.asarray(jenv.images[:, 1])
    for antialias, close in ((True, True), (False, False)):
        resized = torch.nn.functional.interpolate(
            padded, size=(NV * P, NH * P), mode="bilinear", align_corners=False,
            antialias=antialias).permute(0, 2, 3, 1).numpy()
        miss = np.abs(resized - level1).max()
        assert (miss <= PYRAMID_TOL["atol"]) if close else (miss > 100 * PYRAMID_TOL["atol"])

    start = np.array([[1, 0], [0, 2], [1, 1]], np.int32)
    jstate, jpatches, _ = jenv.reset(positions=jnp.asarray(start))
    tstate, tpatches, _ = tenv.reset(positions=torch.from_numpy(start))
    assert tpatches.shape == (B, levels, P, P, 3) and tpatches.dtype == torch.float32
    np.testing.assert_allclose(tpatches.numpy(), np.asarray(jpatches), **PYRAMID_TOL)
    for t, (actions, frozen) in enumerate(zip(ACTIONS, FROZEN)):
        ja, ta = jnp.asarray(actions, jnp.int32), torch.from_numpy(actions)
        if masked:
            jout = jenv.masked_step(jstate, ja, jnp.asarray(frozen))
            tout = tenv.masked_step(tstate, ta, torch.from_numpy(frozen))
        else:
            jout, tout = jenv.step(jstate, ja), tenv.step(tstate, ta)
        _check(jout[:5], tout[:5], t, PYRAMID_TOL)
        jstate, tstate = jout[0], tout[0]
    coords = np.array([[[0, 0], [1, 2]]] * B, np.int32)
    np.testing.assert_array_equal(tenv.gather_patches_at(torch.from_numpy(coords)).numpy(),
                                  np.asarray(jenv.gather_patches_at(jnp.asarray(coords))))


@pytest.mark.parametrize("shape,patch", [((1, 32, 96, 3), 32), ((2, 96, 64, 1), 32),
                                         ((1, 160, 224, 3), 32)])
def test_pyramid_matches_jax_at_other_shapes(shape, patch):
    """One patch high (the reflection runs past the edge: pad = H), one
    channel, a scale that is not a binary fraction; 3 levels."""
    images = np.random.default_rng(3).random(shape, dtype=np.float32)
    want = np.asarray(jax_pyramid(jnp.asarray(images), patch, 3))
    got = build_glimpse_pyramid(torch.from_numpy(images), patch, 3).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **PYRAMID_TOL)
