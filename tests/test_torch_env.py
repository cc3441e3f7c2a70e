"""The port's batched env (jolineedle_tpu_torch/env/batched_env.py) against
the JAX NeedleEnv: the same images, boxes, reset positions and action
sequences give the same positions, visited masks, rewards, termination and
patches, with STOP and frozen (masked) steps included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu_torch.env.batched_env import NeedleEnv as TorchEnv

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, NV, NH, B, T = 32, 2, 3, 3, 6
STOP = 8


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


def _check(jout, tout, step):
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
    np.testing.assert_array_equal(tpatches.numpy(), np.asarray(jpatches), msg)


@pytest.mark.parametrize(
    "stop_enabled,terminate_on_all_found,stop_bonus_scale",
    [(True, True, 1.0), (True, True, 0.25), (False, True, 1.0), (False, False, 1.0)],
)
@pytest.mark.parametrize("masked", [False, True])
def test_env_matches_jax(stop_enabled, terminate_on_all_found, stop_bonus_scale, masked):
    images, boxes = _scene(0)
    kw = dict(stop_enabled=stop_enabled, terminate_on_all_found=terminate_on_all_found,
              stop_bonus_scale=stop_bonus_scale)
    jenv = JaxEnv(jnp.asarray(images), jnp.asarray(boxes), P, T, 1, **kw)
    tenv = TorchEnv(images, boxes, P, T, 1, device="cpu", **kw)
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
    with pytest.raises(NotImplementedError):
        TorchEnv(images, boxes, P, T, n_glimps_levels=2, device="cpu")
