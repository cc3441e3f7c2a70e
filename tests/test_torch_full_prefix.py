"""``--no-recurrent-embedding``: the full-prefix rollout, port against JAX and
against the port's own KV-cache decode.

The JAX side is ``ReinforceTrainer._rollout_scan`` of a model built with
the flag (``trainer.py:516-567``): every step runs the full forward over
the zero-padded history and takes the logits of the current step. The
weights, images and reset positions are those of ``test_torch_serve.py``
(gpt-nano, yolox-nano, concat embeddings, sinusoidal positions, STOP,
patch 64, 4 steps, float32 on the CPU).

- greedy, the port's full-prefix rollout against JAX's: the same positions
  and actions, logits within ``LOGIT_TOL``;
- the port's full-prefix against its KV-cache rollout: greedy, and sampled
  from one seeded generator (both branches draw the same numbers), the same
  actions and positions, logits within ``LOGIT_TOL``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.train.reinforce import ReinforceTrainer
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.models.bridge import flax_to_torch
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.train.rollout import eval_rollout, to_numpy
from tests.test_torch_serve import B, LOGIT_TOL, NH, NV, P, T, _cli, _np_tree, _randomize

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def full_prefix(tmp_path_factory):
    cli = _cli(tmp_path_factory.mktemp("full_prefix")) + ["--no-recurrent-embedding"]
    train_config, model_config = args_to_config(get_args(cli))
    jmodel = JaxGPT.from_config(model_config, get_actions_info(train_config))
    assert jmodel.no_recurrent_embedding
    trainer = ReinforceTrainer(train_config, jmodel, None, None, None)
    variables = _randomize(_np_tree(trainer.eval_variables()), 3)

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, NV * P, NH * P, 3), dtype=np.uint8)
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[:, 0] = [10, 10, 70, 40]
    boxes[:, 1] = [140, 70, 170, 100]
    start = np.array([[0, 0], [1, 2]], np.int32)

    @jax.jit
    def jax_rollout(v, images, boxes, positions):
        env = JaxEnv(images, boxes, P, T, 1, True)
        ro = trainer._rollout_scan(v, env, jax.random.PRNGKey(0), sample=False,
                                   collect=("logits", "actions"), positions=positions)
        ro.pop("final_state")
        return ro

    jro = jax.device_get(jax_rollout(variables, jnp.asarray(images), jnp.asarray(boxes),
                                     jnp.asarray(start)))
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(cli))
    tmodel = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu").eval()
    assert tmodel.no_recurrent_embedding
    flax_to_torch(variables, tmodel)
    return dict(jro=jro, tmodel=tmodel, t_train=t_train, images=images, boxes=boxes,
                start=torch.from_numpy(start))


def _port(fp, full_prefix: bool, sample: bool, seed: int = 0):
    model = fp["tmodel"]
    model.no_recurrent_embedding = full_prefix
    try:
        gen = torch.Generator().manual_seed(seed)
        return to_numpy(eval_rollout(model, fp["images"], fp["boxes"], fp["t_train"],
                                     sample=sample, generator=gen, positions=fp["start"],
                                     device="cpu", collect=("logits", "actions")))
    finally:
        model.no_recurrent_embedding = True


def test_full_prefix_rollout_matches_jax(full_prefix):
    jro = full_prefix["jro"]
    tro = _port(full_prefix, full_prefix=True, sample=False)
    logits = np.sort(jro["logits"], axis=-1)
    assert (logits[..., -1] - logits[..., -2]).min() > 50 * LOGIT_TOL, "a near-tie"
    np.testing.assert_allclose(tro["logits"], jro["logits"], atol=LOGIT_TOL, rtol=0)
    for name in ("actions", "positions", "masks"):
        np.testing.assert_array_equal(tro[name], jro[name], err_msg=name)
    assert (np.abs(np.diff(jro["positions"], axis=1)).sum(-1) > 0).any()


@pytest.mark.parametrize("sample,seed", [(False, 0), (True, 0), (True, 1), (True, 2)])
def test_full_prefix_matches_kv_cache(full_prefix, sample, seed):
    full = _port(full_prefix, full_prefix=True, sample=sample, seed=seed)
    cached = _port(full_prefix, full_prefix=False, sample=sample, seed=seed)
    np.testing.assert_allclose(full["logits"], cached["logits"], atol=LOGIT_TOL, rtol=0)
    for name in ("actions", "positions", "masks"):
        np.testing.assert_array_equal(full[name], cached[name], err_msg=name)
    if sample:  # a sampled episode takes other actions than the greedy one
        greedy = _port(full_prefix, full_prefix=True, sample=False)
        assert not np.array_equal(full["actions"], greedy["actions"])
