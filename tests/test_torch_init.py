"""A fresh port model is initialised as the JAX package initialises its GPT,
and the flag the port does not implement is refused.

- ``models/init.py``: for every leaf that ``models/bridge.py`` maps, the mean
  and standard deviation of a fresh port model (torch seed 0) against those
  of ``GPT.init_all`` (PRNGKey 0) at the gpt-nano config with the flagship
  embeddings; the values differ (other random streams), the distributions
  must not. Constant leaves (biases, norms, running statistics) must be
  equal exactly.
- ``--no-recurrent-embedding`` raises "not yet ported" in the train CLI and
  in ``infer`` (from a model directory whose ``config.json`` sets it).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.models.bridge import gpt_key_map
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT

P = 64
CLI = [
    "--training-mode", "supervised", "--dataset-dir", "/nonexistent",
    "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--enable-stop", "--max-seq-len", "4", "--patch-size", str(P),
    "--minimum-image-size", "0", "--compute-dtype", "float32", "--devices", "0",
]
# Sampling tolerance, in standard errors of the difference of two
# independent samples of n draws with standard deviation s: s * sqrt(2 / n)
# for the means, s * sqrt(1 / n) for the standard deviations.
Z = 5.0


@pytest.fixture(scope="module")
def inits():
    train_config, model_config = args_to_config(get_args(CLI))
    jmodel = JaxGPT.from_config(model_config, get_actions_info(train_config))
    variables = jax.jit(
        lambda rng: jmodel.init(
            rng,
            jnp.zeros((1, 1, P, P, 3)),
            jnp.zeros((1, 1), jnp.int32),
            jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 1, 2), jnp.int32),
            jnp.zeros((1, P, P, 3)),
            method=JaxGPT.init_all,
        )
    )(jax.random.PRNGKey(0))
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(CLI))
    torch.manual_seed(0)
    tmodel = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu")
    return jax.device_get(variables), tmodel


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree, np.float64)


def test_fresh_model_draws_the_jax_distributions(inits):
    variables, tmodel = inits
    state = tmodel.state_dict()
    n_random = 0
    for tkey, coll, fpath, _ in gpt_key_map(tmodel):
        want = _leaf(variables[coll], fpath)
        got = state[tkey].double().numpy()
        name = f"{tkey} ({'/'.join(fpath)})"
        assert got.size == want.size, name
        if want.std() == 0:  # constant: biases, norms, running statistics
            np.testing.assert_array_equal(got.ravel(), np.full(got.size, want.flat[0]),
                                          err_msg=name)
            continue
        n_random += 1
        s, n = want.std(), want.size
        assert abs(got.mean() - want.mean()) <= Z * s * np.sqrt(2.0 / n), name
        assert abs(got.std() - want.std()) <= Z * s * np.sqrt(1.0 / n), name
    # every bias of the port is exactly 0 (Dense, conv and norm biases)
    biases = [k for k, _ in tmodel.named_parameters() if k.endswith(".bias")]
    assert len(biases) > 100 and all(not state[k].any() for k in biases)
    assert n_random > 100  # the kernels and embeddings of the whole tree


def test_init_distributions_by_kind(inits):
    """The standard deviations named by the JAX package: 0.02 for the
    embeddings and DENSE_INIT layers, 0.02 / sqrt(2 n_layer) for both
    c_proj, and lecun_normal (variance 1 / fan_in, a depthwise 3x3 has
    fan_in 9) for the conv kernels."""
    _, tmodel = inits
    state = tmodel.state_dict()
    n_layer = tmodel.n_layer
    cases = {
        "embed_class.weight": 0.02,
        "h.0.attn.c_attn.weight": 0.02,
        "h.0.attn.c_proj.weight": 0.02 / np.sqrt(2 * n_layer),
        "h.2.c_proj.weight": 0.02 / np.sqrt(2 * n_layer),
        "action_head.dense.weight": 0.02,
        "yolox.backbone.backbone.dark2.0.dconv.conv.weight": 1 / 3,
        "yolox.backbone.backbone.stem.conv.conv.weight": 1 / np.sqrt(12 * 9),
        "embed_fpn_conv.weight": 1 / np.sqrt(256),  # 1024 * 0.25 channels
    }
    for key, std in cases.items():
        value = state[key].double()
        tol = Z * std / np.sqrt(2 * value.numel())
        assert abs(float(value.std()) - std) <= tol, (key, float(value.std()), std)
    # lecun_normal is truncated at two standard deviations
    w = state["yolox.backbone.backbone.dark5.0.pconv.conv.weight"]
    assert float(w.abs().max()) <= 2 * np.sqrt(1 / w[0].numel()) / 0.87962566103423978


def _refused_flags(tmp_path):
    flags = list(CLI)
    flags[flags.index("--dataset-dir") + 1] = str(tmp_path / "data")
    flags[flags.index("--work-dir") + 1] = str(tmp_path / "out")
    return flags + ["--no-recurrent-embedding", "--env-name", "norec"]


def test_no_recurrent_embedding_is_refused(tmp_path):
    """The full-prefix rollout is not ported: the train CLI and ``infer``
    (on a model directory whose config.json sets the flag) raise instead of
    running the KV-cache decode in its place."""
    from jolineedle_tpu_torch.infer import get_infer_args, infer
    from jolineedle_tpu_torch.main import main

    flags = _refused_flags(tmp_path)
    with pytest.raises(NotImplementedError,
                       match="--no-recurrent-embedding is not yet ported"):
        main(tconfig.get_args(flags), device="cpu")

    t_train, t_model = tconfig.args_to_config(tconfig.get_args(flags))
    assert t_model.no_recurrent_embedding
    tconfig.save_config(t_model, t_train)
    model_dir = tmp_path / "out" / "norec"
    assert json.loads((model_dir / "config.json").read_text())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        infer(get_infer_args(["--model-dir", str(model_dir)]), device="cpu")
