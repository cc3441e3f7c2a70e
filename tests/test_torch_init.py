"""A fresh port model is initialised as the JAX package initialises its GPT,
and ``--no-recurrent-embedding`` trains and serves.

- ``models/init.py``: for every leaf that ``models/bridge.py`` maps, the mean
  and standard deviation of a fresh port model (torch seed 0) against those
  of ``GPT.init_all`` (PRNGKey 0) at the gpt-nano config with the flagship
  embeddings; the values differ (other random streams), the distributions
  must not. Constant leaves (biases, norms, running statistics) must be
  equal exactly.
- ``--no-recurrent-embedding`` runs in the train CLI (one supervised
  iteration and its test on the CPU; one REINFORCE iteration, whose sampled
  train rollout is full-prefix) and in ``infer`` (one image served from the
  run directory, whose ``config.json`` sets it), through the full-prefix
  rollout: the KV-cache decode is never called.
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

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

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


def _full_prefix_flags(tmp_path):
    flags = list(CLI)
    flags[flags.index("--dataset-dir") + 1] = str(tmp_path / "data")
    flags[flags.index("--work-dir") + 1] = str(tmp_path / "out")
    return flags + ["--no-recurrent-embedding", "--env-name", "norec", "--max-iters", "2",
                    "--test-every", "1000", "--test-samples", "1", "--batch-size", "2",
                    "--max-det-patches", "4", "--max-boxes", "4"]


def test_no_recurrent_embedding_trains_and_serves(tmp_path, monkeypatch):
    """The train CLI takes one iteration and its final test (whose eval
    rollouts are full-prefix), then ``infer`` serves one image from the run
    directory; neither calls the KV-cache decode."""
    from PIL import Image

    from jolineedle_tpu_torch.data.toy import generate_toy_dataset
    from jolineedle_tpu_torch.infer import get_infer_args, infer
    from jolineedle_tpu_torch.main import main

    def no_cache(*args, **kwargs):
        raise AssertionError("the full-prefix rollout ran the KV-cache decode")

    monkeypatch.setattr(TorchGPT, "init_cache", no_cache)
    monkeypatch.setattr(TorchGPT, "decode_step", no_cache)
    generate_toy_dataset(tmp_path / "data", n_train=4, n_test=2, image_size=(2 * P, 3 * P),
                         seed=0, box_size=(12, 40))
    trainer = main(tconfig.get_args(_full_prefix_flags(tmp_path)
                                    + ["--device-data-cache", "off"]), device="cpu")
    assert trainer.model.no_recurrent_embedding and trainer.step == 1
    assert trainer.pool is None  # the pixels streamed
    model_dir = tmp_path / "out" / "norec"
    assert json.loads((model_dir / "config.json").read_text())["model"][
        "no_recurrent_embedding"]

    image = sorted((tmp_path / "data" / "images").iterdir())[0]
    Image.open(image).save(tmp_path / "img.png")
    (tmp_path / "img.txt").write_text("0 10 10 70 40\n")
    (tmp_path / "list.txt").write_text("img.png img.txt\n")
    metrics = infer(get_infer_args(["--model-dir", str(model_dir), "--dataset",
                                    str(tmp_path / "list.txt")]), device="cpu")
    assert metrics["episode_length"] and all(np.isfinite(v[0]) for v in metrics.values())


def test_no_recurrent_embedding_trains_reinforce(tmp_path, monkeypatch):
    """The REINFORCE train CLI takes one iteration with the flag: its sampled
    train rollout and its final test's rollouts are full-prefix (the
    KV-cache decode is never called), the loss is finite and the update
    moves the decoder."""
    from jolineedle_tpu_torch.data.toy import generate_toy_dataset
    from jolineedle_tpu_torch.main import main

    def no_cache(*args, **kwargs):
        raise AssertionError("the full-prefix rollout ran the KV-cache decode")

    monkeypatch.setattr(TorchGPT, "init_cache", no_cache)
    monkeypatch.setattr(TorchGPT, "decode_step", no_cache)
    generate_toy_dataset(tmp_path / "data", n_train=4, n_test=2, image_size=(2 * P, 3 * P),
                         seed=0, box_size=(12, 40))
    flags = _full_prefix_flags(tmp_path)
    flags[flags.index("--training-mode") + 1] = "reinforce"
    flags[flags.index("--max-iters") + 1] = "1"
    torch.manual_seed(0)
    trainer = main(tconfig.get_args(flags + ["--seed", "0", "--device-data-cache", "on"]),
                   device="cpu")
    assert trainer.model.no_recurrent_embedding and trainer.pool is not None
    assert trainer.step == 1 and trainer.optimizer.updates == 1
    metrics = trainer.last_train_metrics
    assert "action_loss" in metrics
    assert np.isfinite([float(v) for v in metrics.values()]).all()
    trained = torch.load(tmp_path / "out" / "norec" / "checkpoint.pt", weights_only=True)
    torch.manual_seed(0)
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(flags + ["--seed", "0"]))
    init = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu").state_dict()
    assert any(not torch.equal(init[k], v) for k, v in trained.items() if k.startswith("h."))
    # the same fresh model: the embedder's BN statistics never move
    assert all(torch.equal(init[k], v) for k, v in trained.items()
               if k.startswith("gpt_backbone_net.") and "running" in k)
