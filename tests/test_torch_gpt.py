"""The port's GPT decision model (jolineedle_tpu_torch/models/gpt.py) against
the JAX GPT with the same weights, carried over by models/bridge.py.

gpt-nano widths with the flagship embeddings (yolox-nano embedder, concat,
sinusoidal positions, grid position, STOP), at patch 64 so that the top FPN
level is 2x2 and the NHWC flatten order matters; float32 on the CPU.
"""

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
from jolineedle_tpu_torch.models.bridge import flax_to_torch
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, T, B = 64, 4, 2

CLI = [
    "--training-mode", "reinforce", "--dataset-dir", "/nonexistent",
    "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--enable-stop", "--max-seq-len", str(T), "--patch-size", str(P),
    "--minimum-image-size", "0", "--batch-size", str(B), "--dropout", "0.0",
    "--compute-dtype", "float32", "--devices", "0",
]


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.array(v) for k, v in tree.items()}


def _randomize(variables, seed):
    """Non-trivial BN stats and affine terms (the defaults, mean 0 and var 1,
    would pass with an unported tree), and a sharper action head so greedy
    argmaxes have clear margins."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "mean":
                node[k] = (rng.normal(size=v.shape) * 0.3).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif path and path[-1] == "BatchNorm_0":
                value = (rng.uniform(0.5, 1.5, v.shape) if k == "scale"
                         else rng.normal(size=v.shape) * 0.1)
                node[k] = value.astype(np.float32)

    walk(variables["batch_stats"], ())
    walk(variables["params"], ())
    variables["params"]["action_head"]["Dense_0"]["kernel"] *= 50.0
    return variables


@pytest.fixture(scope="module")
def models():
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
    variables = _randomize(_np_tree(variables), 1)

    t_train, t_model = tconfig.args_to_config(tconfig.get_args(CLI))
    tmodel = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu").eval()
    flax_to_torch(variables, tmodel)
    return jmodel, variables, tmodel


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        patches=rng.random((B, T, P, P, 3)).astype(np.float32),
        actions=rng.integers(0, 9, (B, T)).astype(np.int32),
        classes=np.zeros((B,), np.int32),
        positions=rng.integers(0, 3, (B, T, 2)).astype(np.int32),
    )


def _torch(a):
    t = torch.from_numpy(a)
    return t.long() if a.dtype == np.int32 else t


def test_forward_matches_jax(models):
    jmodel, variables, tmodel = models
    x = _inputs(2)
    want = np.asarray(jmodel.apply(
        variables, *(jnp.asarray(x[k]) for k in ("patches", "actions", "classes", "positions"))
    )[0])
    with torch.no_grad():
        got = tmodel(*(_torch(x[k]) for k in ("patches", "actions", "classes", "positions")))[0]
    assert got.shape == (B, T, 9)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # the logits are not degenerate: the comparison has something to hold
    assert np.ptp(want) > 1.0


def test_decode_loop_matches_jax(models):
    jmodel, variables, tmodel = models
    x = _inputs(3)
    init_cache = jax.jit(lambda v, c: jmodel.apply(v, c, method=JaxGPT.init_cache))
    decode = jax.jit(lambda v, cache, p, a, pos, t: jmodel.apply(
        v, cache, p, a, pos, t, method=JaxGPT.decode_step))
    jcache = init_cache(variables, jnp.asarray(x["classes"]))
    with torch.no_grad():
        tcache = tmodel.init_cache(_torch(x["classes"]))
        for t in range(T):
            want, jcache = decode(
                variables, jcache, jnp.asarray(x["patches"][:, t]),
                jnp.asarray(x["actions"][:, t]), jnp.asarray(x["positions"][:, t]),
                jnp.int32(t),
            )
            got, tcache = tmodel.decode_step(
                tcache, _torch(x["patches"][:, t]), _torch(x["actions"][:, t]),
                _torch(x["positions"][:, t]), t,
            )
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0,
                                       err_msg=f"step {t}")
    assert tcache["index"] == T + 1


def test_decode_equals_forward_in_port(models):
    _, _, tmodel = models
    x = {k: _torch(v) for k, v in _inputs(4).items()}
    with torch.no_grad():
        full = tmodel(x["patches"], x["actions"], x["classes"], x["positions"])[0]
        cache = tmodel.init_cache(x["classes"])
        for t in range(T):
            step, cache = tmodel.decode_step(
                cache, x["patches"][:, t], x["actions"][:, t], x["positions"][:, t], t)
            torch.testing.assert_close(step, full[:, t], atol=1e-5, rtol=0)


def test_embed_flattens_nhwc(models):
    """The patch embedding of the port equals the JAX one (the bridged
    embed_fpn_dense weight only matches an NHWC flatten)."""
    jmodel, variables, tmodel = models
    x = _inputs(5)["patches"]
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), method=JaxGPT.embed_patches))
    with torch.no_grad():
        got = tmodel.embed_patches(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_train_mode_raises(models):
    """Train mode is ported; what still raises is dropout with no generator
    to draw it from (the port takes no hidden global random state)."""
    _, _, tmodel = models
    x = {k: _torch(v) for k, v in _inputs(6).items()}
    args = (x["patches"], x["actions"], x["classes"], x["positions"])
    tmodel.dropout = 0.1
    try:
        with pytest.raises(ValueError, match="needs a torch.Generator"):
            tmodel(*args, train=True)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(0)
            a = tmodel(*args, train=True, generator=gen)[0]
            b = tmodel(*args, train=True, generator=torch.Generator().manual_seed(0))[0]
            c = tmodel(*args, train=True, generator=gen)[0]
            d = tmodel(*args)[0]
    finally:
        tmodel.dropout = 0.0
    torch.testing.assert_close(a, b, atol=0, rtol=0)  # the generator alone decides
    assert not torch.equal(a, c) and not torch.equal(a, d)
