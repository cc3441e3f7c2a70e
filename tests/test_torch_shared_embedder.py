"""The shared embedder: with no ``gpt_backbone`` the yolox detector's own
backbone embeds the decision patches and its gradient stops at the FPN
(``jolineedle_tpu/models/gpt.py:246-266``: ``jax.lax.stop_gradient``). The
port's ``GPT.embed_patches`` runs that backbone forward only, outside
autograd: in train mode on batch statistics with one update of the running
statistics, in eval mode (REINFORCE's recompute) on the fused conv kernels,
whose plain versions run on the CPU.

The recipes' default pairing (the yolox-nano detector, no
``--gpt-backbone``) at gpt-nano widths and patch 64, float32, on the same
numpy patches and bridged weights (``models/bridge.py``):

- against the JAX package's ``embed_patches`` in train and eval mode: the
  embeddings, and after a train-mode call the running statistics against
  the JAX call's updated ``batch_stats``;
- against the route the port took before (the backbone under autograd, its
  top level detached): equal embeddings and running statistics;
- no gradient reaches ``yolox.backbone`` from a loss on the embedding, in
  either mode, while the embedder's own layers get one.
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
from test_torch_gpt import _np_tree, _randomize

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, T, B = 64, 4, 2
# float32 on both sides, the same ops in another order: the embeddings within
# EMB_ATOL (they reach about 1), the running statistics within STATS_ATOL.
EMB_ATOL, STATS_ATOL = 1e-4, 1e-5

CLI = [
    "--training-mode", "reinforce", "--dataset-dir", "/nonexistent",
    "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--enable-stop", "--max-seq-len", str(T), "--patch-size", str(P),
    "--minimum-image-size", "0", "--batch-size", str(B), "--dropout", "0.0",
    "--compute-dtype", "float32", "--devices", "0",
]


def _torch_model(variables):
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(CLI))
    assert t_model.gpt_backbone is None
    model = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu").eval()
    assert not hasattr(model, "gpt_backbone_net")
    flax_to_torch(variables, model)
    return model


@pytest.fixture(scope="module")
def models():
    train_config, model_config = args_to_config(get_args(CLI))
    assert model_config.gpt_backbone is None
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
    return jmodel, variables


def _patches(seed):
    return np.random.default_rng(seed).random((B, T, P, P, 3)).astype(np.float32)


def _backbone_stats(model):
    return {k: v.clone() for k, v in model.yolox.backbone.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _old_route(model, patches, train):
    """The embedding as the port computed it before: the shared backbone
    under autograd (PyTorch convs), its top level detached."""
    backbone = model.yolox.backbone
    forward = backbone.forward

    def under_autograd(x, train=False, autograd=False):
        with torch.enable_grad():
            return tuple(f.detach() for f in forward(x, train, True))

    backbone.forward = under_autograd
    try:
        return model.embed_patches(patches, train)
    finally:
        del backbone.forward


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_shared_embed_equals_jax(models, train):
    """The embeddings, and in train mode the running statistics after the
    call against the JAX call's updated ``batch_stats`` (bridged into a
    second port model)."""
    jmodel, variables = models
    x = _patches(3)
    out = jmodel.apply(variables, jnp.asarray(x), train, method=JaxGPT.embed_patches,
                       mutable=["batch_stats"] if train else False)
    want, updated = (out[0], out[1]["batch_stats"]) if train else (out, None)
    model = _torch_model(variables)
    before = _backbone_stats(model)
    with torch.no_grad():
        got = model.embed_patches(torch.from_numpy(x), train)
    assert got.shape == (B, T, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EMB_ATOL, rtol=0)
    assert np.ptp(np.asarray(want)) > 0.1  # the embeddings are not degenerate
    after = _backbone_stats(model)
    if not train:
        assert all(torch.equal(after[k], before[k]) for k in before)
        return
    reference = _torch_model({**variables, "batch_stats": _np_tree(updated)})
    want_stats = _backbone_stats(reference)
    moved = 0
    for k, v in after.items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), atol=STATS_ATOL, rtol=0,
                                   err_msg=k)
        moved += not torch.equal(v, before[k])
    assert moved == len(after)  # every BN layer of the backbone updated once


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_no_grad_route_equals_the_autograd_route(models, train):
    """The forward-only route against the autograd-then-detach one on two
    copies of one model: equal embeddings and running statistics."""
    _, variables = models
    x = torch.from_numpy(_patches(4))
    new, old = _torch_model(variables), _torch_model(variables)
    got = new.embed_patches(x, train)
    want = _old_route(old, x, train)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=EMB_ATOL,
                               rtol=0)
    got_stats, want_stats = _backbone_stats(new), _backbone_stats(old)
    for k, v in got_stats.items():
        np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(), atol=STATS_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_no_gradient_reaches_the_shared_backbone(models, train):
    """A loss on the embedding (grad enabled, as in a train step) leaves
    every parameter of ``yolox.backbone`` without a gradient and gives the
    embedder's own conv and dense one."""
    _, variables = models
    model = _torch_model(variables)
    x = torch.from_numpy(_patches(5))
    emb = model.embed_patches(x, train)
    assert emb.requires_grad
    (emb * torch.linspace(-1.0, 1.0, emb.numel()).reshape(emb.shape)).sum().backward()
    assert all(p.grad is None for p in model.yolox.backbone.parameters())
    for p in (model.embed_fpn_conv.weight, model.embed_fpn_dense.weight):
        assert p.grad is not None and p.grad.abs().max() > 0
    # and the detector's own forward still trains the backbone
    head, _ = model.yolox_outputs(x[:, 0], train=True)
    head["obj_logits"].sum().backward()
    assert any(p.grad is not None and p.grad.abs().max() > 0
               for p in model.yolox.backbone.parameters())


def test_old_route_builds_a_backward_graph_the_new_one_does_not(models):
    """Eval mode under grad (the REINFORCE recompute): the old route's
    backbone output carried an autograd graph that nothing used; the new
    route's top level is a leaf with no history."""
    _, variables = models
    model = _torch_model(variables)
    x = model._to_compute(torch.from_numpy(_patches(6)).reshape(B * T, P, P, 3))
    old = model.yolox.backbone(x, False, True)[-1]
    assert old.grad_fn is not None
    seen = []
    handle = model.yolox.backbone.register_forward_hook(
        lambda module, inputs, output: seen.append(output[-1]))
    try:
        model.embed_patches(torch.from_numpy(_patches(6)), False)
    finally:
        handle.remove()
    assert len(seen) == 1 and seen[0].grad_fn is None and not seen[0].requires_grad
    np.testing.assert_allclose(seen[0].numpy(), old.detach().numpy(), atol=EMB_ATOL, rtol=0)
