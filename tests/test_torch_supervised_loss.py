"""The supervised train step's loss of the port against the JAX package.

gpt-nano widths with the flagship embeddings (concat, sinusoidal positions,
grid position, STOP with a STOP class weight of 2), a yolox-nano detector,
patch 64, episode length T = 4, batch B = 2 and K = 4 detector patches, float32
on the CPU; dropout 0 and un-augmented patches, so both packages see the same
inputs (the augmentation and dropout draw from different random streams).
The weights are the JAX init with random BN terms, carried into the port by
``models/bridge.py``; the batch is made with numpy from a seed.

The JAX side is the pieces of its ``loss_fn`` (``supervised.py:137-202``):
``model.apply(train=True, mutable=["batch_stats"])``, ``action_ce_metrics``,
then ``yolox_outputs(train=True)`` from the UPDATED statistics and
``yolox_losses``, differentiated by ``jax.value_and_grad``, computed in
float64 (``jax.enable_x64`` and a float64 compute dtype, on the same float32
weights): the float32 port is held against the more exact reference, since
XLA's float32 gradients on the CPU stray further from it. The port's side
is ``decision_loss`` then ``detection_loss``. Held: the loss terms, every
gradient, and the chained BN running statistics, with the yolox-nano
``--gpt-backbone`` embedder (its statistics move with the decision forward)
and without it (the shared detector backbone's statistics are updated twice,
embedding pass first, while the decision loss's gradient stops at its FPN).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.ops import simota as jsimota
from jolineedle_tpu.train import supervised as jsup
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.train.supervised import decision_loss, detection_loss

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, NV, NH, T, B, K = 64, 2, 3, 4, 2, 4
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
STOP_WEIGHT = 2.0


def _cli(backbone: bool):
    return [
        "--training-mode", "supervised", "--dataset-dir", "/nonexistent",
        "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
        "--image-processor", "yolox-nano", "--concat-embeddings",
        "--decoder-pos-encoding", "--use-positional-embedding", "--enable-stop",
        "--stop-weight", str(STOP_WEIGHT), "--max-seq-len", str(T),
        "--patch-size", str(P), "--minimum-image-size", "0", "--batch-size", str(B),
        "--dropout", "0.0", "--max-det-patches", str(K), "--max-boxes", "4",
        "--devices", "0", "--compute-dtype", "float32",
    ] + (["--gpt-backbone", "yolox-nano"] if backbone else [])


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.array(v) for k, v in tree.items()}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): v})
    return out


def _randomize_bn(variables, seed):
    """Random BN scales, biases and running statistics (the defaults would
    hide a statistic that was never updated, or updated from the wrong
    start)."""
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
    variables["params"]["action_head"]["Dense_0"]["kernel"] *= 5.0
    return variables


def _batch(seed):
    """A supervised batch as ``build_supervised_batch`` shapes it, drawn
    with numpy: a live prefix per episode, STOP among the labels, one padded
    detector patch (zero pixels, not valid) and boxes in the valid ones."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((B, T), np.float32)
    masks[0, :T] = 1
    masks[1, : T - 1] = 1
    ref = rng.integers(0, 9, (B, T)).astype(np.int32)
    ref[0, 1] = ref[1, 0] = 8  # STOP, weighted by STOP_WEIGHT
    valid = np.ones((B, K), bool)
    valid[1, K - 1] = False
    det = rng.integers(0, 256, (B, K, P, P, 3), dtype=np.uint8)
    det[~valid] = 0
    boxes = np.zeros((B, K, 4, 6), np.float32)
    boxes[:, :, 0] = [0, 8, 10, 40, 30, 1]
    boxes[0, 1, 1] = [0, 30, 35, 60, 62, 1]
    boxes[~valid] = 0
    return {
        "patches": rng.integers(0, 256, (B, T, P, P, 3), dtype=np.uint8),
        "current_actions": rng.integers(0, 9, (B, T)).astype(np.int32),
        "class_id": np.zeros((B,), np.int32),
        "positions": np.stack([rng.integers(0, NV, (B, T)), rng.integers(0, NH, (B, T))],
                              -1).astype(np.int32),
        "reference_actions": ref,
        "masks": masks,
        "patches_yolox": det,
        "bboxes_yolox": boxes,
        "yolox_valid": valid,
    }


def _unit(x):
    """The already augmented patches both sides take: float32 in [0, 1]."""
    return (x.astype(np.float32) / 255.0)


@pytest.fixture(scope="module", params=[True, False], ids=["gpt_backbone", "shared_backbone"])
def case(request):
    backbone = request.param
    train_config, model_config = args_to_config(get_args(_cli(backbone)))
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
    variables = _randomize_bn(_np_tree(variables), 3)
    batch = _batch(4)
    class_weight = np.ones((9,), np.float32)
    class_weight[8] = STOP_WEIGHT

    def loss_fn(params, batch_stats):
        f64 = lambda x: jnp.asarray(x, jnp.float64)
        (logits, _), mut = jmodel64.apply(
            {"params": params, "batch_stats": batch_stats},
            f64(_unit(batch["patches"])), jnp.asarray(batch["current_actions"]),
            jnp.asarray(batch["class_id"]), jnp.asarray(batch["positions"]),
            train=True, mutable=["batch_stats"])
        action_loss, accuracy = jsup.action_ce_metrics(
            logits, jnp.asarray(batch["reference_actions"]), f64(batch["masks"]),
            f64(class_weight))
        det = f64(_unit(batch["patches_yolox"])).reshape((B * K, P, P, 3))
        (head, _), mut2 = jmodel64.apply(
            {"params": params, "batch_stats": mut["batch_stats"]}, det, True,
            method=JaxGPT.yolox_outputs, mutable=["batch_stats"])
        ylo = jsimota.yolox_losses(head, f64(batch["bboxes_yolox"]).reshape(B * K, 4, 6),
                                   jnp.asarray(batch["yolox_valid"]).reshape(-1))
        loss = action_loss + ylo["total_loss"]
        return loss, (action_loss, accuracy, ylo["total_loss"], mut2["batch_stats"])

    # The JAX reference in float64: train-mode BN over 8 patches is
    # ill-conditioned, and in float32 XLA's gradients stray further from the
    # float64 ones than GRAD_TOL, while the float32 port's stay within it.
    jmodel64 = jmodel.clone(compute_dtype=jnp.float64)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), variables)
        (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], v64["batch_stats"])
        want = jax.device_get({"loss": loss, "action_loss": aux[0], "accuracy": aux[1],
                               "yolo": aux[2], "stats": aux[3], "grads": grads})

    t_train, t_model = tconfig.args_to_config(tconfig.get_args(_cli(backbone)))
    model = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu")
    flax_to_torch(variables, model)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    al, metrics = decision_loss(model, torch.from_numpy(_unit(batch["patches"])), tb,
                                torch.from_numpy(class_weight))
    ylo = detection_loss(model, torch.from_numpy(_unit(batch["patches_yolox"])), tb)
    loss = al + ylo["total_loss"]
    loss.backward()
    grads = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    grads.update({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    got = {"loss": loss.item(), "action_loss": al.item(),
           "accuracy": float(metrics["action_accuracy"]),
           "yolo": ylo["total_loss"].item(),
           "episode_length": float(metrics["episode_length"]),
           "stats": torch_to_flax(model.state_dict(), model)["batch_stats"],
           "grads": torch_to_flax(grads, model)["params"]}
    return backbone, variables, want, got


def test_supervised_loss_matches_jax(case):
    backbone, _, want, got = case
    for key in ("loss", "action_loss", "yolo"):
        np.testing.assert_allclose(got[key], float(want[key]), **GRAD_TOL, err_msg=key)
    assert got["accuracy"] == pytest.approx(float(want["accuracy"]), abs=1e-6)
    assert got["episode_length"] == (T + T - 1) / 2
    assert float(want["action_loss"]) > 0 and float(want["yolo"]) > 0


def test_supervised_grads_match_jax(case):
    """Every gradient leaf within GRAD_TOL of its scale: max |got - want| <=
    rtol * max |want| + atol. Entry by entry, a float32 gradient misses the
    float64 one by more than rtol on the few entries of a leaf that cancel
    to far below its largest, wherever the float32 rounding lands."""
    backbone, _, want, got = case
    g, w = _flat(got["grads"]), _flat(want["grads"])
    assert g.keys() == w.keys()
    for path, value in w.items():
        err = np.abs(np.asarray(g[path], np.float64) - np.asarray(value)).max()
        limit = GRAD_TOL["rtol"] * np.abs(np.asarray(value)).max() + GRAD_TOL["atol"]
        assert err <= limit, f"{'/'.join(path)}: max error {err} > {limit}"
    # The decision loss trains the gpt_backbone embedder; with a shared
    # backbone its gradient stops at the FPN, so the detector's backbone
    # gradient is the detection loss's alone (and is not zero).
    moved = lambda prefix: [p for p, v in g.items() if p[0] == prefix and np.abs(v).max() > 0]
    if backbone:
        assert len(moved("gpt_backbone_net")) == len([p for p in g if p[0] == "gpt_backbone_net"])
    assert moved("yolox") and moved("h_0") and moved("embed_fpn_dense")


def test_chained_bn_statistics_match_jax(case):
    """The running statistics after the decision forward and then the
    detector forward, each in train mode: with a gpt_backbone its statistics
    move once (the decision forward) and the detector's once; without it the
    shared backbone's move twice (embedding pass first)."""
    backbone, variables, want, got = case
    s, w = _flat(got["stats"]), _flat(want["stats"])
    assert s.keys() == w.keys()
    for path, value in w.items():
        np.testing.assert_allclose(np.asarray(s[path]), np.asarray(value), **GRAD_TOL,
                                   err_msg="/".join(path))
    before = _flat(variables["batch_stats"])
    assert all(not np.array_equal(s[p], before[p]) for p in s)
