"""The REINFORCE training slice of the port against the JAX package.

gpt-nano widths with the flagship embeddings (yolox-nano embedder and
detector, concat, sinusoidal positions, grid position, STOP) at patch 64 on a
2x3 grid, episode length T = 4, batch B = 2, float32 on the CPU. Inputs are
made with numpy from a seed; weights are the JAX init with random BN
statistics, carried into the port by ``models/bridge.py``.

- the premise of the port's design: in JAX, the gradient through the
  KV-cache decode loop (what the JAX train step differentiates) equals the
  gradient through the teacher-forced forward on the same actions;
- the port's ``reinforce_loss`` and its gradients against the JAX loss on one
  rollout record;
- ``yolox_losses`` (SimOTA) and the detector's gradients, train-mode BN
  running statistics;
- the optimizer against optax;
- the train CLI end to end on a toy dataset, with a checkpoint and a resume.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.ops import simota as jsimota
from jolineedle_tpu.train.optim import make_optimizer
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.env.batched_env import NeedleEnv
from jolineedle_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.ops.simota import yolox_losses
from jolineedle_tpu_torch.train.optim import Optimizer
from jolineedle_tpu_torch.train.reinforce import reinforce_loss
from jolineedle_tpu_torch.train.rollout import rollout

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, NV, NH, T, B = 64, 2, 3, 4, 2
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)

CLI = [
    "--training-mode", "reinforce", "--dataset-dir", "/nonexistent",
    "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--enable-stop", "--max-seq-len", str(T), "--patch-size", str(P),
    "--minimum-image-size", "0", "--batch-size", str(B), "--dropout", "0.0",
    "--max-det-patches", "4", "--max-boxes", "4", "--devices", "0",
    "--compute-dtype", "float32",
]


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.array(v) for k, v in tree.items()}


def _randomize_bn(variables, seed):
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
    variables = _randomize_bn(_np_tree(variables), 11)
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(CLI))

    def port_model():
        m = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu")
        flax_to_torch(variables, m)
        return m

    return jmodel, variables, port_model, train_config


def _port_grads(model):
    """The port's gradients as a JAX ``params`` tree (zeros where none)."""
    grads = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    for name, p in model.named_parameters():
        if p.grad is not None:
            grads[name] = p.grad
    return torch_to_flax(grads, model)["params"]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): v})
    return out


def _assert_trees_close(got, want, **tol):
    got, want = _flat(got), _flat(jax.device_get(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(w), **tol,
                                   err_msg="/".join(path))


def _assert_trees_close_to_scale(got, want, rel, atol):
    """Per leaf: max |got - want| <= rel * max |want| + atol."""
    got, want = _flat(got), _flat(jax.device_get(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = np.abs(np.asarray(got[path]) - np.asarray(w)).max()
        bound = rel * np.abs(np.asarray(w)).max() + atol
        assert err <= bound, f"{'/'.join(path)}: max error {err} > {bound}"


def _world(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, NV * P, NH * P, 3), dtype=np.uint8)
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[:, 0] = [10, 10, 70, 40]
    boxes[:, 1] = [140, 70, 170, 100]
    return images, boxes


@pytest.fixture(scope="module")
def record(models):
    """One sampled rollout of the port (its actions, positions, masks and
    returns), the data both packages' losses are computed on."""
    _, _, port_model, _ = models
    images, boxes = _world(0)
    env = NeedleEnv(images, boxes, P, T, 1, True, device="cpu")
    gen = torch.Generator().manual_seed(5)
    ro = rollout(port_model(), env, sample=True, generator=gen, collect=("actions",))
    ro.pop("final_state")
    assert (ro["actions"] != ro["actions"][:, :1]).any(), "the episodes should move"
    return images, boxes, {k: v.numpy() for k, v in ro.items()}


RET_MEAN, RET_STD, ENT_W = 0.3, 1.7, 0.01


def _jax_losses(jmodel, images, boxes, rec):
    """The JAX REINFORCE loss on the record's actions, two ways: through
    the decode loop and env steps of ``_rollout_scan`` (what the JAX train
    step differentiates), and through one teacher-forced forward."""
    actions = jnp.asarray(rec["actions"], jnp.int32)
    positions = jnp.asarray(rec["positions"], jnp.int32)

    def finish(logp_all, masks, returns):
        logprobs = jnp.take_along_axis(logp_all, actions[..., None], -1)[..., 0]
        entropies = -(jnp.exp(logp_all) * logp_all).sum(-1)
        adv = (returns - RET_MEAN) / (RET_STD + 1e-8)
        msum = jnp.maximum(masks.sum(), 1.0)
        return (-(logprobs * adv * masks).sum() / msum
                - ENT_W * (entropies * masks).sum() / msum)

    def by_decode(params, batch_stats):
        v = {"params": params, "batch_stats": batch_stats}
        env = JaxEnv(jnp.asarray(images), jnp.asarray(boxes), P, T, 1, True)
        state, patches, _ = env.reset(positions=positions[:, 0])
        cache = jmodel.apply(v, jnp.zeros((B,), jnp.int32), method=JaxGPT.init_cache)
        prev, done = jnp.zeros((B,), jnp.int32), jnp.zeros((B,), bool)
        logps, masks, rewards = [], [], []
        for t in range(T):
            logits, cache = jmodel.apply(v, cache, patches[:, 0], prev, state.positions,
                                         jnp.int32(t), method=JaxGPT.decode_step)
            logps.append(jax.nn.log_softmax(logits.astype(jnp.float32)))
            masks.append(~done)
            state, patches, r, terminated, _, _ = env.masked_step(state, actions[:, t], done)
            done = done | terminated
            rewards.append(r)
            prev = actions[:, t]
        masks = jnp.stack(masks, 1).astype(jnp.float32)
        rewards = jnp.stack(rewards, 1)
        returns = jnp.flip(jnp.cumsum(jnp.flip(rewards * masks, 1), 1), 1)
        return finish(jnp.stack(logps, 1), masks, returns), (masks, returns)

    def by_forward(params, batch_stats):
        v = {"params": params, "batch_stats": batch_stats}
        env = JaxEnv(jnp.asarray(images), jnp.asarray(boxes), P, T, 1, True)
        patches = env.gather_patches_at(positions[:, :T])
        prev = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), actions[:, :-1]], 1)
        logits, _ = jmodel.apply(v, patches, prev, jnp.zeros((B,), jnp.int32),
                                 positions[:, :T])
        masks = jnp.asarray(rec["logit_masks"])
        return finish(jax.nn.log_softmax(logits.astype(jnp.float32)), masks,
                      jnp.asarray(rec["returns"])), None

    grad = lambda f: jax.jit(jax.value_and_grad(f, has_aux=True))
    return grad(by_decode), grad(by_forward)


@pytest.fixture(scope="module")
def jax_reinforce(models, record):
    jmodel, variables, _, _ = models
    images, boxes, rec = record
    by_decode, by_forward = _jax_losses(jmodel, images, boxes, rec)
    args = (variables["params"], variables["batch_stats"])
    return by_decode(*args), by_forward(*args)


def test_jax_decode_loop_grads_equal_teacher_forced_grads(record, jax_reinforce):
    """The premise: differentiating the decode loop (JAX's train step) and
    the teacher-forced forward give the same loss and gradient."""
    _, _, rec = record
    (loss_d, (masks, returns)), grads_d = jax_reinforce[0]
    (loss_f, _), grads_f = jax_reinforce[1]
    # the port's rollout record is the JAX env's, step for step
    np.testing.assert_array_equal(np.asarray(masks), rec["logit_masks"])
    np.testing.assert_allclose(np.asarray(returns), rec["returns"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(loss_f), float(loss_d), rtol=1e-5, atol=1e-6)
    _assert_trees_close(jax.device_get(grads_f), grads_d, rtol=1e-4, atol=1e-6)


def test_reinforce_loss_and_grads_match_jax(models, record, jax_reinforce):
    _, _, port_model, _ = models
    images, boxes, rec = record
    (want_loss, _), want_grads = jax_reinforce[0]
    model = port_model()
    env = NeedleEnv(images, boxes, P, T, 1, True, device="cpu")
    ro = {k: torch.from_numpy(v) for k, v in rec.items()}
    loss, metrics = reinforce_loss(model, env, ro, RET_MEAN, RET_STD, ENT_W, reward_norm=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **GRAD_TOL)
    got = _port_grads(model)
    _assert_trees_close(got, want_grads, **GRAD_TOL)
    # the decision loss reaches the gpt_backbone embedder, not the detector
    assert all(np.abs(g).max() > 0 for g in _flat(got["gpt_backbone_net"]).values())
    assert all(np.abs(g).max() == 0 for g in _flat(got["yolox"]).values())
    assert float(metrics["ret_count"]) == rec["logit_masks"].sum()


def _det_inputs(seed, n=3):
    rng = np.random.default_rng(seed)
    patches = rng.random((n, P, P, 3)).astype(np.float32)
    targets = np.zeros((n, 4, 6), np.float32)
    targets[0, 0] = [0, 10, 12, 40, 30, 1]
    targets[0, 1] = [0, 30, 35, 60, 62, 1]
    targets[1, 0] = [0, 0, 20, 25, 50, 1]
    valid = np.array([True, True, False])
    return patches, targets, valid


@pytest.fixture(scope="module")
def jax_detection(models):
    jmodel, variables, _, _ = models
    patches, targets, valid = _det_inputs(1)

    def loss_fn(params, batch_stats):
        (head, _), mut = jmodel.apply(
            {"params": params, "batch_stats": batch_stats}, jnp.asarray(patches), True,
            method=JaxGPT.yolox_outputs, mutable=["batch_stats"])
        ylo = jsimota.yolox_losses(head, jnp.asarray(targets), jnp.asarray(valid))
        return ylo["total_loss"], (ylo, head, mut["batch_stats"])

    (_, (ylo, head, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    return jax.device_get((ylo, head, stats, grads))


def test_simota_and_losses_match_jax_on_the_same_head(jax_detection):
    """``yolox_losses`` on the JAX detector's own head outputs: the same
    losses, and the same assignment to the anchor."""
    ylo, head, _, _ = jax_detection
    patches, targets, valid = _det_inputs(1)
    got = yolox_losses({k: torch.from_numpy(np.array(v)) for k, v in head.items()},
                       torch.from_numpy(targets), torch.from_numpy(valid), with_assignment=True)
    for name, want in ylo.items():
        np.testing.assert_allclose(float(got[name]), float(want), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    gt_cxcywh = jsimota.xyxy_to_cxcywh(jnp.asarray(targets[..., 1:5]))
    assign = jax.vmap(jsimota.simota_assign, in_axes=(0, 0, 0, 0, 0, 0, None, None))
    fg, matched, miou = assign(
        head["boxes"], head["obj_logits"], head["cls_logits"], gt_cxcywh,
        jnp.asarray(targets[..., 0], jnp.int32),
        jnp.asarray((targets[..., 5] > 0.5) & valid[:, None]), head["grids"], head["strides"])
    fg = np.asarray(fg) & valid[:, None]
    np.testing.assert_array_equal(got["fg_mask"].numpy(), fg)
    np.testing.assert_array_equal(got["matched_gt"].numpy()[fg], np.asarray(matched)[fg])
    np.testing.assert_allclose(got["matched_iou"].numpy(), np.asarray(miou), atol=1e-6, rtol=0)
    assert fg.sum() > 0 and float(got["num_fg"]) == fg.sum()


def test_detector_grads_and_bn_stats_match_jax(models, jax_detection):
    """The train-mode detector (batch-statistics BN) and its SimOTA loss:
    the loss, the detector's gradients and the updated running statistics
    (momentum 0.97, biased variance)."""
    _, _, port_model, _ = models
    ylo, _, want_stats, want_grads = jax_detection
    patches, targets, valid = _det_inputs(1)
    model = port_model()
    head, _ = model.yolox_outputs(torch.from_numpy(patches), train=True)
    got = yolox_losses(head, torch.from_numpy(targets), torch.from_numpy(valid))
    got["total_loss"].backward()
    np.testing.assert_allclose(float(got["total_loss"].detach()), float(ylo["total_loss"]),
                               rtol=1e-4)
    # Batch-statistics BN over three patches is ill-conditioned: in float32
    # the port's own gradients differ from its float64 ones by up to 1.4e-3
    # of a leaf's largest entry, so that is the scale they are held to.
    _assert_trees_close_to_scale(_port_grads(model)["yolox"], want_grads["yolox"],
                                 rel=3e-3, atol=1e-5)
    stats = torch_to_flax(model.state_dict(), model)["batch_stats"]
    _assert_trees_close(stats["yolox"], want_stats["yolox"], rtol=0, atol=1e-5)
    # the embedder's statistics stay: only the detector ran in train mode
    _assert_trees_close(stats["gpt_backbone_net"], models[1]["batch_stats"]["gpt_backbone_net"],
                        rtol=0, atol=0)


class _Tiny(torch.nn.Module):
    """Parameters named as the GPT's partitions are: a detector backbone
    (frozen by --freeze-image-processor), a detector head, a decoder part."""

    def __init__(self, values):
        super().__init__()
        self.yolox = torch.nn.Module()
        self.yolox.backbone = torch.nn.Module()
        self.yolox.head = torch.nn.Module()
        self.h = torch.nn.Module()
        self.yolox.backbone.w = torch.nn.Parameter(torch.from_numpy(values["backbone"].copy()))
        self.yolox.head.w = torch.nn.Parameter(torch.from_numpy(values["head"].copy()))
        self.h.w = torch.nn.Parameter(torch.from_numpy(values["h"].copy()))


def _tiny_window(model, opt, grads, held):
    """Backward passes of ``grads`` into the tiny model, each followed by
    ``opt.step()``; with ``held``, ``opt.hold_grads()`` before each, as a
    graphed train step does. Returns the steps' results and each window's
    summed gradients, read just before its update."""
    params = (("backbone", model.yolox.backbone.w), ("head", model.yolox.head.w),
              ("h", model.h.w))
    applied, sums = [], []
    for g in grads:
        if held:
            opt.hold_grads()
        sum((p * torch.from_numpy(g[name])).sum() for name, p in params).backward()
        if opt.mini_step + 1 == opt.every_k:
            sums.append({name: p.grad.clone() for name, p in params if p.grad is not None})
        applied.append(opt.step())
    return applied, sums


@pytest.mark.parametrize("held", [False, True], ids=["set_to_none", "held"])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_optimizer_matches_optax(schedule, held):
    """Two AdamW groups at their own rates, one frozen partition, k = 2
    micro-batches averaged before the clip at 1.0, weight decay: four
    backward passes, two updates. ``held``: the gradients that a graphed
    train step keeps allocated (``Optimizer.hold_grads``) sum each window
    bit for bit as the eager route's, which sets them to None after each
    update, and give the same weights."""
    rng = np.random.default_rng(3)
    values = {k: rng.normal(size=(3, 4)).astype(np.float32) for k in ("backbone", "head", "h")}
    grads = [{k: (rng.normal(size=(3, 4)) * 2).astype(np.float32) for k in values}
             for _ in range(4)]
    kw = dict(learning_rate=1e-2, yolo_lr=3e-3, gradient_accumulation=2,
              freeze_image_processor=True, detection_enabled=True, clip_value=1.0,
              weight_decay=0.05, lr_schedule=schedule, lr_warmup_iters=1, lr_decay_iters=3)

    params = {"yolox": {"backbone": {"w": values["backbone"]}, "head": {"w": values["head"]}},
              "h": {"w": values["h"]}}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = make_optimizer(params, **kw)
    opt_state = tx.init(params)
    for g in grads:
        g_tree = {"yolox": {"backbone": {"w": g["backbone"]}, "head": {"w": g["head"]}},
                  "h": {"w": g["h"]}}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g_tree),
                                       opt_state, params)
        params = optax.apply_updates(params, updates)

    model = _Tiny(values)
    opt = Optimizer(model, **kw)
    applied, sums = _tiny_window(model, opt, grads, held)
    assert applied == [False, True, False, True] and opt.updates == 2
    assert opt.grads_held == held
    assert all((p.grad is not None) == held for p in opt.trained_params())
    if held:
        eager = _Tiny(values)
        eager_opt = Optimizer(eager, **kw)
        _, eager_sums = _tiny_window(eager, eager_opt, grads, held=False)
        assert [sorted(w) for w in sums] == [sorted(w) for w in eager_sums]
        for got, want in zip(sums, eager_sums):
            for name in want:
                assert torch.equal(got[name], want[name]), name
        for got, want in zip(model.parameters(), eager.parameters()):
            assert torch.equal(got, want)
    np.testing.assert_array_equal(model.yolox.backbone.w.detach().numpy(), values["backbone"])
    for got, want, init in ((model.yolox.head.w, params["yolox"]["head"]["w"], values["head"]),
                            (model.h.w, params["h"]["w"], values["h"])):
        assert not np.allclose(got.detach().numpy(), init)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("window", [
    [], [(0.0, 0.0, 0.0)], [(1.5, 2.25, 1.0)], [(3.0, 9.0, 4.0), (-1.0, 5.0, 3.0)],
    [(2.0, 1.0, 2.0)],  # a negative raw variance, clipped to 0
])
def test_return_window_matches_jax(window):
    """The return-normalisation window (Bessel-corrected std over the
    accumulation window's live steps) on the same sums as JAX's."""
    from types import SimpleNamespace

    from jolineedle_tpu.train.reinforce import ReinforceTrainer as JaxTrainer
    from jolineedle_tpu_torch.train.reinforce import ReinforceTrainer as TorchTrainer

    got, want = (SimpleNamespace(_window_stats=[tuple(map(torch.tensor, s)) for s in window],
                                 last_return_mean=9.0, last_return_std=9.0) for _ in range(2))
    want._window_stats = [tuple(map(jnp.float32, s)) for s in window]
    TorchTrainer._update_return_stats(got)
    JaxTrainer._update_return_stats(want)
    assert (got.last_return_mean, got.last_return_std) == pytest.approx(
        (want.last_return_mean, want.last_return_std), rel=1e-6)
    assert got._window_stats == want._window_stats == []


def test_augment_deterministic_parts_match_jax():
    """The photometric stack draws from a torch.Generator, so only its
    deterministic parts can match JAX: the 3-tap separable blur with
    replicated edges, and the bilinear upsampling of the shadow field."""
    import torch.nn.functional as F

    from jolineedle_tpu.ops import augment as jaug
    from jolineedle_tpu_torch.ops import augment as taug

    rng = np.random.default_rng(8)
    img = rng.random((3, 10, 12, 3)).astype(np.float32)
    kernels = rng.uniform(0.1, 1.0, (3, 3)).astype(np.float32)
    want = np.stack([np.asarray(jaug._separable_blur_3(jnp.asarray(i), jnp.asarray(k)))
                     for i, k in zip(img, kernels)])
    got = taug._separable_blur_3(torch.from_numpy(img).permute(0, 3, 1, 2),
                                 torch.from_numpy(kernels)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    coarse = rng.random((4, 4, 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(coarse), (64, 48, 1), method="bilinear"))
    got = F.interpolate(torch.from_numpy(coarse).permute(2, 0, 1)[None], size=(64, 48),
                        mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_augment_shape_range_and_generator():
    """As the JAX module's own test holds it: shape kept, values in [0, 1],
    uint8 scaled by 1/255; the generator alone decides the draws."""
    from jolineedle_tpu_torch.ops.augment import detection_augment

    rng = np.random.default_rng(9)
    images = torch.from_numpy(rng.integers(0, 256, (2, 3, 16, 16, 3), dtype=np.uint8))
    a = detection_augment(torch.Generator().manual_seed(0), images)
    b = detection_augment(torch.Generator().manual_seed(0), images.float() / 255.0)
    c = detection_augment(torch.Generator().manual_seed(1), images)
    assert a.shape == images.shape and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    assert not torch.allclose(a, images.float() / 255.0, atol=1e-3)


@pytest.mark.parametrize("num_workers", [1, 3])
def test_prefetcher_raises_a_worker_error(num_workers):
    """A batch that fails to build is raised by ``next()``, after the
    batches before it, instead of leaving the train loop waiting."""
    from jolineedle_tpu_torch.train.batching import Prefetcher

    def make_batch(i):
        if i == 2:
            raise OSError("unreadable image")
        return {"i": i}

    counter = iter(range(10))
    prefetcher = Prefetcher(make_batch, n_prefetch=1, num_workers=num_workers,
                            pick_work=lambda: next(counter))
    try:
        with pytest.raises(OSError, match="unreadable image"):
            for _ in range(10):
                next(prefetcher)
    finally:
        prefetcher.close()


def test_train_cli_trains_checkpoints_and_resumes_on_cpu(tmp_path):
    """``main`` end to end on a toy dataset on the CPU: 2 iterations with
    gradient accumulation 2 (one update) from the device pool, the final
    test, the checkpoint files; then a resumed run, streaming the pixels,
    that restores the train state and takes one more iteration. The update moved both optimizer groups and the
    detector's BN statistics, and left the embedder's statistics alone."""
    from jolineedle_tpu_torch.checkpoint import load_train_state
    from jolineedle_tpu_torch.data.toy import generate_toy_dataset
    from jolineedle_tpu_torch.main import main

    generate_toy_dataset(tmp_path / "toy", n_train=4, n_test=2, image_size=(128, 192), seed=0,
                         box_size=(12, 40))
    cli = tconfig.get_args
    flags = [f if f != "/nonexistent" else None for f in CLI]
    flags[flags.index(None)] = str(tmp_path / "toy")
    flags[flags.index(None)] = str(tmp_path / "out")
    flags += ["--gradient-accumulation", "2", "--max-iters", "2", "--test-every", "1000",
              "--test-samples", "2", "--seed", "1", "--env-name", "cli"]
    trainer = main(cli(flags), device="cpu")
    run_dir = tmp_path / "out" / "cli"
    assert trainer.step == 2 and trainer.optimizer.updates == 1
    assert trainer.graphs is None and not trainer.optimizer.grads_held  # eager on the CPU
    assert trainer.pool is not None  # --device-data-cache auto: the toy set fits
    assert {"config.json", "checkpoint.pt", "checkpoint_best.pt", "train_state.pt",
            "metrics.json", "best_model.txt", "visdom.pkl"} <= {p.name for p in run_dir.iterdir()}
    metrics = trainer.last_train_metrics
    assert np.isfinite([float(v) for v in metrics.values()]).all()
    assert "yolo_total_loss" in metrics and "action_loss" in metrics

    torch.manual_seed(1)
    t_train, t_model = tconfig.args_to_config(cli(flags))
    init = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu").state_dict()
    trained = torch.load(run_dir / "checkpoint.pt", weights_only=True)
    moved = lambda prefix: any(not torch.equal(init[k], v) for k, v in trained.items()
                               if k.startswith(prefix) and "running" not in k)
    assert moved("h.") and moved("gpt_backbone_net.") and moved("yolox.head.")
    assert any(not torch.equal(init[k], v) for k, v in trained.items()
               if k.startswith("yolox.") and k.endswith("running_var"))
    assert all(torch.equal(init[k], v) for k, v in trained.items()
               if k.startswith("gpt_backbone_net.") and "running" in k)
    state = load_train_state(run_dir)
    assert state["step"] == 2 and state["optimizer"]["updates"] == 1

    resumed = main(cli(flags + ["--resume-training", str(run_dir), "--max-iters", "1",
                                "--device-data-cache", "off"]), device="cpu")
    assert resumed.step == 3 and resumed.pool is None
    assert (resumed.optimizer.updates, resumed.optimizer.mini_step) == (1, 1)


def test_step_graphs_off_by_the_environment(monkeypatch):
    """``JOLINEEDLE_TORCH_STEP_GRAPHS=0`` keeps a trainer on the card and on
    one rank on the eager route: no graphs, gradients not held."""
    from types import SimpleNamespace

    from jolineedle_tpu_torch.train.trainer import Trainer

    monkeypatch.setenv("JOLINEEDLE_TORCH_STEP_GRAPHS", "0")
    rng = np.random.default_rng(0)
    model = _Tiny({k: rng.normal(size=(3, 4)).astype(np.float32)
                   for k in ("backbone", "head", "h")})
    opt = Optimizer(model, learning_rate=1e-3, yolo_lr=1e-3, gradient_accumulation=4)
    trainer = SimpleNamespace(device=torch.device("cuda"), world=SimpleNamespace(grouped=False),
                              graphs=None, model=model, optimizer=opt)
    assert Trainer.step_graphs(trainer) is None and trainer.graphs is None
    assert not opt.grads_held


@pytest.mark.parametrize("device,grouped", [("cpu", False), ("cpu", True), ("cuda", True),
                                            ("cuda", False)])
def test_train_step_graphs_only_on_the_card_on_one_rank(device, grouped):
    """``Trainer.step_graphs``, which both trainers' ``train_step`` asks: no
    graphs on the CPU or over several ranks (the eager route, gradients set
    to None after each update); on the card on one rank the model's
    ``TrainGraphs``, made once, and the optimizer then holds its gradients.
    Nothing is captured here: the graphs capture at their first use."""
    from types import SimpleNamespace

    from jolineedle_tpu_torch.train.graphs import TrainGraphs
    from jolineedle_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(0)
    model = _Tiny({k: rng.normal(size=(3, 4)).astype(np.float32)
                   for k in ("backbone", "head", "h")})
    opt = Optimizer(model, learning_rate=1e-3, yolo_lr=1e-3, gradient_accumulation=4)
    trainer = SimpleNamespace(device=torch.device(device), world=SimpleNamespace(grouped=grouped),
                              graphs=None, model=model, optimizer=opt)
    graphs = Trainer.step_graphs(trainer)
    if device == "cpu" or grouped:
        assert graphs is None and trainer.graphs is None and not opt.grads_held
        assert all(p.grad is None for p in model.parameters())
    else:
        assert isinstance(graphs, TrainGraphs) and graphs.model is model
        assert Trainer.step_graphs(trainer) is graphs and opt.grads_held
        assert all(torch.equal(p.grad, torch.zeros_like(p)) for p in opt.trained_params())
        assert graphs.captures == {"embedder": 0, "shared_embedder": 0, "detector": 0,
                                   "rollout": 0}
