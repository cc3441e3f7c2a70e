"""The REINFORCE STOP fine-tune's recipe (``run_rl_finetune_stop.sh``):
eight iterations of the port's train step against the JAX package's.

The recipe's flags at a small size, in each pairing (the yolox-nano
detector and a separate yolox-nano ``gpt_backbone`` embedder; and the
recipe's default, the yolox-nano detector's own backbone as the embedder,
its gradient stopped at the FPN), gpt-nano, patch 64, B = 2, episodes of
4, 2 detector patches an image, float32, the streamed pixels: STOP,
entropy 0.01, accumulation 4 in chunks of 4 (``--steps-per-dispatch``),
return normalisation, the two learning rates (3e-5 and 2e-5) and the
warm start (``--init-from``) from an 8-action state, grafted onto the
9-action STOP model by each package from one msgpack. The eight iterations
are two accumulation windows; the return statistics change between them.

At each iteration the JAX trainer's jitted step runs in float64, its chunk
keys and batches as its loop draws them, and the port's ``train_step``
runs in float32 from the JAX state that the iteration starts from
(weights, statistics, the AdamW moments and counts and the window's
accumulated gradients, as ``--resume-training`` loads a JAX train state)
and the JAX trainer's return mean and std. The port's rollout is replaced
by the JAX step's own sampled rollout, its detection batch and
augmentation by the JAX step's (the same keys, recomputed outside the
step; the step's return sums show they are its), so that both take the
same actions on the same patches. Checked: the losses; the accumulated
gradients within each window; at each window's end their sum before the
update (JAX's from its accumulated mean and the last micro-step's gradient,
the step rerun from the window's start); the AdamW moments and counts, the
BN statistics and the weights after every iteration.

SimOTA's anchor assignment is discrete: a near tie that float32 and float64
resolve differently changes the detector's loss terms by percents (seen
from another 8-action init), which no tolerance here admits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.ops.augment import detection_augment as jax_detection_augment
from jolineedle_tpu.train.reinforce import ReinforceTrainer as JaxReinforce
import main as jax_main
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.checkpoint import flax_optimizer_state, optimizer_to_flax
from jolineedle_tpu_torch.main import build_trainer
from jolineedle_tpu_torch.models.bridge import flax_to_torch, gpt_param_entries, torch_to_flax
from jolineedle_tpu_torch.parallel import mesh
from jolineedle_tpu_torch.scripts import make_toyds_big
from jolineedle_tpu_torch.train import reinforce as treinforce
from test_torch_recipes import _flat, _recipe_argv, _tree

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

N_ITERS, WINDOW, B, T, MAX_DET = 8, 4, 2, 4, 2
LR, BETAS, CLIP = 3e-5, (0.9, 0.999), 1.0  # the larger lr of the two; AdamW; clip
# Tolerances, port (float32) against JAX (float64), each from the same state
# (measured over the 8 iterations: 3.9e-4, 4.1e-3, 3.0e-4, 1.3 lr, 0.02 %):
# the loss terms within LOSS_RTOL, the action loss (a mean of normalised
# advantages, near 0) also within ACTION_ATOL; the window's accumulated
# gradient (its mean inside the window, its sum at its end, before the clip)
# and the BN statistics within a share of their leaf's largest value; the
# AdamW moments within MOMENT_RTOL of theirs, plus at an update what the
# gradient's tolerance moves them by through the clip (the detector's
# train-mode BN over 4 patches leaves its gradients uncertain at 1e-3 of
# its largest, which reach 1e2: above the clip at 1); every weight within
# STEP_TOL learning rates of JAX's (an AdamW step of the other sign where
# float32 leaves a clipped gradient's sign uncertain) and all but
# FLIP_SHARE of them within STATE_ATOL.
LOSS_RTOL, ACTION_ATOL = 1e-3, 1e-5
GRAD_RTOL, STATS_RTOL, MOMENT_RTOL = 1e-2, 1e-3, 3e-2
STEP_TOL, FLIP_SHARE, STATE_ATOL = 2.0, 2e-2, 1e-6
LOSS_TERMS = ("loss", "action_loss", "entropy_loss", "yolo_loss", "yolo_iou_loss",
              "yolo_conf_loss", "yolo_cls_loss", "yolo_l1_loss")


#: The pairings' backbone flags: a separate ``gpt_backbone`` embedder, or the
#: detector's backbone shared (``run_rl_finetune_stop.sh``'s default).
PAIRINGS = {"gpt_backbone": "--image-processor yolox-nano --gpt-backbone yolox-nano",
            "shared": "--image-processor yolox-nano"}


def _argv(toy, work, init_from, stop=True, pairing="gpt_backbone"):
    values = {"DATASET_DIR": str(toy), "SUP_RUN": str(init_from), "WORK_DIR": str(work),
              "MAX_ITERS": str(N_ITERS), "DETECTOR": "yolox-nano", "ENTROPY": "0.01",
              "BACKBONE_FLAGS": PAIRINGS[pairing], "EXTRA_FLAGS": ""}
    drop = () if stop else ("--enable-stop",)
    return _recipe_argv("run_rl_finetune_stop.sh", values, drop=drop) + [
        "--batch-size", str(B), "--max-seq-len", str(T), "--max-det-patches", str(MAX_DET),
        "--compute-dtype", "float32", "--device-data-cache", "off", "--devices", "0"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("rl_recipe")
    return make_toyds_big.make_toyds_big(root / "toy", n_train=4, n_test=2)


def _jax_trainer(argv, toy):
    cfg, model_cfg = args_to_config(get_args(argv))
    train, test = jax_main.build_both_datasets(cfg, model_cfg, toy)
    model = JaxGPT.from_config(model_cfg, get_actions_info(cfg))
    return JaxReinforce(cfg, model, None, train, test), cfg


def _graft_source(toy, tmp, pairing):
    """The JAX trainer's 8-action (no STOP) state of the same model at
    another seed, as a ``checkpoint_best.msgpack``: what ``--init-from``
    reads."""
    argv = _argv(toy, tmp / "src_work", tmp / "none", stop=False, pairing=pairing) + [
        "--seed", "5"]
    trainer, _ = _jax_trainer(argv, toy)
    assert trainer.state.params["action_head"]["Dense_0"]["kernel"].shape[-1] == 8
    source = tmp / "sup"
    source.mkdir()
    state = jax.device_get(trainer.state)
    (source / "checkpoint_best.msgpack").write_bytes(serialization.to_bytes(
        {"params": state.params, "batch_stats": state.batch_stats}))
    return source


def _chunk_work(cfg, n_train):
    """The JAX loop's picks (``reinforce.py:357-438``) at steps per dispatch
    ``WINDOW``: per chunk, WINDOW batches of indices and their build seeds."""
    order_rng = np.random.default_rng(cfg.seed)
    pool, counter, out = [], 0, []
    for _ in range(N_ITERS // WINDOW):
        picks = []
        for _ in range(WINDOW):
            while len(pool) < cfg.batch_size:
                pool += order_rng.permutation(n_train).tolist()
            indices, pool = pool[:cfg.batch_size], pool[cfg.batch_size:]
            counter += 1
            picks.append((indices, cfg.seed + 1 + counter))
        out += [(ids, picks[0][1] + k) for k, (ids, _) in enumerate(picks)]
    return out


def _trajectory(toy, tmp, monkeypatch, pairing="gpt_backbone"):
    """The eight iterations in ``pairing``; per iteration the loss terms
    (JAX, port), the states after it (JAX's, the port's, as flax state
    dicts) and at a window's end the clipped mean gradient (JAX's, the
    port's)."""
    source = _graft_source(toy, tmp, pairing)
    argv = _argv(toy, tmp / "work", source, pairing=pairing)
    jtrainer, cfg = _jax_trainer(argv, toy)
    assert (cfg.stop_enabled, cfg.gradient_accumulation, cfg.steps_per_dispatch,
            cfg.reward_norm, cfg.entropy_weight) == (True, WINDOW, WINDOW, True, 0.01)
    assert (jtrainer.model.gpt_backbone is None) == (pairing == "shared")
    jtrainer.load_params_checkpoint(source)
    t_cfg, t_model_cfg = tconfig.args_to_config(tconfig.get_args(argv))
    port = build_trainer(mesh.single("cpu"), t_cfg, t_model_cfg, toy, log=False)
    entries = gpt_param_entries(port.model)
    # The graft: both packages read the same 8-action msgpack into the same
    # 9-action model (the STOP row of the head and wte keeps each one's init).
    grafted = torch_to_flax(port.model.state_dict(), port.model)
    want = jax.device_get({"params": jtrainer.state.params,
                           "batch_stats": jtrainer.state.batch_stats})
    source_tree = serialization.msgpack_restore((source / "checkpoint_best.msgpack").read_bytes())
    for path, value in _flat(grafted).items():
        source_leaf = _flat(source_tree)[path]
        overlap = tuple(slice(0, n) for n in np.shape(source_leaf))
        np.testing.assert_array_equal(np.asarray(value)[overlap],
                                      np.asarray(_flat(want)[path])[overlap])
        np.testing.assert_array_equal(np.asarray(value)[overlap], source_leaf)

    # The JAX step's rollout, detection batch and augmentation, recomputed
    # from its keys (loss_fn of reinforce.py:116-208).
    def parts(variables, batch, rng):
        env = JaxEnv(batch["image"], batch["bboxes"], cfg.patch_size, T, 1, True,
                     stop_bonus_scale=getattr(cfg, "stop_bonus_scale", 1.0))
        k_roll, k_det, k_aug = jax.random.split(rng, 3)
        ro = jtrainer._rollout_scan(variables, env, k_roll, sample=True, collect=("actions",))
        patches, targets, valid = env.get_detection_batch(k_det, cfg.max_det_patches,
                                                          sample_neg=1)
        ro = {k: ro[k] for k in ("actions", "positions", "logit_masks", "returns", "rewards")}
        return ro, (patches, targets, valid), jax_detection_augment(k_aug, patches)

    fed = {}

    def fed_rollout(model, env, sample, generator=None, collect=()):
        assert sample and collect == ("actions",)
        return fed.pop("ro")

    def fed_detection_batch(self, generator, max_patches, sample_neg=1):
        assert (max_patches, sample_neg) == (MAX_DET, 1)
        return fed.pop("det")

    def fed_augment(generator, raw):
        want_raw, augmented = fed.pop("aug")
        assert torch.equal(raw, want_raw)
        return augmented

    monkeypatch.setattr(treinforce, "rollout", fed_rollout)
    monkeypatch.setattr(treinforce.NeedleEnv, "get_detection_batch", fed_detection_batch)
    monkeypatch.setattr(treinforce, "detection_augment", fed_augment)
    window_grads = []
    opt_step = port.optimizer.step

    def recorded_step():  # the window's summed gradient, before its update
        if port.optimizer.mini_step + 1 == port.optimizer.every_k:
            grads = {k: torch.zeros_like(v) for k, v in port.model.state_dict().items()}
            grads.update({name: p.grad.clone() for name, p in port.model.named_parameters()
                          if p.grad is not None})
            window_grads.append(torch_to_flax(grads, port.model)["params"])
        return opt_step()

    monkeypatch.setattr(port.optimizer, "step", recorded_step)

    # Under float64 (jax.enable_x64) the JAX env's literal start indices are
    # int64 beside its int32 positions, which lax refuses to mix: cast a
    # slice's start indices to int32, which changes none of their values.
    int32 = lambda start: [jnp.asarray(i, jnp.int32) for i in start]
    dynamic_slice, dynamic_update_slice = jax.lax.dynamic_slice, jax.lax.dynamic_update_slice
    monkeypatch.setattr(jax.lax, "dynamic_slice", lambda x, start, sizes, **kw:
                        dynamic_slice(x, int32(start), sizes, **kw))
    monkeypatch.setattr(jax.lax, "dynamic_update_slice", lambda x, update, start, **kw:
                        dynamic_update_slice(x, update, int32(start), **kw))
    key = jax.random.PRNGKey(cfg.seed)
    work = _chunk_work(cfg, len(jtrainer.train_dataset))
    out = []
    with jax.enable_x64():
        jtrainer.model = jtrainer.model.clone(compute_dtype=jnp.float64)
        jtrainer._train_step = jtrainer._build_train_step()
        jparts = jax.jit(parts)
        state = jax.tree_util.tree_map(jnp.asarray, _tree(
            jax.device_get(jtrainer.state), np.float64))
        chunk_sums = []
        for it in range(1, N_ITERS + 1):
            if (it - 1) % WINDOW == 0:  # a chunk's keys (reinforce.py:459-470)
                key, sub = jax.random.split(key)
                step_keys = jax.random.split(sub, WINDOW)
            step_key = step_keys[(it - 1) % WINDOW]
            start = _tree(serialization.to_state_dict(jax.device_get(state)), np.float32)
            flax_to_torch({"params": start["params"], "batch_stats": start["batch_stats"]},
                          port.model)
            port.optimizer.load_state_dict(
                flax_optimizer_state(start["opt_state"], port.optimizer, entries))
            port.step = int(start["step"])
            mean, std = jtrainer.last_return_mean, jtrainer.last_return_std
            port.last_return_mean, port.last_return_std = mean, std

            indices, seed = work[it - 1]
            batch = jtrainer._build_env_batch(indices, seed, with_pixels=True)
            jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
            variables = {"params": state.params, "batch_stats": state.batch_stats}
            ro, det, aug = jax.device_get(jparts(variables, jbatch, step_key))
            fed["ro"] = {k: torch.from_numpy(np.array(
                v, np.int64 if k in ("actions", "positions") else np.float32))
                for k, v in ro.items()}
            fed["det"] = (torch.from_numpy(np.array(det[0], np.float32)),
                          torch.from_numpy(np.array(det[1], np.float32)),
                          torch.from_numpy(np.array(det[2])))
            fed["aug"] = (fed["det"][0], torch.from_numpy(np.array(aug, np.float32)))
            args = (jbatch, step_key, jnp.float32(mean), jnp.float32(std), None)
            last_grad = None
            if it % WINDOW == 0:  # the window's last micro-step's own gradient
                sd = serialization.to_state_dict(state)
                alone = dict(sd["opt_state"], mini_step=np.asarray(0, np.int32),
                             acc_grads=jax.tree_util.tree_map(np.zeros_like,
                                                              sd["opt_state"]["acc_grads"]))
                alone = serialization.from_state_dict(state, dict(sd, opt_state=alone))
                alone = jax.tree_util.tree_map(jnp.asarray, _tree(jax.device_get(alone),
                                                                  np.float64))
                last_grad = _tree(serialization.to_state_dict(jax.device_get(
                    jtrainer._train_step(alone, *args)[0].opt_state.acc_grads)), np.float64)
                acc = _tree(serialization.to_state_dict(jax.device_get(
                    state.opt_state.acc_grads)), np.float64)
            state, j_metrics = jtrainer._train_step(state, *args)
            j_metrics = jax.device_get(j_metrics)
            # The fed rollout is the step's: the same return sums.
            masks = np.asarray(ro["logit_masks"], np.float64)
            np.testing.assert_allclose(float(j_metrics["ret_count"]), masks.sum())
            np.testing.assert_allclose(float(j_metrics["ret_sum"]),
                                       (np.asarray(ro["returns"]) * masks).sum(), rtol=1e-12)
            t_metrics = port.train_step(batch)
            assert not fed
            chunk_sums.append([float(j_metrics[k]) for k in ("ret_sum", "ret_sumsq",
                                                             "ret_count")])
            if it % WINDOW == 0:  # the chunk's window update (reinforce.py:488-495)
                jtrainer._window_stats.append(tuple(np.sum(chunk_sums, axis=0)))
                jtrainer._update_return_stats()
                chunk_sums = []
            window = None
            if last_grad is not None:  # MultiSteps' running mean of 3, then the 4th
                window = (jax.tree_util.tree_map(lambda a, g: (WINDOW - 1) * a + g,
                                                 acc, last_grad), window_grads.pop())
            want = _tree(serialization.to_state_dict(jax.device_get(state)), np.float64)
            got = _tree({**torch_to_flax(port.model.state_dict(), port.model),
                         "opt_state": optimizer_to_flax(port.optimizer, entries),
                         "step": port.step}, np.float64)
            out.append(({name: (float(j_metrics[name]), float(t_metrics[name]))
                         for name in LOSS_TERMS}, want, got, window))
    assert not window_grads
    assert (jtrainer.last_return_mean, jtrainer.last_return_std) != (0.0, 1.0)
    return out


def _close_to_leaf_max(got, want, rtol, where):
    for path, value in _flat(want).items():
        value = np.asarray(value, np.float64)
        err = np.abs(np.asarray(_flat(got)[path], np.float64) - value)
        assert err.max() <= rtol * np.abs(value).max() + 1e-12, f"{where} {path}"


def _moment_tol(path, value, window_sum):
    """The tolerance of an AdamW moment leaf: MOMENT_RTOL of its largest
    value, and after an update (``window_sum``, JAX's) what the window's
    gradient tolerance can move it by through the clip: the mean's
    tolerance d = GRAD_RTOL * max|sum| / WINDOW moves the clipped mean by
    min(d, 2 CLIP), mu by (1 - b1) times that and nu by (1 - b2) times
    that times 2 CLIP."""
    tol = MOMENT_RTOL * np.abs(value).max()
    moment = [i for i, key in enumerate(path) if key in ("mu", "nu")]
    if window_sum is None or not moment:
        return tol
    i = moment[0]
    d = GRAD_RTOL * np.abs(np.asarray(_flat(window_sum)[path[i + 1:]])).max() / WINDOW
    d = min(d, 2 * CLIP)
    return tol + ((1 - BETAS[0]) * d if path[i] == "mu" else (1 - BETAS[1]) * d * 2 * CLIP)


def test_rl_finetune_trajectory_equals_jax(toy, tmp_path, monkeypatch):
    _check_trajectory(_trajectory(toy, tmp_path, monkeypatch))


def test_rl_finetune_shared_trajectory_equals_jax(toy, tmp_path, monkeypatch):
    """The recipe's default pairing: the recompute embeds on the shared
    detector backbone forward only (the fused kernels' plain versions here,
    JAX's ``stop_gradient`` there), so its backbone is trained by the
    detector's loss alone, in both packages."""
    _check_trajectory(_trajectory(toy, tmp_path, monkeypatch, pairing="shared"))


def _check_trajectory(steps):
    assert len(steps) == N_ITERS
    for it, (terms, want, got, window) in enumerate(steps, start=1):
        for name, (j, t) in terms.items():
            atol = ACTION_ATOL if name == "action_loss" else 0.0
            np.testing.assert_allclose(t, j, rtol=LOSS_RTOL, atol=atol,
                                       err_msg=f"iteration {it} {name}")
        assert got["step"] == int(want["step"]) == it
        opt_w, opt_g = want["opt_state"], got["opt_state"]
        assert int(opt_g["mini_step"]) == int(opt_w["mini_step"]) == it % WINDOW
        assert int(opt_g["gradient_step"]) == int(opt_w["gradient_step"]) == it // WINDOW
        # The window's accumulated gradient (zeros after its update).
        _close_to_leaf_max(opt_g["acc_grads"], opt_w["acc_grads"], GRAD_RTOL,
                           f"iteration {it} accumulated gradient")
        if window is not None:
            _close_to_leaf_max(window[1], window[0], GRAD_RTOL,
                               f"iteration {it} the window's summed gradient")
        else:
            assert it % WINDOW
        w, g = _flat(want), _flat(got)
        assert g.keys() == w.keys()
        flips = total = 0
        for path, value in w.items():
            value = np.asarray(value, np.float64)
            err = np.abs(np.asarray(g[path], np.float64) - value)
            where = f"iteration {it} {'/'.join(map(str, path))}"
            if path[0] == "params":  # AdamW moves a weight by about lr at most
                assert err.max() <= STEP_TOL * LR + STATE_ATOL, where
                flips, total = flips + np.sum(err > STATE_ATOL), total + err.size
            elif path[0] == "batch_stats":
                assert err.max() <= STATS_RTOL * np.abs(value).max() + STATE_ATOL, where
            elif path[0] == "opt_state" and path[1] != "acc_grads":  # AdamW moments, counts
                window_sum = None if window is None else window[0]
                assert err.max() <= _moment_tol(path, value, window_sum), where
        assert flips <= FLIP_SHARE * total, f"iteration {it}: {flips} of {total} weights"
