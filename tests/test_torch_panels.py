"""The trainers' trajectory panels, port against JAX, on the CPU.

- the port's ``visual_rng`` is the JAX trainer's (``np.random.default_rng(
  seed + 2)``): the same visual ids for the same seed and test set;
- the supervised ``eval_envs`` and the REINFORCE ``eval_on_sample``, given
  the same eval rollouts and detector outputs on both sides, build panels
  that draw the JAX package's images pixel for pixel (the model's
  trajectories and, supervised, the oracle samples), as many and of the same
  shape, beside the same metrics;
- a ``test()`` of each trainer runs the worst-images pass (``int(0.1 n)``
  panels at ``--failure-select-rate`` 0.1) and gives exactly the same
  metrics with matplotlib blocked as with it present; blocked, the logger
  receives no image and one line says so; present, ``visdom.pkl`` holds the
  image windows.

gpt-nano widths with the flagship embeddings at patch 64, episode length 5,
float32, on a toy test set of 10 images of 2 x 3 patches.
"""

import pickle
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jolineedle_tpu.train.trainer as jtrainer
from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.data.dataset import build_datasets as jax_build_datasets
from jolineedle_tpu.train import reinforce as jrl
from jolineedle_tpu.train import supervised as jsup
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.main import build_both_datasets
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.observe.logger import Logger
from jolineedle_tpu_torch.train import reinforce as trl
from jolineedle_tpu_torch.train import supervised as tsup
from jolineedle_tpu_torch.train.rollout import eval_rollout, to_numpy
from jolineedle_tpu_torch.utils.geometry import BBox, Position
from jolineedle_tpu_torch.utils.plotting import plot_model_prediction

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, T, N_TEST, N_ACTIONS = 64, 5, 10, 9
CLI = [
    "--training-mode", "supervised", "--dataset-dir", "/nonexistent",
    "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--enable-stop", "--stop-weight", "1.5", "--max-seq-len", str(T),
    "--patch-size", str(P), "--minimum-image-size", "0", "--batch-size", "4",
    "--max-det-patches", "4", "--max-boxes", "3", "--devices", "0",
    "--compute-dtype", "float32", "--dropout", "0.0", "--test-samples", "3",
    "--detector-conf-threshold", "0.3", "--seed", "4",
]
N_ANCHORS = sum((P // s) ** 2 for s in (8, 16, 32))
CONF = 0.3  # --detector-conf-threshold


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from jolineedle_tpu_torch.data.toy import generate_toy_dataset

    root = tmp_path_factory.mktemp("panels")
    generate_toy_dataset(root / "toy", n_train=3, n_test=N_TEST, image_size=(128, 192), seed=2,
                         box_size=(12, 40))
    return root


def _flags(toy, mode="supervised", extra=()):
    flags = list(CLI)
    flags[flags.index("--dataset-dir") + 1] = str(toy / "toy")
    flags[flags.index("--work-dir") + 1] = str(toy / "out")
    flags[flags.index("--training-mode") + 1] = mode
    return flags + list(extra)


def _both(toy, mode="supervised"):
    """Each package's train config and test dataset from one command line."""
    flags = _flags(toy, mode)
    j_train, j_model = args_to_config(get_args(flags))
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(flags))
    _, j_test = jax_build_datasets(
        toy / "toy", patch_size=j_model.patch_size, max_ep_len=j_model.block_size,
        min_keypoints=j_train.min_keypoints, max_keypoints=j_train.max_keypoints,
        rotations=False, translations=False, test_size=j_train.test_size,
        test_pattern=j_train.test_pattern, seed=j_train.seed, train_size=j_train.train_size,
        binomial_keypoints=j_train.binomial_keypoints,
        minimum_image_size=j_train.minimum_image_size, filter_classes=j_train.filter_classes)
    _, t_test = build_both_datasets(t_train, t_model, toy / "toy")
    return j_train, t_train, t_model, j_test, t_test


def _head(rng, k):
    xy = rng.uniform(0, P, (k, N_ANCHORS, 2))
    return {"boxes": np.concatenate([xy, rng.uniform(4, 30, (k, N_ANCHORS, 2))], -1)
            .astype(np.float32),
            "obj_logits": rng.normal(size=(k, N_ANCHORS)).astype(np.float32),
            "cls_logits": rng.normal(size=(k, N_ANCHORS, 1)).astype(np.float32)}


def _stubs(seed):
    """The batched eval helpers as seeded functions of the call: rollout
    records (logits, actions, live steps) per row and detector outputs per
    request, the same on both sides."""
    def rollouts(rows, sample_actions):
        out = []
        for i, _ in enumerate(rows):
            rng = np.random.default_rng(seed * 1000 + i)
            steps = T - 1
            out.append({
                "logits": rng.normal(size=(1, steps, N_ACTIONS)).astype(np.float32),
                "actions": rng.integers(0, 8, (1, steps)).astype(np.int64),
                "logit_masks": (np.arange(steps) < rng.integers(1, steps + 1))[None]
                .astype(np.float32),
            })
        return out

    def detections(requests):
        return [{"head": _head(np.random.default_rng(seed * 1000 + 500 + i),
                               len(r["patches"])),
                 "losses": {"total_loss": 1.5 + i % 3, "iou_loss": 0.5, "num_fg": 3.0}}
                for i, r in enumerate(requests)]
    return rollouts, detections


def _eval_trainer(module, cfg, seed):
    """A supervised trainer of ``module`` with what ``eval_envs`` reads, its
    batched helpers replaced by ``_stubs(seed)``."""
    me = module.SupervisedTrainer.__new__(module.SupervisedTrainer)
    weight = np.ones(N_ACTIONS, np.float32)
    weight[8] = cfg.stop_weight
    me.config, me.class_weight_np = cfg, weight
    me.model = SimpleNamespace(detector_conf_threshold=CONF)
    me.visual_rng = np.random.default_rng(cfg.seed + 2)
    me._batched_eval_rollouts, me._batched_patch_detections = _stubs(seed)
    return me


def _assert_same_metrics(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)


def test_visual_rng_equals_jax(toy, monkeypatch):
    """The trainers' own constructors: the same eval ids and visual picks."""
    j_train, t_train, t_model, j_test, t_test = _both(toy)
    monkeypatch.setattr(jtrainer.Trainer, "_init_state", lambda self: None)
    jt = jtrainer.Trainer(j_train, None, None, None, j_test)
    model = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu")
    tt = tsup.SupervisedTrainer(t_train, model, None, None, t_test, device="cpu")
    np.testing.assert_array_equal(tt.test_env_ids, jt.test_env_ids)
    for n in (len(tt.test_env_ids), N_TEST, 4):
        for _ in range(2):
            want = jt.visual_rng.choice(np.arange(n), size=min(6, n), replace=False)
            got = tt.visual_rng.choice(np.arange(n), size=min(6, n), replace=False)
            np.testing.assert_array_equal(got, want)


def test_supervised_panels_equal_jax(toy):
    """``eval_envs`` on the whole test set: the model's panels (first start,
    parsed targets and predictions) and the oracle samples from the first
    start (the episode's seeded generator) draw the JAX images exactly."""
    j_train, t_train, _, j_test, t_test = _both(toy)
    env_ids = list(range(N_TEST))
    j_metrics, j_images = _eval_trainer(jsup, j_train, 1).eval_envs(j_test, env_ids)
    t_metrics, t_panels = _eval_trainer(tsup, t_train, 1).eval_envs(t_test, env_ids)
    _assert_same_metrics(t_metrics, j_metrics)
    assert set(t_panels) == set(j_images) == {"model_images", "sample_images"}
    # The JAX sample panels draw the boxes of the last image of the loop
    # (``supervised.py:793-799`` reads ``boxes`` left from the episodes'
    # loop); the port's draw each image's own. The rest of the panel (the
    # oracle's trajectory from the episode's seeded generator, the image,
    # the patch grid) is held by drawing the port's panel with those boxes.
    items = [t_test.__getitem__(i, np.random.default_rng(i)) for i in env_ids]
    boxes = [np.asarray(item["bboxes"], np.float64).reshape(-1, 4) for item in items]
    last = boxes[-1]
    for key, want in j_images.items():
        assert len(t_panels[key]) == len(want) == 6, key
        for panel, image in zip(t_panels[key], want):
            if key == "sample_images":
                i = next(i for i, item in enumerate(items)
                         if np.array_equal(item["image"], panel["image"]))
                own = [[b.up_left.x, b.up_left.y, b.bottom_right.x, b.bottom_right.y]
                       for b in panel["true_bboxes"]]
                np.testing.assert_array_equal(np.asarray(own).reshape(-1, 4), boxes[i])
                panel = dict(panel, true_bboxes=[
                    BBox(Position(y=b[1], x=b[0]), Position(y=b[3], x=b[2])) for b in last])
            drawn = plot_model_prediction(**panel)
            assert drawn.shape == image.shape, key
            np.testing.assert_array_equal(drawn, image, err_msg=key)
    assert any(p["predicted_bboxes"] for p in t_panels["model_images"]), "no box drawn"


def test_reinforce_panel_equals_jax(toy):
    """``eval_on_sample`` with ``plot_traj`` on one rollout and one set of
    detector outputs: the same metrics, and the panel draws the JAX image."""
    _, _, _, j_test, t_test = _both(toy, "reinforce")
    flags = _flags(toy, "reinforce")
    j_train, _ = args_to_config(get_args(flags))
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(flags))
    torch.manual_seed(0)
    model = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu").eval()
    tt = trl.ReinforceTrainer(t_train, model, None, None, t_test, device="cpu")
    jt = jrl.ReinforceTrainer.__new__(jrl.ReinforceTrainer)
    jt.config, jt.max_ep_len, jt.stop_enabled = j_train, T, True
    jt.entropy_weight, jt.last_return_mean, jt.last_return_std = j_train.entropy_weight, 0.0, 1.0
    jt.model = SimpleNamespace(detector_conf_threshold=CONF)

    n_drawn = 0
    for idx in range(3):
        item = t_test.__getitem__(idx, np.random.default_rng(idx))
        jitem = j_test.__getitem__(idx, np.random.default_rng(idx))
        np.testing.assert_array_equal(item["image"], jitem["image"])
        boxes = np.zeros((1, t_train.max_boxes, 4), np.float32)
        b = np.asarray(item["bboxes"], np.float32).reshape(-1, 4)[: t_train.max_boxes]
        boxes[0, : len(b)] = b
        gen = torch.Generator().manual_seed(idx)
        ro = to_numpy(eval_rollout(model, torch.from_numpy(item["image"][None].copy()), boxes, t_train,
                                   generator=gen, device="cpu"))
        rng = np.random.default_rng(idx)
        batch = tt._batched_detection_batches([item])[0]
        dets = {"traj": {"head": _head(rng, T + 1)}, "batch": batch,
                "batch_det": {"head": _head(rng, len(batch[0])),
                              "losses": {"total_loss": 2.0, "num_fg": 1.0}}}
        j_metrics, image = jt.eval_on_sample(jitem, True, False, rollout=ro, dets=dets)
        t_metrics, panel = tt.eval_on_sample(item, True, False, rollout=ro, dets=dets)
        _assert_same_metrics(t_metrics, j_metrics)
        np.testing.assert_array_equal(plot_model_prediction(**panel), image)
        assert tt.eval_on_sample(item, False, False, rollout=ro, dets=dets)[1] is None
        n_drawn += len(panel["predicted_bboxes"])
    assert n_drawn > 0, "no predicted box drawn"


def _tested(toy, mode, block_matplotlib, monkeypatch, extra=()):
    """A fresh trainer of ``mode`` (the same seed and weights each time),
    with a logger, tested on the whole test set."""
    extra = ["--env-name", f"{mode}_{block_matplotlib}_{len(extra)}", *extra] + (
        ["--enable-stop"] if mode == "reinforce" else [])
    train_config, model_config = tconfig.args_to_config(tconfig.get_args(_flags(toy, mode, extra)))
    train_ds, test_ds = build_both_datasets(train_config, model_config, toy / "toy")
    torch.manual_seed(0)
    model = TorchGPT.from_config(model_config, t_actions_info(train_config), device="cpu").eval()
    cls = trl.ReinforceTrainer if mode == "reinforce" else tsup.SupervisedTrainer
    trainer = cls(train_config, model, Logger(train_config, model_config), train_ds, test_ds,
                  device="cpu")
    trainer.test_env_ids = list(range(len(test_ds)))
    handed = []
    log_eval = trainer.log_eval
    trainer.log_eval = lambda m, panels, mode: (handed.append(panels), log_eval(m, panels, mode))
    with monkeypatch.context() as mp:
        if block_matplotlib:
            mp.setitem(sys.modules, "matplotlib", None)
        trainer.test()
    return trainer, handed[0]


@pytest.mark.parametrize("mode", ["reinforce", "supervised"])
def test_test_metrics_do_not_depend_on_matplotlib(toy, mode, monkeypatch, capsys):
    with_mpl, panels = _tested(toy, mode, False, monkeypatch)
    capsys.readouterr()
    without, blocked_panels = _tested(toy, mode, True, monkeypatch)
    out = capsys.readouterr().out
    assert out.count("trajectory panels not drawn: matplotlib is not installed") == 1
    assert with_mpl.last_test_metrics.keys() == without.last_test_metrics.keys()
    for k, v in with_mpl.last_test_metrics.items():
        assert without.last_test_metrics[k] == v, k
    n_worst = int(0.1 * N_TEST)
    assert n_worst == 1
    want = {"model_images": 6, "worst_images": n_worst}
    if mode == "supervised":
        want["sample_images"] = 6
    for handed in (panels, blocked_panels):
        assert {k: len(v) for k, v in handed.items()} == want
    assert without.logger.visdom.images == {}
    windows = {"model_images": "Model predictions (test)", "worst_images": "Model failures (test)",
               "sample_images": "Generated samples (test)"}
    with open(with_mpl.checkpoint_dir / "visdom.pkl", "rb") as f:
        saved = pickle.load(f)["images"]
    assert set(saved) == {windows[k] for k in want}
    for key, n in want.items():
        grid = saved[windows[key]]
        assert grid.shape[:2] == (n, 3) and grid.dtype == np.float32


def test_supervised_worst_pass_with_a_per_episode_best_metric(toy, monkeypatch):
    """``--best-metric prop_patches_found`` has one value per episode (two
    starts per image): the worst pass ranks the images by their mean over
    the starts, also where the lowest episode is an image's second start."""
    extra = ["--best-metric", "prop_patches_found", "--failure-select-rate", "0.1"]
    passes = []
    eval_envs = tsup.SupervisedTrainer.eval_envs
    monkeypatch.setattr(tsup.SupervisedTrainer, "eval_envs", lambda self, ds, ids, **kw: (
        passes.append(list(ids)), eval_envs(self, ds, ids, **kw))[1])
    trainer, panels = _tested(toy, "supervised", False, monkeypatch, extra)
    found = np.asarray(trainer.last_test_metrics["prop_patches_found"])
    assert found.shape == (2 * N_TEST,)
    assert passes[0] == list(range(N_TEST))
    assert passes[1] == [int(np.argsort(found.reshape(N_TEST, 2).mean(axis=1))[0])]
    assert len(panels["worst_images"]) == 1

    # the lowest episode a second start, past the last image
    metrics = {"prop_patches_found": [0.5] * (2 * N_TEST)}
    metrics["prop_patches_found"][2 * 7 + 1] = 0.0
    np.testing.assert_array_equal(trainer.worst_ids(metrics, N_TEST, 2)[:1], [7])
    metrics = {"prop_patches_found": [0.5] * N_TEST + [0.0] * N_TEST}
    assert set(trainer.worst_ids(metrics, N_TEST, N_TEST // 2)) == set(range(N_TEST // 2, N_TEST))
    with pytest.raises(ValueError, match="prop_patches_found"):
        trainer.worst_ids({"prop_patches_found": [0.0] * (N_TEST + 1)}, N_TEST, 1)
