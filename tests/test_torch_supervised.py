"""The supervised slice of the port against the JAX package, on the CPU.

- the oracle (``env/oracle.py``: ``generate_sample``,
  ``detection_patch_positions``, ``optimal_next_action``) and the batch
  assembly (``train/batching.py``) give exactly the JAX arrays for the same
  ``np.random.Generator``, in both loss modes, with STOP enabled;
- ``action_ce_metrics`` (tensors) and ``action_ce_metrics_np`` against
  JAX's;
- the eval's host stages (``_replay_episode``, ``_finish_episode``,
  ``_per_patch_map``) give the JAX metrics on one rollout record and one
  detector head;
- the train CLI with ``--training-mode supervised`` end to end on a toy
  dataset: 2 iterations, the test, the checkpoint files with ``map`` as the
  best metric, and a resume.

The train step's loss, gradients and BN statistics are held against JAX in
``tests/test_torch_supervised_loss.py``. gpt-nano widths with the flagship
embeddings at patch 64, ``--max-seq-len`` 5, float32.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.data.dataset import build_datasets as jax_build_datasets
from jolineedle_tpu.env import oracle as joracle
from jolineedle_tpu.train import batching as jbatching
from jolineedle_tpu.train import supervised as jsup
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env import oracle as toracle
from jolineedle_tpu_torch.train import batching as tbatching
from jolineedle_tpu_torch.train import supervised as tsup

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, T = 64, 5
CLI = [
    "--training-mode", "supervised", "--dataset-dir", "/nonexistent",
    "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--enable-stop", "--stop-weight", "1.5", "--max-seq-len", str(T),
    "--patch-size", str(P), "--minimum-image-size", "0", "--batch-size", "3",
    "--max-det-patches", "4", "--max-boxes", "3", "--devices", "0",
    "--compute-dtype", "float32", "--dropout", "0.0", "--test-samples", "2",
]


def _flags(data_dir, work_dir, extra=()):
    flags = list(CLI)
    flags[flags.index("--dataset-dir") + 1] = str(data_dir)
    flags[flags.index("--work-dir") + 1] = str(work_dir)
    return flags + list(extra)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from jolineedle_tpu_torch.data.toy import generate_toy_dataset

    root = tmp_path_factory.mktemp("sup")
    generate_toy_dataset(root / "toy", n_train=5, n_test=2, image_size=(128, 192), seed=0,
                         box_size=(12, 40))
    return root


def _datasets(toy, extra):
    """Each package's (train, test) datasets and train config from one
    command line."""
    from jolineedle_tpu_torch.main import build_both_datasets

    flags = _flags(toy / "toy", toy / "out", extra)
    j_train, j_model = args_to_config(get_args(flags))
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(flags))
    jds = jax_build_datasets(
        toy / "toy", patch_size=j_model.patch_size, max_ep_len=j_model.block_size,
        min_keypoints=j_train.min_keypoints, max_keypoints=j_train.max_keypoints,
        rotations=j_train.rotations, translations=j_train.translations,
        test_size=j_train.test_size, test_pattern=j_train.test_pattern, seed=j_train.seed,
        train_size=j_train.train_size, binomial_keypoints=j_train.binomial_keypoints,
        minimum_image_size=j_train.minimum_image_size, filter_classes=j_train.filter_classes)
    tds = build_both_datasets(t_train, t_model, toy / "toy")
    return jds, tds, j_train, t_train


def _assert_same_arrays(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("loss_mode,keypoints", [
    ("on-optimal-trajectory", ["--min-keypoints", "1", "--max-keypoints", "2"]),
    ("on-self-trajectory", ["--min-keypoints", "0", "--max-keypoints", "3",
                            "--binomial-keypoints"]),
])
def test_supervised_batch_equals_jax(toy, loss_mode, keypoints):
    """``build_supervised_batch`` on the same dataset files, indices and
    seed: every array equal, the rotate/translate augmentations drawn from
    the same generator, with and without the pixels; STOP is on and never
    a label."""
    extra = ["--loss", loss_mode, "--augment-rotate", "--augment-translate"] + keypoints
    (j_train_ds, _), (t_train_ds, _), j_cfg, t_cfg = _datasets(toy, extra)
    assert t_cfg.stop_enabled and t_cfg.loss_mode == loss_mode
    indices = [0, 3, 1, 4, 2, 0]
    want = jbatching.build_supervised_batch(j_train_ds, indices, j_cfg,
                                            np.random.default_rng(7))
    got = tbatching.build_supervised_batch(t_train_ds, indices, t_cfg, np.random.default_rng(7))
    _assert_same_arrays(got, want)
    assert got["patches"].shape == (len(indices), T, P, P, 3)
    assert got["patches"].dtype == np.uint8 and got["patches"].any()
    assert (got["next_actions"] != 8).all() and got["yolox_valid"].any()
    if loss_mode == "on-self-trajectory":
        assert not np.array_equal(got["reference_actions"], got["next_actions"])
    # the device pool's batch: no pixels, the same episodes, the augmentations
    want = jbatching.build_supervised_batch(j_train_ds, indices, j_cfg,
                                            np.random.default_rng(7), with_pixels=False)
    no_px = tbatching.build_supervised_batch(t_train_ds, indices, t_cfg,
                                             np.random.default_rng(7), with_pixels=False)
    _assert_same_arrays(no_px, want)
    assert {"aug_rot", "aug_shift", "base_hw", "image_idx"} <= set(no_px)
    assert set(got) - set(no_px) == {"patches", "patches_yolox"}


def _world(seed, hw=(4 * P, 5 * P)):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 4))
    xy = rng.integers(0, (hw[1] - 50, hw[0] - 50), (n, 2))
    wh = rng.integers(8, 120, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, (hw[1] - 1, hw[0] - 1))], 1).astype(
        np.float64), hw


@pytest.mark.parametrize("seed", range(8))
def test_oracle_equals_jax(seed):
    """``generate_sample`` (from a random or given start, with a visited
    set, with tail truncation), ``detection_patch_positions`` (capped and
    not) and ``optimal_next_action`` give the JAX values, and leave both
    generators in the same state."""
    boxes, hw = _world(seed)
    envs = [mod.OracleEnv(hw, P, boxes, np.random.default_rng(seed))
            for mod in (joracle, toracle)]
    position = None if seed % 2 else (seed % 4, seed % 5)
    visited = {(0, 0)} if seed % 3 == 0 else None
    samples = [mod.generate_sample(env, max_ep_len=3 + seed, min_keypoints=seed % 3,
                                   max_keypoints=2 + seed % 3, binomial_keypoints=seed % 2 == 0,
                                   position=position, visited=visited, max_boxes=3)
               for mod, env in zip((joracle, toracle), envs)]
    _assert_same_arrays(samples[1], samples[0])
    for cap in (None, 2, 5):
        want, got = (mod.detection_patch_positions(env, cap)
                     for mod, env in zip((joracle, toracle), envs))
        _assert_same_arrays(dict(zip("pv", got)), dict(zip("pv", want)))
    for env in envs:
        env.reset((1, 2))
    want = jsup.SupervisedTrainer.optimal_next_action(envs[0])
    got = tsup.SupervisedTrainer.optimal_next_action(envs[1])
    assert got.value == want.value
    assert envs[0].rng.integers(1 << 30) == envs[1].rng.integers(1 << 30)


def test_action_ce_metrics_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 6, 9)) * 3).astype(np.float32)
    targets = rng.integers(0, 9, (3, 6)).astype(np.int32)
    targets[0, :3] = 8
    masks = (rng.random((3, 6)) < 0.7).astype(np.float32)
    weight = np.ones(9, np.float32)
    weight[8] = 2.5
    want = jsup.action_ce_metrics(jnp.asarray(logits), jnp.asarray(targets),
                                  jnp.asarray(masks), jnp.asarray(weight))
    got = tsup.action_ce_metrics(torch.from_numpy(logits), torch.from_numpy(targets),
                                 torch.from_numpy(masks), torch.from_numpy(weight))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), abs=1e-6, rel=1e-6)
    want_np = jsup.action_ce_metrics_np(logits, targets, masks, weight)
    got_np = tsup.action_ce_metrics_np(logits, targets, masks, weight)
    np.testing.assert_allclose(got_np, want_np, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_np, [float(w) for w in want], rtol=1e-6, atol=1e-6)
    # an all-padding batch has loss and accuracy 0, not NaN
    zero = tsup.action_ce_metrics(torch.from_numpy(logits), torch.from_numpy(targets),
                                  torch.zeros(3, 6), torch.from_numpy(weight))
    assert [float(z) for z in zero] == [0.0, 0.0]


def _eval_self(module, cfg, weight):
    """The attributes the eval's host stages read from their trainer."""
    return SimpleNamespace(config=cfg, class_weight_np=weight,
                           model=SimpleNamespace(detector_conf_threshold=0.3),
                           optimal_next_action=module.SupervisedTrainer.optimal_next_action)


def test_eval_host_stages_equal_jax(toy):
    """On one image, two rollout records (logits, actions, live steps) and
    one detector head per episode: the replays, the episodes' metrics and
    boxes, and the one- and two-start mAP equal the JAX trainer's."""
    (_, j_test), (_, t_test), j_cfg, t_cfg = _datasets(toy, [])
    item = t_test.__getitem__(0, np.random.default_rng(0))
    boxes = np.asarray(item["bboxes"], np.float64).reshape(-1, 4)
    weight = np.ones(9, np.float32)
    weight[8] = 1.5
    rng = np.random.default_rng(3)
    steps = T - 1
    records = []
    for n_live in (steps, 2):
        records.append({
            "logits": rng.normal(size=(1, steps, 9)).astype(np.float32),
            "actions": rng.integers(0, 8, (1, steps)).astype(np.int64),
            "logit_masks": (np.arange(steps) < n_live)[None].astype(np.float32),
        })
    n_anchors = sum((P // s) ** 2 for s in (8, 16, 32))

    def head(seed):
        r = np.random.default_rng(seed)
        xy = r.uniform(0, P, (T, n_anchors, 2))
        return {"boxes": np.concatenate([xy, r.uniform(4, 30, (T, n_anchors, 2))], -1)
                .astype(np.float32),
                "obj_logits": r.normal(size=(T, n_anchors)).astype(np.float32),
                "cls_logits": r.normal(size=(T, n_anchors, 1)).astype(np.float32)}

    dets = [{"head": head(i), "losses": {"total_loss": 1.5 + i, "iou_loss": 0.5,
                                         "num_fg": 3.0}} for i in range(2)]
    results = []
    for module, oracle, cfg in ((jsup, joracle, j_cfg), (tsup, toracle, t_cfg)):
        me = _eval_self(module, cfg, weight)
        cls = module.SupervisedTrainer
        env = oracle.OracleEnv(item["image"].shape[:2], P, boxes, np.random.default_rng(0))
        starts = [(0, 0), (1, 2)]
        reps, samples, metrics, outs = [], [], [], []
        for start, ro, det in zip(starts, records, dets):
            env.reset(start)
            rep = cls._replay_episode(me, item, env, ro, cfg.test_max_seq_len)
            sample, m, bb = cls._finish_episode(me, rep, det)
            reps.append(rep), samples.append(sample), metrics.append(m), outs.append(bb)
        maps = [cls._per_patch_map(me, env, samples[:n], outs[:n]) for n in (1, 2)]
        results.append((reps, samples, metrics, outs, maps))

    (j_reps, j_samples, j_metrics, j_outs, j_maps), (t_reps, t_samples, t_metrics, t_outs,
                                                       t_maps) = results
    for jr, tr in zip(j_reps, t_reps):
        assert jr["true_actions"] == tr["true_actions"] and jr["labels"] == tr["labels"]
        np.testing.assert_array_equal(np.stack(tr["pred_logits"]), np.stack(jr["pred_logits"]))
        _assert_same_arrays({k: v for k, v in tr["det_request"].items()},
                            jr["det_request"])
        _assert_same_arrays({k: tr[k] for k in ("visited", "patches", "local_bboxes")},
                            {k: jr[k] for k in ("visited", "patches", "local_bboxes")})
    for jm, tm in zip(j_metrics, t_metrics):
        assert tm.keys() == jm.keys()
        for k in jm:
            assert tm[k] == pytest.approx(jm[k], rel=1e-6, abs=1e-6), k
    for jo, to in zip(j_outs, t_outs):
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5)
    assert any(o is not None for o in t_outs[0]), "no box passed the threshold"
    assert t_maps == j_maps
    assert t_metrics[0]["episode_length"] == T and t_metrics[1]["episode_length"] == 3


def test_train_cli_supervised_trains_tests_and_resumes_on_cpu(toy):
    """``main`` with ``--training-mode supervised`` on the CPU: 2 iterations
    (``--max-iters 3``, as the JAX loop counts) with gradient accumulation 2
    (one update), the final test; the checkpoint files with ``map`` as the
    best metric; both optimizer groups, the embedder's and the detector's
    BN statistics moved; then a resumed run takes one more iteration from
    the saved optimizer state and generator. Both runs train from the device
    pool (``auto``, then ``on``)."""
    from jolineedle_tpu_torch.checkpoint import load_train_state
    from jolineedle_tpu_torch.env.actions import get_actions_info
    from jolineedle_tpu_torch.main import main
    from jolineedle_tpu_torch.models.gpt import GPT

    flags = _flags(toy / "toy", toy / "out", [
        "--gradient-accumulation", "2", "--max-iters", "3", "--test-every", "1000",
        "--seed", "1", "--env-name", "cli", "--dropout", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(tconfig.get_args(flags))  # the GPU unless the caller asks for the CPU
    trainer = main(tconfig.get_args(flags), device="cpu")
    run_dir = toy / "out" / "cli"
    assert isinstance(trainer, tsup.SupervisedTrainer)
    assert trainer.step == 2 and trainer.optimizer.updates == 1
    assert trainer.pool is not None  # --device-data-cache auto: the toy set fits
    assert {"config.json", "checkpoint.pt", "checkpoint_best.pt", "train_state.pt",
            "metrics.json", "best_model.txt", "visdom.pkl"} <= {p.name for p in run_dir.iterdir()}
    assert "map:" in (run_dir / "best_model.txt").read_text()
    metrics = trainer.last_train_metrics
    assert np.isfinite([float(v) for v in metrics.values()]).all()
    assert {"action_loss", "action_accuracy", "yolo_total_loss", "loss"} <= set(metrics)
    tested = trainer.last_test_metrics
    assert {"map", "map_multistart_2", "supervised_action_loss", "supervised_map",
            "prop_patches_found_traj"} <= set(tested)
    assert len(tested["map"]) == len(trainer.test_dataset)

    torch.manual_seed(1)
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(flags))
    init = GPT.from_config(t_model, get_actions_info(t_train), device="cpu").state_dict()
    trained = torch.load(run_dir / "checkpoint.pt", weights_only=True)
    moved = lambda pred: any(not torch.equal(init[k], v) for k, v in trained.items() if pred(k))
    for prefix in ("h.", "gpt_backbone_net.", "yolox.head.", "yolox.backbone."):
        assert moved(lambda k: k.startswith(prefix) and "running" not in k), prefix
    for prefix in ("gpt_backbone_net.", "yolox."):
        assert moved(lambda k: k.startswith(prefix) and k.endswith("running_var")), prefix
    state = load_train_state(run_dir)
    assert state["step"] == 2 and state["optimizer"]["updates"] == 1
    assert torch.equal(state["generator"], trainer.generator.get_state())

    resumed = main(tconfig.get_args(flags + ["--resume-training", str(run_dir),
                                             "--max-iters", "2", "--device-data-cache", "on"]),
                   device="cpu")
    assert resumed.step == 3 and resumed.pool is not None
    assert (resumed.optimizer.updates, resumed.optimizer.mini_step) == (1, 1)
