"""A run directory written by the JAX package's trainer, read by the port.

The JAX train CLI (root ``main.py``) trains one supervised iteration on a
toy dataset (gpt-nano, yolox-nano embedder and detector, patch 64, 4 steps,
8 actions: no STOP, float32, on the CPU), as ``tests/test_init_from.py``
does, and leaves ``config.json`` and flax msgpack checkpoints. Then:

- the port's reader gives flax's own tree of the best checkpoint, every
  leaf bit for bit (``opt_state`` included), and ``infer.load_model_dir``
  loads a state dict whose every leaf equals ``flax_to_torch`` of its
  params and batch statistics;
- served from that directory, the port's greedy rollout agrees with JAX's
  ``_rollout_scan`` on the same weights (positions equal, logits within
  ``LOGIT_TOL``) and the detector's outputs on the visited patches agree
  within the tolerances of ``test_torch_serve.py``; the infer CLI serves
  the directory, also with ``--detection-checkpoint``;
- ``--init-from`` that directory into a port REINFORCE ``--enable-stop``
  trainer (9 actions) equals JAX's ``load_params_only`` on the grafted
  region, and STOP keeps the port's fresh init;
- ``--detection-checkpoint`` with the JAX train state and with a
  ported-weights file written by flax loads the detector leaf for leaf as
  ``flax_to_torch`` does, in the train CLI and in ``infer``;
- the port's ``scripts/eval_checkpoint.py`` validates the directory (its
  recorded dataset, the msgpack checkpoints, best and last) as the JAX
  package's script does in this process: the same eval trajectories and
  every ``FULL-TEST`` metric within ``EVAL_TOL``, the directory left as it
  was; also on the weights as a REINFORCE run with ``--no-merge-bboxes``
  (the starts and detector batches, which each package draws from its own
  generator, replayed from JAX's);
- the port's ``scripts/eval_oracle_ceiling.py`` measures the directory's
  task ceiling as the JAX package's script does in this process: the same
  oracle trajectories and every ``ORACLE-CEILING`` value within
  ``EVAL_TOL``, the directory left as it was.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from jolineedle_tpu import checkpoint as jckpt
from jolineedle_tpu.config import args_to_config
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.train.reinforce import ReinforceTrainer as JaxReinforce
from jolineedle_tpu.train.trainer import Trainer as JaxTrainer
from jolineedle_tpu_torch import checkpoint as ckpt
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.env.oracle import gather_patches
from jolineedle_tpu_torch.infer import get_infer_args, infer, load_model_dir
from jolineedle_tpu_torch.models.bridge import flax_to_torch, yolox_flax_to_torch
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.train.reinforce import ReinforceTrainer
from jolineedle_tpu_torch.train.rollout import eval_rollout, to_numpy
from jolineedle_tpu_torch.train.trainer import Trainer as PortTrainer
from tests.test_torch_checkpoint import _same

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, T, NV, NH, B = 64, 4, 2, 3, 2
LOGIT_TOL = 1e-4  # tests/test_torch_serve.py
EVAL_TOL = 1e-4


def _cli(toy_dir, work_dir, mode, extra=()):
    return [
        "--seed", "11", "--dataset-dir", str(toy_dir), "--training-mode", mode,
        "--work-dir", str(work_dir), "--max-iters", "2", "--test-every", "1000",
        "--test-samples", "1", "--env-name", mode, "--model-type", "gpt-nano",
        "--gpt-backbone", "yolox-nano", "--image-processor", "yolox-nano",
        "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
        "--max-seq-len", str(T), "--batch-size", "2", "--dropout", "0.0",
        "--patch-size", str(P), "--minimum-image-size", "0", "--devices", "0",
        "--max-det-patches", "4", "--max-boxes", "4", "--compute-dtype", "float32",
        "--detector-conf-threshold", "0.05", *extra,
    ]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    import main as jax_main
    from jolineedle_tpu.data.toy import generate_toy_dataset

    root = tmp_path_factory.mktemp("jax_run")
    toy = generate_toy_dataset(root / "toy", n_train=4, n_test=2, image_size=(192, 256), seed=7)
    trainer = jax_main.main(jax_main.get_args(_cli(toy, root / "out", "supervised")))
    run_dir = trainer.checkpoint_dir
    best = run_dir / jckpt.CKPT_BEST
    assert best.exists() and not (run_dir / ckpt.CKPT_BEST).exists()
    raw = serialization.msgpack_restore(best.read_bytes())
    assert int(raw["step"]) == 1
    return dict(root=root, toy=toy, run_dir=run_dir, best=best, raw=raw, trainer=trainer)


def _jax_trainer(jax_run, work, mode, extra=()):
    """A JAX ReinforceTrainer (no data) of the run's flags, as ``infer.py`` builds one."""
    import main as jax_main

    train_config, model_config = args_to_config(
        jax_main.get_args(_cli(jax_run["toy"], jax_run["root"] / work, mode, extra)))
    model = JaxGPT.from_config(model_config, get_actions_info(train_config))
    return JaxReinforce(train_config, model, None, None, None)


def _variables(raw):
    return {"params": raw["params"], "batch_stats": raw["batch_stats"]}


def _fresh_port(jax_run, mode="supervised", extra=(), seed=0):
    cli = _cli(jax_run["toy"], jax_run["root"] / "port", mode, extra)
    train_config, model_config = tconfig.args_to_config(tconfig.get_args(cli))
    torch.manual_seed(seed)
    model = TorchGPT.from_config(model_config, t_actions_info(train_config), device="cpu")
    return train_config, model


def test_reader_and_load_model_dir_match_flax(jax_run):
    _same(ckpt.read_msgpack(jax_run["best"]), jax_run["raw"])
    assert "opt_state" in jax_run["raw"]
    _, _, served = load_model_dir(jax_run["run_dir"], device="cpu")
    assert served.n_actions == 8
    _, want = _fresh_port(jax_run)
    want_state = flax_to_torch(_variables(jax_run["raw"]), want)
    got_state = served.state_dict()
    assert got_state.keys() == want_state.keys()
    for key, value in want_state.items():
        torch.testing.assert_close(got_state[key], value, rtol=0, atol=0, msg=key)


def test_serving_the_jax_run_matches_jax(jax_run):
    jtrainer = jax_run["trainer"]  # its _rollout_scan and _yolox_predict take any weights
    variables = jax.tree_util.tree_map(jnp.asarray, _variables(jax_run["raw"]))

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, NV * P, NH * P, 3), dtype=np.uint8)
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[:, 0] = [10, 10, 70, 40]
    start = np.array([[0, 0], [1, 2]], np.int32)
    env = JaxEnv(jnp.asarray(images), jnp.asarray(boxes), P, T, 1, False)
    jro = jax.device_get(jtrainer._rollout_scan(variables, env, jax.random.PRNGKey(0),
                                                sample=False, collect=("logits", "actions"),
                                                positions=jnp.asarray(start)))

    t_train, _, model = load_model_dir(jax_run["run_dir"], device="cpu")
    tro = to_numpy(eval_rollout(model, images, boxes, t_train, positions=torch.from_numpy(start),
                                device="cpu", collect=("logits", "actions")))
    logits = np.sort(jro["logits"], axis=-1)
    assert (logits[..., -1] - logits[..., -2]).min() > 10 * LOGIT_TOL, "a near-tie"
    np.testing.assert_allclose(tro["logits"], jro["logits"], atol=LOGIT_TOL, rtol=0)
    for name in ("actions", "positions", "masks"):
        np.testing.assert_array_equal(tro[name], jro[name], err_msg=name)

    for b in range(B):
        patches = gather_patches(images[b], tro["positions"][b], P)
        want = jax.device_get(jtrainer._yolox_predict(variables, jnp.asarray(patches)))
        with torch.no_grad():
            got = model.yolox_outputs(torch.from_numpy(patches))[0]
        for name in ("boxes", "obj_logits", "cls_logits"):
            np.testing.assert_allclose(got[name].numpy(), want[name], atol=2e-4, rtol=1e-3,
                                       err_msg=name)


def test_init_from_the_jax_run_matches_jax_graft(jax_run, capsys):
    extra = ["--enable-stop", "--init-from", str(jax_run["run_dir"])]
    train_config, model = _fresh_port(jax_run, "reinforce", extra, seed=5)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = ReinforceTrainer(train_config, model, None, None, None, device="cpu")
    trainer.load_params_checkpoint(jax_run["run_dir"])
    assert "grafted overlap (8, 48)" in capsys.readouterr().out

    jrl = _jax_trainer(jax_run, "jrl", "reinforce", ["--enable-stop"])
    state = jckpt.load_params_only(jax_run["best"], jrl.state)
    _, want_model = _fresh_port(jax_run, "reinforce", extra)
    want = flax_to_torch(jax.device_get({"params": state.params,
                                         "batch_stats": state.batch_stats}), want_model)
    got = model.state_dict()
    grown = ("wte.weight", "action_head.dense.weight")
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key in grown:  # the 8 moves grafted, STOP (row 8) the fresh init of each package
            torch.testing.assert_close(got[key][:8], value[:8], rtol=0, atol=0, msg=key)
            torch.testing.assert_close(got[key][8], fresh[key][8], rtol=0, atol=0, msg=key)
        else:
            torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)


def _yolox_state(raw_yolox, seed=9):
    """``yolox_flax_to_torch`` of a YOLOX subtree into a fresh port detector."""
    torch.manual_seed(seed)
    from jolineedle_tpu_torch.models.yolox import NeedleYOLOX

    return yolox_flax_to_torch(raw_yolox, NeedleYOLOX("yolox-nano", device="cpu"))


def test_detection_checkpoint_loads_like_flax_to_torch(jax_run, tmp_path):
    raw = jax_run["raw"]
    # a ported-weights file (scripts/port_yolox_weights.py's layout), by flax,
    # with other values than the run's, so a load is seen
    ported = jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.5 + 0.25,
                                    {"params": raw["params"]["yolox"],
                                     "batch_stats": raw["batch_stats"]["yolox"]})
    ported_path = tmp_path / "ported.msgpack"
    ported_path.write_bytes(serialization.msgpack_serialize(ported))
    for path, yolox in ((jax_run["best"], {"params": raw["params"]["yolox"],
                                           "batch_stats": raw["batch_stats"]["yolox"]}),
                        (ported_path, ported)):
        _, model = _fresh_port(jax_run, seed=3)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        ckpt.load_detection_params(path, model)
        want = _yolox_state(yolox)
        for key, value in want.items():
            torch.testing.assert_close(model.yolox.state_dict()[key], value, rtol=0, atol=0,
                                       msg=key)
        for key, value in model.state_dict().items():
            if not key.startswith("yolox."):
                torch.testing.assert_close(value, before[key], rtol=0, atol=0, msg=key)

    # infer: the JAX run served with the ported detector
    from PIL import Image

    image = Image.open(sorted((jax_run["toy"] / "images").iterdir())[0])
    image.save(tmp_path / "img.png")
    (tmp_path / "img.txt").write_text("0 10 10 70 40\n")
    (tmp_path / "list.txt").write_text("img.png img.txt\n")
    metrics = infer(get_infer_args(["--model-dir", str(jax_run["run_dir"]), "--dataset",
                                    str(tmp_path / "list.txt"), "--detection-checkpoint",
                                    str(ported_path)]), device="cpu")
    assert "map" in metrics and all(np.isfinite(v[0]) for v in metrics.values())
    t_train, _, model = load_model_dir(jax_run["run_dir"], "cpu", str(ported_path))
    assert t_train.detection_enabled
    for key, value in _yolox_state(ported).items():
        torch.testing.assert_close(model.yolox.state_dict()[key], value, rtol=0, atol=0)

    # the train CLI: no iteration (--max-iters 1), the final test, the loaded detector
    from jolineedle_tpu_torch.main import main as train_main

    cli = _cli(jax_run["toy"], tmp_path / "out", "supervised",
               ["--detection-checkpoint", str(ported_path)])
    cli[cli.index("--max-iters") + 1] = "1"
    trainer = train_main(tconfig.get_args(cli), device="cpu")
    assert trainer.step == 0
    for key, value in _yolox_state(ported).items():
        torch.testing.assert_close(trainer.model.yolox.state_dict()[key], value, rtol=0, atol=0)


def _jax_eval_checkpoint(run_dir, which, work_dir, merge_bboxes=None):
    """What the JAX package's ``scripts/eval_checkpoint.py`` does, in this
    process, with the trainer's work dir under ``work_dir`` in place of the
    script's fixed one: the mean metrics it prints."""
    import main as jax_main
    from jolineedle_tpu.config import config_from_file
    from jolineedle_tpu.parallel.mesh import replicate
    from jolineedle_tpu.train.supervised import SupervisedTrainer as JaxSupervised

    train_config, model_config = config_from_file(run_dir / "config.json")
    train_ds, test_ds = jax_main.build_both_datasets(train_config, model_config,
                                                     train_config.dataset_dir)
    model = JaxGPT.from_config(model_config, get_actions_info(train_config))
    cls = JaxReinforce if train_config.training_mode == "reinforce" else JaxSupervised
    train_config.work_dir = str(work_dir)
    train_config.env_name = run_dir.name + "_eval"
    if merge_bboxes is not None:
        train_config.merge_bboxes = merge_bboxes
    trainer = cls(train_config, model, None, train_ds, test_ds)
    name = jckpt.CKPT_BEST if which == "best" else jckpt.CKPT_LAST
    trainer.state = replicate(trainer.mesh,
                              jckpt.load_params_only(run_dir / name, trainer.state))
    trainer.test_env_ids = list(range(len(test_ds)))
    trainer.test()
    return {k: float(np.mean(v)) for k, v in trainer.last_test_metrics.items()}


def _recorded_rollouts(monkeypatch, trainer_class):
    """Every eval rollout ``trainer_class``'s trainers run from now on, in order."""
    out = []
    rollouts = trainer_class._batched_eval_rollouts

    def recorded(self, rows, sample_actions):
        got = rollouts(self, rows, sample_actions)
        out.extend(got)
        return got

    monkeypatch.setattr(trainer_class, "_batched_eval_rollouts", recorded)
    return out


def _port_eval_checkpoint(argv, capsys):
    """The port's script on the CPU: its printed metrics, checked against
    its return value, and its output."""
    import json

    from jolineedle_tpu_torch.scripts import eval_checkpoint

    capsys.readouterr()
    got = eval_checkpoint.main(argv, device="cpu")
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("FULL-TEST: ")][-1]
    assert json.loads(line[len("FULL-TEST: "):]) == got
    return got, out


def _assert_same_trajectories(got, want):
    """The port's eval rollouts took JAX's trajectories (positions, live
    steps and, where recorded, actions), so the metrics compare the same
    episodes. A failure names the smallest gap between JAX's two highest
    logits where they are recorded: below ``10 * LOGIT_TOL`` it is a near-tie
    that float32 rounding may flip, not a fault of the port."""
    assert len(got) == len(want) > 0
    for i, (t, j) in enumerate(zip(got, want)):
        gap = "not recorded"
        if "logits" in j:
            top = np.sort(np.asarray(j["logits"]), axis=-1)
            live = np.asarray(j["logit_masks"]) > 0
            gap = (top[..., -1] - top[..., -2])[live].min(initial=np.inf)
        keys = [k for k in ("positions", "masks", "actions", "logit_masks") if k in j]
        assert "positions" in keys and all(k in t for k in keys), (i, keys)
        for key in keys:
            np.testing.assert_array_equal(np.asarray(t[key]), np.asarray(j[key]),
                                          err_msg=f"rollout {i} {key}, smallest top-2 logit gap {gap}")


def _assert_metrics_match_jax(got, want):
    """Every metric of the full test within ``EVAL_TOL``: the same actions
    and detections on both sides, the losses summed in float32 in another
    order."""
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, rtol=EVAL_TOL, atol=EVAL_TOL, err_msg=name)


@pytest.mark.parametrize("which", ["best", "last"])
def test_eval_checkpoint_validates_the_jax_run(jax_run, which, tmp_path, monkeypatch, capsys):
    run_dir = jax_run["run_dir"]
    before = {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in run_dir.iterdir()}
    port_rollouts = _recorded_rollouts(monkeypatch, PortTrainer)
    got, out = _port_eval_checkpoint([str(run_dir), "--ckpt", which], capsys)
    name = jckpt.CKPT_BEST if which == "best" else jckpt.CKPT_LAST
    assert f"loading {run_dir / name}" in out
    jax_rollouts = _recorded_rollouts(monkeypatch, JaxTrainer)
    want = _jax_eval_checkpoint(run_dir, which, tmp_path)
    _assert_same_trajectories(port_rollouts, jax_rollouts)
    _assert_metrics_match_jax(got, want)
    assert {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in run_dir.iterdir()} == before


def test_eval_checkpoint_override_on_a_reinforce_run_matches_jax(jax_run, tmp_path, monkeypatch,
                                                                 capsys):
    """The run's weights as a REINFORCE run that merges boxes (its
    config.json with ``training_mode`` reinforce and ``merge_bboxes``),
    validated with ``--no-merge-bboxes``: the JAX script's metrics under the
    same override. The REINFORCE eval draws its start positions and its
    detector batches' positive patches (at most ``--max-det-patches``) from
    each package's own generator, so the port's are replayed from JAX's."""
    import json
    import shutil

    run_dir = tmp_path / "rl_run"
    shutil.copytree(jax_run["run_dir"], run_dir)
    config = json.loads((run_dir / "config.json").read_text())
    config["train"].update(training_mode="reinforce", merge_bboxes=True)
    (run_dir / "config.json").write_text(json.dumps(config))
    jax_rollouts = _recorded_rollouts(monkeypatch, JaxTrainer)
    jax_det_batches = []
    det_batches = JaxReinforce._batched_detection_batches
    monkeypatch.setattr(JaxReinforce, "_batched_detection_batches", lambda self, items: (
        jax_det_batches.append(det_batches(self, items)) or jax_det_batches[-1]))
    want = _jax_eval_checkpoint(run_dir, "best", tmp_path, merge_bboxes=False)

    def replay_jax(merge):
        starts = [np.asarray(ro["positions"])[:, 0] for ro in jax_rollouts]
        batches = list(jax_det_batches)
        seen = set()

        def from_jax_starts(self, images, boxes, rows, generator, sample_actions):
            positions = np.concatenate([starts.pop(0) for _ in rows])
            return eval_rollout(self.model, torch.from_numpy(images), boxes, self.config,
                                sample=sample_actions, generator=generator, device=self.device,
                                positions=torch.from_numpy(positions))

        def from_jax_batches(self, items):
            out = batches.pop(0)
            assert len(out) == len(items)
            seen.add(self.config.merge_bboxes)
            return out

        with monkeypatch.context() as mp:
            mp.setattr(PortTrainer, "_dispatch_eval_rollout", from_jax_starts)
            mp.setattr(ReinforceTrainer, "_batched_detection_batches", from_jax_batches)
            port_rollouts = _recorded_rollouts(mp, PortTrainer)
            got, _ = _port_eval_checkpoint([str(run_dir)] + (
                [] if merge else ["--no-merge-bboxes"]), capsys)
        assert not starts and not batches
        assert seen == {merge}
        return got, port_rollouts

    got, port_rollouts = replay_jax(merge=False)
    _assert_same_trajectories(port_rollouts, jax_rollouts)
    _assert_metrics_match_jax(got, want)
    replay_jax(merge=True)  # without the override, the test merges as the run did


def _jax_oracle_ceiling(run_dir, which, work_dir, dataset_dir):
    """What the JAX package's ``scripts/eval_oracle_ceiling.py`` does, in
    this process, with the trainer's work dir under ``work_dir`` in place of
    the script's fixed one: the numbers it prints, and the visited
    positions of each episode."""
    import main as jax_main
    from jolineedle_tpu.config import config_from_file
    from jolineedle_tpu.env.oracle import OracleEnv
    from jolineedle_tpu.parallel.mesh import replicate
    from jolineedle_tpu.train.supervised import SupervisedTrainer as JaxSupervised

    train_config, model_config = config_from_file(run_dir / "config.json")
    train_ds, test_ds = jax_main.build_both_datasets(train_config, model_config, dataset_dir)
    model = JaxGPT.from_config(model_config, get_actions_info(train_config))
    train_config.work_dir = str(work_dir)
    train_config.env_name = run_dir.name + "_oracle"
    trainer = JaxSupervised(train_config, model, None, train_ds, test_ds)
    name = jckpt.CKPT_BEST if which == "best" else jckpt.CKPT_LAST
    trainer.state = replicate(trainer.mesh,
                              jckpt.load_params_only(run_dir / name, trainer.state))
    cfg = trainer.config
    T = cfg.test_max_seq_len
    n_actions = get_actions_info(train_config)[0].nclasses
    episodes = []
    for loop_id in range(len(test_ds)):
        item = test_ds.__getitem__(loop_id, np.random.default_rng(loop_id))
        boxes = np.asarray(item["bboxes"], np.float64).reshape(-1, 4)
        env = OracleEnv(item["image"].shape[:2], cfg.patch_size, boxes,
                        np.random.default_rng(loop_id))
        env.reset(None)
        start = env.position
        acts = []
        for _ in range(T - 1):
            a = JaxSupervised.optimal_next_action(env)
            acts.append(a.value)
            env.step(a)
        fake_rollout = {"actions": np.array(acts, np.int32)[None],
                        "logits": np.zeros((1, T - 1, n_actions), np.float32),
                        "logit_masks": np.ones((1, T - 1), np.float32)}
        env.reset(start)
        episodes.append((env, trainer._replay_episode(item, env, fake_rollout, T)))
    dets = trainer._batched_patch_detections([rep["det_request"] for _, rep in episodes])
    maps, props, stopped, ep_len = [], [], [], []
    for (env, rep), det in zip(episodes, dets):
        sample, metrics, bboxes = trainer._finish_episode(rep, det)
        maps.append(trainer._per_patch_map(env, [sample], [bboxes])["map"])
        props.append(metrics["prop_patches_found"])
        stopped.append(metrics["stopped_inside_bbox"])
        ep_len.append(metrics["episode_length"])
    return {"n_images": len(episodes), "ep_len": float(np.mean(ep_len)),
            "map": float(np.mean(maps)), "prop_patches_found": float(np.mean(props)),
            "stopped_inside_bbox": float(np.mean(stopped)), "dataset_dir": str(dataset_dir),
            "ckpt": which}, [rep["visited"] for _, rep in episodes]


def test_oracle_ceiling_measures_the_jax_run_as_jax_does(jax_run, tmp_path, monkeypatch,
                                                         capsys):
    import json

    from jolineedle_tpu_torch.scripts import eval_oracle_ceiling
    from jolineedle_tpu_torch.train.supervised import SupervisedTrainer

    run_dir = jax_run["run_dir"]
    before = {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in run_dir.iterdir()}
    visited = []
    replay = SupervisedTrainer._replay_episode

    def recorded(self, *args):
        rep = replay(self, *args)
        visited.append(rep["visited"])
        return rep

    monkeypatch.setattr(SupervisedTrainer, "_replay_episode", recorded)
    capsys.readouterr()
    got = eval_oracle_ceiling.main([str(run_dir), "--dataset-dir", str(jax_run["toy"])],
                                   device="cpu")
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("ORACLE-CEILING: ")]
    assert len(line) == 1 and json.loads(line[0][len("ORACLE-CEILING: "):]) == got
    assert f"loading {run_dir / jckpt.CKPT_BEST}" in out
    want, want_visited = _jax_oracle_ceiling(run_dir, "best", tmp_path, jax_run["toy"])
    assert got.keys() == want.keys()
    assert (got["n_images"], got["ep_len"], got["dataset_dir"], got["ckpt"]) == (
        want["n_images"], want["ep_len"], want["dataset_dir"], want["ckpt"]) == (
        2, float(T), str(jax_run["toy"]), "best")
    assert len(visited) == len(want_visited) == 2
    for a, b in zip(visited, want_visited):
        np.testing.assert_array_equal(a, b)
    for name in ("map", "prop_patches_found", "stopped_inside_bbox"):
        np.testing.assert_allclose(got[name], want[name], rtol=EVAL_TOL, atol=EVAL_TOL,
                                   err_msg=name)
    assert got["prop_patches_found"] > 0  # the oracle walks onto the boxes
    assert {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in run_dir.iterdir()} == before
