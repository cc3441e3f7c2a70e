"""The port's training recipes (``jolineedle_tpu_torch/scripts/run_*.sh``)
against the JAX package's (``scripts/run_*.sh``).

- Each port recipe is the JAX script with ``python -m
  jolineedle_tpu_torch.main`` in place of ``python main.py``: the ``exec``
  lines of both files give the same flags in the same order, and every
  other line of code is the same but ``DATASET_DIR``'s default (the port's
  ``make_toyds_big`` writes ``toyds_big`` in the working directory).
- The flagship recipe's schedule: the port's ``lr_at`` at every update of
  the 20,000, for both groups, against the learning rate the JAX package's
  optax ``adamw`` applies (``make_optimizer`` of the recipe's flags, read
  from its update of a unit parameter at weight decay 1), within
  ``LR_RTOL``.
- Twelve iterations of the supervised recipe at a small size (the default
  yolox-nano pairing, gpt-nano, patch 64, B = 2, float32, dropout 0, no
  translate, warmup 3 of 12 updates: the run crosses into the cosine
  decay): at each, the JAX package's jitted train step (in float64) and
  the port's ``train_step`` from the JAX state the iteration starts from,
  on the same batch, the JAX run's photometric augmentations replayed into
  the port: the loss terms within ``LOSS_RTOL``, then the weights, the BN
  running statistics and the AdamW moments and counts against JAX's.
- Each recipe runs end to end on the CPU (``JOLINEEDLE_TORCH_DEVICE=cpu``,
  ``MAX_ITERS`` 2 on a small toy set; the fine-tune from the flagship's
  run) and leaves the run directory's files and the final validation's
  metrics; ``time_recipe.pace`` reads a run's pace and tests, and
  ``--stop-after-tests`` ends a run after its first tests; ``sup_probe``
  runs the flagship recipe's own flags.

The trajectory's helpers (``_jax_trainer`` … ``_check_trajectory``) also
serve ``test_torch_shared_recipe_parity.py``.
"""

import json
import os
import re
import shlex
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

import main as jax_main
from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.ops.augment import detection_augment as jax_detection_augment
from jolineedle_tpu.ops.augment import to_unit_float
from jolineedle_tpu.train.batching import build_supervised_batch
from jolineedle_tpu.train.optim import make_optimizer
from jolineedle_tpu.train.supervised import SupervisedTrainer as JaxSupervised
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.main import build_trainer
from jolineedle_tpu_torch.checkpoint import flax_optimizer_state, optimizer_to_flax
from jolineedle_tpu_torch.models.bridge import flax_to_torch, gpt_param_entries, torch_to_flax
from jolineedle_tpu_torch.parallel import mesh
from jolineedle_tpu_torch.scripts import make_toyds_big, time_recipe
from jolineedle_tpu_torch.train import supervised as tsup
from jolineedle_tpu_torch.train.optim import Optimizer, lr_at

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RECIPES = ("run_sup_flagship.sh", "run_rl_finetune_stop.sh", "run_rl_scratch_stop.sh")
JAX_ENTRY = ["python", "main.py"]
PORT_ENTRY = ["python", "-m", "jolineedle_tpu_torch.main"]
DATASET_LINE = "DATASET_DIR=${DATASET_DIR:-%s}"
LR_RTOL = 1e-6
LOSS_RTOL = 1e-3
# After each step, from the same state (measured over the 12: 2.7e-4, 1.6e-2,
# 0.73 lr and 0.7 %): BN statistics and AdamW moments within a share of their
# leaf's largest value; every weight within STEP_TOL learning rates of JAX's,
# and all but FLIP_SHARE of them within STATE_ATOL.
STATS_RTOL, MOMENT_RTOL, STEP_TOL, FLIP_SHARE, STATE_ATOL = 1e-3, 3e-2, 1.0, 2e-2, 1e-6
N_ITERS = 12
LOSS_TERMS = ("loss", "action_loss", "yolo_loss", "yolo_iou_loss", "yolo_conf_loss",
              "yolo_cls_loss", "yolo_l1_loss")


def _code(path: Path) -> list:
    """The script's lines of code: continuations joined, comments and blank
    lines dropped."""
    lines = re.sub(r"\\\n", " ", path.read_text()).splitlines()
    return [" ".join(line.split()) for line in lines
            if line.strip() and not line.strip().startswith("#")]


def _exec_args(lines: list) -> list:
    (line,) = [line for line in lines if line.startswith("exec ")]
    return shlex.split(line)[1:]


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_passes_the_jax_scripts_flags(name):
    jax_code = _code(ROOT / "scripts" / name)
    port_code = _code(ROOT / "jolineedle_tpu_torch" / "scripts" / name)
    jax_args, port_args = _exec_args(jax_code), _exec_args(port_code)
    assert jax_args[:2] == JAX_ENTRY and port_args[:3] == PORT_ENTRY
    assert port_args[3:] == jax_args[2:]
    assert "--dataset-dir" in port_args and "$DATASET_DIR" in port_args
    # Every other line alike, but the dataset's default directory.
    (jax_line,) = [line for line in jax_code if line.startswith("DATASET_DIR=")]
    jax_prefix, jax_suffix = DATASET_LINE.split("%s")
    assert jax_line.startswith(jax_prefix + "/") and jax_line.endswith("/toyds_big" + jax_suffix)
    assert DATASET_LINE % make_toyds_big.get_args([]).out_dir in port_code
    rest = lambda code: [line for line in code
                         if not line.startswith(("exec ", "DATASET_DIR="))]
    assert rest(port_code) == rest(jax_code)


def _recipe_argv(name: str, values: dict, drop=()) -> list:
    """The recipe's flags with its shell variables set to ``values``."""
    args = _exec_args(_code(ROOT / "jolineedle_tpu_torch" / "scripts" / name))[3:]
    out = []
    for arg in args:
        if arg in drop:
            continue
        value = re.sub(r"\$(\w+)", lambda m: values[m.group(1)], arg)
        # An unquoted variable splits into words, as sh splits it.
        out += value.split() if arg.startswith("$") else [value]
    return out


FLAGSHIP = {"SEED": "1", "DATASET_DIR": "/nonexistent", "WORK_DIR": "/nonexistent",
            "MAX_ITERS": "20000", "DETECTOR": "yolox-s", "SPD": "1",
            "BACKBONE_FLAGS": "--image-processor yolox-s --gpt-backbone yolox-nano"}


def test_flagship_schedule_equals_optax_over_20000_updates():
    argv = _recipe_argv("run_sup_flagship.sh", FLAGSHIP)
    j_cfg, _ = args_to_config(get_args(argv))
    t_cfg, _ = tconfig.args_to_config(tconfig.get_args(argv))
    assert (t_cfg.lr_warmup_iters, t_cfg.lr_decay_iters) == (500, 20000)
    n = t_cfg.lr_decay_iters + 1  # updates 0 .. 20,000: warmup, decay and its end

    # JAX: the lr each update applies, from adamw's update of a unit
    # parameter with a zero gradient at weight decay 1 (-lr * (0 + 1 * 1)).
    params = {"h": jnp.ones((1,), jnp.float32), "yolox": jnp.ones((1,), jnp.float32)}
    tx = make_optimizer(params, learning_rate=j_cfg.learning_rate, yolo_lr=j_cfg.yolo_lr,
                        weight_decay=1.0, lr_schedule=j_cfg.lr_schedule,
                        lr_warmup_iters=j_cfg.lr_warmup_iters,
                        lr_decay_iters=j_cfg.lr_decay_iters)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)

    def body(state, _):
        updates, state = tx.update(zeros, state, params)
        return state, (-updates["h"][0], -updates["yolox"][0])

    _, (gpt_lr, yolo_lr) = jax.jit(lambda s: jax.lax.scan(body, s, None, length=n))(
        tx.init(params))

    # The port: the optimizer of the same flags sets each group's lr by lr_at.
    model = torch.nn.ModuleDict({"h": torch.nn.Linear(1, 1), "yolox": torch.nn.Linear(1, 1)})
    opt = Optimizer(model, t_cfg.learning_rate, t_cfg.yolo_lr, lr_schedule=t_cfg.lr_schedule,
                    lr_warmup_iters=t_cfg.lr_warmup_iters, lr_decay_iters=t_cfg.lr_decay_iters)
    groups = {g["label"]: g["base_lr"] for g in opt.adamw.param_groups}
    assert groups == {"gpt": 2e-4, "yolox": 1e-4}
    for label, want in (("gpt", gpt_lr), ("yolox", yolo_lr)):
        got = np.array([lr_at(groups[label], u, *opt.schedule) for u in range(n)])
        want = np.asarray(want, np.float64)
        assert want[0] == 0 and want[500] == pytest.approx(groups[label], rel=1e-6)
        assert want[-1] == pytest.approx(0.05 * groups[label], rel=1e-6)
        np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0, err_msg=label)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipes")
    return make_toyds_big.make_toyds_big(root / "toy", n_train=4, n_test=2)


def _trajectory_argv(toy: Path, work: Path, n_iters: int = N_ITERS,
                     drop=("--augment-translate",)) -> list:
    """The recipe's flags for ``n_iters`` iterations of the shared yolox-nano
    pairing at a small size: B = 2, float32, dropout 0, warmup 3 updates,
    without the flags in ``drop``."""
    values = {**FLAGSHIP, "DATASET_DIR": str(toy), "WORK_DIR": str(work),
              "MAX_ITERS": str(n_iters + 1), "BACKBONE_FLAGS": "--image-processor yolox-nano",
              "DETECTOR": "yolox-nano"}
    return _recipe_argv("run_sup_flagship.sh", values, drop=drop) + [
        "--batch-size", "2", "--compute-dtype", "float32", "--dropout", "0.0",
        "--lr-warmup-iters", "3", "--devices", "0"]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): v})
    return out


def _tree(tree, dtype):
    """A copy of a train state's tree (numpy leaves) with its floating
    leaves in ``dtype``: the host views of a state share its buffers, which
    the JAX step donates and the port's step updates in place."""
    return jax.tree_util.tree_map(
        lambda x: np.array(x, dtype) if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.array(x), tree)


def _jax_trainer(argv: list, toy: Path) -> JaxSupervised:
    """The JAX package's supervised trainer of ``argv`` on ``toy``."""
    j_cfg, j_model_cfg = args_to_config(get_args(argv))
    j_train, j_test = jax_main.build_both_datasets(j_cfg, j_model_cfg, toy)
    return JaxSupervised(j_cfg, JaxGPT.from_config(j_model_cfg, get_actions_info(j_cfg)),
                         None, j_train, j_test)


def _port_trainer(argv: list, toy: Path):
    t_cfg, t_model_cfg = tconfig.args_to_config(tconfig.get_args(argv))
    return build_trainer(mesh.single("cpu"), t_cfg, t_model_cfg, toy, log=False)


def _jax_iterations(jtrainer: JaxSupervised, n_iters: int):
    """The JAX loop's picks and keys (supervised.py:285-297, :360-368): for
    each iteration, (it, the batch's indices, its rng seed, the step's key)."""
    cfg = jtrainer.config
    order_rng = np.random.default_rng(cfg.seed)
    key = jax.random.PRNGKey(cfg.seed)
    index_pool = []
    for it in range(1, n_iters + 1):
        while len(index_pool) < cfg.batch_size:
            index_pool += order_rng.permutation(len(jtrainer.train_dataset)).tolist()
        indices, index_pool = index_pool[:cfg.batch_size], index_pool[cfg.batch_size:]
        key, step_key = jax.random.split(key)
        yield it, indices, cfg.seed + 1 + it, step_key


def _replay_augments(monkeypatch):
    """Replays the JAX step's photometric augmentations into the port's
    ``train_step``. Returns ``stage(batch, step_key)``, which queues the
    patches that JAX's step augments from ``step_key`` (decision, then
    detector); the port's step then checks its raw patches against the
    batch's and takes JAX's augmented ones. ``stage`` returns the queue,
    which the port's step empties."""
    replay = []

    def replayed(generator, raw):
        want_raw, augmented = replay.pop(0)
        assert torch.equal(raw, torch.from_numpy(want_raw))
        return torch.from_numpy(augmented)

    monkeypatch.setattr(tsup, "detection_augment", replayed)
    augment = jax.jit(lambda k, x: jax_detection_augment(k, to_unit_float(x)))

    def stage(batch, step_key):
        k_aug1, k_aug2, _ = jax.random.split(step_key, 3)
        replay[:] = [(batch[name], np.asarray(augment(k, batch[name]), np.float32))
                     for name, k in (("patches", k_aug1), ("patches_yolox", k_aug2))]
        return replay

    return stage


def _host_state(state, dtype) -> dict:
    """A JAX train state as a flax state dict of numpy leaves in ``dtype``."""
    return _tree(serialization.to_state_dict(jax.device_get(state)), dtype)


def _load_port(port, start: dict, entries) -> None:
    """Loads a JAX train state's dict (weights, statistics, AdamW moments
    and counts, step) into the port's trainer, as ``--resume-training``
    loads a JAX train state."""
    flax_to_torch({"params": start["params"], "batch_stats": start["batch_stats"]}, port.model)
    port.optimizer.load_state_dict(flax_optimizer_state(start["opt_state"], port.optimizer,
                                                        entries))
    port.step = int(start["step"])


def _port_state(port, entries) -> dict:
    """The port trainer's state as a flax state dict of float64 leaves."""
    return _tree({**torch_to_flax(port.model.state_dict(), port.model),
                  "opt_state": optimizer_to_flax(port.optimizer, entries),
                  "step": port.step}, np.float64)


def _f64_step(jtrainer: JaxSupervised) -> None:
    """Makes the JAX trainer's model and jitted step compute in float64
    (under ``jax.enable_x64``)."""
    jtrainer.model = jtrainer.model.clone(compute_dtype=jnp.float64)
    jtrainer._train_step = jtrainer._build_train_step()


def _trajectory(toy: Path, argv: list, monkeypatch, pool: bool = False,
                jtrainer: JaxSupervised = None) -> list:
    """The iterations of ``argv`` (``--max-iters`` - 1) of the JAX trainer's
    step, in float64, and at each one the port's ``train_step`` of ``argv``
    from the JAX state that the iteration starts from (``_load_port``), on
    the same batch and the same augmented patches (``_replay_augments``).
    With ``pool``, the port trains from its device pool on the batch's
    pixel-free twin (``build_batch``), so its gathers must give JAX's host
    patches. ``jtrainer``: a JAX trainer of the same schedule and data whose
    step ``_f64_step`` made float64 (by default one built from ``argv``).
    Returns, per iteration, the loss terms (JAX, port) and the states after
    it (JAX's, the port's), as flax state dicts."""
    port = _port_trainer(argv, toy)
    if jtrainer is None:
        jtrainer = _jax_trainer(argv, toy)
        _f64_step(jtrainer)
    j_cfg = jtrainer.config
    n_iters = j_cfg.max_iters - 1
    assert (j_cfg.lr_schedule, j_cfg.lr_decay_iters) == ("cosine", port.config.lr_decay_iters)
    assert j_cfg.translations == port.train_dataset.translations
    if pool:
        port.pool = port.build_pool()
        assert port.pool is not None
    entries = gpt_param_entries(port.model)
    stage = _replay_augments(monkeypatch)
    out = []
    with jax.enable_x64():
        state = jax.tree_util.tree_map(jnp.asarray, _tree(
            jax.device_get(jtrainer.state), np.float64))
        for it, indices, seed, step_key in _jax_iterations(jtrainer, n_iters):
            _load_port(port, _host_state(state, np.float32), entries)
            batch = build_supervised_batch(jtrainer.train_dataset, indices, j_cfg,
                                           np.random.default_rng(seed))
            port_batch = port.build_batch(indices, seed) if pool else batch
            assert ("patches" in port_batch) != pool
            replay = stage(batch, step_key)
            state, j_metrics = jtrainer._train_step(
                state, jax.tree_util.tree_map(jnp.asarray, batch), step_key, None)
            t_metrics = port.train_step(port_batch)
            assert not replay
            out.append(({name: (float(j_metrics[name]), float(t_metrics[name]))
                         for name in LOSS_TERMS}, _host_state(state, np.float64),
                        _port_state(port, entries)))
    return out


def test_supervised_trajectory_equals_jax(toy, tmp_path, monkeypatch):
    """The JAX reference runs in float64 (``jax.enable_x64`` and a float64
    compute dtype on the same weights), as ``test_torch_supervised_loss.py``
    holds the loss; the port in float32. Each iteration starts the port
    from the JAX state (a free-running float32 run cannot be held: AdamW's
    first updates move every weight by about the learning rate along the
    sign of its gradient, and the gradients that float32 leaves uncertain
    in sign, about 150 of 1.0 M at 1e-4 of their leaf's largest, turn into
    steps of opposite sign; from the first update at the full rate SimOTA
    assigns other anchors and the runs part, by 0.2 % at iteration 4 and
    10-30 % after, also between the float64 port and JAX)."""
    argv = _trajectory_argv(toy, tmp_path)
    assert "--augment-translate" not in argv
    steps = _trajectory(toy, argv, monkeypatch)
    assert len(steps) == N_ITERS
    _check_trajectory(steps)


def _check_trajectory(steps: list) -> None:
    """Holds each iteration's loss terms and state (``_trajectory``'s
    output) against JAX's: the terms within ``LOSS_RTOL``; every weight
    within ``STEP_TOL`` learning rates of JAX's (the cosine schedule of
    ``len(steps)`` iterations, warmup 3), all but ``FLIP_SHARE`` of them
    within ``STATE_ATOL``; the BN statistics and AdamW moments within a
    share of their leaf's largest value."""
    for it, (terms, want, got) in enumerate(steps, start=1):
        for name, (j, t) in terms.items():
            np.testing.assert_allclose(t, j, rtol=LOSS_RTOL, atol=0,
                                       err_msg=f"iteration {it} {name}")
        assert got["step"] == int(want["step"]) == it
        w, g = _flat(want), _flat(got)
        assert g.keys() == w.keys()
        lr = lr_at(2e-4, it - 1, "cosine", 3, len(steps) + 1)
        flips = total = 0
        for path, value in w.items():
            value = np.asarray(value, np.float64)
            err = np.abs(np.asarray(g[path], np.float64) - value)
            where = f"iteration {it} {'/'.join(map(str, path))}"
            if path[0] == "params":  # AdamW moves a weight by about lr at most
                assert err.max() <= STEP_TOL * lr + STATE_ATOL, where
                flips, total = flips + np.sum(err > STATE_ATOL), total + err.size
            elif path[0] == "batch_stats":
                assert err.max() <= STATS_RTOL * np.abs(value).max() + STATE_ATOL, where
            else:  # the AdamW moments and counts
                assert err.max() <= MOMENT_RTOL * np.abs(value).max(), where
        assert flips <= FLIP_SHARE * total, f"iteration {it}: {flips} of {total} weights"


def _run_recipe(name: str, args: list, tmp: Path, env: dict) -> subprocess.CompletedProcess:
    """``sh`` the port's recipe ``name`` with ``args`` on the CPU
    (``JOLINEEDLE_TORCH_DEVICE=cpu``), this interpreter as its ``python``."""
    bin_dir = tmp / "bin"
    bin_dir.mkdir(exist_ok=True)
    (bin_dir / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    (bin_dir / "python").chmod(0o755)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
           "PYTHONPATH": str(ROOT), "JOLINEEDLE_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
           **env}
    proc = subprocess.run(["sh", str(ROOT / "jolineedle_tpu_torch" / "scripts" / name), *args],
                          cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "peak device memory" not in proc.stdout  # the CPU has none
    return proc


RUN_FILES = {"config.json", "checkpoint.pt", "checkpoint_best.pt", "train_state.pt",
             "metrics.json", "best_model.txt", "visdom.pkl"}


def _final_metrics(run_dir: Path, names) -> dict:
    assert {p.name for p in run_dir.iterdir()} >= RUN_FILES
    metrics = json.loads((run_dir / "metrics.json").read_text())
    for name in names:
        assert 0.0 <= metrics[name] <= 1.0, name
    return metrics


@pytest.fixture(scope="module")
def flagship_run(toy, tmp_path_factory):
    """``SEED=3 sh run_sup_flagship.sh <dir> yolox-s 1 2``: one iteration,
    then the final validation from the last checkpoint (no test ran before
    it)."""
    tmp = tmp_path_factory.mktemp("flagship")
    proc = _run_recipe("run_sup_flagship.sh", [str(tmp / "out"), "yolox-s", "1", "2"], tmp,
                       {"DATASET_DIR": str(toy), "SEED": "3"})
    return proc, tmp / "out" / "r3_sup_yolox-s"


def test_flagship_recipe_runs_end_to_end_on_cpu(flagship_run):
    proc, run_dir = flagship_run
    assert "Could not reload best checkpoint for final test" in proc.stdout
    config = json.loads((run_dir / "config.json").read_text())
    assert config["train"]["seed"] == 3 and config["train"]["batch_size"] == 16
    assert config["model"]["image_processor"] == "yolox-s"
    metrics = _final_metrics(run_dir, ("map", "map_multistart_2", "supervised_map",
                                       "prop_patches_found"))
    assert metrics["episode_length"] == 8.0


def test_rl_finetune_recipe_runs_from_the_flagship_run(toy, flagship_run, tmp_path):
    """``run_rl_finetune_stop.sh <dir> <flagship run> yolox-s 2`` with
    ``EXTRA_FLAGS``: the 8-action supervised weights grafted into the
    9-action STOP model, two REINFORCE iterations in float32, the final
    validation."""
    _, sup_dir = flagship_run
    proc = _run_recipe("run_rl_finetune_stop.sh",
                       [str(tmp_path / "out"), str(sup_dir), "yolox-s", "2"], tmp_path,
                       {"DATASET_DIR": str(toy), "EXTRA_FLAGS": "--compute-dtype float32"})
    assert f"Warm-starting params from {sup_dir}/checkpoint_best.pt" in proc.stdout
    assert "grafted overlap (8, 48)" in proc.stdout
    run_dir = tmp_path / "out" / "r3_rlft_yolox-s"
    config = json.loads((run_dir / "config.json").read_text())
    assert config["train"]["compute_dtype"] == "float32" and config["train"]["stop_enabled"]
    _final_metrics(run_dir, ("map", "prop_patches_found", "stop_used"))


def test_rl_scratch_recipe_runs_end_to_end_on_cpu(toy, tmp_path):
    """``run_rl_scratch_stop.sh <dir> 2``: two from-scratch REINFORCE
    iterations with STOP, the final validation."""
    _run_recipe("run_rl_scratch_stop.sh", [str(tmp_path / "out"), "2"], tmp_path,
                {"DATASET_DIR": str(toy)})
    _final_metrics(tmp_path / "out" / "r3_scratch_stop", ("map", "prop_patches_found"))


# A recipe prints its loss every 256 iterations (at the end of the chunk that
# holds it). The supervised flagship tests every 2,500 iterations, at 0.08 s
# an iteration: the test at 2,500 falls between 2,304 and 2,560, that at
# 5,000 between 4,864 and 5,120, 7.5 and 3.25 s late from there on. The
# REINFORCE fine-tune trains in chunks of 4 and tests every 1,000 (the 9
# tests before its 10,000th iteration, each 1.5 s and 0.1 s more than the last).
PACE_RUNS = {
    "supervised": (2500, 20, 0.08, [7.5, 3.25]),
    "reinforce": (1000, 39, 0.075, [1.5 + 0.1 * k for k in range(9)]),
}


@pytest.mark.parametrize("mode", sorted(PACE_RUNS))
def test_time_recipe_reads_the_pace_between_tests(mode):
    """``time_recipe.pace``: the median seconds an iteration over the spans
    between printed iterations that hold no test, and each test's excess."""
    test_every, n_prints, s_iter, tests = PACE_RUNS[mode]
    stamps = []
    for k in range(1, n_prints + 1):
        it = 256 * k
        late = sum(s for j, s in enumerate(tests, start=1) if it > j * test_every)
        stamps.append((it, 10.0 + s_iter * it + late))
    out = time_recipe.pace(stamps, test_every)
    assert out["s_per_iter"] == pytest.approx(s_iter)
    assert out["s_per_iter_spans"] == n_prints - 1 - len(tests)
    assert out["test_s"] == pytest.approx(tests)


@pytest.mark.parametrize("detector", ["yolox-nano", "yolox-s"])
def test_sup_probe_runs_the_recipes_flags(detector):
    """``sup_probe.recipe_argv`` reads ``run_sup_flagship.sh``'s flags as the
    script passes them, for either pairing."""
    from jolineedle_tpu_torch.scripts import sup_probe

    values = {**FLAGSHIP, "DETECTOR": detector,
              "BACKBONE_FLAGS": sup_probe.backbone_flags(detector)}
    want = _recipe_argv("run_sup_flagship.sh", values)
    assert sup_probe.recipe_argv(values) == want
    assert ("--gpt-backbone" in want) == (detector != "yolox-nano")


def test_time_recipe_stops_after_tests(tmp_path, monkeypatch):
    """``time_recipe --stop-after-tests 1`` reads each test's metrics from
    the CLI's printed JSON and ends the command after the first test."""
    monkeypatch.setattr(time_recipe, "query_gpu", lambda fields: (
        ["1980 MHz"] if fields == "clocks.max.sm" else ["FAKE GPU, 700.00 W"]))
    monkeypatch.setattr(time_recipe, "SAMPLE_EVERY_S", 600.0)
    test = {"map": 0.25, "map_multistart_2": 0.5, "supervised_map": 0.75, "loss": 1.0}
    script = (f"import json, time\nprint('iter 256: loss 1.0')\n"
              f"for _ in range(2):\n    print(json.dumps({test!r}, indent=4), flush=True)\n"
              f"    time.sleep(60)\n")
    start = time.monotonic()
    out = time_recipe.main(["--log", str(tmp_path / "log.txt"), "--stop-after-tests", "1",
                            "--", sys.executable, "-c", script])
    assert time.monotonic() - start < 30
    assert out["tests"] == [{k: test[k] for k in time_recipe.TEST_KEYS}]
    assert out["rc"] != 0 and out["card"] == "FAKE GPU, 700.00 W"


def test_export_flax_run_writes_the_runs_weights(flagship_run, tmp_path):
    """``export_flax_run`` writes a JAX run directory of the flagship run:
    each msgpack restores (flax's codec) to the ``.pt`` file's weights and
    statistics, and the config takes the dtype and dataset asked for."""
    from jolineedle_tpu_torch import checkpoint as ckpt
    from jolineedle_tpu_torch.config import config_from_file
    from jolineedle_tpu_torch.env.actions import get_actions_info
    from jolineedle_tpu_torch.models.gpt import GPT
    from jolineedle_tpu_torch.scripts import export_flax_run

    _, run_dir = flagship_run
    out = tmp_path / "jax_run"
    written = export_flax_run.main([str(run_dir), str(out), "--compute-dtype", "float32",
                                    "--dataset-dir", "/elsewhere"])
    assert [p.name for p in written] == [ckpt.FLAX_BEST, ckpt.FLAX_LAST]
    train_config, model_config = config_from_file(out / "config.json")
    assert (train_config.compute_dtype, model_config.compute_dtype) == ("float32", "float32")
    assert train_config.dataset_dir == "/elsewhere"
    for pt, msgpack in export_flax_run.EXPORTS:
        model = GPT.from_config(model_config, get_actions_info(train_config), device="cpu")
        ckpt.load_model_file(model, run_dir / pt)
        want = _flat(_tree(torch_to_flax(model.state_dict(), model), np.float32))
        got = _flat(_tree(serialization.msgpack_restore((out / msgpack).read_bytes()),
                          np.float32))
        assert got.keys() == want.keys()
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value, err_msg=str(path))
