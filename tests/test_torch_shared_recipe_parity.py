"""The supervised recipe's step in the shared yolox-nano pairing (the
recipes' default: the detector's own backbone embeds the decision patches)
against the JAX package's, in the settings that
``test_torch_recipes.py::test_supervised_trajectory_equals_jax`` leaves out:
the recipe's bfloat16 compute dtype, its own data route
(``--augment-translate`` and the device pool), and the port's own
photometric augmentation, which the trajectories replace by JAX's.

Both cases run ``N_ITERS`` iterations of the recipe's flags at a small size
(gpt-nano, yolox-nano shared, patch 64, B = 2, ``--max-seq-len 8``, dropout
0, warmup 3 updates), start each iteration from the JAX state, and replay
JAX's augmented patches into the port (``test_torch_recipes``' helpers).
They share one JAX trainer (``jax_run``), so JAX's float64 step is compiled
once for both.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu.ops.augment import detection_augment as jax_detection_augment
from jolineedle_tpu.ops.augment import to_unit_float
from jolineedle_tpu.train.batching import build_supervised_batch
from jolineedle_tpu_torch.models.bridge import gpt_param_entries, torch_to_flax
from jolineedle_tpu_torch.scripts import make_toyds_big
from jolineedle_tpu_torch.train import supervised as tsup
from jolineedle_tpu_torch.train.optim import lr_at

from test_torch_recipes import (LOSS_TERMS, STATE_ATOL, STEP_TOL, _check_trajectory, _f64_step,
                                _flat, _host_state, _jax_iterations, _jax_trainer, _load_port,
                                _port_state, _port_trainer, _replay_augments, _trajectory,
                                _trajectory_argv, _tree)

# The suite runs in several test processes that share the cores.
torch.set_num_threads(1)

N_ITERS = 3
# bf16 against float64: the port's distance at most BF16_FACTOR times JAX
# bf16's, plus an atol (see the test's docstring).
BF16_FACTOR = 2.0
LOSS_ATOL_SHARE, STATS_ATOL, WEIGHT_ATOL_LR, FLIP_SHARE = 2.0 ** -8, 1e-6, 0.1, 2e-2
AUG_RTOL = 0.03
# Shares of images or pixels, rare events: absolute tolerances.
AUG_ATOL = {"gray": 0.02, "at_0": 0.002, "at_1": 0.005}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("shared_recipe")
    return make_toyds_big.make_toyds_big(root / "toy", n_train=4, n_test=2)


def _argv(toy: Path, work: Path, dtype: str) -> list:
    """The recipe's flags, ``--augment-translate`` kept, on the device pool."""
    return _trajectory_argv(toy, work, N_ITERS, drop=()) + [
        "--device-data-cache", "on", "--compute-dtype", dtype]


@pytest.fixture(scope="module")
def jax_run(toy, tmp_path_factory):
    """The JAX trainer of the bf16 flags with its bf16 step and model kept
    aside, then its step made float64 (``_f64_step``)."""
    jtrainer = _jax_trainer(_argv(toy, tmp_path_factory.mktemp("jax"), "bfloat16"), toy)
    assert jtrainer.config.translations
    bf16 = jtrainer._train_step, jtrainer.model
    _f64_step(jtrainer)
    return jtrainer, bf16


def _decision_stats_fn(model):
    """The running statistics that the JAX step's decision forward leaves
    (``supervised.py:138-151``): with a shared detector only its backbone
    has BatchNorm there (``gpt.py:246-263``), run in train mode on the
    step's augmented decision patches in the compute dtype."""

    def backbone(module, flat):
        return module.yolox.backbone(flat.astype(module.compute_dtype), True)

    def run(params, batch_stats, batch, step_key):
        k_aug1, _, _ = jax.random.split(step_key, 3)
        patches = jax_detection_augment(k_aug1, to_unit_float(batch["patches"]))
        flat = patches.reshape((-1,) + patches.shape[2:])
        _, mut = model.apply({"params": params, "batch_stats": batch_stats}, flat,
                             method=backbone, mutable=["batch_stats"])
        return mut["batch_stats"]

    return jax.jit(run)


def _bf16_steps(toy: Path, work: Path, monkeypatch, jax_run) -> list:
    """``N_ITERS`` iterations of the JAX step in bfloat16; at each, from the
    state it starts from and on the same batch and augmented patches, the
    port's bfloat16 ``train_step`` and the JAX step in float64. Returns per
    iteration a dict of run (``jax``: JAX bf16, ``port``, ``f64``) -> (the
    loss terms, the BN statistics after the decision forward, the state
    after the step)."""
    jtrainer, (step_bf16, model_bf16) = jax_run
    step_f64, cfg = jtrainer._train_step, jtrainer.config
    port = _port_trainer(_argv(toy, work, "bfloat16"), toy)
    assert port.model.compute_dtype == torch.bfloat16
    entries = gpt_param_entries(port.model)
    stage = _replay_augments(monkeypatch)
    decision, seen = tsup.decision_loss, []

    def watched(model, *args, **kw):
        out = decision(model, *args, **kw)
        seen.append(_tree(torch_to_flax(model.state_dict(), model)["batch_stats"], np.float64))
        return out

    monkeypatch.setattr(tsup, "decision_loss", watched)
    stats_bf16, stats_f64 = _decision_stats_fn(model_bf16), _decision_stats_fn(jtrainer.model)
    # A copy: the bf16 step donates its state, and the fixture's stays for
    # the other case.
    state = jax.tree_util.tree_map(jnp.asarray, _tree(jax.device_get(jtrainer.state),
                                                      np.float32))
    out = []
    for it, indices, seed, step_key in _jax_iterations(jtrainer, N_ITERS):
        start = _host_state(state, np.float32)
        batch = build_supervised_batch(jtrainer.train_dataset, indices, cfg,
                                       np.random.default_rng(seed))
        with jax.enable_x64():
            s64 = jax.tree_util.tree_map(jnp.asarray, _tree(jax.device_get(state), np.float64))
            b64 = jax.tree_util.tree_map(jnp.asarray, batch)
            d64 = _tree(stats_f64(s64.params, s64.batch_stats, b64, step_key), np.float64)
            s64, m64 = step_f64(s64, b64, step_key, None)
            f64 = ({n: float(m64[n]) for n in LOSS_TERMS}, d64, _host_state(s64, np.float64))
        _load_port(port, start, entries)
        replay = stage(batch, step_key)
        t_metrics = port.train_step(batch)
        assert not replay
        ported = ({n: float(t_metrics[n]) for n in LOSS_TERMS}, seen.pop(),
                  _port_state(port, entries))
        dev = jax.tree_util.tree_map(jnp.asarray, batch)
        d16 = _tree(stats_bf16(state.params, state.batch_stats, dev, step_key), np.float64)
        state, j_metrics = step_bf16(state, dev, step_key, None)
        out.append({"jax": ({n: float(j_metrics[n]) for n in LOSS_TERMS}, d16,
                            _host_state(state, np.float64)),
                    "port": ported, "f64": f64})
    return out


def _leaf_distances(steps, index: int, root) -> dict:
    """Per leaf of item ``index`` of each run (under the path prefix
    ``root``, or every leaf), over the iterations: the root mean square of
    the port's and of JAX bf16's distances from float64, the port's and
    JAX's largest distance in learning rates, and the counts of the port's
    and JAX's elements off by more than ``STATE_ATOL`` and of all elements."""
    sums = {}
    for it, runs in enumerate(steps, start=1):
        lr = lr_at(2e-4, it - 1, "cosine", 3, N_ITERS + 1)
        port, jax_, ref = (_flat(runs[k][index]) for k in ("port", "jax", "f64"))
        for path, value in ref.items():
            if root is not None and path[0] != root:
                continue
            value = np.asarray(value, np.float64)
            t = np.abs(np.asarray(port[path], np.float64) - value)
            j = np.abs(np.asarray(jax_[path], np.float64) - value)
            acc = sums.setdefault(path, np.zeros(7))
            acc += [np.sum(t * t), np.sum(j * j), 0.0, 0.0, np.sum(t > STATE_ATOL),
                    np.sum(j > STATE_ATOL), value.size]
            if lr:
                acc[2:4] = np.maximum(acc[2:4], [t.max() / lr, j.max() / lr])
    return {path: (np.sqrt(t2 / n), np.sqrt(j2 / n), t_lr, j_lr, t_off, j_off, n)
            for path, (t2, j2, t_lr, j_lr, t_off, j_off, n) in sums.items()}


def test_bf16_step_no_further_from_float64_than_jax(toy, tmp_path, monkeypatch, jax_run):
    """The recipe's bfloat16 step (``config.py``'s default dtype, every run
    on the card) against JAX's bfloat16 step, both against JAX's float64
    step from the same state: a cast that sits elsewhere than in JAX (the
    conv outputs, BN and SiLU in float32, the head's float32 concatenations,
    ``_layer_norm`` before ``ln_f``, the SimOTA loss) shows up as the port
    drifting further from float64 than JAX does. Each iteration starts from
    the JAX bf16 state. Each distance is pooled over the ``N_ITERS``
    iterations; the port's is at most ``BF16_FACTOR`` (2) times JAX bf16's
    plus an atol:

    - each loss term: the sum of its absolute distances, atol
      ``LOSS_ATOL_SHARE`` (2^-8, one bf16 step) of the sum of its float64
      values (one iteration's term is one draw: at this size bf16 moves
      SimOTA's assignment, and a term with it by up to 30 %, in JAX as in
      the port);
    - each BN statistics leaf, after the decision forward (the shared
      backbone's; ``tsup.decision_loss`` watched) and after the step (the
      detector forward's): the root mean square distance, atol
      ``STATS_ATOL`` (1e-6);
    - each weight leaf after the update: the root mean square distance,
      atol ``WEIGHT_ATOL_LR`` (0.1) of the largest learning rate; and the
      bounds of ``test_supervised_trajectory_equals_jax`` scaled to bf16,
      where AdamW's early steps reach past one learning rate and most of
      their signs are uncertain, in JAX too: every weight within
      ``STEP_TOL`` learning rates of float64's, or ``BF16_FACTOR`` times
      JAX bf16's largest such distance if that is more (+ ``STATE_ATOL``);
      the weights off by more than ``STATE_ATOL`` at most ``BF16_FACTOR``
      times JAX's count plus ``FLIP_SHARE`` (2 %) of all.

    Measured on an 8-core x86 CPU: the loss terms' distances 0.51-1.54
    times JAX bf16's; the statistics' and weights' root mean squares at
    most 1.15 and 1.36 times JAX's; the largest weight distance 1.74 learning
    rates, JAX's 1.73."""
    steps = _bf16_steps(toy, tmp_path, monkeypatch, jax_run)
    assert len(steps) == N_ITERS
    for name in LOSS_TERMS:
        port, jax_, ref = (np.array([runs[k][0][name] for runs in steps])
                           for k in ("port", "jax", "f64"))
        assert np.all(np.isfinite(port)), name
        bound = BF16_FACTOR * np.abs(jax_ - ref).sum() + LOSS_ATOL_SHARE * np.abs(ref).sum()
        assert np.abs(port - ref).sum() <= bound, (name, port, jax_, ref)
    for label, index, root in (("decision", 1, None), ("step", 2, "batch_stats")):
        for path, (rms_t, rms_j, *_) in _leaf_distances(steps, index, root).items():
            assert rms_t <= BF16_FACTOR * rms_j + STATS_ATOL, (label, path, rms_t, rms_j)
    lr_max = max(lr_at(2e-4, u, "cosine", 3, N_ITERS + 1) for u in range(N_ITERS))
    weights = _leaf_distances(steps, 2, "params")
    step_tol = max(STEP_TOL, BF16_FACTOR * max(w[3] for w in weights.values()))
    off = np.zeros(3)
    for path, (rms_t, rms_j, t_lr, _, *counts) in weights.items():
        assert rms_t <= BF16_FACTOR * rms_j + WEIGHT_ATOL_LR * lr_max, (path, rms_t, rms_j)
        assert t_lr <= step_tol + STATE_ATOL / lr_max, (path, t_lr, step_tol)
        off += counts
    assert off[0] <= BF16_FACTOR * off[1] + FLIP_SHARE * off[2], off


def test_recipe_route_trajectory_equals_jax(toy, tmp_path, monkeypatch, jax_run):
    """The trajectory of ``test_supervised_trajectory_equals_jax`` (the port
    in float32 against JAX in float64, from JAX's state at each iteration,
    with its tolerances) on the recipe's own data route: ``--augment-translate``
    kept, and the port on its device pool (``--device-data-cache on``, the
    gathers on CPU tensors: ``aug_canvases`` replays each batch's translate,
    ``gather_canvas_patches`` cuts the patches), which must give JAX's host
    patches bit for bit. Dropout stays 0: its three sites were read equal,
    the port's ``models/gpt.py:100``, ``:119`` and ``:323-324`` against the
    JAX package's ``models/gpt.py:94``, ``:123`` and ``:320``."""
    jtrainer, _ = jax_run
    steps = _trajectory(toy, _argv(toy, tmp_path, "float32"), monkeypatch, pool=True,
                        jtrainer=jtrainer)
    assert len(steps) == N_ITERS
    _check_trajectory(steps)


def test_augment_distribution_matches_jax():
    """The port's photometric augmentation (``ops/augment.py``, drawn from a
    ``torch.Generator``), which the trajectories above replace by JAX's
    replayed patches, against the JAX package's as distributions: 8 draws
    of 512 patches (8 x 8 blocks of random colour upsampled to 64 px and a
    bright square), each statistic within ``AUG_RTOL`` (3 %) of JAX's, the
    grayscale share within 0.02. Measured: at most 1.7 % apart (the mean
    absolute neighbour difference, a blur measure)."""
    from jolineedle_tpu_torch.ops.augment import detection_augment as port_augment

    rng = np.random.default_rng(0)
    images = np.repeat(np.repeat(rng.random((512, 8, 8, 3), dtype=np.float32), 8, 1), 8, 2)
    images[:, 20:40, 20:40, :] = 0.9
    augment = jax.jit(jax_detection_augment)
    draws = {"jax": np.stack([np.asarray(augment(jax.random.PRNGKey(k), jnp.asarray(images)))
                              for k in range(8)]),
             "port": np.stack([port_augment(torch.Generator().manual_seed(k),
                                            torch.from_numpy(images)).numpy()
                               for k in range(8)])}
    stats = {}
    for name, out in draws.items():
        moved = out - images
        stats[name] = {
            "mean": out.mean(axis=(0, 1, 2, 3)), "std": out.std(),
            "abs_moved": np.abs(moved).mean(), "sq_moved": np.square(moved).mean(),
            "image_mean_std": out.mean(axis=(2, 3, 4)).std(),
            "d_rows": np.abs(np.diff(out, axis=2)).mean(),
            "d_cols": np.abs(np.diff(out, axis=3)).mean(),
            "at_0": (out == 0).mean(), "at_1": (out == 1).mean()}
        gray = np.all(np.abs(out[..., :1] - out[..., 1:]) < 1e-6, axis=-1).mean(axis=(2, 3))
        stats[name]["gray"] = (gray > 0.99).mean()
    for key, want in stats["jax"].items():
        got = stats["port"][key]
        if key in AUG_ATOL:
            assert abs(got - want) <= AUG_ATOL[key], (key, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=AUG_RTOL, err_msg=key)
