"""Witnesses of the supervised recipe in the shared yolox-nano pairing (the
recipes' default) against the JAX package, where the trajectories of
``test_torch_recipes.py`` and ``test_torch_shared_recipe_parity.py`` stay
narrower than the recipe:

- (a) the step at the recipe's dropout (the CLI's 0.1), JAX's masks
  replayed into the port through its own keep test and rescale;
- (b) the host batches of the port's own ``Trainer.train_batches`` on its
  pool route, at the recipe's flags, for hundreds of iterations of seeds
  1-3, against the JAX loop's picks and ``build_supervised_batch``;
- (c) a test cycle (sampled tests and the worst-images pass) leaves the
  trainer's training state and its next batches as they were;
- (d) two iterations at the recipe's B = 16, the second from the port's
  own state;
- (e) a fresh model of the shared pairing at the recipe's widths against
  flax's draw, leaf by leaf;
- (f) the gradients and statistics of one step (``test_torch_trained_state.py``'s
  witness of trained states) from the JAX initial state.

The trajectories reuse ``test_torch_recipes``' helpers; (e) reuses
``test_torch_init``'s.
"""

import copy
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
from scipy import stats

import flax.linen as fnn
import jax
import jax.numpy as jnp

import main as jax_main
from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.train.batching import build_supervised_batch
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.models import gpt as tgpt
from jolineedle_tpu_torch.models.bridge import gpt_key_map
from jolineedle_tpu_torch.models.init import TRUNCATED_STD
from jolineedle_tpu_torch.scripts import make_toyds_big
from jolineedle_tpu_torch.train import batching as tbatching

from test_torch_init import _leaf, check_fresh_draws, check_init_by_kind
from test_torch_recipes import (FLAGSHIP, LOSS_TERMS, _check_trajectory, _f64_step, _flat,
                                _jax_iterations, _jax_trainer, _port_trainer, _recipe_argv,
                                _trajectory, _trajectory_argv)

# The suite runs in several test processes that share the cores.
torch.set_num_threads(1)

N_TRAIN, N_TEST = 256, 10
RECIPE_B, SMALL_B = 16, 4
DROPOUT = 0.1  # the CLI's default, which the recipe keeps
# Standard errors of a kept share that a site's draw may stray by.
Z_KEEP = 5.0
HOST_ITERS, PIXEL_ITERS, SEEDS = 200, 4, (1, 2, 3)
KS_P, KS_MIN_SIZE = 1e-3, 256


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """``make_toyds_big``'s images, ``N_TRAIN`` of them to train and
    ``N_TEST`` to test (enough for one worst image at the CLI's
    ``--failure-select-rate`` 0.1)."""
    root = tmp_path_factory.mktemp("witnesses")
    return make_toyds_big.make_toyds_big(root / "toy", n_train=N_TRAIN, n_test=N_TEST)


def _dropout_argv(toy: Path, work: Path, n_iters: int, batch_size: int) -> list:
    """The trajectory's flags at the recipe's dropout and ``batch_size``."""
    return _trajectory_argv(toy, work, n_iters, dropout=None) + [
        "--batch-size", str(batch_size)]


def _dropout_sites(n_layer: int) -> list:
    """The flax module paths of the decoder's dropouts in the order the
    forward calls them (``gpt.py:320``, then per block ``:94`` and
    ``:123``), which is the port's order (``models/gpt.py``)."""
    sites = [("drop",)]
    for i in range(n_layer):
        sites += [(f"h_{i}", "attn", "Dropout_0"), (f"h_{i}", "Dropout_0")]
    return sites


@pytest.fixture(scope="module")
def jax_drops(toy, tmp_path_factory):
    """``get(B)``: the JAX trainer of the recipe's flags at dropout 0.1 and
    batch size B for three iterations (built once per B), its step made
    float64 and traced with each ``nn.Dropout``'s mask sent to the host,
    ``masks``: after a step, each site's module path -> its mask, and
    ``grads``: the list each step appends its gradients to. The
    interceptor draws the mask as flax does (one ``make_rng`` per call, on
    a tensor of ones) and applies it as flax does (``lax.select(mask, x /
    keep, 0)``)."""
    made = {}

    def get(batch_size: int):
        if batch_size not in made:
            made[batch_size] = _jax_drop(toy, tmp_path_factory.mktemp("jax"), batch_size)
        return made[batch_size]

    return get


def _jax_drop(toy: Path, work: Path, batch_size: int):
    jtrainer = _jax_trainer(_dropout_argv(toy, work, 3, batch_size), toy)
    assert jtrainer.model.dropout == DROPOUT
    grads = _capture_grads(jtrainer)
    _f64_step(jtrainer)
    return jtrainer, _intercept_dropout(jtrainer), grads


def _capture_grads(jtrainer) -> list:
    """Makes the JAX trainer's optimizer send each step's gradients to the
    host before it updates; returns the list they are appended to. The
    steps built after the call send them."""
    grads, tx = [], jtrainer.tx

    def update(updates, state, params=None, **extra):
        jax.debug.callback(lambda g: grads.append(jax.tree_util.tree_map(np.asarray, g)),
                           updates)
        return tx.update(updates, state, params, **extra)

    jtrainer.tx = optax.GradientTransformationExtraArgs(tx.init, update)
    return grads


def _intercept_dropout(jtrainer) -> dict:
    """Wraps the JAX trainer's ``_train_step`` so that each step sends
    every ``nn.Dropout``'s mask to the host; returns the dict (module path
    -> mask) that each step fills (``jax_drops``)."""
    masks = {}

    def interceptor(next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x, ones = args[0], jnp.ones_like(args[0])
        scaled = next_fun(ones, *args[1:], **kwargs)
        if scaled is ones:  # deterministic: the identity
            return x
        mask, site = scaled != 0, tuple(context.module.path)
        jax.debug.callback(lambda m: masks.__setitem__(site, np.asarray(m)), mask)
        keep = 1.0 - context.module.rate
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))

    step = jtrainer._train_step

    def traced(*args):
        with fnn.intercept_methods(interceptor):
            out = step(*args)
        jax.effects_barrier()
        return out

    jtrainer._train_step = traced
    return masks


def _replay_dropout(monkeypatch, masks: dict, n_layer: int) -> dict:
    """Replays the JAX step's dropout masks into the port. The port's own
    ``_dropout`` runs: at each site it draws its uniforms (``draw``), keeps
    those below its keep probability and rescales them by 1 / keep; the
    replay hands it, in place of its draw, a value just below JAX's keep
    probability where JAX kept and JAX's keep probability where it dropped,
    so that a port whose threshold is not flax's 1 - rate (in float32)
    drops other elements. Each site's output must be JAX's mask applied
    with flax's rescale, bit for bit. Returns the port's own kept shares
    per site, for the caller to hold against 1 - rate."""
    sites = _dropout_sites(n_layer)
    keep = np.float32(1.0 - DROPOUT)
    below = np.nextafter(keep, np.float32(0))
    calls, shares, last = [0], {site: [] for site in sites}, {}
    draw = tgpt.draw

    def replayed(sample, shape):
        own = draw(sample, shape)
        site = sites[calls[0] % len(sites)]
        calls[0] += 1
        shares[site].append((float((own < float(keep)).float().mean()), own.numel()))
        mask = masks.pop(site)
        assert mask.shape == tuple(shape), (site, mask.shape, shape)
        last["mask"] = torch.from_numpy(mask.copy())
        return torch.where(last["mask"], torch.tensor(below), torch.tensor(keep)).to(own.dtype)

    dropout = tgpt.GPT._dropout

    def checked(self, train, generator):
        assert self.dropout == DROPOUT
        drop = dropout(self, train, generator)
        if drop is None:
            return None

        def run(x):
            y = drop(x)
            want = torch.where(last.pop("mask"), x / (1.0 - DROPOUT), torch.zeros_like(x))
            assert torch.equal(y, want)
            return y

        return run

    monkeypatch.setattr(tgpt, "draw", replayed)
    monkeypatch.setattr(tgpt.GPT, "_dropout", checked)
    return shares


def _check_keep_shares(shares: dict, n_steps: int) -> None:
    """Each site's share of the port's own uniforms below its keep
    probability within ``Z_KEEP`` standard errors of 1 - rate."""
    keep = 1.0 - DROPOUT
    for site, drawn in shares.items():
        assert len(drawn) == n_steps, site
        for share, n in drawn:
            assert abs(share - keep) <= Z_KEEP * np.sqrt(keep * DROPOUT / n), (site, share)


def test_dropout_trajectory_equals_jax(toy, tmp_path, monkeypatch, jax_drops):
    """(a) Two iterations of the recipe's flags at its dropout 0.1 and B =
    4 (float32 against JAX's float64 step, each from the JAX state, the
    augmented patches replayed), JAX's dropout masks replayed into the port
    at its three kinds of site (``models/gpt.py``'s token dropout and each
    block's two, against ``jolineedle_tpu/models/gpt.py:320``, ``:94`` and
    ``:123``): the loss terms, weights, BN statistics and AdamW moments
    within ``_check_trajectory``'s bounds (``LOSS_RTOL`` 1e-3; every weight
    within 1 lr, all but 2 % within 1e-6; statistics within 1e-3 and
    moments within 3e-2 of their leaf's largest value). At every site the
    port keeps an element where its own uniform is below flax's keep
    probability 0.9 and rescales it by 1 / 0.9, bit for bit
    (``_replay_dropout``), and its own draws keep 0.9 of the elements
    within 5 standard errors.

    Those bounds assume no pre-activation within float32's rounding of a
    kink: on a toy set of 192 images the first batch holds an
    ``embed_fpn_conv`` output 1.8e-6 from ReLU's kink (of 5.1 at most, a
    sum of 256 terms), whose flip moves that kernel's first moment by 4.1 %
    of its largest value, past the 3 %."""
    jtrainer, masks, _ = jax_drops(SMALL_B)
    shares = _replay_dropout(monkeypatch, masks, jtrainer.model.n_layer)
    steps = _trajectory(toy, _dropout_argv(toy, tmp_path, 3, SMALL_B), monkeypatch,
                        jtrainer=jtrainer, n_iters=2)
    assert len(steps) == 2 and not masks
    _check_keep_shares(shares, 2)
    _check_trajectory(steps)


@pytest.mark.parametrize("batch_size", [SMALL_B, pytest.param(RECIPE_B, marks=pytest.mark.slow)])
def test_second_iteration_from_the_ports_own_state(toy, tmp_path, monkeypatch, jax_drops,
                                                    batch_size):
    """(d) Two consecutive iterations at dropout 0.1 (JAX's masks and
    augmented patches replayed), float32 against JAX's float64 step, the
    port loaded from the JAX state before the first only: the second starts
    from the weights, BN running statistics, AdamW moments and counts and
    step that the port carried itself. Both iterations within
    ``_check_trajectory``'s own bounds, not widened: the first update's
    learning rate is 0 (warmup), so the second starts from JAX's weights
    and from moments and statistics within float32 rounding of JAX's,
    which those bounds (moments within 3 % of their leaf's largest value,
    statistics within 0.1 %) hold with room. At B = 4 in tier-1; at the
    recipe's B = 16 (JAX's float64 step there takes about a minute on the
    CPU) marked ``slow``."""
    jtrainer, masks, _ = jax_drops(batch_size)
    shares = _replay_dropout(monkeypatch, masks, jtrainer.model.n_layer)
    steps = _trajectory(toy, _dropout_argv(toy, tmp_path, 3, batch_size), monkeypatch,
                        jtrainer=jtrainer, reload={1}, n_iters=2)
    assert len(steps) == 2 and not masks
    _check_keep_shares(shares, 2)
    _check_trajectory(steps)


def test_step_from_the_jax_initial_state(toy, tmp_path, monkeypatch, jax_drops):
    """(f) ``test_torch_trained_state.py``'s witness of the step from a
    trained state, run from the JAX trainer's initial state of seed 1
    (written as a port run directory and read back through
    ``export_flax_run``, as a trained run is) at B = 4 in float32, on two
    batches with JAX's masks and patches replayed: the port's loss terms,
    per-leaf gradients before AdamW and BatchNorm statistics after the step
    no further from JAX's float64 step than twice JAX float32's distance,
    plus the atols of ``step_probe`` (``within``)."""
    from test_torch_trained_state import check, initial_run, injected_steps, steps_from

    jtrainer, masks, grads = jax_drops(SMALL_B)
    run_dir = initial_run(jtrainer, _dropout_argv(toy, tmp_path / "run", 3, SMALL_B), toy)
    steps = {**injected_steps(jtrainer, ("float32",)), "float64": jtrainer._train_step}
    grads.clear()
    runs = steps_from(run_dir, "best", toy, tmp_path, monkeypatch,
                      (jtrainer, steps, grads, masks),
                      lambda work, dtype: _dropout_argv(toy, work, 3, SMALL_B) + [
                          "--compute-dtype", dtype], ("float32",), n_batches=2)
    assert len(runs["float64"]) == 2 and runs["inputs"] is not None
    check(runs, "float32")


def _host_argv(toy: Path, work: Path, seed: int) -> list:
    """``run_sup_flagship.sh``'s flags with ``DETECTOR=yolox-nano``, as they
    are (B = 16, ``--max-seq-len`` 8, ``--augment-translate``,
    ``--merge-bboxes``, ``--num-workers`` 1, STOP off: the recipe passes
    no ``--enable-stop``), for ``HOST_ITERS`` iterations of ``seed``."""
    values = {**FLAGSHIP, "SEED": str(seed), "DATASET_DIR": str(toy), "WORK_DIR": str(work),
              "MAX_ITERS": str(HOST_ITERS + 1), "DETECTOR": "yolox-nano",
              "BACKBONE_FLAGS": "--image-processor yolox-nano"}
    return _recipe_argv("run_sup_flagship.sh", values)


def _assert_same_batch(got: dict, want: dict, where: str) -> None:
    assert got.keys() == want.keys(), where
    for key, value in want.items():
        assert got[key].dtype == value.dtype, (where, key)
        np.testing.assert_array_equal(got[key], value, err_msg=f"{where} {key}")


@pytest.mark.parametrize("seed", SEEDS)
def test_port_train_batches_equal_the_jax_loops(toy, tmp_path, seed):
    """(b) The port's own batch pipeline (``Trainer.train_batches`` behind
    its prefetcher, ``--num-workers`` 1, spd 1) on its device-pool route
    (no pixels, the route the card trains on) at the recipe's own flags
    (``_host_argv``): ``HOST_ITERS`` (200) iterations, 3,200 episodes over
    the ``N_TRAIN`` (256) images, against the JAX loop's picks and seeds
    (``_jax_iterations``) and the JAX package's ``build_supervised_batch``.
    Every array equal, bit for bit and in dtype; the first ``PIXEL_ITERS``
    batches also with their pixels (the streamed route). The episodes
    cover the rare branches: short (masked) trajectories, several boxes,
    starts on the image's edge."""
    argv = _host_argv(toy, tmp_path, seed)
    j_cfg, j_model_cfg = args_to_config(get_args(argv))
    assert (j_cfg.batch_size, j_cfg.max_seq_len, j_cfg.stop_enabled) == (RECIPE_B, 8, False)
    assert j_cfg.translations and j_cfg.num_workers == 1
    j_train, _ = jax_main.build_both_datasets(j_cfg, j_model_cfg, toy)

    class JaxLoop:  # what _jax_iterations reads of a JAX trainer
        config, train_dataset = j_cfg, j_train

    port = _port_trainer(argv, toy)
    port.pool = port.build_pool()
    assert port.pool is not None and port.steps_per_dispatch() == 1
    prefetcher = port.train_batches(1)
    short = edge = multi = 0
    try:
        for it, indices, batch_seed, _ in _jax_iterations(JaxLoop, HOST_ITERS):
            (got,) = next(prefetcher)
            want = build_supervised_batch(j_train, indices, j_cfg,
                                          np.random.default_rng(batch_seed), with_pixels=False)
            _assert_same_batch(got, want, f"seed {seed} iteration {it}")
            short += int((want["masks"].sum(axis=1) < j_cfg.max_seq_len).sum())
            edge += int((want["positions"][:, 0] == 0).any(axis=-1).sum())
            multi += int(((want["bboxes_yolox"][..., 5] == 1).sum(axis=-1) > 1).sum())
            if it <= PIXEL_ITERS:
                _assert_same_batch(
                    tbatching.build_supervised_batch(port.train_dataset, indices, port.config,
                                                     np.random.default_rng(batch_seed)),
                    build_supervised_batch(j_train, indices, j_cfg,
                                           np.random.default_rng(batch_seed)),
                    f"seed {seed} iteration {it} with pixels")
    finally:
        prefetcher.close()
    assert short and edge and multi, (short, edge, multi)



def _cycle_argv(toy: Path, work: Path, test_every: int) -> list:
    """Three iterations of the recipe's flags at its dropout and
    ``--augment-translate`` (B = 2, float32), on the device pool, with a
    test every ``test_every`` iterations of 2 sampled images."""
    return _trajectory_argv(toy, work, 3, drop=(), dropout=None) + [
        "--test-every", str(test_every), "--test-samples", "2", "--device-data-cache", "on"]


def _training_state(port) -> dict:
    """A copy of everything a train step reads or writes outside its batch:
    the weights and buffers, the optimizer's state and counters, the
    training generator and the step."""
    return {"model": {k: v.clone() for k, v in port.model.state_dict().items()},
            "optimizer": copy.deepcopy(port.optimizer.state_dict()),
            "generator": port.generator.get_state().clone(),
            "counters": (port.step, port.optimizer.updates, port.optimizer.mini_step,
                         port.model.training)}


def _assert_bit_equal(got, want, where: str = "") -> None:
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want), where
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for key in want:
            _assert_bit_equal(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bit_equal(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _run_recording(toy: Path, work: Path, test_every: int) -> tuple:
    """The port's ``train_loop`` over the three iterations of
    ``_cycle_argv``: (each iteration's batch and metrics, the training
    state after them, what each test cycle saw: the training state before
    and after it and the ``eval_envs`` calls it made)."""
    port = _port_trainer(_cycle_argv(toy, work, test_every), toy)
    batches, metrics, cycles = [], [], []
    step, test, eval_envs = port.train_step, port.test, port.eval_envs

    def recorded_step(batch):
        batches.append({k: v.copy() for k, v in batch.items()})
        out = step(batch)
        metrics.append({k: float(v) for k, v in out.items()})
        return out

    def counted_eval(*args, **kwargs):
        cycles[-1]["eval_envs"] += 1
        return eval_envs(*args, **kwargs)

    def watched_test(*args, **kwargs):
        cycles.append({"before": _training_state(port), "eval_envs": 0})
        test(*args, **kwargs)
        cycles[-1]["after"] = _training_state(port)

    port.train_step, port.test, port.eval_envs = recorded_step, watched_test, counted_eval
    port.train_loop(port.train_iterations())
    assert port.pool is not None and len(batches) == 3
    return batches, metrics, _training_state(port), cycles


def test_test_cycle_leaves_training_as_it_was(toy, tmp_path):
    """(c) The trainer's test cycle as the recipe runs it, between
    iterations 2 and 3 (``train_loop``'s ``test_on_main``: the sampled
    tests' eval rollouts, the worst-images pass, the teacher-forced eval,
    the checkpoints), leaves every parameter and buffer, the optimizer's
    moments, counts and counters, the training generator and the step
    exactly as they were, bit for bit. The run then goes on as the same
    run with no test: iteration 3's batch (the prefetcher's next pick),
    its loss terms and metrics, and the whole training state after it
    equal, bit for bit, those of a second trainer of the same seed whose
    loop tests never."""
    tested = _run_recording(toy, tmp_path / "tested", 2)
    untested = _run_recording(toy, tmp_path / "untested", 1000)
    (cycle,) = tested[3]
    assert cycle["eval_envs"] == 2  # the sampled test and its worst-images pass
    _assert_bit_equal(cycle["after"], cycle["before"], "the test cycle")
    assert not untested[3]
    _assert_bit_equal(tested[:3], untested[:3], "tested against untested")
    assert set(LOSS_TERMS) <= set(tested[1][2])


@pytest.fixture(scope="module")
def shared_inits(toy, tmp_path_factory, jax_drops):
    """Fresh models of the shared pairing at the recipe's widths (no
    ``--gpt-backbone``, ``--max-seq-len`` 8): the JAX trainer's initial
    weights and statistics (flax's ``GPT.init_all`` from PRNGKey 1, the
    seed) and the port's ``GPT`` of the same flags from torch seed 0."""
    jtrainer, *_ = jax_drops(SMALL_B)
    argv = _dropout_argv(toy, tmp_path_factory.mktemp("init"), 3, SMALL_B)
    assert "--gpt-backbone" not in argv and argv[argv.index("--max-seq-len") + 1] == "8"
    variables = jax.device_get({"params": jtrainer.state.params,
                                "batch_stats": jtrainer.state.batch_stats})
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(argv))
    torch.manual_seed(0)
    return variables, tgpt.GPT.from_config(t_model, t_actions_info(t_train), device="cpu")


def test_shared_pairing_draws_the_jax_distributions(shared_inits):
    """(e) ``test_torch_init.py``'s two checks on the shared pairing: every
    mapped leaf's mean and spread within 5 standard errors of flax's,
    constant leaves equal, every port bias 0; and the standard deviations
    by kind."""
    check_fresh_draws(shared_inits)
    check_init_by_kind(shared_inits[1])


def test_shared_pairing_init_leaf_by_leaf(shared_inits):
    """(e) Leaf by leaf, beyond mean and spread: every flax leaf is mapped
    by ``gpt_key_map`` and every mapped port leaf is one flax draws; the
    port's only unmapped leaves are BatchNorm's ``num_batches_tracked``
    (one per BatchNorm, which flax has no leaf for). A leaf is random in
    the port where it is random in flax, and constant where flax's is.
    Every conv kernel, in both, lies within lecun_normal's truncation at two
    standard deviations, 2 sqrt(1 / fan_in) / 0.8796.

    Each random leaf of at least ``KS_MIN_SIZE`` (256) values is held to
    flax's draw by a two-sample Kolmogorov-Smirnov test at a family-wise
    ``KS_P`` (1e-3) over the n leaves tested (123): every p above 1e-3 / n
    (Bonferroni; Holm's test rejects nothing then either), and the n
    p-values, which are uniform where every leaf's distribution is flax's,
    not skewed towards 0 (a one-sample test against the uniform, p above
    1e-3): a difference shared by many leaves, each too small to fail
    alone, fails there. A per-leaf 1e-3 fails one leaf in eight such trees
    by chance: flax's draw of this tree from PRNGKey 0 gives
    ``lateral_conv0`` (32,768 values) p = 2.1e-4 against the port's from
    torch seed 0, and 0.012-0.079 against flax's own draws from PRNGKey
    1-3, which take the port's at 0.77-0.95."""
    variables, tmodel = shared_inits
    entries = gpt_key_map(tmodel)
    flax_leaves = {(coll,) + path for coll in variables for path in _flat(variables[coll])}
    assert {(coll,) + fpath for _, coll, fpath, _ in entries} == flax_leaves
    state = tmodel.state_dict()
    unmapped = set(state) - {tkey for tkey, *_ in entries}
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in tmodel.modules())
    assert all(k.endswith(".num_batches_tracked") for k in unmapped) and len(unmapped) == n_bn
    pvalues = {}
    for tkey, coll, fpath, _ in entries:
        want = _leaf(variables[coll], fpath).ravel()
        got = state[tkey].double().numpy().ravel()
        assert (want.std() > 0) == (got.std() > 0), tkey
        if want.std() == 0:
            continue
        if state[tkey].ndim == 4:  # a conv kernel
            bound = 2.0 * np.sqrt(1.0 / state[tkey][0].numel()) / TRUNCATED_STD
            assert max(np.abs(want).max(), np.abs(got).max()) <= bound * (1 + 1e-6), tkey
        if want.size >= KS_MIN_SIZE:
            pvalues[tkey] = stats.ks_2samp(want, got).pvalue
    assert len(pvalues) > 100
    worst = min(pvalues, key=pvalues.get)
    assert pvalues[worst] > KS_P / len(pvalues), (worst, pvalues[worst])
    uniform = stats.ks_1samp(list(pvalues.values()), stats.uniform.cdf, alternative="greater")
    assert uniform.pvalue > KS_P, uniform


def test_sup_probe_runs_to_the_end_with_no_tests(toy, tmp_path, monkeypatch):
    """``sup_probe --tests 0``, which ``run_flagship_seed.sh`` runs with
    ``INIT_FROM``: the recipe's flags, the seed's and the extra ones (an
    ``--init-from`` run) under ``time_recipe`` with no stop, its JSON line
    written, and the run's own exit code returned."""
    from jolineedle_tpu_torch.scripts import sup_probe, time_recipe

    calls = []
    monkeypatch.setattr(time_recipe, "main", lambda argv: calls.append(argv) or {
        "rc": 3, "tests": []})
    monkeypatch.setenv("DATASET_DIR", str(toy))
    out = tmp_path / "out"
    assert sup_probe.main([str(out), str(tmp_path / "work"), "--seed", "2", "--tests", "0",
                           "--", "--init-from", "runs/jax_init"]) == 3
    (argv,) = calls
    assert "--stop-after-tests" not in argv
    command = argv[argv.index("--") + 1:]
    assert command[-2:] == ["--init-from", "runs/jax_init"]
    assert command[command.index("--seed") + 1] == "2"
    assert command[command.index("--max-iters") + 1] == "20000"
    assert (out / "time_recipe.json").is_file()
