"""The supervised recipe's step from trained states of the shared yolox-nano
pairing (the recipes' default), against the JAX package's step.

The other witnesses of that step (``test_torch_recipes.py``,
``test_torch_shared_recipe_parity.py``, ``test_torch_shared_recipe_witnesses.py``)
start from the initial weights or a few iterations after them, where the
detector finds nothing, the decision logits are flat, the backbone's
BatchNorm statistics are fresh and SimOTA assigns few anchors. Here the
step starts from the states of full 20k-iteration runs of
``run_sup_flagship.sh``, brought back from the card into
``build/trained/<run>/`` by ``run_stream_seeds.sh``: the run's best weights
(``checkpoint_best.pt``) and the weights and train state its training ended
with (``checkpoint.pt``, ``train_state.pt``). For each state:

- the port loads it as ``--init-from`` (the best weights) and
  ``--resume-training`` (the last train state) do;
- the JAX trainer loads the same weights from the msgpack that
  ``scripts/export_flax_run.py`` writes of the run;
- ``N_BATCHES`` host batches of the recipe's flags (B = 16,
  ``--max-seq-len 8``, ``--augment-translate``, dropout 0.1) of seed 1 each
  go through one step from the state, JAX's augmented patches and dropout
  masks replayed into the port (``_replay_augments``, ``_replay_dropout``);
- the port's loss terms, every parameter's gradient (before AdamW) and the
  BatchNorm statistics after the step are held against JAX's float64 step
  by the rule of ``test_bf16_step_no_further_from_float64_than_jax``: the
  port's distance from float64 at most ``step_probe.FACTOR`` (2) times the
  JAX step's of the same compute dtype, plus ``step_probe``'s atols, in
  float32 and in bfloat16. Every step takes the float64 step's draws
  (``injected_steps``): under ``jax.enable_x64`` ``jax.random`` draws other
  numbers, and a float32 step that drew its own would be held against a
  reference of other inputs.

Measured on the H100 runs' states (two runs, best and last each): in
float32 every leaf holds, the port's distances a few hundredths to a tenth
of JAX float32's; in bfloat16 one objectness leaf of the detector head per
state (``obj_pred_1`` or ``obj_pred_2``, bias or kernel) lies at 2.2-2.9
times JAX bfloat16's, and every other leaf within the rule. Those leaves
move with SimOTA's assignment, which bfloat16 shifts by a few anchors of
500-700 a batch in either package; neither taking the prediction convs'
gradients in float32 nor leaving every conv's output unrounded before its
BatchNorm moved them.

These cases read ``build/trained/`` and take minutes (JAX's float64 and
bfloat16 steps at B = 16 on the CPU), so they are marked ``slow``. Each also
writes ``build/trained/probe/<run>_<state>.pt`` (the state, its first batch,
the replayed patches and masks, JAX's float64 gradients and statistics, and
the CPU port's distances from them), from which
``jolineedle_tpu_torch/scripts/step_probe.py`` takes the same step on the
card. The same code runs in tier-1 from the JAX trainer's own initial state
of seed 1, written as a port run directory (``initial_run``), at B = 4 in
float32: ``test_torch_shared_recipe_witnesses.py::
test_step_from_the_jax_initial_state``, beside the JAX step that file
compiles already.
"""

import contextlib
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from flax import serialization

import flax.linen as fnn
import jax
import jax.numpy as jnp

from jolineedle_tpu.train import supervised as jax_supervised

from jolineedle_tpu.train.batching import build_supervised_batch
from jolineedle_tpu_torch import checkpoint as ckpt
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from jolineedle_tpu_torch.scripts import export_flax_run, make_toyds_big, step_probe

from test_torch_recipes import (LOSS_TERMS, _f64_step, _flat, _jax_iterations, _jax_trainer,
                                _port_trainer, _replay_augments, _trajectory_argv, _tree)
from test_torch_shared_recipe_witnesses import (DROPOUT, _capture_grads, _dropout_sites,
                                                 _intercept_dropout, _replay_dropout)

# The suite runs in several test processes that share the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TRAINED = REPO / "build" / "trained"
N_TRAIN, N_TEST = 64, 2
RECIPE_B, N_BATCHES = 16, 4
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: The batch keys that carry the float64 step's draws into the other steps.
AUG_KEYS, MASK = ("aug_patches", "aug_patches_yolox"), "mask:"
#: The weights files of a run directory that a state names.
STATE_FILES = {"best": ckpt.CKPT_BEST, "last": ckpt.CKPT_LAST}


def _runs() -> list:
    """The trained runs brought back into ``build/trained/`` (each a
    directory with both weights files, ``train_state.pt`` and the run's
    ``config.json``)."""
    if not TRAINED.is_dir():
        return []
    return sorted(p.name for p in TRAINED.iterdir()
                  if all((p / n).is_file() for n in (*STATE_FILES.values(),
                                                      ckpt.TRAIN_STATE, "config.json")))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("trained_state")
    return make_toyds_big.make_toyds_big(root / "toy", n_train=N_TRAIN, n_test=N_TEST)


def _argv(toy: Path, work: Path, batch_size: int, dtype: str) -> list:
    """The recipe's flags as they are (``--augment-translate``, dropout 0.1,
    ``--max-seq-len 8``) at ``batch_size`` and ``dtype``, on ``toy``."""
    return _trajectory_argv(toy, work, N_BATCHES, drop=(), dropout=None) + [
        "--batch-size", str(batch_size), "--compute-dtype", dtype]


@contextlib.contextmanager
def _injected(augmented: list, masks: dict):
    """While a JAX step is traced inside, its photometric augmentation
    returns ``augmented`` (the decision patches, then the detector's) and
    each ``nn.Dropout`` applies the mask that ``masks`` holds for its module
    path ("/"-joined) as flax applies its own (``lax.select(mask, x / keep,
    0)``), in place of their draws."""
    def augment(key, images):
        return augmented.pop(0)

    def interceptor(next_fun, args, kwargs, context):
        if not isinstance(context.module, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x, ones = args[0], jnp.ones_like(args[0])
        if next_fun(ones, *args[1:], **kwargs) is ones:  # deterministic: the identity
            return x
        keep = 1.0 - context.module.rate
        mask = masks.pop("/".join(context.module.path))
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))

    with mock.patch.object(jax_supervised, "detection_augment", augment), \
            fnn.intercept_methods(interceptor):
        yield
    assert not augmented and not masks


def injected_steps(jtrainer, dtypes) -> dict:
    """The JAX trainer's step with its model in each of ``dtypes``, taking
    its augmented patches (``AUG_KEYS``) and dropout masks (``MASK`` +
    module path) from its batch instead of drawing them (``_injected``).
    Under ``jax.enable_x64`` the JAX step draws other numbers than without
    it (``jax.random``'s default dtypes widen), so the float32 and bfloat16
    steps take the float64 step's draws, as the port does. Build after
    ``_capture_grads``: the steps send their gradients."""
    model, steps = jtrainer.model, {}
    for name in dtypes:
        jtrainer.model = model.clone(compute_dtype=DTYPES[name])
        jtrainer._build_train_step()
        core = jtrainer._train_step_core

        def run(state, batch, rng, core=core):
            batch = dict(batch)
            augmented = [batch.pop(key) for key in AUG_KEYS]
            masks = {k[len(MASK):]: batch.pop(k) for k in list(batch) if k.startswith(MASK)}
            with _injected(augmented, masks):
                return core(state, batch, rng, None)

        steps[name] = jax.jit(run)
    jtrainer.model = model
    return steps


@pytest.fixture(scope="module")
def jax_recipe(toy, tmp_path_factory):
    """The JAX trainer of the recipe's flags at B = 16, its gradients sent
    to the host (``grads``), with its step in float32 and bfloat16 and,
    under ``jax.enable_x64``, in float64 (the last also sending its dropout
    masks, ``masks``)."""
    jtrainer = _jax_trainer(_argv(toy, tmp_path_factory.mktemp("jax"), RECIPE_B, "float32"),
                            toy)
    assert jtrainer.model.dropout == DROPOUT
    grads = _capture_grads(jtrainer)
    steps = injected_steps(jtrainer, DTYPES)
    _f64_step(jtrainer)
    masks = _intercept_dropout(jtrainer)
    return jtrainer, {**steps, "float64": jtrainer._train_step}, grads, masks


def _jax_variables(run_dir: Path, state: str, toy: Path, work: Path) -> dict:
    """The JAX package's ``{"params", "batch_stats"}`` of ``run_dir``'s
    ``state`` weights, as ``export_flax_run`` writes them."""
    export_flax_run.export(run_dir, work, compute_dtype="float32", dataset_dir=toy)
    name = {"best": ckpt.FLAX_BEST, "last": ckpt.FLAX_LAST}[state]
    return serialization.msgpack_restore((work / name).read_bytes())


def _load_state(port, run_dir: Path, state: str) -> None:
    """The port trainer at ``run_dir``'s ``state``: the best weights as
    ``--init-from`` loads them, or the last train state's weights,
    optimizer and step as ``--resume-training`` restores them (not its
    generator: a card run saves a CUDA generator's state, which a CPU
    generator does not take; the step's draws are replayed anyway)."""
    if state == "best":
        port.load_params_checkpoint(run_dir)
        return
    ckpt.load_model_file(port.model, run_dir / ckpt.CKPT_LAST)
    train_state = ckpt.load_train_state(run_dir)
    port.optimizer.load_state_dict(train_state["optimizer"])
    port.step = int(train_state["step"])


def _grads_sink(port) -> list:
    """Wraps ``port``'s optimizer step so that each step first appends
    every trained parameter's gradient (zeros where it has none, as the
    optimizer then treats it) in the JAX package's layout."""
    sink, step = [], port.optimizer.step

    def captured():
        grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                 for name, p in port.model.named_parameters() if p.requires_grad}
        sink.append(torch_to_flax(grads, port.model, strict=False)["params"])
        step()

    port.optimizer.step = captured
    return sink


def steps_from(run_dir: Path, state: str, toy: Path, work: Path, monkeypatch, jax_run,
               argv_of, dtypes, n_batches: int = N_BATCHES) -> dict:
    """``n_batches`` steps from ``run_dir``'s ``state``, each from the state
    on the next batch of the JAX trainer's seed. ``jax_run``: (the JAX
    trainer, its steps by dtype with ``float64``, the list its steps send
    their gradients to, the dict its float64 step sends its dropout masks
    to); ``argv_of(work, dtype)``: the port's flags of the same recipe.
    Returns ``{"float64": runs, dtype: {"jax":
    runs, "port": runs}}``, each ``runs`` a list over the batches of (the
    loss terms, the gradients, the BatchNorm statistics after the step) as
    flat dicts of float64 numpy leaves; and ``inputs``, the first batch's
    (batch, replayed patches, masks in the port's order, the port's state
    dict)."""
    jtrainer, steps, grads, masks = jax_run
    cfg = jtrainer.config
    trained = tconfig.config_from_file(run_dir / "config.json")[1].to_dict()
    j_variables = _jax_variables(run_dir, state, toy, work / "jax_run")
    start = jtrainer.state.replace(
        params=serialization.from_state_dict(jtrainer.state.params, j_variables["params"]),
        batch_stats=serialization.from_state_dict(jtrainer.state.batch_stats,
                                                  j_variables["batch_stats"]))
    ports = {}
    for dtype in dtypes:
        argv = argv_of(work / dtype, dtype)
        flags = tconfig.args_to_config(tconfig.get_args(argv))[1].to_dict()
        assert {**trained, "compute_dtype": dtype} == flags  # the recipe's model
        port = _port_trainer(argv, toy)
        _load_state(port, run_dir, state)
        state_dict = {k: v.clone() for k, v in port.model.state_dict().items()}
        ports[dtype] = port, state_dict, _grads_sink(port)
    stage = _replay_augments(monkeypatch)
    _replay_dropout(monkeypatch, masks, jtrainer.model.n_layer)
    out = {"float64": [], **{d: {"jax": [], "port": []} for d in dtypes}, "inputs": None}

    def record(metrics, grads_tree, stats):
        return ({n: float(metrics[n]) for n in LOSS_TERMS},
                _flat(_tree(grads_tree, np.float64)), _flat(_tree(stats, np.float64)))

    for it, indices, seed, step_key in _jax_iterations(jtrainer, n_batches):
        batch = build_supervised_batch(jtrainer.train_dataset, indices, cfg,
                                       np.random.default_rng(seed))
        with jax.enable_x64():
            s64 = jax.tree_util.tree_map(jnp.asarray, _tree(jax.device_get(start), np.float64))
            s64, m64 = steps["float64"](s64, jax.tree_util.tree_map(jnp.asarray, batch),
                                        step_key, None)
            jax.effects_barrier()
            out["float64"].append(record(m64, grads.pop(), jax.device_get(s64.batch_stats)))
            augmented = [a for _, a in stage(batch, step_key)]  # the float64 step's draws
        drawn = dict(masks)
        injected = {**batch, **dict(zip(AUG_KEYS, augmented)),
                    **{MASK + "/".join(site): m for site, m in drawn.items()}}
        if it == 1:
            out["inputs"] = (batch, augmented,
                             [drawn[site] for site in _dropout_sites(jtrainer.model.n_layer)],
                             ports[dtypes[0]][1])
        for dtype in dtypes:
            s32 = jax.tree_util.tree_map(jnp.asarray, _tree(jax.device_get(start), np.float32))
            s32, m32 = steps[dtype](s32, jax.tree_util.tree_map(jnp.asarray, injected), step_key)
            jax.effects_barrier()
            out[dtype]["jax"].append(record(m32, grads.pop(), jax.device_get(s32.batch_stats)))
            port, state_dict, sink = ports[dtype]
            port.model.load_state_dict(state_dict)
            masks.clear()
            masks.update(drawn)
            with jax.enable_x64():
                replay = stage(batch, step_key)
            metrics = port.train_step(batch)
            assert not replay and not masks
            stats = torch_to_flax(port.model.state_dict(), port.model)["batch_stats"]
            out[dtype]["port"].append(record(metrics, sink.pop(), stats))
        masks.clear()
    assert not grads
    return out


def _distances(runs: dict, dtype: str) -> dict:
    """The step's distances from float64 in ``dtype`` (``step_probe.
    distances`` on the port's and JAX's runs), pooled over the batches."""
    ref = runs["float64"]
    return {who: step_probe.distances(runs[dtype][who], ref) for who in ("port", "jax")}


def judge(runs: dict, dtype: str) -> tuple:
    """The port's distances from float64 against JAX's of ``dtype``: (where
    ``step_probe.within`` finds them outside its rule, the leaf groups'
    summary, each gradient leaf's root mean square distances of the port
    and JAX and of float64's gradient)."""
    dist = _distances(runs, dtype)
    leaves = {name: (d, dist["jax"]["grads"][name][0], ref)
              for name, (d, ref, _) in dist["port"]["grads"].items()}
    return (step_probe.within(dist["port"], dist["jax"], dtype),
            step_probe.summary(dist["port"], dist["jax"]), leaves)


def check(runs: dict, dtype: str) -> None:
    """Holds the port's distances from float64 within ``judge``'s rule."""
    failures, summary, _ = judge(runs, dtype)
    assert not failures, (failures, json.dumps(summary))


def initial_run(jtrainer, argv: list, toy: Path) -> Path:
    """The JAX trainer's initial weights and statistics written as a port
    run directory of ``argv`` (``config.json`` and ``checkpoint_best.pt``)."""
    t_cfg, t_model_cfg = tconfig.args_to_config(tconfig.get_args(argv))
    port = _port_trainer(argv, toy)
    flax_to_torch(jax.device_get({"params": jtrainer.state.params,
                                  "batch_stats": jtrainer.state.batch_stats}), port.model)
    tconfig.save_config(t_model_cfg, t_cfg)
    run_dir = Path(t_cfg.work_dir) / t_cfg.env_name
    ckpt.save_model(port.model, run_dir, best=True)
    return run_dir


@pytest.mark.slow
@pytest.mark.parametrize("state", sorted(STATE_FILES))
@pytest.mark.parametrize("run", _runs() or ["none"])
def test_step_from_a_trained_state(run, state, toy, tmp_path, monkeypatch, jax_recipe):
    """The step from a trained ``state`` of ``run`` (``build/trained/``) at
    the recipe's B = 16 over ``N_BATCHES`` batches, in float32 and in
    bfloat16, by ``step_probe.within``'s rule; writes the summary by leaf
    group (``build/trained/witness/``) and the card probe's input
    (``build/trained/probe/``)."""
    if run == "none":
        pytest.skip("no trained run in build/trained (run_stream_seeds.sh brings them back)")
    runs = steps_from(TRAINED / run, state, toy, tmp_path, monkeypatch, jax_recipe,
                      lambda work, dtype: _argv(toy, work, RECIPE_B, dtype), tuple(DTYPES))
    judged = {dtype: judge(runs, dtype) for dtype in DTYPES}
    (TRAINED / "witness").mkdir(exist_ok=True)
    (TRAINED / "witness" / f"{run}_{state}.json").write_text(json.dumps(
        {dtype: {"failures": failures, "summary": summary, "grads": leaves}
         for dtype, (failures, summary, leaves) in judged.items()}, indent=1, default=float))
    batch, augmented, masks, state_dict = runs["inputs"]
    first = {dtype: {who: step_probe.distances(runs[dtype][who][:1], runs["float64"][:1])
                     for who in ("port", "jax")} for dtype in DTYPES}
    (TRAINED / "probe").mkdir(exist_ok=True)
    torch.save({
        "flags": _argv(Path("TOY"), Path("WORK"), RECIPE_B, "float32"),
        "state_dict": state_dict, "batch": batch, "augmented": augmented, "masks": masks,
        "reference": runs["float64"][0], "cpu": first}, TRAINED / "probe" / f"{run}_{state}.pt")
    assert not any(failures for failures, *_ in judged.values()), {
        dtype: failures for dtype, (failures, *_) in judged.items()}
