"""The REINFORCE STOP fine-tune where ``test_torch_rl_recipe.py`` does not
look: what only a warm-started, STOP-enabled, free-running run touches,
each part held against the JAX package on the CPU at a small size (the
recipe's flags with gpt-nano widths and one decoder layer, the yolox-nano
``gpt_backbone`` embedder, 64 px patches, B = 4, float32).

- The warm start (``--init-from``) grafts an 8-action checkpoint into the
  9-action STOP model, from the JAX package's msgpack and from the port's
  own ``.pt``: every leaf of the source is the source's in both packages,
  bit for bit, and the new STOP rows of the action head and ``wte`` keep
  the fresh init, normal(0, 0.02) as the JAX package draws it (a
  distribution, since the random streams differ).
- The REINFORCE loss after STOP: the port recomputes the rollout's
  log-probabilities with one teacher-forced forward
  (``reinforce.teacher_forced``) where the JAX package keeps its scan's
  own, and differentiates that forward where JAX differentiates through the
  scan. After a STOP the env is frozen, the positions repeat, the previous
  action is STOP and ``logit_masks`` zero the steps. The JAX package's
  sampled rollout, in which rows press STOP early, late and never (the
  STOP row of the head scaled alike in both packages), and the port's
  rollout made to take its actions: the rollouts, the recomputed
  log-probabilities and entropies at every step, and the gradients of the
  action loss and of the entropy term on every weight.
- The return normalisation at ``--gradient-accumulation 4
  --steps-per-dispatch 4``: the (mean, std) that each package's train loop
  hands every iteration of three windows, the steps' return sums drawn
  with episode lengths that vary as STOP makes them.

And the port alone: ``time_recipe --keep-last`` keeps the weights a run
ends its training with, which the final validation overwrites; and the
card's wrappers of the recipes (``run_flagship_seed.sh``,
``run_rlft_seed.sh``, ``run_rlft_samples.sh``) take the pairing from
``DETECTOR``: unset, the yolox-s detector with a yolox-nano
``gpt_backbone``; ``yolox-nano``, the recipes' default shared pairing. Each
runs end to end on the CPU (``JOLINEEDLE_TORCH_DEVICE=cpu``, stand-ins for
``nvidia-smi`` and for ``python``, which logs each train CLI call and
shortens it to 4 iterations at B = 2) and leaves the pairing's run
directory and quality bands.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp
from flax import serialization

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.train.reinforce import ReinforceTrainer as JaxReinforce
import main as jax_main
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.env.batched_env import NeedleEnv
from jolineedle_tpu_torch.main import build_trainer
from jolineedle_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from jolineedle_tpu_torch.models.gpt import GPT
from jolineedle_tpu_torch.parallel import mesh
from jolineedle_tpu_torch.scripts import make_toyds_big, time_recipe
from jolineedle_tpu_torch.train import reinforce as treinforce
from jolineedle_tpu_torch.train import rollout as rollout_module
from jolineedle_tpu_torch.train.rollout import rollout
from test_torch_recipes import _flat, _recipe_argv

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

B, T, N_LAYER, STOP = 4, 6, 1, 8  # STOP is the last action id
HEAD, WTE = ("params", "action_head", "Dense_0", "kernel"), ("params", "wte", "embedding")
# The graft's fresh rows: drawn by INIT_SEEDS port models, held to
# normal(0, DENSE_STD) by a Kolmogorov-Smirnov test at KS_P (the seeds are
# fixed, so the test is deterministic; a std of 0.8 or 1.25 times 0.02 fails it).
INIT_SEEDS, DENSE_STD, KS_P = 16, 0.02, 1e-3
# The STOP rollout: the head's STOP row times STOP_SCALE, the batch from
# BATCH_SEED, starts from START_SEED and JAX's sampling key SAMPLE_KEY give
# rows that STOP at steps 0, 1 and 5 and never. Float32 on both sides: the
# log-probabilities and entropies within LOGP_RTOL (plus LOGP_ATOL near 0),
# each gradient leaf within GRAD_RTOL of its largest value.
STOP_SCALE, BATCH_SEED, START_SEED, SAMPLE_KEY = 2.0, 3, 0, 7
# The port's Gumbel-max sampling made to take JAX's action: uniforms that
# add about 16.6 to its logit and -4.2 to the others'.
U_TAKEN, U_OTHER = 1.0 - 2.0 ** -24, 1e-30
LOGP_RTOL, LOGP_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-5
RET_MEAN, RET_STD = 0.37, 1.9  # a previous window's return statistics
# The window: three windows of WINDOW iterations in chunks of WINDOW; the
# JAX loop sums a chunk's statistics in float32, the port in float64.
WINDOW, N_WINDOWS, WINDOW_RTOL = 4, 3, 1e-6


def _argv(toy, work, init_from=None, stop=True):
    values = {"DATASET_DIR": str(toy), "SUP_RUN": str(init_from), "WORK_DIR": str(work),
              "MAX_ITERS": str(WINDOW * N_WINDOWS), "DETECTOR": "yolox-nano",
              "ENTROPY": "0.01", "EXTRA_FLAGS": "",
              "BACKBONE_FLAGS": "--image-processor yolox-nano --gpt-backbone yolox-nano"}
    argv = _recipe_argv("run_rl_finetune_stop.sh", values,
                        drop=() if stop else ("--enable-stop",))
    if init_from is None:
        i = argv.index("--init-from")
        argv = argv[:i] + argv[i + 2:]
    return argv + ["--batch-size", str(B), "--max-seq-len", str(T), "--max-det-patches", "2",
                   "--compute-dtype", "float32", "--device-data-cache", "off",
                   "--devices", "0"]


def _jax_configs(argv):
    cfg, model_cfg = args_to_config(get_args(argv))
    model_cfg.n_layer = N_LAYER
    return cfg, model_cfg


def _port_configs(argv):
    cfg, model_cfg = tconfig.args_to_config(tconfig.get_args(argv))
    model_cfg.n_layer = N_LAYER
    return cfg, model_cfg


def _jax_trainer(argv, toy):
    cfg, model_cfg = _jax_configs(argv)
    train, test = jax_main.build_both_datasets(cfg, model_cfg, toy)
    model = JaxGPT.from_config(model_cfg, get_actions_info(cfg))
    return JaxReinforce(cfg, model, None, train, test)


def _port_trainer(argv, toy):
    return build_trainer(mesh.single("cpu"), *_port_configs(argv), toy, log=False)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return make_toyds_big.make_toyds_big(tmp_path_factory.mktemp("stop_ft") / "toy",
                                         n_train=4, n_test=2)


@pytest.fixture(scope="module")
def sources(toy, tmp_path_factory):
    """One 8-action (no STOP) state of the model as the JAX package's
    ``checkpoint_best.msgpack`` and as the port's ``checkpoint_best.pt``:
    what ``--init-from`` reads, by format."""
    root = tmp_path_factory.mktemp("stop_sources")
    cfg, model_cfg = _port_configs(_argv(toy, root / "work", stop=False))
    torch.manual_seed(5)
    model = GPT.from_config(model_cfg, t_actions_info(cfg), device="cpu")
    assert model.action_head.dense.weight.shape[0] == STOP
    state = torch_to_flax(model.state_dict(), model)
    out = {"msgpack": root / "msgpack", "pt": root / "pt"}
    out["msgpack"].mkdir()
    (out["msgpack"] / "checkpoint_best.msgpack").write_bytes(serialization.to_bytes(state))
    out["pt"].mkdir()
    torch.save(model.state_dict(), out["pt"] / "checkpoint_best.pt")
    out["tree"] = serialization.msgpack_restore(
        (out["msgpack"] / "checkpoint_best.msgpack").read_bytes())
    return out


@pytest.fixture(scope="module")
def jax_stop(toy, sources, tmp_path_factory):
    """The JAX package's 9-action STOP trainer warm-started from the msgpack."""
    argv = _argv(toy, tmp_path_factory.mktemp("stop_jax"), sources["msgpack"])
    trainer = _jax_trainer(argv, toy)
    trainer.load_params_checkpoint(sources["msgpack"])
    return trainer, argv


# --- (a) the warm start's graft across 8 -> 9 actions ------------------------------
@pytest.mark.parametrize("fmt", ["msgpack", "pt"])
def test_warm_start_graft_equals_jax(toy, sources, jax_stop, tmp_path, fmt):
    jtrainer, _ = jax_stop
    argv = _argv(toy, tmp_path / "work", sources[fmt])
    port = _port_trainer(argv, toy)  # --init-from, as the CLI loads it
    want = _flat(jax.device_get({"params": jtrainer.state.params,
                                 "batch_stats": jtrainer.state.batch_stats}))
    got = _flat(torch_to_flax(port.model.state_dict(), port.model))
    source = _flat(sources["tree"])
    assert got.keys() == want.keys() == source.keys()
    grown = set()
    for path, src in source.items():
        src, w, g = np.asarray(src), np.asarray(want[path]), np.asarray(got[path])
        assert w.shape == g.shape, path
        overlap = tuple(slice(0, n) for n in src.shape)
        np.testing.assert_array_equal(g[overlap], src, err_msg=str(path))
        np.testing.assert_array_equal(w[overlap], src, err_msg=str(path))
        if src.shape != w.shape:
            grown.add(path)
    assert grown == {HEAD, WTE}
    # The grown rows are the fresh model's: the same seed's init, kept.
    torch.manual_seed(port.config.seed)
    fresh = GPT.from_config(_port_configs(argv)[1], t_actions_info(port.config), device="cpu")
    assert torch.equal(port.model.action_head.dense.weight[STOP],
                       fresh.action_head.dense.weight[STOP])
    assert torch.equal(port.model.wte.weight[STOP], fresh.wte.weight[STOP])
    assert port.model.action_head.dense.bias is None  # bias-free, as in JAX


def test_stop_rows_draw_as_jax(toy, sources, jax_stop):
    """The fresh STOP rows of the head and ``wte`` over INIT_SEEDS port
    models, and the JAX trainer's own: each normal(0, 0.02), and the two
    draws one distribution."""
    jtrainer, argv = jax_stop
    cfg, model_cfg = _port_configs(argv)
    port = []
    for seed in range(INIT_SEEDS):
        torch.manual_seed(seed)
        model = GPT.from_config(model_cfg, t_actions_info(cfg), device="cpu")
        port += [model.action_head.dense.weight[STOP].detach().numpy(),
                 model.wte.weight[STOP].detach().numpy()]
    port = np.concatenate(port)
    params = jax.device_get(jtrainer.state.params)
    jax_rows = np.concatenate([np.asarray(params["action_head"]["Dense_0"]["kernel"])[:, STOP],
                               np.asarray(params["wte"]["embedding"])[STOP]])
    for draw in (port, jax_rows):
        assert stats.kstest(draw / DENSE_STD, "norm").pvalue > KS_P
    assert stats.ks_2samp(port, jax_rows).pvalue > KS_P
    for scale in (0.8, 1.25):  # the test tells such a std apart
        assert stats.kstest(port / (scale * DENSE_STD), "norm").pvalue < KS_P


# --- (b) the REINFORCE loss and its gradient with episodes that STOP --------------
def _stop_setup(toy, jtrainer, argv, tmp_path):
    """The warm-started weights with the head's STOP row scaled, in both
    packages; a batch and its start positions."""
    params = jax.tree_util.tree_map(np.array, jax.device_get(jtrainer.state.params))
    params["action_head"]["Dense_0"]["kernel"][:, STOP] *= STOP_SCALE
    variables = {"params": params,
                 "batch_stats": jax.tree_util.tree_map(np.array, jax.device_get(
                     jtrainer.state.batch_stats))}
    port = _port_trainer(argv, toy)
    flax_to_torch(variables, port.model)
    n_train = len(jtrainer.train_dataset)
    batch = jtrainer._build_env_batch([i % n_train for i in range(B)], BATCH_SEED,
                                      with_pixels=True)
    P = jtrainer.config.patch_size
    rows, cols = batch["image"].shape[1] // P, batch["image"].shape[2] // P
    rng = np.random.default_rng(START_SEED)
    starts = np.stack([rng.integers(0, rows, B), rng.integers(0, cols, B)], 1).astype(np.int32)
    return variables, port, batch, starts


def _jax_parts(jtrainer, variables, batch, starts):
    """The JAX package's sampled rollout from ``starts`` and the gradients
    of its action loss and its entropy term (``reinforce.py:166-176``),
    through the scan, with the return statistics (RET_MEAN, RET_STD)."""
    cfg = jtrainer.config

    def roll(params):
        env = JaxEnv(jnp.asarray(batch["image"]), jnp.asarray(batch["bboxes"]), cfg.patch_size,
                     T, 1, True)
        return jtrainer._rollout_scan({"params": params,
                                       "batch_stats": variables["batch_stats"]},
                                      env, jax.random.PRNGKey(SAMPLE_KEY), sample=True,
                                      collect=("actions",), positions=jnp.asarray(starts))

    def terms(params):
        ro = roll(params)
        masks = ro["logit_masks"]
        returns = jax.lax.stop_gradient(ro["returns"])
        advantages = (returns - RET_MEAN) / (RET_STD + 1e-8)
        msum = jnp.maximum(masks.sum(), 1.0)
        return (-(ro["logprobs"] * advantages * masks).sum() / msum,
                -(ro["entropies"] * masks).sum() / msum)

    ro = jax.device_get(jax.jit(roll)(variables["params"]))
    grads = jax.device_get(jax.jit(jax.jacrev(terms))(variables["params"]))
    return ro, grads


def _port_grads(model, loss):
    model.zero_grad(set_to_none=True)
    loss.backward()
    grads = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    grads.update({name: p.grad.clone() for name, p in model.named_parameters()
                  if p.grad is not None})
    return _flat(torch_to_flax(grads, model)["params"])


def test_stop_rollout_recompute_and_gradients_equal_jax(toy, jax_stop, tmp_path,
                                                        monkeypatch):
    jtrainer, argv = jax_stop
    variables, port, batch, starts = _stop_setup(toy, jtrainer, argv, tmp_path)
    ro_j, (g_action, g_entropy) = _jax_parts(jtrainer, variables, batch, starts)
    # The mix the test is for: rows that STOP at once, later, and never.
    actions = np.array(ro_j["actions"])
    first = [int(np.argmax(r == STOP)) if (r == STOP).any() else None for r in actions]
    assert None in first and any(f is not None and f <= 1 for f in first) \
        and any(f is not None and f >= 3 for f in first), first

    steps = iter(range(T))

    def forced(sample, shape):  # the uniforms under which Gumbel-max takes JAX's action
        u = torch.full(shape, U_OTHER)
        u[torch.arange(B), torch.from_numpy(actions[:, next(steps)]).long()] = U_TAKEN
        return u

    monkeypatch.setattr(rollout_module, "draw", forced)
    cfg = port.config
    env = NeedleEnv(torch.from_numpy(batch["image"]), batch["bboxes"], cfg.patch_size, T, 1,
                    True, device="cpu")
    ro = rollout(port.model, env, sample=True, generator=torch.Generator(), collect=("actions",),
                 positions=torch.from_numpy(starts).long())

    # The rollouts: the same actions, positions, masks and returns.
    np.testing.assert_array_equal(ro["actions"].numpy(), actions)
    np.testing.assert_array_equal(ro["positions"].numpy(), np.asarray(ro_j["positions"]))
    np.testing.assert_array_equal(ro["logit_masks"].numpy(), np.asarray(ro_j["logit_masks"]))
    np.testing.assert_array_equal(ro["masks"].numpy(), np.asarray(ro_j["masks"]))
    np.testing.assert_allclose(ro["returns"].numpy(), np.asarray(ro_j["returns"]),
                               rtol=1e-6, atol=1e-6)
    for name in ("logprobs", "entropies"):
        np.testing.assert_allclose(ro[name].numpy(), np.asarray(ro_j[name]), rtol=LOGP_RTOL,
                                   atol=LOGP_ATOL, err_msg=f"rollout {name}")

    # The loss's teacher-forced recompute: the scan's values at every step,
    # those after a STOP included.
    fed = {k: ro[k] for k in ("actions", "positions", "logit_masks", "returns", "rewards")}
    with torch.no_grad():
        logprobs, entropies = treinforce.teacher_forced(port.model, env, fed)
    np.testing.assert_allclose(logprobs.numpy(), np.asarray(ro_j["logprobs"]), rtol=LOGP_RTOL,
                               atol=LOGP_ATOL, err_msg="recomputed logprobs")
    np.testing.assert_allclose(entropies.numpy(), np.asarray(ro_j["entropies"]),
                               rtol=LOGP_RTOL, atol=LOGP_ATOL, err_msg="recomputed entropies")

    # The gradients: the action loss alone (entropy weight 0), and the
    # entropy term alone (returns of 0, unnormalised: no action loss).
    loss, _ = treinforce.reinforce_loss(port.model, env, fed, RET_MEAN, RET_STD, 0.0)
    t_action = _port_grads(port.model, loss)
    loss, _ = treinforce.reinforce_loss(port.model, env, dict(fed, returns=torch.zeros_like(
        fed["returns"])), 0.0, 1.0, 1.0, reward_norm=False)
    t_entropy = _port_grads(port.model, loss)
    for name, want, got in (("action", g_action, t_action), ("entropy", g_entropy, t_entropy)):
        want = _flat(want)
        assert want.keys() == got.keys()
        for path, w in want.items():
            w, g = np.asarray(w, np.float64), np.asarray(got[path], np.float64)
            tol = GRAD_RTOL * np.abs(w).max() + 1e-12
            assert np.abs(g - w).max() <= tol, f"{name} gradient {path}"
        # The head's STOP row takes gradient at every live step.
        assert np.abs(np.asarray(want[HEAD[1:]])[:, STOP]).max() > 0


# --- (c) the return-normalisation window at accumulation 4, 4 steps a dispatch ----
def _window_draws(n_iters):
    """Per iteration: (ret_sum, ret_sumsq, ret_count) of B episodes of at
    most T live steps that STOP at varying steps, as float32."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n_iters):
        lengths = rng.integers(1, T + 1, B)
        returns = [rng.normal(0.5, 1.5, n) for n in lengths]
        flat = np.concatenate(returns)
        out.append(np.array([flat.sum(), (flat ** 2).sum(), lengths.sum()], np.float32))
    return out


def test_return_window_equals_jax(toy, jax_stop, tmp_path, monkeypatch):
    """Both train loops, their steps stubbed to record the statistics they
    are handed and to return the drawn sums; no test falls in the run."""
    n_iters = WINDOW * N_WINDOWS
    draws = _window_draws(n_iters)
    jtrainer, argv = jax_stop
    cfg = jtrainer.config
    assert (cfg.max_iters, cfg.gradient_accumulation, cfg.steps_per_dispatch,
            cfg.reward_norm) == (n_iters, WINDOW, WINDOW, True) and cfg.test_every > n_iters
    seen_jax = []

    def multi_step(state, batches, keys, ret_mean, ret_std, pool_images=None):
        n = len(keys)
        first = len(seen_jax)
        seen_jax.extend([(float(ret_mean), float(ret_std))] * n)
        chunk = jnp.asarray(np.stack(draws[first:first + n]))  # float32, summed as the jit does
        window = {k: chunk[:, i].sum() for i, k in enumerate(("ret_sum", "ret_sumsq",
                                                              "ret_count"))}
        return state, {"loss": jnp.float32(0.0)}, window

    monkeypatch.setattr(jtrainer, "_build_multi_train_step", lambda: multi_step)
    monkeypatch.setattr(jtrainer, "test", lambda *a, **k: None)
    monkeypatch.setattr(jtrainer, "prepare_validation", lambda: None)
    jtrainer.run()

    port = _port_trainer(argv, toy)
    seen_port = []

    def train_step(batch):
        seen_port.append((port.last_return_mean, port.last_return_std))
        values = torch.from_numpy(draws[len(seen_port) - 1])
        return {"loss": torch.zeros(()), "ret_sum": values[0], "ret_sumsq": values[1],
                "ret_count": values[2]}

    monkeypatch.setattr(port, "train_step", train_step)
    monkeypatch.setattr(port, "test", lambda *a, **k: None)
    monkeypatch.setattr(port, "prepare_validation", lambda: None)
    port.run()

    assert len(seen_port) == len(seen_jax) == n_iters
    assert seen_jax[:WINDOW] == seen_port[:WINDOW] == [(0.0, 1.0)] * WINDOW
    for w in range(N_WINDOWS):
        window = seen_jax[w * WINDOW:(w + 1) * WINDOW]
        assert window == [window[0]] * WINDOW  # constant inside a window
        if w:
            assert window[0] != seen_jax[(w - 1) * WINDOW]  # and renewed at its end
    np.testing.assert_allclose(np.array(seen_port), np.array(seen_jax), rtol=WINDOW_RTOL)
    # The last window's statistics, from its own draws.
    tail = np.stack(draws[-2 * WINDOW:-WINDOW]).astype(np.float64).sum(0)
    mean = tail[0] / tail[2]
    std = ((tail[1] - tail[2] * mean ** 2) / (tail[2] - 1)) ** 0.5
    np.testing.assert_allclose(seen_port[-1], (mean, std), rtol=WINDOW_RTOL)


# --- the weights a fine-tune ends its training with ------------------------------
def test_time_recipe_keeps_the_last_weights(tmp_path, monkeypatch):
    """``time_recipe --keep-last``: the final validation writes the best
    weights over ``checkpoint.pt`` (as the JAX package does); the copy taken
    when its first line is printed holds the last test's. A stand-in CLI
    writes the last weights, prints the line, and 2 s later the best's."""
    run, dest = tmp_path / "run", tmp_path / "last"
    run.mkdir()
    (run / "config.json").write_text("{}")
    cli = ("import pathlib, time\n"
           f"run = pathlib.Path({str(run)!r})\n"
           "(run / 'checkpoint.pt').write_bytes(b'last')\n"
           "print('iter 256: loss 1.0', flush=True)\n"
           "print('Loading best checkpoint for validation: best', flush=True)\n"
           "time.sleep(2.0)\n"
           "(run / 'checkpoint.pt').write_bytes(b'best')\n")
    monkeypatch.setattr(time_recipe, "query_gpu", lambda fields: ["FAKE GPU, 700.00 W"])
    monkeypatch.setattr(time_recipe, "sample_memory", lambda stop, every, samples: None)
    out = time_recipe.main(["--log", str(tmp_path / "log.txt"), "--keep-last", str(run),
                            str(dest), "--", sys.executable, "-c", cli])
    assert out["rc"] == 0 and out["kept_last"] == str(dest)
    assert (dest / "checkpoint.pt").read_bytes() == b"last"
    assert (run / "checkpoint.pt").read_bytes() == b"best"
    assert (dest / "config.json").read_text() == "{}"


# --- the card's wrappers of the recipes, by pairing ---------------------------------
ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = "jolineedle_tpu_torch/scripts"
# What the stand-in python appends to each train CLI call: B = 2, episodes of
# 4, --max-iters 4 with a test at the 4th (the fine-tune's one chunk and its
# test, whose weights --keep-last copies; the supervised loop runs 3
# iterations and its final validation only).
SHORT = ["--max-iters", "4", "--test-every", "4", "--batch-size", "2", "--test-samples", "2",
         "--max-seq-len", "4", "--compute-dtype", "float32"]
PAIRINGS = {None: ["--image-processor", "yolox-s", "--gpt-backbone", "yolox-nano"],
            "yolox-nano": ["--image-processor", "yolox-nano"]}
# The quality bands each pairing's wrapper writes (the JAX runs ± 0.08).
SUP_BANDS = {None: {"map": [0.28, 0.52], "map_multistart_2": [0.46, 0.68],
                    "supervised_map": [0.73, 0.97]},
             "yolox-nano": {"map": [0.35, 0.53], "map_multistart_2": [0.50, 0.67],
                            "supervised_map": [0.69, 0.86]}}
RLFT_BANDS = {None: {"map": [0.54, 0.70], "yolo_map": [0.81, 0.97], "stop_used": [0.42, 0.59],
                     "stop_misused": [0.0, 0.12]},
              "yolox-nano": {"map": [0.49, 0.65], "yolo_map": [0.64, 0.80],
                             "stop_used": [0.43, 0.59], "stop_misused": [0.0, 0.09]}}


def _stand_ins(tmp):
    """A bin directory with a ``python`` (this interpreter; each train CLI
    call logged to ``calls.txt`` and shortened by SHORT) and an
    ``nvidia-smi`` that answers the wrappers' and ``time_recipe``'s queries."""
    bin_dir = tmp / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp / "calls.txt"
    (bin_dir / "python").write_text(
        "#!/bin/sh\n"
        'if [ "$1 $2" = "-m jolineedle_tpu_torch.main" ]; then\n'
        f'  echo "$*" >> "{log}"\n'
        f'  exec "{sys.executable}" "$@" {" ".join(SHORT)}\n'
        "fi\n"
        f'exec "{sys.executable}" "$@"\n')
    (bin_dir / "nvidia-smi").write_text(
        "#!/bin/sh\n"
        'case "$1" in\n'
        '  *name,power.limit*) echo "FAKE GPU, 700.00 W" ;;\n'
        '  *clocks.max.sm*) echo "1980 MHz" ;;\n'
        '  *) echo "1000, 100.0, 1980, 2619" ;;\n'
        "esac\n")
    for name in ("python", "nvidia-smi"):
        (bin_dir / name).chmod(0o755)
    return bin_dir, log


def _wrapper(script, args, tmp, detector, extra_env=None):
    """``sh`` the wrapper from the repo's root with the stand-ins first on the
    PATH and ``DETECTOR`` set to ``detector`` (unset for None); returns the
    process and the train CLI calls it made, each as its list of flags."""
    bin_dir, log = _stand_ins(tmp)
    env = {k: v for k, v in os.environ.items() if k != "DETECTOR"}
    env.update({"PATH": f"{bin_dir}{os.pathsep}{env['PATH']}", "PYTHONPATH": str(ROOT),
                "JOLINEEDLE_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1", "SEED": "1",
                **(extra_env or {})})
    if detector is not None:
        env["DETECTOR"] = detector
    proc = subprocess.run(["sh", f"{SCRIPTS}/{script}", *map(str, args)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    calls = [line.split()[2:] for line in log.read_text().splitlines()] if log.exists() else []
    return proc, calls


def _pairing_of(flags):
    i = flags.index("--image-processor")
    return flags[i:i + 4] if "--gpt-backbone" in flags else flags[i:i + 2]


@pytest.fixture(scope="module")
def flagship_wrappers(toy, tmp_path_factory):
    """``run_flagship_seed.sh`` once per pairing, each from its own
    directory: {detector: (process, its CLI calls, out dir, run dir)}."""
    runs = {}
    for detector in PAIRINGS:
        tmp = tmp_path_factory.mktemp(f"wrapper_sup_{detector}")
        proc, calls = _wrapper("run_flagship_seed.sh", [tmp / "out", tmp / "work"], tmp,
                               detector, {"DATASET_DIR": str(toy)})
        runs[detector] = (proc, calls, tmp / "out",
                          tmp / "work" / f"r3_sup_{detector or 'yolox-s'}")
    return runs


@pytest.mark.parametrize("detector", list(PAIRINGS), ids=["default", "yolox-nano"])
def test_flagship_wrapper_takes_the_pairing(flagship_wrappers, detector):
    """The supervised wrapper trains ``run_sup_flagship.sh <work>
    $DETECTOR`` (default yolox-s): that pairing's flags, its run directory,
    the eval_checkpoint cross-check, and its bands in ``bands.json``."""
    proc, calls, out, run_dir = flagship_wrappers[detector]
    (flags,) = calls
    assert _pairing_of(flags) == PAIRINGS[detector]
    assert flags[flags.index("--env-name") + 1] == f"sup_{detector or 'yolox-s'}"
    assert flags[flags.index("--max-iters") + 1] == "20000"  # the recipe's, before SHORT
    config = json.loads((run_dir / "config.json").read_text())
    assert config["model"]["image_processor"] == (detector or "yolox-s")
    assert config["model"]["gpt_backbone"] == (None if detector else "yolox-nano")
    assert "eval_checkpoint against the final validation" in proc.stdout
    bands = json.loads((out / "bands.json").read_text())
    assert bands["detector"] == (detector or "yolox-s")
    assert {k: v["band"] for k, v in bands["best"].items()} == SUP_BANDS[detector]
    assert json.loads((out / "time_recipe.json").read_text())["card"] == "FAKE GPU, 700.00 W"


@pytest.mark.parametrize("detector", list(PAIRINGS), ids=["default", "yolox-nano"])
def test_rlft_wrapper_takes_the_pairing(toy, flagship_wrappers, tmp_path, detector):
    """The fine-tune wrapper from the same pairing's supervised run:
    ``run_rl_finetune_stop.sh <work>/rlft <sup run> $DETECTOR`` with that
    pairing's flags and the fine-tune's seed, its run directory, the best
    and the last checkpoint's rows in the pairing's bands."""
    sup_run = flagship_wrappers[detector][3]
    proc, calls = _wrapper("run_rlft_seed.sh", [tmp_path / "out", tmp_path / "work", sup_run],
                           tmp_path, detector, {"DATASET_DIR": str(toy), "RLFT_SEED": "3"})
    (flags,) = calls
    assert _pairing_of(flags) == PAIRINGS[detector]
    assert flags[flags.index("--init-from") + 1] == str(sup_run)
    assert flags[flags.index("--env-name") + 1] == f"rlft_{detector or 'yolox-s'}"
    assert flags[-2:] == ["--seed", "3"]  # RLFT_SEED, the last --seed
    name = f"r3_rlft_{detector or 'yolox-s'}"
    assert (tmp_path / "work" / "rlft" / name / "checkpoint.pt").exists()
    assert (tmp_path / "work" / "rlft_last" / "checkpoint.pt").exists()
    bands = json.loads((tmp_path / "out" / "bands.json").read_text())
    assert bands["detector"] == (detector or "yolox-s") and bands["rlft_seed"] == 3
    want = dict(RLFT_BANDS[detector], episode_length=[0.0, 20.0 - 1e-9])
    for which in ("best", "last"):
        got = {k: v["band"] for k, v in bands[which].items() if k != "map_above_warm_start"}
        assert got == want, which
    assert "pace:" in proc.stdout


@pytest.mark.parametrize("detector", list(PAIRINGS), ids=["default", "yolox-nano"])
def test_rlft_samples_pass_the_pairing_on(tmp_path, detector):
    """``run_rlft_samples.sh`` starts ``run_rlft_seed.sh`` once per seed with
    ``DETECTOR`` as it was given (yolox-s when unset), from a stand-in
    repository whose ``run_rlft_seed.sh`` records what it was handed."""
    scripts = tmp_path / "repo" / SCRIPTS
    scripts.mkdir(parents=True)
    (scripts / "run_rlft_samples.sh").write_text(
        (ROOT / SCRIPTS / "run_rlft_samples.sh").read_text())
    (scripts / "run_rlft_seed.sh").write_text(
        'echo "DETECTOR=$DETECTOR RLFT_SEED=$RLFT_SEED $*" > "$1/handed.txt"\n')
    toy = tmp_path / "toy"
    toy.mkdir()
    (toy / "train.txt").write_text("")
    env = {k: v for k, v in os.environ.items() if k != "DETECTOR"}
    env.update({"DATASET_DIR": str(toy), "SEED": "1", "RLFT_SEEDS": "2 3"})
    if detector is not None:
        env["DETECTOR"] = detector
    proc = subprocess.run(["sh", f"{SCRIPTS}/run_rlft_samples.sh", "sup", "out", "work"],
                          cwd=tmp_path / "repo", env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for seed in (2, 3):
        handed = (tmp_path / "repo" / "out" / f"rlft_s1_f{seed}" / "handed.txt").read_text()
        assert handed.split() == [f"DETECTOR={detector or 'yolox-s'}", f"RLFT_SEED={seed}",
                                  f"out/rlft_s1_f{seed}", f"work/rlft_s1_f{seed}", "sup"]
