"""The supervised step on the key route (``Trainer.key_stream``: JAX's own
random numbers, ``utils/jax_random.py``) against the JAX package's, and the
train state's resume across devices:

- (e) from JAX seed 1's initial state at the recipe's flags (the shared
  yolox-nano pairing, B = 4, dropout 0.1, ``--augment-translate``) in
  float32, the port's ``train_step`` on the key route against the JAX
  step under the same step key, with no draw injected: the loss terms,
  the per-leaf gradients before AdamW and the BatchNorm statistics after
  the step; the default route (the trainer's ``torch.Generator``) from the
  same state on the same batch fails that rule;
- the bf16 recipe's step holds float32 products only in the three Dense
  layers that ``GPT.tpu_default_precision`` covers (read off the JAX
  step's jaxpr), besides the shadow's bilinear resize, which XLA runs at
  ``HIGHEST`` precision;
- (g) the default route unchanged: three iterations of the CLI give the
  losses and state digests that they gave before the key route existed;
- fault 3: a train state written on the card (a CUDA generator's 16-byte
  state) resumes on the CPU, its generator reseeded from ``--seed`` with a
  printed line; a CPU-to-CPU resume stays bit-exact; the key route
  resumes its (seed, steps per dispatch) and step;
- the launcher: ``stream_seed.py --jax-keys N`` runs the CLI on the JAX
  loop's keys, ``--tpu-default-precision`` turns the option on, and
  ``sup_probe`` hands both on.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu.train.batching import build_supervised_batch
from jolineedle_tpu_torch import checkpoint as ckpt
from jolineedle_tpu_torch import main as tmain
from jolineedle_tpu_torch.models.bridge import gpt_param_entries, torch_to_flax
from jolineedle_tpu_torch.scripts import make_toyds_big, stream_seed, sup_probe, time_recipe
from jolineedle_tpu_torch.train.supervised import SupervisedTrainer
from jolineedle_tpu_torch.utils import jax_random as jr

from test_torch_recipes import (LOSS_TERMS, LOSS_RTOL, STATE_ATOL, _flat, _host_state,
                                _jax_iterations, _jax_trainer, _load_port, _port_trainer,
                                _trajectory_argv, _tree)
from test_torch_shared_recipe_witnesses import _capture_grads
from test_torch_trained_state import _grads_sink

# The suite runs in several test processes that share the cores.
torch.set_num_threads(1)

SMALL_B = 4
# Float32 against float32 (not against JAX's float64 step, as the
# trajectory tests hold the port): two orders of summation through the
# train-mode embedder and detector, whose batch statistics amplify them.
# Per leaf, the root mean square of the port's gradient's distance from
# JAX's over the RMS of JAX's (measured here: a median of 0.006 over the
# leaves, 0.021 at most; on an 8-image toy set 0.075 on embed_fpn_conv's
# kernel, where two outputs lie within float32's spread of ReLU's kink;
# the default route's own draws: a median of 1.2), and each BN statistic
# within a share of its leaf's largest value (measured 1.3e-3 at most, on
# the head's 2x2 maps, where the trajectory's 1e-3 against float64 holds
# the port alone).
GRAD_RMS_RTOL, GRAD_MEDIAN_RTOL, STATS_F32_RTOL = 0.1, 0.01, 5e-3


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return make_toyds_big.make_toyds_big(tmp_path_factory.mktemp("keys") / "toy",
                                         n_train=16, n_test=2)


def _recipe_argv(toy: Path, work: Path, n_iters: int = 3) -> list:
    """The recipe's flags at B = 4 with its dropout (0.1) and its
    ``--augment-translate``, in float32."""
    return _trajectory_argv(toy, work, n_iters, drop=(), dropout=None) + [
        "--batch-size", str(SMALL_B)]


@pytest.fixture(scope="module")
def jax_recipe(toy, tmp_path_factory):
    """The JAX trainer of the recipe's flags (seed 1's initial state), its
    step sending its gradients to the returned list."""
    jtrainer = _jax_trainer(_recipe_argv(toy, tmp_path_factory.mktemp("jax")), toy)
    assert jtrainer.model.dropout == 0.1 and jtrainer.config.translations
    grads = _capture_grads(jtrainer)
    jtrainer._train_step = jtrainer._build_train_step()
    return jtrainer, grads


def _rel_rms(got: dict, want: dict) -> dict:
    return {k: float(np.sqrt(np.mean((got[k] - v) ** 2)) / np.sqrt(np.mean(v ** 2)))
            for k, v in want.items() if np.any(v)}


def _judge(j_terms, j_grads, j_stats, t_terms, t_grads, t_stats) -> list:
    """The failures of the port's step against JAX's: the loss terms
    within ``LOSS_RTOL``, every leaf's gradient within ``GRAD_RMS_RTOL``
    and their median within ``GRAD_MEDIAN_RTOL``, the BN statistics within
    ``STATS_F32_RTOL`` of their leaf's largest value."""
    failures = [f"{n}: {t_terms[n]} against {j_terms[n]}" for n in LOSS_TERMS
                if abs(t_terms[n] - j_terms[n]) > LOSS_RTOL * abs(j_terms[n])]
    assert t_grads.keys() == j_grads.keys() and t_stats.keys() == j_stats.keys()
    rel = _rel_rms(t_grads, j_grads)
    stats = max(np.abs(t_stats[k] - v).max() / np.abs(v).max() for k, v in j_stats.items())
    terms = max(abs(t_terms[n] / j_terms[n] - 1) for n in LOSS_TERMS)
    print(f"loss terms within {terms:.3g}; gradients: median {np.median(list(rel.values())):.4f},"
          f" max {max(rel.values()):.4f}; statistics {stats:.3g} of their leaf's largest")
    failures += [f"gradient {'/'.join(k)}: {v:.4f}" for k, v in rel.items() if v > GRAD_RMS_RTOL]
    if np.median(list(rel.values())) > GRAD_MEDIAN_RTOL:
        failures.append(f"median gradient distance {np.median(list(rel.values())):.4f}")
    failures += [f"statistic {'/'.join(k)}" for k, v in j_stats.items()
                 if np.abs(t_stats[k] - v).max() > STATS_F32_RTOL * np.abs(v).max() + STATE_ATOL]
    return failures


def test_key_route_step_equals_the_jax_step(toy, tmp_path, jax_recipe):
    """(e) One iteration from JAX seed 1's initial state: the JAX step
    under the loop's first step key, the port's step on the key route at
    step 0 (whose key it is), on the same host batch."""
    jtrainer, grads = jax_recipe
    port = _port_trainer(_recipe_argv(toy, tmp_path), toy)
    entries, sink = gpt_param_entries(port.model), _grads_sink(port)
    start = _host_state(jtrainer.state, np.float32)
    _, indices, seed, step_key = next(_jax_iterations(jtrainer, 1))
    batch = build_supervised_batch(jtrainer.train_dataset, indices, jtrainer.config,
                                   np.random.default_rng(seed))
    state, j_metrics = jtrainer._train_step(
        jax.tree_util.tree_map(jnp.asarray, _tree(jax.device_get(jtrainer.state), np.float32)),
        jax.tree_util.tree_map(jnp.asarray, batch), step_key, None)
    jax.effects_barrier()
    want = ({n: float(j_metrics[n]) for n in LOSS_TERMS}, _flat(_tree(grads.pop(), np.float64)),
            _flat(_tree(jax.device_get(state.batch_stats), np.float64)))

    def port_step(key_stream):
        _load_port(port, start, entries)
        port.key_stream = key_stream
        metrics = port.train_step(batch)
        return ({n: float(metrics[n]) for n in LOSS_TERMS}, _flat(_tree(sink.pop(), np.float64)),
                _flat(_tree(torch_to_flax(port.model.state_dict(), port.model)["batch_stats"],
                            np.float64)))

    stream = jr.KeyStream(jtrainer.config.seed)
    assert stream.step_key(0) == tuple(np.asarray(step_key).astype(np.int64).tolist())
    failures = _judge(*want, *port_step(stream))
    assert not failures, failures
    assert _judge(*want, *port_step(None))  # the trainer's generator: other draws


#: Where the JAX GPT's float32 Dense layers call ``dot_general``
#: (``jolineedle_tpu/models/gpt.py``): the action head, ``embed_fpn_dense``
#: in ``embed_patches`` and ``project_concat`` in ``_fuse_tokens``.
F32_DENSE_LINES = {("gpt.py", 135), ("gpt.py", 266), ("gpt.py", 296)}


def _products(jaxpr) -> list:
    """Every ``dot_general`` and ``conv_general_dilated`` of a jaxpr and
    the jaxprs inside it: (primitive, operand dtypes, precision, the JAX
    package's innermost frame)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            frames = [(Path(f.file_name).name, f.line_num)
                      for f in eqn.source_info.traceback.frames
                      if "jolineedle_tpu/" in f.file_name]
            out.append((eqn.primitive.name, tuple(str(v.aval.dtype) for v in eqn.invars),
                        eqn.params.get("precision"), frames[0] if frames else None))
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out += _products(inner)
    return out


def test_the_bf16_steps_float32_products_are_the_three_dense_layers(toy, tmp_path, jax_recipe):
    """The option's scope: in the recipe's bf16 step, every float32 product
    at XLA's default precision (which a TPU runs as one bf16 pass) is a
    forward or backward product of the three Dense layers; the only other
    float32 products are the bilinear resize's, at ``HIGHEST``."""
    jtrainer, _ = jax_recipe
    bf16 = jtrainer.model.clone(compute_dtype=jnp.bfloat16)
    model, jtrainer.model = jtrainer.model, bf16
    try:
        step = jtrainer._build_train_step()
    finally:
        jtrainer.model = model
    _, indices, seed, step_key = next(_jax_iterations(jtrainer, 1))
    batch = build_supervised_batch(jtrainer.train_dataset, indices, jtrainer.config,
                                   np.random.default_rng(seed))
    jaxpr = jax.make_jaxpr(lambda s, b, k: step(s, b, k, None))(
        jtrainer.state, jax.tree_util.tree_map(jnp.asarray, batch), step_key)
    products = _products(jaxpr.jaxpr)
    assert any(p[1] == ("bfloat16", "bfloat16") for p in products)  # the bf16 convs
    f32 = [p for p in products if "float32" in p[1]]
    default = [p for p in f32 if p[2] is None or p[2] == (None, None)
               or "DEFAULT" in str(p[2])]
    assert {p[3] for p in default} == F32_DENSE_LINES
    assert all(p[0] == "dot_general" and p[1] == ("float32", "float32") for p in default)
    assert len(default) == 3 * len(F32_DENSE_LINES)  # the forward and two transposes
    assert all("HIGHEST" in str(p[2]) and p[3][0] == "augment.py" for p in f32
               if p not in default)


#: Three iterations of ``_default_argv``'s CLI on the CPU (PyTorch 2.13,
#: one intra-op thread), recorded before the key route existed: each
#: iteration's loss and the trainer's ``state_digest`` after it.
DEFAULT_ROUTE = [
    (83.7618637084961, "0d211eff01ef61bea5e9d7679b8310360cdb44a7b955fa0537f392d77de42369"),
    (74.71592712402344, "18f467a8bc2575648cb1556c82f3c073113510098fbe09a7b8fb533dd822b33c"),
    (84.34510040283203, "323fca5145652736f474d9a5a163009ff669635aa70fa9f8bb5c6f1114c72115"),
]


def _default_argv(toy: Path, work: Path, n_iters: int = 3) -> list:
    """``run_sup_flagship.sh``'s flags (the shared yolox-nano pairing, seed
    1, dropout 0.1, ``--augment-translate``) at B = 2 in float32."""
    values = {"SEED": "1", "DATASET_DIR": str(toy), "WORK_DIR": str(work),
              "MAX_ITERS": str(n_iters + 1), "SPD": "1", "DETECTOR": "yolox-nano",
              "BACKBONE_FLAGS": sup_probe.backbone_flags("yolox-nano")}
    return sup_probe.recipe_argv(values) + [
        "--batch-size", "2", "--compute-dtype", "float32", "--test-every", "1000",
        "--test-samples", "2", "--devices", "0"]


def _recorded_cli(argv: list, monkeypatch, launcher=None) -> list:
    """The CLI's iterations (through ``launcher`` if given): per iteration,
    the trainer, its loss and the state digest after it."""
    seen, step = [], SupervisedTrainer.train_step

    def recorded(self, batch):
        metrics = step(self, batch)
        seen.append((self, float(metrics["loss"]), self.state_digest()))
        return metrics

    monkeypatch.setattr(SupervisedTrainer, "train_step", recorded)
    monkeypatch.setenv("JOLINEEDLE_TORCH_DEVICE", "cpu")
    (launcher or tmain.cli)(argv)
    return seen


def test_default_route_is_unchanged(toy, tmp_path, monkeypatch):
    """(g) The trainer's generator and its order, bit for bit: the
    per-iteration losses and digests of weights, statistics, optimizer,
    generator and step recorded before the key route. (The trajectory
    tests replay JAX's draws into the port and so cannot see the
    generator's.)"""
    seen = _recorded_cli(_default_argv(toy, tmp_path), monkeypatch)
    assert seen[0][0].key_stream is None
    assert [(loss, digest) for _, loss, digest in seen] == DEFAULT_ROUTE


def _trainer(toy: Path, work: Path):
    return _port_trainer(_default_argv(toy, work, n_iters=1), toy)


def test_card_train_state_resumes_on_the_cpu(toy, tmp_path, capsys):
    """Fault 3: a ``train_state.pt`` whose generator is a CUDA generator's
    (16 bytes: its seed and offset) resumes on the CPU: weights, optimizer
    and step as saved, the generator restarted from ``--seed`` (as the JAX
    package's key restarts from ``PRNGKey(seed)``), one line says so."""
    written = _trainer(toy, tmp_path / "a")
    written.step = 7
    state = written.train_state()
    state["generator"] = torch.tensor([5, 0, 0, 0, 0, 0, 0, 0, 96, 1, 0, 0, 0, 0, 0, 0],
                                      dtype=torch.uint8)
    run = tmp_path / "card_run"
    ckpt.save_model(written.model, run, best=False)
    ckpt.save_train_state(state, run)
    resumed = _trainer(toy, tmp_path / "b")
    torch.rand(3, generator=resumed.generator)  # moved away from the seed
    resumed.load_checkpoint(run)
    assert "its draws restart from --seed 1" in capsys.readouterr().out
    assert resumed.step == 7 and resumed.key_stream is None
    assert torch.equal(resumed.generator.get_state(),
                       torch.Generator().manual_seed(1).get_state())


def test_cpu_resume_stays_bit_exact_and_the_key_route_resumes(toy, tmp_path, capsys):
    written = _trainer(toy, tmp_path / "a")
    torch.rand(5, generator=written.generator)
    written.step = 11
    written.key_stream = jr.KeyStream(3, 4)
    run = tmp_path / "cpu_run"
    ckpt.save_model(written.model, run, best=False)
    ckpt.save_train_state(written.train_state(), run)
    resumed = _trainer(toy, tmp_path / "b")
    resumed.load_checkpoint(run)
    assert "restart" not in capsys.readouterr().out
    assert torch.equal(resumed.generator.get_state(), written.generator.get_state())
    assert torch.equal(torch.rand(4, generator=resumed.generator),
                       torch.rand(4, generator=written.generator))
    assert resumed.step == 11 and resumed.key_stream.state_dict() == {
        "seed": 3, "steps_per_dispatch": 4}
    assert resumed.step_draws(3) == written.step_draws(3)


def test_launcher_runs_the_cli_on_the_jax_loops_keys(toy, tmp_path, monkeypatch):
    """``--jax-keys 4 --tpu-default-precision``: each iteration's step key
    is the JAX loop's at ``--steps-per-dispatch`` 4, and the model computes
    its train-step products at the TPU's precision."""
    used, draws = [], SupervisedTrainer.step_draws

    def recorded(self, n):
        used.append(self.key_stream.step_key(self.step))
        return draws(self, n)

    monkeypatch.setattr(SupervisedTrainer, "step_draws", recorded)
    seen = _recorded_cli(["--jax-keys", "4", "--tpu-default-precision", "--",
                          *_default_argv(toy, tmp_path)], monkeypatch, stream_seed.main)
    trainer = seen[0][0]
    assert trainer.model.tpu_default_precision and trainer.key_stream.state_dict() == {
        "seed": 1, "steps_per_dispatch": 4}
    key, sub = jax.random.split(jax.random.PRNGKey(1))
    want = [tuple(np.asarray(k).astype(np.int64).tolist()) for k in jax.random.split(sub, 4)[:3]]
    assert used == want
    assert [loss for _, loss, _ in seen] != [loss for loss, _ in DEFAULT_ROUTE]


def test_launcher_refuses_the_key_route_off_the_supervised_step(toy, tmp_path):
    argv = _default_argv(toy, tmp_path)
    argv[argv.index("--training-mode") + 1] = "reinforce"
    with pytest.raises(ValueError, match="supervised step"):
        stream_seed.main(["--jax-keys", "1", "--", *argv])
    with pytest.raises(SystemExit):
        stream_seed.main(["--stream-seed", "2", "--jax-keys", "1", "--", *argv])


def test_sup_probe_hands_the_key_route_on(toy, tmp_path, monkeypatch):
    """``run_flagship_seed.sh``'s ``JAX_KEYS`` and ``TPU_PRECISION`` (with
    ``INIT_FROM``) reach the launcher through ``sup_probe``."""
    calls = []
    monkeypatch.setattr(time_recipe, "main", lambda argv: calls.append(argv) or {
        "rc": 0, "tests": []})
    monkeypatch.setenv("DATASET_DIR", str(toy))
    assert sup_probe.main([str(tmp_path / "out"), str(tmp_path / "work"), "--tests", "0",
                           "--jax-keys", "4", "--tpu-default-precision", "--",
                           "--init-from", "runs/jax_init"]) == 0
    (argv,) = calls
    command = argv[argv.index("--") + 1:]
    assert command[1:7] == ["-m", "jolineedle_tpu_torch.scripts.stream_seed", "--jax-keys", "4",
                            "--tpu-default-precision", "--"]
    assert command[-2:] == ["--init-from", "runs/jax_init"]
