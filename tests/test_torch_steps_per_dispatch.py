"""``--steps-per-dispatch N`` in the port's train CLI, against the JAX
package's trainers and against the port at N = 1.

The JAX trainers take N iterations per jitted dispatch: each work item draws
N single picks, chunk k is built from the first pick's seed + k (the k-th
pick's own seed), and the host looks only at a chunk's end
(``jolineedle_tpu/train/supervised.py:277-384``,
``jolineedle_tpu/train/reinforce.py:399-496``). The port's chunk is a loop
over its steps (``Trainer.train_loop``). gpt-pico with a yolox-nano embedder
and detector, patch 32, float32 on the CPU.

- the host chunks at N = 3 (both modes, with the pixels and for the device
  pool) are bit-equal to the JAX package's stacked chunks, built from the JAX
  trainers' own batch functions on the same picks, as ``tests/
  test_multistep.py`` builds them;
- a port run at N = 3 (supervised) or N = 2 (REINFORCE) through the train
  CLI equals the run at N = 1: every iteration's loss within ``LOSS_RTOL``
  (1e-4, ``chip_smoke.py``'s tolerance for two runs of one path), the final
  weights and statistics within ``STATE_TOL``, the REINFORCE return window
  within 1e-12 (float64 sums); the last chunk is short; tests run and losses
  print only at chunks' ends; a resume at N continues as the resume at N = 1;
- the CLI's errors for an N that does not divide are JAX's, word for word.
"""

import re
import types

import numpy as np
import pytest
import torch

import main as jax_main
from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.train.batching import build_supervised_batch
from jolineedle_tpu.train.reinforce import ReinforceTrainer as JaxReinforce
from jolineedle_tpu.train.reinforce import fixed_training_shape
from jolineedle_tpu.train.supervised import SupervisedTrainer as JaxSupervised
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.data.toy import generate_toy_dataset
from jolineedle_tpu_torch.main import build_trainer
from jolineedle_tpu_torch.main import main as train_main
from jolineedle_tpu_torch.parallel import mesh
from jolineedle_tpu_torch.train.trainer import Trainer

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, T = 32, 3
LOSS_RTOL = 1e-4
STATE_TOL = dict(rtol=1e-5, atol=1e-7)


def _flags(mode, toy, work_dir, extra=()):
    return [
        "--training-mode", mode, "--dataset-dir", str(toy), "--work-dir", str(work_dir),
        "--model-type", "gpt-pico", "--image-processor", "yolox-nano",
        "--gpt-backbone", "yolox-nano", "--concat-embeddings", "--decoder-pos-encoding",
        "--use-positional-embedding", "--enable-stop", "--max-seq-len", str(T),
        "--patch-size", str(P), "--minimum-image-size", "0", "--batch-size", "2",
        "--dropout", "0.0", "--max-det-patches", "3", "--max-boxes", "4",
        "--compute-dtype", "float32", "--seed", "5", "--gradient-accumulation", "2",
        "--test-samples", "1", "--env-name", mode, "--devices", "0",
        "--augment-rotate", "--augment-translate",
    ] + list(extra)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("spd")
    generate_toy_dataset(root / "toy", n_train=5, n_test=1, image_size=(128, 160), seed=0,
                         box_size=(8, 30))
    return root


def _jax_chunks(build, cfg, n_train, spd, n_chunks):
    """The JAX trainers' work items at ``spd`` (``supervised.py:252-266``,
    ``:323-331``) and their stacked chunks, ``make_batch`` without the
    device transfer: batch k of a chunk from the chunk's indices' k-th
    slice and seed + k."""
    order_rng = np.random.default_rng(cfg.seed)
    global_batch = cfg.batch_size
    index_pool, counter = [], [0]

    def single_pick():
        nonlocal index_pool
        while len(index_pool) < global_batch:
            index_pool += order_rng.permutation(n_train).tolist()
        indices, index_pool = index_pool[:global_batch], index_pool[global_batch:]
        counter[0] += 1
        return indices, cfg.seed + 1 + counter[0]

    out = []
    for _ in range(n_chunks):
        drawn = [single_pick() for _ in range(spd)]
        indices, seed = [i for ids, _ in drawn for i in ids], drawn[0][1]
        chunks = [build(indices[k * global_batch:(k + 1) * global_batch], seed + k)
                  for k in range(spd)]
        out.append({k: np.stack([c[k] for c in chunks]) for k in chunks[0]})
    return out


@pytest.mark.parametrize("pixels", [True, False], ids=["pixels", "pool"])
@pytest.mark.parametrize("mode", ["supervised", "reinforce"])
def test_host_chunks_at_3_equal_the_jax_stacked_chunks(toy, mode, pixels):
    spd, n_chunks = 3, 2
    flags = _flags(mode, toy / "toy", toy / "chunks",
                   ["--steps-per-dispatch", str(spd), "--test-every", str(spd),
                    "--gradient-accumulation", str(spd)])
    j_cfg, j_model = args_to_config(get_args(flags))
    j_train, _ = jax_main.build_both_datasets(j_cfg, j_model, toy / "toy")
    if mode == "supervised":
        build = lambda ids, seed: build_supervised_batch(
            j_train, ids, j_cfg, np.random.default_rng(seed), with_pixels=pixels)
    else:
        host = types.SimpleNamespace(config=j_cfg, train_dataset=j_train,
                                     fixed_shape=fixed_training_shape(j_train, P))
        build = lambda ids, seed: JaxReinforce._build_env_batch(host, ids, seed,
                                                                with_pixels=pixels)
    want = _jax_chunks(build, j_cfg, len(j_train), spd, n_chunks)

    t_cfg, t_model = tconfig.args_to_config(tconfig.get_args(flags))
    trainer = build_trainer(mesh.single("cpu"), t_cfg, t_model, toy / "toy", log=False)
    trainer.pool = None if pixels else trainer.build_pool()
    assert (trainer.pool is None) == pixels
    prefetcher = trainer.train_batches(trainer.steps_per_dispatch())
    try:
        got = [next(prefetcher) for _ in range(n_chunks)]
    finally:
        prefetcher.close()
    for c, (chunk, stacked) in enumerate(zip(got, want)):
        assert len(chunk) == spd
        assert set(chunk[0]) == set(stacked), c
        for key, value in stacked.items():
            g = np.stack([b[key] for b in chunk])
            assert g.dtype == value.dtype, (c, key)
            np.testing.assert_array_equal(g, value, err_msg=f"chunk {c} {key}")


def _run(toy, mode, spd, work, extra=(), capsys=None):
    flags = _flags(mode, toy / "toy", toy / work, ["--steps-per-dispatch", str(spd), *extra])
    if capsys is not None:
        capsys.readouterr()
    trainer = train_main(tconfig.get_args(flags), device="cpu")
    out = capsys.readouterr().out if capsys is not None else ""
    return trainer, out


def _assert_close_tree(got, want, path):
    if isinstance(want, torch.Tensor):
        torch.testing.assert_close(got, want, **STATE_TOL, msg=path)
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for key in want:
            _assert_close_tree(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, f"{path}/{i}")
    else:
        assert got == want, path


def _assert_same_run(got, want):
    a = np.array([float(v) for v in got.loss_history])
    b = np.array([float(v) for v in want.loss_history])
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=0)
    assert got.step == want.step and got.optimizer.updates == want.optimizer.updates
    g, w = got.model.state_dict(), want.model.state_dict()
    assert g.keys() == w.keys()
    for key, value in w.items():
        torch.testing.assert_close(g[key], value, **STATE_TOL, msg=key)
    _assert_close_tree(got.optimizer.state_dict(), want.optimizer.state_dict(), "optimizer")
    if hasattr(want, "last_return_mean"):
        np.testing.assert_allclose([got.last_return_mean, got.last_return_std],
                                   [want.last_return_mean, want.last_return_std],
                                   rtol=1e-12, atol=0)


# (mode, N, --max-iters, --test-every): supervised trains --max-iters - 1.
RUNS = [("supervised", 3, 6, 3), ("reinforce", 2, 5, 2)]


@pytest.mark.parametrize("mode,spd,max_iters,test_every", RUNS)
def test_a_run_at_n_equals_the_run_at_1(toy, mode, spd, max_iters, test_every, capsys,
                                        monkeypatch):
    monkeypatch.setattr(Trainer, "PRINT_EVERY", 2)
    tests = []
    test = Trainer.test_on_main
    monkeypatch.setattr(Trainer, "test_on_main", lambda self: (tests.append(
        (self.config.steps_per_dispatch, self.iter_num)), test(self)))
    extra = ["--max-iters", str(max_iters), "--test-every", str(test_every)]
    one, one_out = _run(toy, mode, 1, "one", extra, capsys)
    many, many_out = _run(toy, mode, spd, "many", extra, capsys)

    n = max_iters - 1 if mode == "supervised" else max_iters
    assert len(one.loss_history) == n and n % spd  # the last chunk is short
    _assert_same_run(many, one)
    ends = [it for it in range(spd, n + spd, spd)]
    ends[-1] = n
    assert many.iter_num == one.iter_num == n
    assert float(many.last_train_metrics["loss"]) == float(many.loss_history[-1])
    # the host looks at chunks' ends only: the tests, the printed losses
    assert tests == [(1, it) for it in range(test_every, n + 1, test_every)] + [
        (spd, it) for it in ends if it % test_every == 0]
    printed = lambda out: [int(i) for i in re.findall(r"^iter (\d+): loss", out, re.M)]
    assert printed(one_out) == [it for it in range(1, n + 1) if it % 2 == 0]
    assert printed(many_out) == [it for it in ends if it % 2 == 0]
    if mode == "reinforce":
        # the window after the short chunk: one entry, the chunk's sums
        assert len(many._window_stats) == 1 and len(one._window_stats) == 1
        np.testing.assert_allclose([float(v) for v in many._window_stats[0]],
                                   [float(v) for v in one._window_stats[0]], rtol=1e-12)

    # a resume at N continues as the resume at N = 1, at the step it saved
    resumed = {}
    for k, run in ((1, "one"), (spd, "many")):
        resumed[k], _ = _run(toy, mode, k, f"resumed_{run}", [
            "--max-iters", str(max_iters - 1), "--test-every", str(test_every),
            "--resume-training", str(toy / run / mode)])
        assert resumed[k].step == n + len(resumed[k].loss_history)
    _assert_same_run(resumed[spd], resumed[1])


def _raised(fn):
    with pytest.raises(ValueError, match="steps-per-dispatch") as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("mode,extra", [
    ("supervised", ["--steps-per-dispatch", "3", "--test-every", "4"]),
    ("reinforce", ["--steps-per-dispatch", "3", "--test-every", "4"]),
    ("reinforce", ["--steps-per-dispatch", "2", "--test-every", "4",
                   "--gradient-accumulation", "3"]),
], ids=["supervised-test-every", "reinforce-test-every", "reinforce-accumulation"])
def test_an_n_that_does_not_divide_raises_jax_error(toy, mode, extra):
    flags = _flags(mode, toy / "toy", toy / "bad", extra + ["--max-iters", "2"])
    j_cfg, j_model = args_to_config(get_args(flags))
    j_train, j_test = jax_main.build_both_datasets(j_cfg, j_model, toy / "toy")
    cls = JaxSupervised if mode == "supervised" else JaxReinforce
    jax_trainer = cls(j_cfg, JaxGPT.from_config(j_model, get_actions_info(j_cfg)), None,
                      j_train, j_test)
    want = _raised(jax_trainer.run)
    got = _raised(lambda: train_main(tconfig.get_args(flags), device="cpu"))
    assert got == want
    # before any step
    assert not any((toy / "bad" / mode).glob("checkpoint*"))
    if "--gradient-accumulation" in extra:
        # without reward normalization the accumulation need not divide
        trainer = train_main(tconfig.get_args(flags + ["--no-reward-norm"]), device="cpu")
        assert trainer.step == 2
