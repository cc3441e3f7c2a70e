"""``scripts/stream_seed.py``: the train CLI with the train step's device
draws seeded apart from ``--seed``.

Two runs of the supervised recipe's flags at ``--seed 1`` through the
launcher, at ``--stream-seed 2`` and ``1``, against the CLI itself: the host
batches (the order rng and each batch's seed) stay the CLI's bit for bit,
and only the trainer's generator (dropout and photometric augmentation)
starts elsewhere. At a small size on the CPU: B = 2, float32, patch 64,
three iterations, no test before the final validation.
"""

import numpy as np
import pytest
import torch

from jolineedle_tpu_torch import main as tmain
from jolineedle_tpu_torch.scripts import make_toyds_big, stream_seed, sup_probe
from jolineedle_tpu_torch.train.supervised import SupervisedTrainer

# The suite runs in several test processes that share the cores.
torch.set_num_threads(1)

N_ITERS = 3


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    return make_toyds_big.make_toyds_big(tmp_path_factory.mktemp("stream") / "toy",
                                         n_train=16, n_test=2)


def _argv(toy, work) -> list:
    """``run_sup_flagship.sh``'s flags (the shared yolox-nano pairing, seed
    1) at a small size."""
    values = {"SEED": "1", "DATASET_DIR": str(toy), "WORK_DIR": str(work),
              "MAX_ITERS": str(N_ITERS + 1), "SPD": "1", "DETECTOR": "yolox-nano",
              "BACKBONE_FLAGS": sup_probe.backbone_flags("yolox-nano")}
    return sup_probe.recipe_argv(values) + [
        "--batch-size", "2", "--compute-dtype", "float32", "--test-every", "1000",
        "--test-samples", "2", "--devices", "0"]


def _run(toy, work, monkeypatch, k=None) -> list:
    """The CLI's iterations (through the launcher at ``--stream-seed k``
    unless ``k`` is None): per iteration, a copy of its host batch, the
    trainer's generator state as the step starts, and its loss terms."""
    seen, step = [], SupervisedTrainer.train_step

    def recorded(self, batch):
        state = self.generator.get_state().clone()
        metrics = step(self, batch)
        seen.append(({key: value.copy() for key, value in batch.items()}, state,
                     {key: float(value) for key, value in metrics.items()}))
        return metrics

    monkeypatch.setattr(SupervisedTrainer, "train_step", recorded)
    monkeypatch.setenv("JOLINEEDLE_TORCH_DEVICE", "cpu")
    argv = _argv(toy, work)
    if k is None:
        tmain.cli(argv)
    else:
        stream_seed.main(["--stream-seed", str(k), "--", *argv])
    assert len(seen) == N_ITERS
    return seen


def test_stream_seed_keeps_the_host_batches_and_moves_the_draws(toy, tmp_path, monkeypatch):
    plain = _run(toy, tmp_path / "plain", monkeypatch)
    moved = _run(toy, tmp_path / "k2", monkeypatch, k=2)
    same = _run(toy, tmp_path / "k1", monkeypatch, k=1)
    for it in range(2):  # the first two host batches, bit for bit
        want, got = plain[it][0], moved[it][0]
        assert got.keys() == want.keys()
        for key, value in want.items():
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=f"iteration {it + 1} {key}")
    for seed, run in ((1, plain), (2, moved)):
        assert torch.equal(run[0][1], torch.Generator().manual_seed(seed).get_state())
    # other dropout masks and augmentations: every iteration's loss moves
    for it in range(N_ITERS):
        assert moved[it][2]["loss"] != plain[it][2]["loss"], it
    # the launcher at the seed's own stream is the CLI, bit for bit
    for (b1, g1, m1), (b2, g2, m2) in zip(plain, same):
        assert torch.equal(g1, g2) and m1 == m2


def test_stream_seed_refuses_several_ranks(toy, tmp_path):
    with pytest.raises(ValueError, match="one process"):
        stream_seed.main(["--stream-seed", "2", "--", *_argv(toy, tmp_path)[:-2],
                          "--devices", "0", "1"])


def test_sup_probe_hands_the_stream_seed_on(toy, tmp_path, monkeypatch):
    """``sup_probe --stream-seed 3 --tests 0`` (``run_flagship_seed.sh``
    with ``STREAM_SEED`` and ``INIT_FROM``) runs the recipe's flags through
    the launcher, and keeps the run's last weights in ``<work>/last``."""
    from jolineedle_tpu_torch.scripts import time_recipe

    calls = []
    monkeypatch.setattr(time_recipe, "main", lambda argv: calls.append(argv) or {
        "rc": 0, "tests": []})
    monkeypatch.setenv("DATASET_DIR", str(toy))
    work = tmp_path / "work"
    assert sup_probe.main([str(tmp_path / "out"), str(work), "--seed", "1", "--tests", "0",
                           "--stream-seed", "3", "--", "--init-from", "runs/jax_init"]) == 0
    (argv,) = calls
    keep = argv.index("--keep-last")
    assert argv[keep + 1:keep + 3] == [str(work / "r3_sup_yolox-nano"), str(work / "last")]
    command = argv[argv.index("--") + 1:]
    launcher = ["-m", "jolineedle_tpu_torch.scripts.stream_seed", "--stream-seed", "3", "--"]
    assert command[1:6] == launcher
    assert command[command.index("--seed") + 1] == "1"
    assert command[-2:] == ["--init-from", "runs/jax_init"]
