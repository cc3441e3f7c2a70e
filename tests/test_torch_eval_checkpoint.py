"""``python -m jolineedle_tpu_torch.scripts.eval_checkpoint`` on a port run,
on the CPU: the cases of ``tests/test_eval_checkpoint.py`` (the full test
set, the ``--no-merge-bboxes`` override, the recorded ``dataset_dir``, and a
config.json that predates it, which needs ``--dataset-dir``), with the run
directory left as it was, and the validation of the best checkpoint equal to
the run's own final test. A JAX run directory is validated in
``tests/test_torch_jax_run.py``.

gpt-nano with a yolox-nano detector at patch 64, 4 steps, float32.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from jolineedle_tpu_torch.config import get_args
from jolineedle_tpu_torch.scripts import eval_checkpoint

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)


def run_dir_state(run_dir):
    """Every file of ``run_dir`` with its size and mtime."""
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in sorted(run_dir.iterdir())}


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    from jolineedle_tpu_torch.data.toy import generate_toy_dataset
    from jolineedle_tpu_torch.main import main

    toy_dir = generate_toy_dataset(tmp_path_factory.mktemp("toyds_evalckpt"), n_train=4,
                                   n_test=2, image_size=(256, 320), seed=3, box_size=(20, 60))
    work_dir = tmp_path_factory.mktemp("run_evalckpt")
    cli = [
        "--seed", "7", "--dataset-dir", str(toy_dir), "--training-mode", "supervised",
        "--work-dir", str(work_dir), "--max-iters", "2", "--test-every", "1000",
        "--test-samples", "1", "--env-name", "run", "--model-type", "gpt-nano",
        "--image-processor", "yolox-nano", "--concat-embeddings", "--decoder-pos-encoding",
        "--use-positional-embedding", "--max-seq-len", "4", "--batch-size", "2",
        "--patch-size", "64", "--minimum-image-size", "0", "--detector-conf-threshold", "0.05",
        "--merge-bboxes", "--devices", "0", "--max-det-patches", "6", "--max-boxes", "4",
        "--compute-dtype", "float32",
    ]
    trainer = main(get_args(cli), device="cpu")
    final = {k: float(np.mean(v)) for k, v in trainer.last_test_metrics.items()}
    return work_dir / "run", toy_dir, final


def _run_eval(argv, capsys):
    capsys.readouterr()
    got = eval_checkpoint.main(argv, device="cpu")
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("FULL-TEST:")][-1]
    metrics = json.loads(line[len("FULL-TEST:"):])
    assert metrics == got
    return metrics


def test_eval_checkpoint_full_test(trained_run, capsys):
    run_dir, toy_dir, final = trained_run
    before = run_dir_state(run_dir)
    metrics = _run_eval([str(run_dir), "--ckpt", "last", "--dataset-dir", str(toy_dir)], capsys)
    assert np.isfinite(metrics["map"])
    assert metrics["episode_length"] > 0
    assert "supervised_map" in metrics
    assert metrics.keys() == final.keys()
    assert run_dir_state(run_dir) == before  # nothing written into the run


def test_eval_checkpoint_best_equals_the_runs_final_test(trained_run, capsys):
    """The run's own final test loaded the best checkpoint and tested the
    whole test set as its trainer's first eval: the same test, exactly."""
    run_dir, _, final = trained_run
    assert _run_eval([str(run_dir), "--ckpt", "best"], capsys) == final


def test_eval_checkpoint_merge_override(trained_run, capsys):
    run_dir, toy_dir, _ = trained_run
    metrics = _run_eval([str(run_dir), "--ckpt", "last", "--dataset-dir", str(toy_dir),
                         "--no-merge-bboxes"], capsys)
    assert np.isfinite(metrics["map"])


def test_eval_checkpoint_recorded_dataset_dir(trained_run, capsys):
    """A run's config.json records dataset_dir: no --dataset-dir needed."""
    run_dir, _, _ = trained_run
    metrics = _run_eval([str(run_dir), "--ckpt", "last"], capsys)
    assert np.isfinite(metrics["map"])


def test_eval_checkpoint_legacy_config_requires_dataset_dir(trained_run, capsys, tmp_path):
    """A config.json without the recorded dataset_dir fails fast with the
    JAX script's --dataset-dir message."""
    run_dir, _, _ = trained_run
    legacy = tmp_path / "legacy_run"
    shutil.copytree(run_dir, legacy)
    cfg_path = legacy / "config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["train"].pop("dataset_dir", None)
    cfg_path.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="--dataset-dir is required"):
        _run_eval([str(legacy), "--ckpt", "last"], capsys)
