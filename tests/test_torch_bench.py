"""The port's throughput bench (jolineedle_tpu_torch/bench.py) against the
repo's root ``bench.py``: the FLOPs of a rollout against the JAX package's
``traced_flops``, the bench's line on the CPU at its small config, its
accumulated reward against the port's rollout, and its reference-loop
emulation's forward against the JAX model's on the same weights.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu_torch import bench
from jolineedle_tpu_torch.env.batched_env import NeedleEnv
from jolineedle_tpu_torch.models.bridge import torch_to_flax
from jolineedle_tpu_torch.train.rollout import rollout
from jolineedle_tpu_torch.utils.flops import rollout_flops

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# The keys of root bench.py's line off the TPU (no measured peak, no MFU).
JAX_LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "passes", "spread_pct",
                 "gflops_per_env_step", "tflops_per_sec", "baseline_env_steps_per_sec",
                 "baseline_window_s")
# The FLOPs the JAX package's traced_flops gives bench.py's rollout_body at
# the full config at B = 1 (20 steps, 448 px): 0.974 GFLOP an env step.
FULL_B1_FLOPS = 19_488_468_768
FLOP_RTOL = 1e-3
SMALL_ENV = {"BENCH_SECONDARY": "0", "BENCH_BASELINE_MIN_S": "0"}


def _jax_config(work_dir):
    """The JAX package's configs from bench.py's flags at its small config
    (``bench.py:116-136``), with ``work_dir``."""
    from jolineedle_tpu.config import args_to_config, get_args

    return args_to_config(get_args([
        "--training-mode", "reinforce", "--dataset-dir", "/nonexistent",
        "--work-dir", str(work_dir), "--model-type", "gpt-nano",
        "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
        "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
        "--enable-stop", "--max-seq-len", "4", "--patch-size", "64",
        "--minimum-image-size", "0", "--batch-size", "2", "--dropout", "0.0",
        "--max-det-patches", "4", "--max-boxes", "4", "--devices", "0",
        "--compute-dtype", "float32"]))


def test_rollout_flops_match_jax_traced_flops_at_the_small_config(tmp_path):
    """``rollout_flops`` of the port's small-config model equals the JAX
    package's ``traced_flops`` of bench.py's ``rollout_body``
    (``bench.py:176-181``; 160,899,648 when written), computed here, within
    0.1 %."""
    from jolineedle_tpu.env import get_actions_info
    from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
    from jolineedle_tpu.models.gpt import GPT as JaxGPT
    from jolineedle_tpu.train.reinforce import ReinforceTrainer as JaxTrainer
    from jolineedle_tpu.utils.flops import traced_flops

    train_config, model_config = _jax_config(tmp_path)
    jmodel = JaxGPT.from_config(model_config, get_actions_info(train_config))
    trainer = JaxTrainer(train_config, jmodel, None, None, None)
    cfg = trainer.config
    batch, steps = 2, 4
    images = np.zeros((batch, 128, 128, 3), np.uint8)  # grid 2 of 64 px: shapes alone count
    boxes = np.zeros((batch, 4, 4), np.float32)

    def rollout_body(variables, images, boxes, key):
        env = JaxEnv(images, boxes, cfg.patch_size, trainer.max_ep_len, 1, trainer.stop_enabled)
        return trainer._rollout_scan(variables, env, key, sample=True)

    want = traced_flops(rollout_body, trainer.eval_variables(), jnp.asarray(images),
                        jnp.asarray(boxes), jax.random.PRNGKey(0))
    _, model, *_ = bench.build(True, env={}, device="cpu")
    got = rollout_flops(model, batch, steps)
    assert want > 0
    assert got == pytest.approx(want, rel=FLOP_RTOL)


@pytest.mark.parametrize("embedder, gflops", [("yolox-nano", 0.974), ("yolox-s", 7.962)])
def test_rollout_flops_at_the_full_config(embedder, gflops):
    """At bench.py's full config at B = 1 (on ``meta``, nothing runs): the
    nano pairing's count equals the JAX package's 19,488,468,768 within 0.1 %,
    and each pairing's GFLOP an env step is the one bench.py reports (0.974
    and 7.962, hardware-free counts)."""
    _, model, _, _, _, steps, _, _ = bench.build(
        False, embedder=embedder, env={"BENCH_BATCH": "1", "BENCH_GRID": "1"}, device="cpu")
    got = rollout_flops(model, 1, steps)
    if embedder == "yolox-nano":
        assert got == pytest.approx(FULL_B1_FLOPS, rel=FLOP_RTOL)
    assert round(got / steps / 1e9, 3) == gflops


@pytest.fixture(scope="module")
def small_run():
    """``run`` at the small config on the CPU with the baseline and no
    secondary (as bench.py does at BENCH_SMALL=1), its window cut to one
    episode."""
    return bench.run(small=True, device="cpu", env=SMALL_ENV)


def test_small_run_has_the_jax_line(small_run):
    """The keys of bench.py's line off the TPU, named where bench.py names
    them; no peak or MFU on the CPU; the small config's sizes."""
    source = (ROOT / "bench.py").read_text()
    for key in JAX_LINE_KEYS + ("peak_tflops_measured", "mfu_pct", "secondary"):
        assert f'"{key}"' in source, key
    assert set(JAX_LINE_KEYS) <= small_run.keys()
    assert not {"peak_tflops_measured", "mfu_pct", "secondary"} & small_run.keys()
    assert small_run["metric"] == "glimpse env steps/sec/chip (gpt-nano+yolox-nano)"
    assert small_run["unit"] == "env steps/s (batch 2, ep_len 4, patch 64, grid 2)"
    assert small_run["device"] == "cpu"
    assert len(small_run["passes"]) == 1 and small_run["value"] > 0
    # 160,899,648 FLOPs over 2 x 4 env steps
    assert small_run["gflops_per_env_step"] == 0.02
    assert small_run["vs_baseline"] > 0 and small_run["baseline_window_s"] >= 0


def test_small_run_reward_equals_the_ports_rollout(small_run):
    """The bench's accumulated reward equals the port's ``rollout`` run here
    from a generator seeded alike, over the same device pool, exactly."""
    iters = 2  # bench.py's BENCH_ITERS at the small config
    trainer, model, images, boxes, *_ = bench.build(True, env={}, device="cpu")
    cfg = trainer.config
    pool = torch.randint(0, 256, images.shape, dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1))
    env = NeedleEnv(pool, boxes, cfg.patch_size, cfg.max_seq_len, 1, cfg.stop_enabled,
                    device="cpu")
    gen = torch.Generator().manual_seed(0)
    want = torch.zeros(())
    for _ in range(iters):
        want += rollout(model, env, sample=True, generator=gen)["rewards"].sum()
    assert small_run["reward_sums"] == [want.item()]
    assert small_run["kernel_counts"]["rollout"]["rollouts"] == iters


def test_small_run_baseline_attends_once_per_layer_a_step(small_run):
    """Each emulated reference episode runs the full forward once per step:
    ``steps x n_layer`` flash-attention calls (launches on the card)."""
    counts = small_run["kernel_counts"]["baseline"]
    n_layer = bench.build(True, env={}, device="cpu")[1].n_layer
    assert counts["iterations"] >= 1 and counts["steps"] == 4
    assert counts["flash_attention"] == counts["iterations"] * counts["steps"] * n_layer
    # the KV-cache rollout attends through the cache, never through flash
    assert small_run["kernel_counts"]["rollout"]["flash_attention"] == 0


def test_baseline_forward_matches_jax_apply():
    """The reference loop's first step (bench.py's host rng, gather and full
    forward) on the port equals JAX's ``model.apply(...)[0]`` on the bridged
    weights within 1e-4 (float32 on the CPU)."""
    from jolineedle_tpu.env import get_actions_info
    from jolineedle_tpu.models.gpt import GPT as JaxGPT

    trainer, model, images, *_ = bench.build(True, env={}, device="cpu")
    P = trainer.config.patch_size
    positions, actions, pos_hist, patches = bench.episode_start(
        np.random.default_rng(0), images.astype(np.float32) / 255.0, P)
    classes = torch.zeros((images.shape[0],), dtype=torch.long)
    got = bench.baseline_forward(model, patches, actions, classes, pos_hist).numpy()

    train_config, model_config = _jax_config("/nonexistent")
    jmodel = JaxGPT.from_config(model_config, get_actions_info(train_config))
    variables = torch_to_flax(model.state_dict(), model)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(patches), jnp.asarray(actions),
                                   jnp.zeros((images.shape[0],), jnp.int32),
                                   jnp.asarray(pos_hist))[0])
    assert got.shape == want.shape == (images.shape[0], 1, model.n_actions)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_peak_is_measured_only_on_the_card():
    """Off the card the MFU denominator is None, as bench.py's is off the
    TPU; nothing is timed on the CPU under a device metric's name."""
    assert bench.measure_peak_tflops("cpu") is None


def test_main_prints_one_line(monkeypatch, capsys):
    """``main`` prints the line once, as one JSON object, under the process
    environment's knobs (the small config, no baseline)."""
    monkeypatch.setenv("BENCH_SMALL", "1")
    monkeypatch.setenv("BENCH_SKIP_BASELINE", "1")
    monkeypatch.setenv("BENCH_ITERS", "1")
    monkeypatch.setenv("BENCH_NO_WATCHDOG", "1")
    result = bench.main(device="cpu")
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["vs_baseline"] is None and "baseline_window_s" not in result
    assert result["unit"].startswith("env steps/s (batch 2, ep_len 4")


def test_watchdog_line_names_a_hung_launch(monkeypatch):
    """The watchdog's error line (bench.py's form) names a hung CUDA launch;
    disarmed, none is started."""
    monkeypatch.setenv("BENCH_NO_WATCHDOG", "1")
    assert bench._hang_watchdog(1) is None
    monkeypatch.delenv("BENCH_NO_WATCHDOG")
    printed = []
    monkeypatch.setattr(bench.os, "_exit", lambda code: printed.append(code))
    monkeypatch.setattr(bench, "print", lambda text, **kw: printed.append(text),
                        raising=False)
    timer = bench._hang_watchdog(0)
    timer.join(timeout=10)
    assert not timer.is_alive()
    line, code = printed
    assert code == 3 and re.search(r'"error": "bench did not finish within 0s: a CUDA launch',
                                   line)
