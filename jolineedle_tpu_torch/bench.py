"""Throughput bench of the port: glimpse env steps/s on one card.

The counterpart of the repo's root ``bench.py`` (``bench.py:95-486``), which
measures the JAX package. Prints ONE JSON line with the keys of that line:
``metric``, ``value``, ``unit``, ``vs_baseline``, ``passes``,
``spread_pct``, ``gflops_per_env_step``, ``tflops_per_sec``,
``peak_tflops_measured``, ``mfu_pct``, ``baseline_env_steps_per_sec``,
``baseline_window_s`` and ``secondary``; besides them ``device`` (the card
it ran on), ``reward_sums`` (each pass's accumulated reward) and
``kernel_counts`` (the kernel wrappers' counts over the timed parts).

    python -m jolineedle_tpu_torch.bench

The measured quantity: batched glimpse-rollout env steps per second on one
card at the flagship config (gpt-nano decision decoder, yolox-nano patch
embedder, 448 px patches, 6 x 6 patch images, 20 steps with STOP, B = 128,
bf16). Each timed iteration is one sampled ``train/rollout.py::rollout``
(KV-cache decode, Gumbel-max sampling and env step, with no host sync
inside) under ``no_grad``, its reward sum added to a device accumulator; a
pass of ``BENCH_ITERS`` iterations ends in one host sync. The median of
``BENCH_REPEATS`` passes is reported, with their spread.

Utilization: FLOPs per rollout counted from the module tree on the ``meta``
device (``utils/flops.py::rollout_flops``, what the JAX package's
``traced_flops`` counts), achieved TFLOP/s, the card's bf16 matmul peak
measured live (``measure_peak_tflops``) and MFU. A FLOP count that fails
raises.

``vs_baseline`` compares with an emulation of the reference's host-loop
rollout on the same card (``bench_reference_style_rollout``): the full
forward over the whole prefix every step, patches gathered on the host and
uploaded, a host sync per step. The yolox-s pairing (the reference's
headline detector) is measured too, as the ``secondary`` block.

Env knobs, bench.py's names: ``BENCH_SMALL=1`` (B = 2, 4 steps, 64 px, grid
2, float32: a CPU smoke size), ``BENCH_BATCH``, ``BENCH_GRID``,
``BENCH_STEPS``, ``BENCH_ITERS``, ``BENCH_REPEATS``, ``BENCH_EMBEDDER``,
``BENCH_SECONDARY`` (0 disables, 1 means yolox-s, any other value names the
variant), ``BENCH_SECONDARY_ITERS``, ``BENCH_SKIP_BASELINE=1``,
``BENCH_BASELINE_MIN_S``, ``BENCH_PROFILE_DIR`` (a ``torch.profiler`` Chrome
trace of the first timed pass, ``bench_trace.json`` there; do not quote
steps/s from a profiled run), ``BENCH_WATCHDOG_SECS`` and
``BENCH_NO_WATCHDOG=1``.

Runs on the card unless the caller of :func:`run` or :func:`main` passes
``device="cpu"``; with no card and no device given it raises.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from . import resolve_device
from .config import args_to_config, get_args
from .env.actions import get_actions_info
from .env.batched_env import NeedleEnv
from .models.gpt import GPT
from .ops import attention as kattn
from .ops import conv as kconv
from .train.reinforce import ReinforceTrainer
from .train.rollout import rollout
from .utils.flops import rollout_flops

WATCHDOG_DEFAULT_SECS = 2700
#: The trainer's work directory: inside the checkout, under ``build/``.
WORK_DIR = Path(__file__).resolve().parents[1] / "build" / "bench"
#: The kernel wrappers on the rollout's path, whose counts each part reports.
WRAPPERS = {
    "dwblock_bn_silu": kconv.dwblock_bn_silu,
    "conv3x3_bn_silu": kconv.conv3x3_bn_silu,
    "flash_attention": kattn.flash_attention,
}
#: The emulated reference loop's move per sampled action id (``bench.py:365-368``).
BASELINE_DELTAS = np.array([(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1),
                            (-1, -1), (0, 0)], np.int32)


def _hang_watchdog(seconds: int = WATCHDOG_DEFAULT_SECS):
    """Print an error line and exit 3 if the bench has not finished after
    ``seconds``: a hung CUDA launch would otherwise hold the run forever
    with nothing recorded. Disarmed by ``BENCH_NO_WATCHDOG=1``."""
    if os.environ.get("BENCH_NO_WATCHDOG"):
        return None

    def fire():
        embedder = os.environ.get("BENCH_EMBEDDER", "yolox-nano")
        print(json.dumps({
            "metric": f"glimpse env steps/sec/chip (gpt-nano+{embedder})",
            "value": 0,
            "unit": "env steps/s (bench timed out)",
            "vs_baseline": None,
            "error": f"bench did not finish within {seconds}s: a CUDA launch likely hung"
                     " (the device never reached the pass's sync)",
        }), flush=True)
        os._exit(3)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t


def kernel_counts(device: torch.device) -> dict:
    """The wrappers' counters: launches on the card, calls on the CPU (where
    they launch nothing)."""
    attr = "launches" if device.type == "cuda" else "calls"
    return {name: getattr(fn, attr) for name, fn in WRAPPERS.items()}


def _counts_since(device, before: dict, **extra) -> dict:
    now = kernel_counts(device)
    return {**extra, **{k: now[k] - before[k] for k in now}}


def build(small: bool, embedder: Optional[str] = None, env: Mapping = os.environ,
          device=None):
    """The bench's trainer, model and host data (``bench.py:95-155``): the
    same CLI flags through the port's config, the model from the config's
    seed on ``device``, uint8 images and two boxes an image from
    ``np.random.default_rng(0)``."""
    dev = resolve_device(device)
    patch = 64 if small else 448
    grid = int(env.get("BENCH_GRID", 2 if small else 6))
    max_ep_len = int(env.get("BENCH_STEPS", 4 if small else 20))
    batch = int(env.get("BENCH_BATCH", 2 if small else 128))
    if embedder is None:
        embedder = env.get("BENCH_EMBEDDER", "yolox-nano")
    cli = [
        "--training-mode", "reinforce",
        "--dataset-dir", "/nonexistent",
        "--work-dir", str(WORK_DIR),
        "--model-type", "gpt-nano",
        "--image-processor", embedder,
        "--gpt-backbone", embedder,
        "--concat-embeddings",
        "--decoder-pos-encoding",
        "--use-positional-embedding",
        "--enable-stop",
        "--max-seq-len", str(max_ep_len),
        "--patch-size", str(patch),
        "--minimum-image-size", "0",
        "--batch-size", str(batch),
        "--dropout", "0.0",
        "--max-det-patches", "4",
        "--max-boxes", "4",
        "--devices", "0",
        "--compute-dtype", "float32" if small else "bfloat16",
    ]
    train_config, model_config = args_to_config(get_args(cli))
    torch.manual_seed(train_config.seed)
    model = GPT.from_config(model_config, get_actions_info(train_config), device=dev).eval()
    trainer = ReinforceTrainer(train_config, model, None, None, None, device=dev)

    rng = np.random.default_rng(0)
    H = W = grid * patch
    images = rng.integers(0, 256, (batch, H, W, 3), dtype=np.uint8)
    boxes = np.zeros((batch, 4, 4), np.float32)
    for i in range(batch):
        for j in range(2):
            x = rng.integers(0, W - 80)
            y = rng.integers(0, H - 80)
            boxes[i, j] = [x, y, x + 64, y + 48]
    return trainer, model, images, boxes, batch, max_ep_len, patch, embedder


def pool_env(trainer, images, boxes) -> NeedleEnv:
    """The rollout's env over a uint8 image pool made on the trainer's
    device from a seeded generator: pixel content does not move the time,
    the shape and type are the host images'."""
    dev, cfg = trainer.device, trainer.config
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = torch.randint(0, 256, images.shape, dtype=torch.uint8, generator=gen, device=dev)
    return NeedleEnv(pool, boxes, cfg.patch_size, trainer.max_ep_len, 1, trainer.stop_enabled,
                     device=dev)


def rollout_pass(model, env: NeedleEnv, iters: int, seed: int = 0) -> float:
    """``iters`` sampled rollouts from one generator seeded with ``seed``,
    each one's reward sum added to a device accumulator; one host sync, at
    the end. Returns the accumulated reward."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    acc = torch.zeros((), dtype=torch.float32, device=env.device)
    for _ in range(iters):
        acc += rollout(model, env, sample=True, generator=gen)["rewards"].float().sum()
    return float(acc)


def bench_rollout(trainer, images, boxes, iters: int, repeats: int = 3,
                  profile_dir: Optional[str] = None) -> dict:
    """The timed rollout (``bench.py:157-238``): ``repeats`` passes of
    ``iters`` rollouts over :func:`pool_env`. One warm pass of one rollout
    first.

    Returns ``elapsed`` (seconds per pass), ``flops`` (of one rollout),
    ``reward_sums`` (per pass) and ``counts`` (the wrappers' counts over the
    timed passes, with the number of rollouts they ran)."""
    model, dev = trainer.model, trainer.device
    env = pool_env(trainer, images, boxes)
    rollout_pass(model, env, 1)  # warm: kernel builds, cuDNN's plans, the allocator
    flops = rollout_flops(model, env.batch_size, env.max_ep_len)

    elapsed, sums = [], []
    before = kernel_counts(dev)
    for rep in range(repeats):
        prof = None
        if profile_dir and rep == 0:  # trace the first pass only
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
        t0 = time.perf_counter()
        sums.append(rollout_pass(model, env, iters))
        elapsed.append(time.perf_counter() - t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(profile_dir) / "bench_trace.json"))
    counts = _counts_since(dev, before, rollouts=iters * repeats)
    return {"elapsed": elapsed, "flops": flops, "reward_sums": sums, "counts": counts}


def measure_peak_tflops(device, dtype=torch.bfloat16, n: int = 8192, iters: int = 10,
                        inner: int = 8, repeats: int = 3) -> Optional[float]:
    """The card's large-matmul rate, the MFU denominator (``bench.py:241-
    281``): ``inner`` chained n x n products per step, ``iters`` steps a
    sample between a pair of CUDA events, the median of ``repeats``
    samples. None off the card, as the JAX version is off the TPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    gen = torch.Generator(device=dev).manual_seed(0)
    # Unit-variance chain: scaled by 1/sqrt(n), so that repeated products
    # neither overflow nor underflow in bf16.
    x = (torch.randn((n, n), generator=gen, device=dev) / np.sqrt(n)).to(dtype)

    def step(acc):
        y = x
        for _ in range(inner):
            y = y @ x
        return acc + y.float().sum()

    float(step(torch.zeros((), device=dev)))  # warm
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        acc = torch.zeros((), device=dev)
        start.record()
        for _ in range(iters):
            acc = step(acc)
        end.record()
        float(acc)
        samples.append(2 * n**3 * inner * iters / (start.elapsed_time(end) / 1e3) / 1e12)
    return float(np.median(samples))


def gather_patches(image: np.ndarray, positions, P: int) -> np.ndarray:
    """The reference's per-sample host gather of ``positions``' patches."""
    return np.stack([image[y * P:(y + 1) * P, x * P:(x + 1) * P] for y, x in positions])


def episode_start(rng: np.random.Generator, images: np.ndarray, P: int):
    """A baseline episode's first step on the host: random positions, the
    zero action, the position history and the gathered patches
    ``[B, 1, P, P, C]``."""
    B, nv, nh = images.shape[0], images.shape[1] // P, images.shape[2] // P
    positions = np.stack([rng.integers(0, nv, B), rng.integers(0, nh, B)], axis=1).astype(np.int32)
    actions = np.zeros((B, 1), np.int32)
    patches = np.stack(
        [gather_patches(images[i], positions[i:i + 1], P)[0] for i in range(B)])[:, None]
    return positions, actions, positions[:, None], patches


@torch.no_grad()
def baseline_forward(model, patches, actions, classes, positions) -> torch.Tensor:
    """One step of the reference's loop on the device: the host arrays
    uploaded, and the full forward over the whole prefix (the flash kernel
    once per layer on the card). Returns the logits ``[B, T, n_actions]``."""
    dev = model.device
    return model(torch.from_numpy(patches).to(dev), torch.from_numpy(actions).long().to(dev),
                 classes, torch.from_numpy(positions).long().to(dev))[0]


def bench_reference_style_rollout(trainer, model, images, iters: int, n_steps: int,
                                  min_seconds: float) -> dict:
    """The reference's rollout architecture on the same card
    (``bench.py:284-386``): a host loop that reruns the forward over the
    whole prefix each step, gathers patches on the host, uploads them and
    syncs every step, with the same numpy rng. Measured over ``n_steps``
    prefix steps an episode (a short prefix understates the reference's
    cost: the ratio is a lower bound), for at least ``iters`` episodes and
    ``min_seconds``.

    Returns ``seconds``, ``iterations`` and ``counts`` (the wrappers' counts
    over the timed episodes)."""
    # The reference normalizes once at image load.
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    dev = trainer.device
    B = images.shape[0]
    P = trainer.config.patch_size
    nv, nh = images.shape[1] // P, images.shape[2] // P
    classes = torch.zeros((B,), dtype=torch.long, device=dev)
    rng = np.random.default_rng(0)

    # Warm-up: each prefix length once (cuDNN's plans), outside the window.
    warm_pos = np.zeros((B, 1, 2), np.int32)
    warm_patches = np.stack([gather_patches(images[i], warm_pos[i], P) for i in range(B)])
    for t in range(1, n_steps + 1):
        float(baseline_forward(model, np.repeat(warm_patches, t, axis=1),
                               np.zeros((B, t), np.int32), classes,
                               np.repeat(warm_pos, t, axis=1)).sum())

    done = 0
    before = kernel_counts(dev)
    t0 = time.perf_counter()
    while done < iters or (time.perf_counter() - t0 < min_seconds and done < 20 * iters):
        done += 1
        positions, actions, pos_hist, patches = episode_start(rng, images, P)
        for _ in range(n_steps):
            logits = baseline_forward(model, patches, actions, classes, pos_hist)
            last = logits[:, -1].float().cpu().numpy()  # host sync, like .item() calls
            p = np.exp(last - last.max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            act = np.array([rng.choice(last.shape[-1], p=p[i]) for i in range(B)], np.int32)
            positions = np.clip(positions + BASELINE_DELTAS[np.clip(act, 0, 8)], 0, [nv - 1, nh - 1])
            new_patches = np.stack(
                [gather_patches(images[i], positions[i:i + 1], P)[0] for i in range(B)])
            patches = np.concatenate([patches, new_patches[:, None]], axis=1)
            actions = np.concatenate([actions, act[:, None]], axis=1)
            pos_hist = np.concatenate([pos_hist, positions[:, None]], axis=1)
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "iterations": done,
            "counts": _counts_since(dev, before, iterations=done)}


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(small: bool = False, device=None, env: Optional[Mapping] = None) -> dict:
    """The bench's line as a dict (``bench.py:389-486``), its knobs read
    from ``env`` (default: the process environment)."""
    env = os.environ if env is None else env
    dev = resolve_device(device)
    iters = int(env.get("BENCH_ITERS", 2 if small else 100))
    base_iters = max(1, min(2, iters // 5))
    repeats = int(env.get("BENCH_REPEATS", 1 if small else 3))
    trainer, model, images, boxes, batch, max_ep_len, patch, embedder = build(
        small, env=env, device=dev)

    timed = bench_rollout(trainer, images, boxes, iters, repeats,
                          profile_dir=env.get("BENCH_PROFILE_DIR"))
    pass_times, flops = timed["elapsed"], timed["flops"]
    per_pass = [batch * max_ep_len * iters / t for t in pass_times]
    steps_per_sec = float(np.median(per_pass))
    scan_time = float(np.median(pass_times))
    result = {
        "metric": f"glimpse env steps/sec/chip (gpt-nano+{embedder})",
        "value": round(steps_per_sec, 2),
        "unit": f"env steps/s (batch {batch}, ep_len {max_ep_len}, "
                f"patch {patch}, grid {images.shape[1] // patch})",
        "vs_baseline": None,
        "passes": [round(v, 1) for v in per_pass],
        "spread_pct": round(100 * (max(per_pass) - min(per_pass)) / steps_per_sec, 1),
    }
    achieved = flops * iters / scan_time / 1e12
    result["gflops_per_env_step"] = round(flops / (batch * max_ep_len) / 1e9, 3)
    result["tflops_per_sec"] = round(achieved, 2)
    peak = measure_peak_tflops(dev)
    if peak:
        result["peak_tflops_measured"] = round(peak, 1)
        result["mfu_pct"] = round(100 * achieved / peak, 1)
    counts = {"rollout": timed["counts"]}

    if env.get("BENCH_SKIP_BASELINE", "") != "1":
        base_steps = min(4, max_ep_len)
        min_s = float(env.get("BENCH_BASELINE_MIN_S", 0 if iters <= 1 else 20))
        base = bench_reference_style_rollout(trainer, model, images, base_iters, base_steps,
                                             min_s)
        ref_steps_per_sec = batch * base_steps * base["iterations"] / base["seconds"]
        result["vs_baseline"] = float(f"{steps_per_sec / ref_steps_per_sec:.2g}")
        result["baseline_env_steps_per_sec"] = round(ref_steps_per_sec, 1)
        result["baseline_window_s"] = round(base["seconds"], 1)
        counts["baseline"] = {**base["counts"], "steps": base_steps}
    del trainer, model, images

    sec_embedder = env.get("BENCH_SECONDARY", "yolox-s")
    if sec_embedder == "1":
        sec_embedder = "yolox-s"
    if sec_embedder not in ("", "0") and not small and sec_embedder != embedder:
        sec_iters = int(env.get("BENCH_SECONDARY_ITERS", max(10, iters // 4)))
        sec_trainer, _, sec_images, sec_boxes, sec_batch, sec_ep, _, _ = build(
            small, embedder=sec_embedder, env=env, device=dev)
        sec_timed = bench_rollout(sec_trainer, sec_images, sec_boxes, sec_iters, repeats)
        sec_times, sec_flops = sec_timed["elapsed"], sec_timed["flops"]
        sec_per_pass = [sec_batch * sec_ep * sec_iters / t for t in sec_times]
        sec_achieved = sec_flops * sec_iters / float(np.median(sec_times)) / 1e12
        sec = {
            "metric": f"glimpse env steps/sec/chip (gpt-nano+{sec_embedder})",
            "value": round(float(np.median(sec_per_pass)), 2),
            "passes": [round(v, 1) for v in sec_per_pass],
            "gflops_per_env_step": round(sec_flops / (sec_batch * sec_ep) / 1e9, 3),
            "tflops_per_sec": round(sec_achieved, 2),
        }
        if peak:
            sec["mfu_pct"] = round(100 * sec_achieved / result["peak_tflops_measured"], 1)
        result["secondary"] = sec
        counts["secondary"] = sec_timed["counts"]

    result["device"] = _device_name(dev)
    result["reward_sums"] = timed["reward_sums"]
    result["kernel_counts"] = counts
    return result


def main(device=None) -> dict:
    """Print the bench's line for the process environment's knobs."""
    watchdog = _hang_watchdog(
        int(os.environ.get("BENCH_WATCHDOG_SECS", str(WATCHDOG_DEFAULT_SECS))))
    result = run(os.environ.get("BENCH_SMALL", "") == "1", device=device)
    if watchdog is not None:
        watchdog.cancel()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
