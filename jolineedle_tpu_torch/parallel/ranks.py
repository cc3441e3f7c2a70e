"""Rank programs that check data-parallel training (``mesh.py``).

``mesh.launch`` spawns each rank from a fresh interpreter, which imports its
target by name: the programs that the CPU tests and ``chip_smoke.py`` run on
their ranks live here, in the package. Each takes its ``World`` first and
returns plain data (CPU tensors, numbers, strings); each also runs alone,
with ``mesh.single(device)``, for the one-device run it is compared with.

- :func:`batch_norm_rank`: train-mode BatchNorm of the rank's rows, with
  and without the global statistics;
- :func:`loss_rank`: the supervised or the REINFORCE loss of the rank's rows
  and its gradients;
- :func:`train_rank_steps`: train iterations of a trainer built from CLI
  flags, with the metrics, the state digest and the kernel launches of
  every iteration, and on request their times.

:func:`compare_runs` holds a W-rank run against the one-rank run at the
same global batch: every rank's state, the losses, the weights by the
aggregate rule the JAX package's 8-device test holds its own to
(``tests/test_dp_equivalence.py``; :func:`weights_disagree`), the BN
statistics (:func:`stats_relative`) and the kernel launches.
"""

from __future__ import annotations

import contextlib
import math
import time
from collections import Counter
from typing import Callable, Dict, List

import numpy as np
import torch

from ..config import args_to_config, get_args
from ..env.actions import get_actions_info
from ..env.batched_env import NeedleEnv
from ..main import build_trainer
from ..models.gpt import GPT
from ..models.yolox import batch_norm_train
from ..ops import attention as kattn
from ..ops import conv as kconv
from . import mesh


def _to_cpu(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def batch_norm_rank(world: mesh.World, x: torch.Tensor, state: Dict[str, torch.Tensor]) -> dict:
    """Train-mode BatchNorm (``batch_norm_train``) of this rank's rows of
    ``x [W n, C, H, W]`` from a ``BatchNorm2d`` state dict, once inside
    ``data_parallel`` (the global batch's statistics) and once outside (the
    rank's own): ``{"synced" | "local": {"y", "state"}}``."""
    out = {}
    for name in ("synced", "local"):
        bn = torch.nn.BatchNorm2d(x.shape[1], eps=1e-3, momentum=0.03).to(world.device)
        bn.load_state_dict(state)
        scope = mesh.data_parallel(world) if name == "synced" else contextlib.nullcontext()
        with scope:
            y = batch_norm_train(bn, world.local(x).to(world.device))
        out[name] = {"y": y.detach().cpu(), "state": _to_cpu(bn.state_dict())}
    return out


def _model(flags, device):
    train_config, model_config = args_to_config(get_args(flags))
    return train_config, GPT.from_config(model_config, get_actions_info(train_config),
                                         device=device)


def loss_rank(world: mesh.World, spec: dict) -> dict:
    """The loss of this rank's rows of ``spec``'s global inputs on the
    weights ``spec["state"]`` of the model of ``spec["flags"]``,
    differentiated inside ``data_parallel``: ``spec["mode"]`` "supervised"
    (``decision_loss`` then ``detection_loss`` on already augmented patches,
    ``spec["batch"]``, with ``spec["class_weight"]``) or "reinforce"
    (``reinforce_loss`` on ``spec["record"]``, a rollout's arrays, over
    ``spec["images"]`` and ``spec["boxes"]``, with ``spec["return_mean"]``
    and ``spec["return_std"]``). Returns this rank's share of the loss, its
    gradients (their sum over the ranks is the global loss's) and the state
    dict after (the BN statistics)."""
    from ..train.reinforce import reinforce_loss
    from ..train.supervised import decision_loss, detection_loss

    cfg, model = _model(spec["flags"], world.device)
    model.load_state_dict(spec["state"])
    on_rank = lambda v: torch.as_tensor(np.asarray(world.local(v))).to(world.device)
    with mesh.data_parallel(world):
        if spec["mode"] == "supervised":
            batch = {k: on_rank(v) for k, v in spec["batch"].items()}
            class_weight = torch.as_tensor(np.asarray(spec["class_weight"])).to(world.device)
            loss, _ = decision_loss(model, batch["patches"], batch, class_weight)
            loss = loss + detection_loss(model, batch["patches_yolox"], batch)["total_loss"]
        else:
            env = NeedleEnv(world.local(spec["images"]), world.local(spec["boxes"]),
                            cfg.patch_size, cfg.max_seq_len, 1, cfg.stop_enabled,
                            device=world.device)
            record = {k: on_rank(v) for k, v in spec["record"].items()}
            loss, _ = reinforce_loss(model, env, record, spec["return_mean"],
                                     spec["return_std"], cfg.entropy_weight, cfg.reward_norm)
        loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
             for n, p in model.named_parameters()}
    return {"loss": float(loss.detach()), "grads": grads, "state": _to_cpu(model.state_dict())}


def kernel_counts() -> Dict[str, Dict[str, int]]:
    """Every kernel wrapper's ``calls`` and ``launches`` so far."""
    wrappers = {"dwblock_bn_silu": kconv.dwblock_bn_silu,
                "conv3x3_bn_silu": kconv.conv3x3_bn_silu,
                "conv3x3": kconv.conv3x3, "flash_attention": kattn.flash_attention}
    return {kind: {k: getattr(w, kind) for k, w in wrappers.items()}
            for kind in ("calls", "launches")}


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_rank_steps(world: mesh.World, jobs: List[dict]) -> List[dict]:
    """For each job: build the trainer of ``job["flags"]`` as the train CLI
    does (``main.build_trainer``, without a logger) and take ``job["iters"]``
    iterations through ``Trainer.train_loop`` (no test unless the flags ask
    for one). After every iteration it records the metrics, the state
    digest, each kernel wrapper's calls and launches and the collectives
    issued (``mesh.counts``). ``job["tf32"]`` False
    turns TF32 off (a spawned rank does not inherit the caller's setting);
    with ``job["time"]`` each iteration's wall time is taken with the
    device synchronised after it, and, over a group, the gradient
    all-reduce of the trained parameters is timed alone after the run."""
    results = []
    for job in jobs:
        if "tf32" in job:
            torch.backends.cuda.matmul.allow_tf32 = job["tf32"]
            torch.backends.cudnn.allow_tf32 = job["tf32"]
        args = get_args(job["flags"])
        trainer = build_trainer(world, *args_to_config(args), args.dataset_dir, log=False)
        rec = {k: [] for k in ("losses", "metrics", "digests", "calls", "launches",
                               "collectives", "step_ms")}
        marks = {"counts": kernel_counts(), "collectives": Counter(mesh.counts),
                 "time": None}

        def hook(it, metrics):
            if job.get("time"):
                _sync(world.device)
                now = time.perf_counter()
                if marks["time"] is not None:
                    rec["step_ms"].append(1e3 * (now - marks["time"]))
                marks["time"] = now
            counts = kernel_counts()
            rec["calls"].append(_delta(counts["calls"], marks["counts"]["calls"]))
            rec["launches"].append(_delta(counts["launches"], marks["counts"]["launches"]))
            rec["collectives"].append(dict(Counter(mesh.counts) - marks["collectives"]))
            rec["metrics"].append({k: float(v) for k, v in metrics.items()})
            rec["losses"].append(rec["metrics"][-1]["loss"])
            rec["digests"].append(trainer.state_digest())
            marks["counts"], marks["collectives"] = kernel_counts(), Counter(mesh.counts)
            if job.get("time"):
                marks["time"] = time.perf_counter()

        trainer.train_loop(range(1, job["iters"] + 1), hook=hook)
        rec["state"] = _to_cpu(trainer.model.state_dict())
        if job.get("time") and world.grouped:
            rec.update(_time_gradient_sum(trainer, world))
        results.append(rec)
        del trainer
        if world.device.type == "cuda":
            torch.cuda.empty_cache()
    return results


def _time_gradient_sum(trainer, world: mesh.World, reps: int = 5) -> dict:
    """The median wall time and the bytes of one gradient all-reduce of the
    trained parameters (``mesh.sum_gradients`` on zero gradients)."""
    params = list(trainer.optimizer.trained_params())
    times = []
    before = mesh.counts["gradient_bytes"]
    for _ in range(reps):
        for p in params:
            p.grad = None
        _sync(world.device)
        start = time.perf_counter()
        mesh.sum_gradients(params)
        _sync(world.device)
        times.append(1e3 * (time.perf_counter() - start))
    trainer.optimizer.zero_grad()
    return {"sync_ms": float(np.median(times)),
            "sync_bytes": (mesh.counts["gradient_bytes"] - before) // reps}


def _parameters(state: Dict[str, torch.Tensor]) -> List[str]:
    return [k for k in state if "running_" not in k and "num_batches_tracked" not in k]


def weights_disagree(want: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor],
                     lr_of: Callable[[str], float]) -> List[str]:
    """What misses in ``got``'s weights against ``want``'s by the aggregate
    rule: each weight within 2e-2 relative (L2) or within 4 learning rates
    (``lr_of(name)``) RMS — a sign flip of a near-zero gradient moves an
    Adam coordinate by up to 2 lr a step — and all of them together within
    1e-3 relative. Returns one line per miss (none: they agree)."""
    misses, sq_diff, sq_norm = [], 0.0, 0.0
    for name in _parameters(want):
        a, b = want[name].double(), got[name].double()
        diff = float((a - b).norm())
        rel = diff / max(float(a.norm()), 1e-6)
        rms = diff / math.sqrt(a.numel())
        if not (rel < 2e-2 or rms < 4 * lr_of(name)):
            misses.append(f"{name}: relative {rel:.3g}, rms {rms:.3g}")
        sq_diff += diff ** 2
        sq_norm += float(a.norm()) ** 2
    if (sq_diff / sq_norm) ** 0.5 >= 1e-3:
        misses.append(f"all weights: relative {(sq_diff / sq_norm) ** 0.5:.3g}")
    return misses


def stats_relative(want: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]) -> float:
    """The relative L2 distance of ``got``'s BN running statistics, all
    together, from ``want``'s."""
    names = [k for k in want if "running_" in k]
    diff = sum(float((want[k].double() - got[k].double()).norm()) ** 2 for k in names)
    norm = sum(float(want[k].double().norm()) ** 2 for k in names)
    return (diff / norm) ** 0.5


def compare_runs(one: dict, ranks_out: List[dict], updated_after: int,
                 lr_of: Callable[[str], float], after_rtol: float = 1e-4):
    """A W-rank run (each rank's :func:`train_rank_steps` record of one
    job) against the one-rank run at the global batch (``one``). Misses:
    a rank whose state digest or final state differs from rank 0's after
    some iteration; a loss before the first update (after iteration
    ``updated_after``) further than rtol 1e-4 from ``one``'s, one after it
    further than ``after_rtol``; weights that :func:`weights_disagree`; BN
    statistics further than 1e-4 relative, all together; kernel calls or
    launches of an iteration unequal. Returns (misses, {"loss_before",
    "loss_after", "stats"}: the largest relative loss differences and the
    statistics' distance)."""
    r0 = ranks_out[0]
    misses = []
    for r, rec in enumerate(ranks_out[1:], start=1):
        if rec["digests"] != r0["digests"]:
            misses.append(f"rank {r}'s state differs from rank 0's after some iteration")
        if any(not torch.equal(v, rec["state"][k]) for k, v in r0["state"].items()):
            misses.append(f"rank {r}'s final state differs from rank 0's")
    a, b = np.asarray(one["losses"]), np.asarray(r0["losses"])
    rel = np.abs(b - a) / np.abs(a) if len(a) == len(b) else np.full(1, np.inf)
    n = updated_after
    numbers = {"loss_before": float(rel[:n].max(initial=0.0)),
               "loss_after": float(rel[n:].max(initial=0.0)),
               "stats": stats_relative(one["state"], r0["state"])}
    if not (numbers["loss_before"] < 1e-4 and numbers["loss_after"] < after_rtol):
        misses.append(f"losses {b.tolist()} against one rank's {a.tolist()}")
    misses += weights_disagree(one["state"], r0["state"], lr_of)
    if not numbers["stats"] < 1e-4:
        misses.append(f"BN statistics: relative {numbers['stats']:.3g}")
    for kind in ("calls", "launches"):
        if any(rec[kind] != one[kind] for rec in ranks_out):
            misses.append(f"{kind} per iteration {[rec[kind] for rec in ranks_out]} against"
                          f" one rank's {one[kind]}")
    return misses, numbers
