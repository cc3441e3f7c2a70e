"""One rollout step of the bench's config cut into its parts, each timed on
the card (the counterpart of ``scripts/bench_rollout_parts.py``):

  - ``dispatch``: one near-empty device operation, the launch floor each
    part pays;
  - ``embed``: ``GPT.embed_patches`` on a [B, 1, P, P, 3] patch batch, the
    yolox backbone + FPN embedder on the kernels;
  - ``decode``: ``GPT.decode_step``, the embed plus one KV-cache step;
  - ``env``: ``NeedleEnv.masked_step``, the uint8 patch gather, scaling and
    the visited / reward / termination logic;
  - ``scan20``: the whole sampled rollout (``bench.py``'s measured
    quantity), reported per step.

Each part's time is the median of its reps, each rep between a pair of CUDA
events (the host clock on the CPU). Prints one line a part and then one
JSON line: the JAX script's keys, the card's name and power limit.

    python -m jolineedle_tpu_torch.scripts.bench_rollout_parts

Knobs: ``BENCH_PARTS_ITERS`` (reps, default 100; scan20 takes a fifth),
``BENCH_SMALL=1`` and bench.py's size knobs (``bench.build``).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .. import bench, resolve_device
from ..train.rollout import rollout
from ..utils.timing import card, median_ms


def main(argv=None, device=None) -> dict:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    dev = resolve_device(device)
    iters = int(os.environ.get("BENCH_PARTS_ITERS", "100"))
    trainer, model, images, boxes, batch, max_ep_len, patch, embedder = bench.build(
        small=os.environ.get("BENCH_SMALL", "") == "1", device=dev)
    env = bench.pool_env(trainer, images, boxes)
    state0, patches0, _ = env.reset(generator=torch.Generator(device=dev).manual_seed(0))
    classes = torch.zeros((batch,), dtype=torch.long, device=dev)
    actions0 = torch.zeros((batch,), dtype=torch.long, device=dev)
    frozen = torch.zeros((batch,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        cache0 = model.init_cache(classes)
    acc = torch.zeros((), device=dev)
    step = {"i": 0}

    def dispatch():
        acc.add_(1.0)

    @torch.no_grad()
    def embed():
        return model.embed_patches(patches0)

    @torch.no_grad()
    def decode():
        cache0["index"] = 1  # the first action token, as step 0 of a rollout
        return model.decode_step(cache0, patches0[:, 0], actions0, state0.positions, 0)

    def env_step():
        step["i"] += 1
        return env.masked_step(state0, actions0 + step["i"] % 8, frozen)

    sampler = torch.Generator(device=dev).manual_seed(0)

    def scan():
        return rollout(model, env, sample=True, generator=sampler)

    where = card(dev)
    results = {}
    for label, key, fn, n, per in (("dispatch", "dispatch_ms", dispatch, iters, 1),
                                   ("embed", "embed_ms", embed, iters, 1),
                                   ("decode", "decode_ms", decode, iters, 1),
                                   ("env", "env_ms", env_step, iters, 1),
                                   ("scan20", "scan_step_ms", scan, max(1, iters // 5),
                                    max_ep_len)):
        results[key] = median_ms(fn, n, dev) / per
        print(f"{label:8s} {results[key]:9.3f} ms/iter  [{where}]", flush=True)
    results["batch"] = batch
    results["embedder"] = embedder
    results["sum_parts_ms"] = results["decode_ms"] + results["env_ms"]
    results["card"] = where
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in results.items()}), flush=True)
    return results


if __name__ == "__main__":
    main()
