"""Take the supervised step from a trained state on the card, and hold it
against the same step on the CPU.

A probe file (a ``torch.save`` of a dict; ``tests/test_torch_trained_state.py``
writes one for each trained state it holds against the JAX package) carries
one step's inputs and its references:

- ``flags``: the train CLI's flags of the step (the recipe's, with ``TOY``
  and ``WORK`` in place of the dataset and work directories);
- ``state_dict``: the port's model at the trained state;
- ``batch``: the host batch (``build_supervised_batch``, with pixels);
- ``augmented``: the step's photometrically augmented decision and detector
  patches (float32), which the step takes in place of its own draws;
- ``masks``: the decoder's dropout masks, in the order the forward draws
  them, which the step's dropout takes in place of its own draws;
- ``reference``: the JAX package's float64 step on those inputs, as
  ``(loss terms, gradients, BatchNorm statistics after the step)``, the
  last two flat dicts of flax paths -> float64 arrays;
- ``cpu``: per compute dtype, the distances (``distances``) from that
  reference of the port's step on the CPU (``port``) and of the JAX
  package's step in that dtype (``jax``).

For each file, in float32 (with PyTorch's TF32 switches as the port runs:
cuDNN's convolutions in TF32, its default; then with TF32 off) and in
bfloat16, this script builds the port's trainer of the flags on the card,
loads the state, replays the patches and masks, and takes one eager step
(no step graphs) under deterministic algorithms (the flags of
``chip_smoke.py``'s deterministic pass); then holds the card's distances
from the reference against the CPU port's by ``within`` and prints one
JSON line per step:

    python -m jolineedle_tpu_torch.scripts.step_probe build/trained/probe/*.pt \\
        --out chiprun_out/step_probe [--graphed-warnings]

``--graphed-warnings`` also trains three steps of the first file's flags on
its batch on the default route (the step graphs, bfloat16) and reports
which backward raised PyTorch's ``AccumulateGrad`` stream warning, and for
the detector's backward at the third step, which of its parameter groups.
Writes ``step_probe.json`` into ``--out``; exits 1 if a step is outside the
rule. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

#: The port's distance from float64 may be FACTOR times the reference
#: run's (the JAX step's of the same compute dtype on the CPU; the CPU
#: port's on the card), plus an atol.
FACTOR = 2.0
#: The loss terms: the sum over the batches of the absolute distances,
#: atol this share of the float64 terms' sum (float32: a few roundings of a
#: mean over B episodes; bfloat16: one bf16 step, 2^-8, as
#: ``test_torch_shared_recipe_parity.py``).
LOSS_ATOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
#: Each gradient leaf: the root mean square distance, atol this share of
#: the float64 gradient's root mean square.
GRAD_ATOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
#: Each BatchNorm statistics leaf: the root mean square distance, atol
#: (``test_torch_shared_recipe_parity.py``'s ``STATS_ATOL``).
STATS_ATOL = 1e-6
#: The leaf groups reported apart: the decision side (the embedder's top,
#: the projection, the decoder, its head), the tokens, the detector.
GROUPS = {"decision": ("embed_fpn_conv", "embed_fpn_dense", "project_concat", "h_", "ln_f",
                       "action_head"),
          "tokens": ("wte", "embed_class"), "detector": ("yolox",)}
DTYPES = ("float32", "bfloat16")


def leaf_name(path) -> str:
    return "/".join(map(str, path)) if isinstance(path, tuple) else str(path)


def group_of(name: str) -> str:
    head = name.split("/")[1] if name.startswith(("params/", "batch_stats/")) else name
    head = head.split("/")[0]
    for group, prefixes in GROUPS.items():
        if head.startswith(prefixes):
            return group
    raise KeyError(name)


def distances(runs: list, ref: list) -> dict:
    """The distances of ``runs`` from ``ref`` (two lists over the same
    batches of (loss terms, gradients, statistics)), pooled over the
    batches: ``terms``: name -> (sum of absolute distances, sum of
    absolute reference values); ``grads`` and ``stats``: leaf name -> (root
    mean square distance, root mean square of the reference, elements)."""
    sums = {"terms": {}, "grads": {}, "stats": {}}
    for (terms, grads, stats), (t_ref, g_ref, s_ref) in zip(runs, ref, strict=True):
        for name, value in t_ref.items():
            acc = sums["terms"].setdefault(name, [0.0, 0.0])
            acc[0] += abs(float(terms[name]) - value)
            acc[1] += abs(value)
        for kind, got, want in (("grads", grads, g_ref), ("stats", stats, s_ref)):
            assert set(got) == set(want), (kind, sorted(set(got) ^ set(want))[:4])
            for path, value in want.items():
                value = np.asarray(value, np.float64)
                d = np.asarray(got[path], np.float64) - value
                acc = sums[kind].setdefault(leaf_name(path), [0.0, 0.0, 0])
                acc[0] += float(np.sum(d * d))
                acc[1] += float(np.sum(value * value))
                acc[2] += value.size
    out = {"terms": {k: tuple(v) for k, v in sums["terms"].items()}}
    for kind in ("grads", "stats"):
        out[kind] = {k: (np.sqrt(d2 / n), np.sqrt(r2 / n), n)
                     for k, (d2, r2, n) in sums[kind].items()}
    return out


def within(got: dict, base: dict, dtype: str) -> list:
    """Where ``got``'s distances (``distances``) exceed ``FACTOR`` times
    ``base``'s plus the atols of ``dtype``; an empty list if nowhere."""
    failures = []
    for name, (dist, ref_sum) in got["terms"].items():
        bound = FACTOR * base["terms"][name][0] + LOSS_ATOL[dtype] * ref_sum
        if not dist <= bound:
            failures.append(("term", name, dist, bound))
    for kind, atol in (("grads", lambda rms_ref: GRAD_ATOL[dtype] * rms_ref),
                       ("stats", lambda rms_ref: STATS_ATOL)):
        for name, (dist, rms_ref, _) in got[kind].items():
            bound = FACTOR * base[kind][name][0] + atol(rms_ref)
            if not dist <= bound:
                failures.append((kind, name, dist, bound))
    return failures


def summary(got: dict, base: dict) -> dict:
    """``got``'s and ``base``'s distances by leaf group: for the gradients
    and the statistics, each group's root mean square distance (over all
    its elements) of both, their ratio and the largest ratio of a leaf with
    the leaf's name; for the loss terms, each term's distances and ratio."""
    out = {"terms": {k: {"got": d, "base": base["terms"][k][0],
                         "ratio": d / base["terms"][k][0] if base["terms"][k][0] else None}
                     for k, (d, _) in got["terms"].items()}}
    for kind in ("grads", "stats"):
        groups = {}
        for name, (dist, _, n) in got[kind].items():
            b = base[kind][name][0]
            acc = groups.setdefault(group_of(name), {"d2": 0.0, "b2": 0.0, "n": 0,
                                                      "max_ratio": 0.0, "max_leaf": None})
            acc["d2"] += dist * dist * n
            acc["b2"] += b * b * n
            acc["n"] += n
            ratio = dist / b if b else (np.inf if dist else 0.0)
            if ratio > acc["max_ratio"] or acc["max_leaf"] is None:
                acc["max_ratio"], acc["max_leaf"] = float(ratio), name
        out[kind] = {g: {"got": float(np.sqrt(a["d2"] / a["n"])),
                         "base": float(np.sqrt(a["b2"] / a["n"])),
                         "ratio": float(np.sqrt(a["d2"] / a["b2"])) if a["b2"] else None,
                         "max_ratio": a["max_ratio"], "max_leaf": a["max_leaf"]}
                     for g, a in groups.items()}
    return out


def _flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): v})
    return out


@contextlib.contextmanager
def tf32(allowed: bool):
    """PyTorch's TF32 switches for cuDNN's convolutions (on by default) and
    cuBLAS's matrix products (off by default) set to ``allowed``, restored
    after."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = allowed
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (warn only) and cuDNN's deterministic flags,
    restored after."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before[2:]


def _trainer(probe: dict, dtype: str, toy: Path, work: Path, device):
    from ..config import args_to_config, get_args
    from ..main import build_trainer
    from ..parallel import mesh

    flags = [{"TOY": str(toy), "WORK": str(work)}.get(f, f) for f in probe["flags"]]
    train_config, model_config = args_to_config(get_args(flags + ["--compute-dtype", dtype]))
    return build_trainer(mesh.single(device), train_config, model_config, toy, log=False)


@contextlib.contextmanager
def replayed(probe: dict, device):
    """The port's augmentation and dropout take the probe's patches and
    masks, in order: each dropout site is handed values that its own keep
    test (below ``1 - p``) turns into the mask."""
    from ..models import gpt
    from ..train import supervised

    patches = [torch.from_numpy(np.asarray(a, np.float32)).to(device)
               for a in probe["augmented"]]
    masks = [torch.from_numpy(np.asarray(m)).to(device) for m in probe["masks"]]
    augment, draw = supervised.detection_augment, gpt.draw

    def replay_augment(generator, raw):
        out = patches.pop(0)
        assert out.shape == raw.shape, (out.shape, raw.shape)
        return out

    def replay_draw(sample, shape):
        mask = masks.pop(0)
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        keep = torch.tensor(np.float32(0.9), device=device)  # the recipe's dropout 0.1
        below = torch.tensor(np.nextafter(np.float32(0.9), np.float32(0)), device=device)
        return torch.where(mask, below, keep)

    supervised.detection_augment, gpt.draw = replay_augment, replay_draw
    try:
        yield lambda: not patches and not masks
    finally:
        supervised.detection_augment, gpt.draw = augment, draw


def card_step(probe: dict, dtype: str, toy: Path, work: Path, device,
              allow_tf32: bool = True) -> tuple:
    """One eager step of ``dtype`` on the card from the probe's state and
    inputs, with PyTorch's TF32 switches as the port leaves them (cuDNN's
    on) or all off: (loss terms, gradients, statistics after the step), flat
    dicts in the JAX package's layout."""
    from ..models.bridge import torch_to_flax

    os.environ["JOLINEEDLE_TORCH_STEP_GRAPHS"] = "0"
    trainer = _trainer(probe, dtype, toy, work, device)
    trainer.model.load_state_dict(probe["state_dict"])
    model, captured, step = trainer.model, {}, trainer.optimizer.step
    if model.dropout != 0.1:
        raise ValueError(f"the probe's masks are of dropout 0.1, the flags give {model.dropout}")

    def capture():
        captured["grads"] = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                             for n, p in model.named_parameters() if p.requires_grad}
        step()

    trainer.optimizer.step = capture
    with deterministic(), tf32(allow_tf32), replayed(probe, device) as used_all:
        metrics = trainer.train_step(probe["batch"])
        assert used_all(), "the step did not take every replayed patch and mask"
    terms = {k: float(v) for k, v in metrics.items() if k in probe["reference"][0]}
    grads = _flat(torch_to_flax(captured["grads"], model, strict=False)["params"])
    stats = _flat(torch_to_flax(model.state_dict(), model)["batch_stats"])
    return terms, grads, stats


def graphed_warnings(probe: dict, toy: Path, work: Path, device) -> dict:
    """Three bfloat16 steps of the probe's flags on its batch on the default
    route (step graphs): the ``AccumulateGrad`` stream warnings raised by
    each of the step's backward calls (``decision``, ``detection``; at the
    third step the detector's taken apart by parameter group, ``backbone``
    and ``head``) and by the rest of each step (the graphs' captures)."""
    os.environ.pop("JOLINEEDLE_TORCH_STEP_GRAPHS", None)
    trainer = _trainer(probe, "bfloat16", toy, work, device)
    trainer.model.load_state_dict(probe["state_dict"])
    yolox = trainer.model.yolox
    parts = {"backbone": [p for p in yolox.backbone.parameters() if p.requires_grad],
             "head": [p for p in yolox.head.parameters() if p.requires_grad]}
    seen, state = {}, {"step": 0, "call": 0}
    backward = torch.Tensor.backward

    def stream_warnings(record) -> int:
        return sum("AccumulateGrad" in str(w.message) for w in record)

    def labelled(self, *args, **kwargs):
        label = ("decision", "detection")[state["call"] % 2]
        state["call"] += 1
        key = f"step {state['step']} {label}"
        with warnings.catch_warnings(record=True) as record:
            warnings.simplefilter("always")
            if label == "detection" and state["step"] == 3:
                for i, (name, params) in enumerate(parts.items()):
                    with warnings.catch_warnings(record=True) as part:
                        warnings.simplefilter("always")
                        torch.autograd.backward(self, inputs=params,
                                                retain_graph=i + 1 < len(parts))
                    seen[f"{key} {name}"] = stream_warnings(part)
                return None
            out = backward(self, *args, **kwargs)
        seen[key] = stream_warnings(record)
        return out

    torch.Tensor.backward = labelled
    try:
        for step in range(1, 4):
            state["step"] = step
            with warnings.catch_warnings(record=True) as record:
                warnings.simplefilter("always")
                trainer.train_step(probe["batch"])
            seen[f"step {step}, outside those backward calls"] = stream_warnings(record)
    finally:
        torch.Tensor.backward = backward
    return {"graphs": trainer.graphs is not None, "stream_warnings": seen}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("probes", nargs="+", type=Path)
    parser.add_argument("--out", type=Path, default=Path("chiprun_out/step_probe"))
    parser.add_argument("--work", type=Path, default=Path("build/step_probe"))
    parser.add_argument("--graphed-warnings", action="store_true")
    args = parser.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("step_probe needs a CUDA device", file=sys.stderr)
        return 2
    from . import make_toyds_big

    device = torch.device("cuda", 0)
    toy = args.work / "toy"
    if not (toy / "train.txt").is_file():
        make_toyds_big.make_toyds_big(toy, n_train=4, n_test=2)
    report, failed = {"card": torch.cuda.get_device_name(0), "steps": []}, False
    for path in args.probes:
        probe = torch.load(path, map_location="cpu", weights_only=False)
        for dtype, allow_tf32 in (("float32", True), ("float32", False), ("bfloat16", True)):
            got = distances([card_step(probe, dtype, toy, args.work / "run", device,
                                       allow_tf32)], [probe["reference"]])
            failures = within(got, probe["cpu"][dtype]["port"], dtype)
            failed |= bool(failures)
            line = {"probe": path.name, "dtype": dtype, "tf32": allow_tf32 and dtype == "float32",
                    "failures": failures[:20],
                    "n_failures": len(failures),
                    "against_cpu_port": summary(got, probe["cpu"][dtype]["port"]),
                    "against_jax": summary(got, probe["cpu"][dtype]["jax"])}
            print(json.dumps(line, default=float), flush=True)
            report["steps"].append(line)
    if args.graphed_warnings:
        probe = torch.load(args.probes[0], map_location="cpu", weights_only=False)
        try:  # a diagnostic: its failure is reported, and fails nothing
            report["graphed"] = graphed_warnings(probe, toy, args.work / "graphed", device)
        except Exception as error:  # noqa: BLE001
            report["graphed"] = {"error": repr(error)}
        print(json.dumps(report["graphed"]), flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "step_probe.json").write_text(json.dumps(report, indent=1, default=float))
    print(json.dumps({"ok": not failed, "steps": len(report["steps"])}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
