"""FLOP and parameter report: the train CLI's ``--measure-flops``.

The counterpart of ``jolineedle_tpu/utils/flops.py:122-196``: the same lines,
labels and ``_pretty`` formatting, for the backbone and the YOLOX head on one
patch, the GPT and the complete model at sequence lengths 1, 2, 4, 8 and 16
(capped at ``block_size``), the backbone and YOLOX on an 8P x 8P image, and
the parameter counts of each part.

The JAX package counts 2 x MACs of the matmuls and convolutions in the traced
program without executing it (``jaxpr_flops``). Here
``torch.utils.flop_counter.FlopCounterMode`` counts the same (2 x MACs of
``mm``/``bmm``/``addmm`` and ``convolution``; elementwise work ignored) on a
copy of the model on the ``meta`` device: only shapes exist there, so the
count runs no kernel and takes no device memory. The model runs as its
PyTorch ops, eval-mode BatchNorm with autograd on, where every conv is a
PyTorch conv as in the flax module tree (the fused conv wrappers' plain
versions compute the depthwise half as nine elementwise taps, which a FLOP
counter does not see); the attention is the flash wrapper's plain version
on meta tensors, the jnp oracle's two einsums, as JAX counts it.

The parameter counts group the model's parameters as the JAX ``params`` tree
groups them, through the bridge's key map (``models/bridge.py``).
"""

from __future__ import annotations

import copy

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models.bridge import gpt_key_map

SEQ_LENS = (1, 2, 4, 8, 16)


def _pretty(n: float) -> str:
    for unit in ["", "K", "M", "G", "T"]:
        if abs(n) < 1000:
            return f"{n:.3f}{unit}"
        n /= 1000
    return f"{n:.3f}P"


def meta_copy(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` with every parameter and buffer replaced by a ``meta``
    tensor of its shape and dtype; no storage is copied."""
    memo = {}
    for t in list(model.parameters()) + list(model.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = (torch.nn.Parameter(meta, requires_grad=t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else meta)
    return copy.deepcopy(model, memo)


def count_flops(fn, *args) -> float:
    """2 x MACs of the matmuls and convolutions ``fn(*args)`` runs."""
    with FlopCounterMode(display=False) as counter, torch.enable_grad():
        fn(*args)
    return float(counter.get_total_flops())


def rollout_flops(model, batch_size: int, steps: int) -> float:
    """2 x MACs of the matmuls and convolutions of one KV-cache rollout of
    ``steps`` steps at ``batch_size``: what ``jolineedle_tpu.utils.flops.
    traced_flops`` counts for ``Trainer._rollout_scan`` (the class token
    into a fresh cache, then per step one patch embedded and one token
    decoded against the whole cache; the env's gather and reward do no
    matmul).

    Counted on a ``meta`` copy of ``model`` at the rollout's per-step shapes:
    a rollout itself cannot run there (sampling and the env step read the
    data), and a kernel launched through ``ctypes`` is invisible to the
    counter, so the count comes from the module tree, never from a run on
    the card. As in :func:`measure_flops`, autograd is on, so every conv is
    a PyTorch conv (the depthwise ones counted as convs, as JAX counts them)
    and the decode's attention is its two einsums over the cache."""
    m = meta_copy(model).eval()
    P, nc = m.patch_size, m.n_channels
    meta = dict(device="meta")
    classes = torch.zeros((batch_size,), dtype=torch.long, **meta)
    with torch.enable_grad():
        cache = m.init_cache(classes)
    patch = torch.zeros((batch_size, P, P, nc), **meta)
    action = torch.zeros((batch_size,), dtype=torch.long, **meta)
    position = torch.zeros((batch_size, 2), dtype=torch.long, **meta)

    def step(t):
        cache["index"] = t
        return m.decode_step(cache, patch, action, position, t)

    # Every step attends over the whole preallocated cache (the masked keys
    # included, as the JAX decode does), so each step counts alike.
    return count_flops(m.init_cache, classes) + sum(count_flops(step, t) for t in range(steps))


def param_counts(model) -> dict:
    """Parameter counts as the JAX ``params`` tree groups them:
    ``backbone`` (yolox/backbone), ``head`` (yolox/head), ``yolox`` and
    ``gpt`` (everything outside yolox)."""
    state = model.state_dict()
    counts = {"backbone": 0, "head": 0, "yolox": 0, "gpt": 0}
    for tkey, coll, fpath, _ in gpt_key_map(model):
        if coll != "params":
            continue
        n = state[tkey].numel()
        if fpath[0] == "yolox":
            counts["yolox"] += n
            counts[fpath[1]] += n
        else:
            counts["gpt"] += n
    return counts


def measure_flops(trainer, model_config, train_config) -> dict:
    """Print the report of ``jolineedle_tpu/utils/flops.py:122-196`` for
    ``trainer.model`` at batch 1; return its numbers (FLOPs as counted,
    before formatting, and the parameter counts)."""
    model = meta_copy(trainer.model).eval()
    P = model_config.patch_size
    nc = model_config.n_channels
    b = 1
    meta = dict(device="meta")
    report = {"params": param_counts(trainer.model), "seq_len": {}}
    params = report["params"]

    def backbone(x):  # as yolox_outputs runs it with autograd on
        return model.yolox.backbone(model._to_compute(x), False, True)

    print(f"Computing FLOPs for patch size = {P} and batch size = {b}")
    one_patch = torch.zeros((b, P, P, nc), **meta)
    bkb_flops = report["backbone"] = count_flops(backbone, one_patch)
    print(f"Backbone FLOPs: {_pretty(bkb_flops)}, Params: {_pretty(params['backbone'])}")
    yolo_flops = report["yolox"] = count_flops(model.yolox_outputs, one_patch)
    print(f"Yolox Head FLOPs: {_pretty(yolo_flops - bkb_flops)}, "
          f"Params: {_pretty(params['head'])}")

    # The reference iterates this fixed list; capped at block_size, as the
    # JAX report does, so small --max-seq-len configs stay inside the model.
    for seq_len in SEQ_LENS:
        if seq_len > model_config.block_size:
            break
        patches = torch.zeros((b, seq_len, P, P, nc), **meta)
        actions = torch.zeros((b, seq_len), dtype=torch.long, **meta)
        positions = torch.zeros((b, seq_len, 2), dtype=torch.long, **meta)
        classes = torch.zeros((b,), dtype=torch.long, **meta)
        flops = report["seq_len"][seq_len] = count_flops(model, patches, actions, classes,
                                                          positions)
        print(f"Seq len: {seq_len}, GPT FLOPs: {_pretty(flops - seq_len * bkb_flops)}, "
              f"Params: {_pretty(params['gpt'])}")
        print(f"Seq len: {seq_len}, Complete Model FLOPs: {_pretty(flops)}, "
              f"Params: {_pretty(params['gpt'] + params['yolox'])}")

    big = P * 8
    print(f"Compute Yolox FLOPs for image of size {big}x{big}")
    full_img = torch.zeros((b, big, big, nc), **meta)
    bkb_full = report["backbone_image"] = count_flops(backbone, full_img)
    print(f"Backbone FLOPs: {_pretty(bkb_full)}, Params: {_pretty(params['backbone'])}")
    yolo_full = report["yolox_image"] = count_flops(model.yolox_outputs, full_img)
    print(f"Yolox total FLOPs: {_pretty(yolo_full)}, "
          f"Params: {_pretty(params['backbone'] + params['head'])}")
    return report
