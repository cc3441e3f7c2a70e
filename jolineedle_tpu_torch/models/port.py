"""Upstream (Megvii) YOLOX weights onto the port's YOLOX.

The counterpart of ``jolineedle_tpu/models/port.py:182-268``. The reference
fine-tunes from COCO-pretrained YOLOX checkpoints, ``{"model": state_dict}``
torch files. The port's YOLOX keeps Megvii's attribute names
(``models/yolox.py``), so the mapping is a checked copy: every key that
``models/bridge.py::yolox_key_map`` lists is taken from the checkpoint and
must have the port's shape, except the class predictions of a checkpoint
with another class count (COCO has 80, the needle 1), which keep the
target's values, as the JAX function skips them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .bridge import yolox_key_map


def load_torch_checkpoint(path) -> Dict[str, torch.Tensor]:
    """An upstream ``{"model": state_dict}`` checkpoint, or a bare state
    dict, as CPU tensors (``weights_only``: no code in the file runs)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("model", ckpt)
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def port_yolox_state_dict(
    state_dict: Dict[str, torch.Tensor],
    target: Dict[str, torch.Tensor],
    variant: str,
    include_head: bool = True,
    num_classes: int = 1,
    strict: bool = True,
) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Map an upstream state_dict onto a copy of ``target``, the port's
    ``NeedleYOLOX`` state_dict of ``variant``. Returns (state_dict, skipped).

    ``strict`` raises on a key the checkpoint lacks (else it is skipped and
    keeps the target's value); ``cls_preds`` whose class count is not
    ``num_classes`` are skipped; ``include_head=False`` maps the PAFPN only.
    A shape that differs from the target's raises.
    """
    out = {k: v.clone() for k, v in target.items()}
    skipped = []
    for tkey, _, _, _ in yolox_key_map(variant, include_head):
        if tkey not in state_dict:
            if strict:
                raise KeyError(f"checkpoint is missing {tkey}")
            skipped.append(tkey)
            continue
        value = state_dict[tkey].detach().to(torch.float32)
        if ".cls_preds." in tkey and value.shape[0] != num_classes:
            skipped.append(tkey)  # class-count mismatch (COCO -> 1 class)
            continue
        if tkey not in out:
            raise KeyError(f"the port's {variant} has no {tkey}")
        if tuple(out[tkey].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {tkey}: {tuple(out[tkey].shape)} vs"
                             f" {tuple(value.shape)}")
        out[tkey] = value.clone()
    return out, skipped
