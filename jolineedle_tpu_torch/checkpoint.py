"""Checkpoints of the port, written with ``torch.save``.

A model directory holds ``config.json`` (``config.save_config``) beside
``checkpoint.pt`` (last) and ``checkpoint_best.pt`` (best), each the model's
``state_dict``: the names of the JAX package's ``checkpoint.msgpack`` /
``checkpoint_best.msgpack``. A trainer adds ``train_state.pt``, the rest of
its state at the last checkpoint (optimizer, step count, return window,
random generator), which ``--resume-training`` restores with
``checkpoint.pt``. The JAX package's msgpack files are not read yet.
"""

from __future__ import annotations

from pathlib import Path

import torch

CKPT_LAST = "checkpoint.pt"
CKPT_BEST = "checkpoint_best.pt"
TRAIN_STATE = "train_state.pt"


def save_model(model: torch.nn.Module, directory, best: bool = False) -> Path:
    """Write ``model.state_dict()`` (moved to the CPU) into ``directory``."""
    path = Path(directory) / (CKPT_BEST if best else CKPT_LAST)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def load_model(model: torch.nn.Module, directory, best: bool = True) -> torch.nn.Module:
    """Load ``directory``'s best (or last) checkpoint into ``model``, strictly."""
    path = Path(directory) / (CKPT_BEST if best else CKPT_LAST)
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


def save_train_state(state: dict, directory) -> Path:
    """Write a trainer's non-model state (tensors, numbers, lists, dicts)."""
    path = Path(directory) / TRAIN_STATE
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, path)
    return path


def load_train_state(directory) -> dict:
    return torch.load(Path(directory) / TRAIN_STATE, map_location="cpu", weights_only=True)
