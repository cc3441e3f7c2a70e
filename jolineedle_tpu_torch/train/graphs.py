"""CUDA graphs of a supervised train step's two conv stacks on the card.

A supervised step of the flagship recipe (B = 16 episodes of 8 patches of
64 px, the yolox-s detector on 12 patches an episode) launches thousands of
small kernels, and the host's pace of launching them, not the device, sets
the step's time (``chip_smoke.py`` phase 11c profiles a step each way;
PERF.md). Most of them are the train-mode forward and backward of
two conv stacks, each run once a step at the same shapes: the
``gpt_backbone`` embedder on the decision patches and the detector on the
detector patches. Each stack is captured once, at its first step, with
``torch.cuda.make_graphed_callables`` and replayed every step after: the
same kernels on the same tensors, one graph launch for each stack's
forward and one for its backward.

What the graphs keep as they were:

- the BatchNorm running statistics: the graphs update them in place at each
  replay, once a step, as the eager stack does; the capture's warm-up runs
  are undone (the buffers are restored after the capture);
- the gradients: the graphs' backward hands the parameters their gradients
  through autograd, as the eager backward does. A graph's gradient buffers
  are static, and autograd may hand one to a parameter as its ``.grad``:
  so graphs run only where every update starts from no gradient, with no
  accumulation window (``--gradient-accumulation 1``) and on one rank;
- what the rest of the step launches: the photometric augmentation (drawn
  from the trainer's generator), the decoder (the flash kernel, with its
  launch count), the SimOTA loss and the optimizer stay eager.

The shared detector backbone used as the embedder (no ``gpt_backbone``:
its gradient stops at the FPN) runs eagerly. On the CPU there are no
graphs.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models import gpt
from ..models.yolox import make_grids_and_strides


class _EmbedderTop(nn.Module):
    """The train-mode ``gpt_backbone`` embedder: its top FPN level."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x, True, True)[-1]


class _DetectorHead(nn.Module):
    """The train-mode detector: its head's outputs that carry gradients."""

    KEYS = ("boxes", "obj_logits", "cls_logits", "raw_reg")

    def __init__(self, yolox: nn.Module):
        super().__init__()
        self.yolox = yolox

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        head, _ = self.yolox(x, True, True)
        return tuple(head[k] for k in self.KEYS)


def graph_stack(module: nn.Module, sample: torch.Tensor):
    """``module`` captured at ``sample``'s shape; its buffers (the running
    statistics) as they were before the capture's warm-up runs."""
    saved = [b.detach().clone() for b in module.buffers()]
    graphed = torch.cuda.make_graphed_callables(module, (sample,))
    with torch.no_grad():
        for b, s in zip(module.buffers(), saved):
            b.copy_(s)
    return graphed


class TrainGraphs:
    """The graphed stacks of one model, captured lazily at each new input
    shape (a supervised step has one of each)."""

    def __init__(self, model):
        self.model = model
        self.graphed: Dict[tuple, nn.Module] = {}
        #: Captures made, by stack (a steady run makes one of each).
        self.captures = {"embedder": 0, "detector": 0}

    def _run(self, name: str, module, x: torch.Tensor):
        key = (name, tuple(x.shape), x.dtype)
        if key not in self.graphed:
            self.graphed[key] = graph_stack(module(), x)
            self.captures[name] += 1
        return self.graphed[key](x)

    def embedder(self, x: torch.Tensor) -> torch.Tensor:
        """The ``gpt_backbone`` embedder's top level on NCHW ``x``."""
        return self._run("embedder", lambda: _EmbedderTop(self.model.gpt_backbone_net), x)

    def detector(self, x: torch.Tensor) -> dict:
        """The detector head's outputs on NCHW ``x`` (``YOLOXHead``'s dict)."""
        outs = self._run("detector", lambda: _DetectorHead(self.model.yolox), x)
        head = dict(zip(_DetectorHead.KEYS, outs))
        head["grids"], head["strides"] = make_grids_and_strides(x.shape[2], x.device)
        return head


@contextmanager
def active(graphs: Optional[TrainGraphs]):
    """Route the model's train-mode stacks through ``graphs`` inside."""
    token = gpt.TRAIN_GRAPHS.set(graphs)
    try:
        yield
    finally:
        gpt.TRAIN_GRAPHS.reset(token)
