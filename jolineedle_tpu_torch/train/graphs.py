"""CUDA graphs of a train step's conv stacks and of REINFORCE's rollout.

A train step of the recipes (B = 16 at 64 px, the yolox-s detector on the
detector patches) launches thousands of small kernels, and the host's pace
of launching them, not the device, sets the step's time (``chip_smoke.py``
phases 11c and 11d profile a step each way; PERF.md). Most of them are in
parts that run once a step at the same shapes:

- the embedder: train-mode on the supervised decision patches, eval-mode
  in REINFORCE's teacher-forced recompute of the rollout's
  log-probabilities. A ``gpt_backbone`` embedder runs under autograd; the
  shared detector backbone used as the embedder (no ``gpt_backbone``: its
  gradient stops at the FPN) runs forward only, outside autograd, in eval
  mode on the fused conv kernels as in the rollout;
- the train-mode detector on the detector patches (both trainers);
- REINFORCE's sampled rollout: ``max_ep_len`` no-grad steps of the embedder
  (the conv kernels), the KV-cache decode and the env.

Each conv stack under autograd is captured once per input shape and mode,
at its first step, with ``torch.cuda.make_graphed_callables`` (one graph
launch for its forward and one for its backward), and replayed every step
after: the same kernels on the same tensors. A stack whose input holds more
than MAX_GRAPHED_INPUT elements runs eagerly: its graph would keep the
activations it saves for the backward in a pool of its own, beside what
the rest of the step allocates (at 448 px and B = 16 the REINFORCE step's
graphs took 52.5 GiB and ran out of the card's 80), while steps of that
size keep the device busier anyway (PERF.md: eagerly, a REINFORCE step at
448 px is 41.8 % busy and a supervised one 89.0 %, a supervised step of
the 64 px recipe 17.8-21.4 %). The parts that nothing differentiates, the
shared embedder (:class:`ForwardGraph`) and the rollout
(:class:`RolloutGraph`), run eagerly at the first step of each shape (on
the capture's stream, which warms them up) and are captured at the next,
each on its own copy of its input that each step copies into before the
replay (:class:`CapturedCall`).

What the graphs keep as they were:

- the BatchNorm running statistics: the train-mode graphs update them in
  place at each replay, once a step, as the eager stack does; the warm-up
  runs of ``make_graphed_callables`` are undone (the buffers are restored
  after the capture), and the shared embedder's eager first step is the
  step's own;
- the gradients: the graphs' backward hands the parameters their gradients
  through autograd, as the eager backward does, from static buffers that
  the next replay overwrites. So a step that takes the graphs keeps every
  trained parameter's gradient allocated (``Optimizer.hold_grads``):
  autograd adds into it and an accumulation window sums as the eager one;
- the random draws: the rollout graph draws from the trainer's generator,
  registered with it, so each replay draws the numbers the eager rollout
  would, in the same order, and advances the generator as far;
- the kernels' counts: an eager first step counts what it launches; each
  replay adds to every wrapper's ``calls`` and ``launches`` what its
  capture recorded; the capture itself launches and counts none;
- what the rest of the step launches: the augmentation and the detection
  batch (drawn from the trainer's generator), the decoder (the flash
  kernel, with its launch count), the losses and the optimizer stay eager.
  On the key route (``Trainer.key_stream``) the draws themselves, the
  thousands of small integer ops that hash JAX's keys, are captured per
  shape (:meth:`TrainGraphs.key_draws`) and replayed on a copy of each
  step's key: the same numbers in a few launches.

In train mode the shared backbone's running statistics are updated twice
a step, by the embedder's graph and then by the detector's, in the eager
step's order (each graph in a memory pool of its own, so neither's replay
touches the other's static tensors). The graphs run on the card and on one
rank only (``Trainer.step_graphs``); on the CPU, over several ranks, in
the eval rollouts, ``infer`` and the bench there are none.

PyTorch warns once a process that "The AccumulateGrad node's stream does
not match the stream of the node that produced the incoming gradient". It
comes from inside a capture, not from a step's backward: at the first
graphed step, ``make_graphed_callables`` differentiates the captured stack
(the detector's, in the shared pairing) in its warm-up and its capture, on
side streams of its own, one for each; the step's own backward calls, then
and at the steps after, raise none (``scripts/step_probe.py --graphed-warnings`` on
the card records every warning of three graphed steps, per backward call).
The streams are ``make_graphed_callables``' own, which it takes no
argument for, so nothing here can make them agree; and a mismatch costs a
synchronisation, not a value: the graphed step computes what the eager
one does, bit for bit (PERF.md: a shared nano supervised run eager
against graphed, every printed loss equal through 3,328 iterations;
``chip_smoke.py`` phase 11e's losses, BatchNorm buffers and deterministic
passes 0 apart).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models import gpt
from ..models.yolox import make_grids_and_strides
from ..ops import attention, conv
from .rollout import rollout

#: The largest input (elements) of a conv stack that is captured: the
#: recipes' 64 px stacks take at most 3.9 M, the flagship's 448 px ones at
#: least 38.5 M.
MAX_GRAPHED_INPUT = 1 << 24

#: The kernel wrappers whose ``calls`` and ``launches`` a graph's replay adds to.
COUNTED = (conv.dwblock_bn_silu, conv.conv3x3_bn_silu, conv.conv3x3, attention.flash_attention)


def _counts() -> list:
    return [(fn.calls, fn.launches) for fn in COUNTED]


def _add_counts(counts: list) -> None:
    for fn, (calls, launches) in zip(COUNTED, counts):
        fn.calls += calls
        fn.launches += launches


class _EmbedderTop(nn.Module):
    """The ``gpt_backbone`` embedder under autograd: its top FPN level, in
    train mode (batch statistics) or eval mode (running statistics)."""

    def __init__(self, net: nn.Module, train: bool):
        super().__init__()
        self.net, self.train_mode = net, train

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x, self.train_mode, True)[-1]


class _SharedTop(nn.Module):
    """The shared detector backbone as the embedder: its top FPN level,
    forward only (no autograd), in train or eval mode."""

    def __init__(self, backbone: nn.Module, train: bool):
        super().__init__()
        self.backbone, self.train_mode = backbone, train

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.backbone(x, self.train_mode, False)[-1]


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


class CapturedCall:
    """``fn()`` captured as one CUDA graph on ``stream``, drawing from
    ``generator`` when one is given (registered with the graph, so each
    replay draws what the eager call would and advances it as far). The
    capture launches nothing and counts none; :meth:`replay` adds to every
    wrapper's counts what the capture recorded and returns ``fn``'s output,
    static tensors that the next replay overwrites."""

    def __init__(self, fn, stream: torch.cuda.Stream,
                 generator: Optional[torch.Generator] = None):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = _counts()
        with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
            self.out = fn()
        after = _counts()
        #: What one replay launches, per wrapper: (calls, launches).
        self.counts = [(c1 - c0, l1 - l0) for (c0, l0), (c1, l1) in zip(before, after)]
        _add_counts([(-c, -n) for c, n in self.counts])

    def replay(self):
        self.graph.replay()
        _add_counts(self.counts)
        return self.out


class ForwardGraph:
    """``module`` (forward only) captured on a copy of ``sample``. A call
    copies ``x`` into that copy and replays the graph."""

    def __init__(self, module: nn.Module, sample: torch.Tensor, stream: torch.cuda.Stream):
        self.x = sample.clone()
        self.captured = CapturedCall(lambda: module(self.x), stream)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.x.copy_(x)
        return self.captured.replay()


class RolloutGraph:
    """A sampled ``rollout`` of ``model`` (with the actions) captured on a
    copy of ``env``'s batch, drawing from ``generator``. A call runs it on
    another env of the same shapes and returns the rollout's outputs."""

    def __init__(self, model, env, generator: torch.Generator, stream: torch.cuda.Stream):
        self.env = env.static_copy()
        self.captured = CapturedCall(
            lambda: rollout(model, self.env, sample=True, generator=generator,
                            collect=("actions",)), stream, generator)

    def __call__(self, env) -> Dict[str, object]:
        self.env.copy_data_(env)
        return self.captured.replay()


class KeyedGraph:
    """``draw(key)`` (the key route's random numbers for fixed shapes)
    captured on a copy of ``key``. A call copies its key into that copy and
    replays the graph."""

    def __init__(self, draw, key: torch.Tensor, stream: torch.cuda.Stream):
        self.key = key.clone()
        self.captured = CapturedCall(lambda: draw(self.key), stream)

    def __call__(self, key: torch.Tensor):
        self.key.copy_(key)
        return self.captured.replay()


class TrainGraphs:
    """The graphed parts of one model's train steps, each captured lazily
    at each new input shape (a steady run makes one of each it uses)."""

    def __init__(self, model):
        self.model = model
        self.graphed: Dict[tuple, object] = {}
        self._warm = set()  # keys run once eagerly, to capture next
        self._stream = None
        #: Captures made, by part.
        self.captures = {"embedder": 0, "shared_embedder": 0, "detector": 0, "rollout": 0}

    def _run(self, key: tuple, make, x: torch.Tensor):
        """``make()``'s module on ``x``: its graph, captured by
        :func:`graph_stack` at the first call of ``x``'s shape, or the module
        itself above MAX_GRAPHED_INPUT."""
        if x.numel() > MAX_GRAPHED_INPUT:
            return make()(x)
        key = key + (tuple(x.shape), x.dtype)
        if key not in self.graphed:
            self.graphed[key] = graph_stack(make(), x)
            self.captures[key[0]] += 1
        return self.graphed[key](x)

    def _eager_then_graph(self, key: tuple, device: torch.device, run, capture, arg):
        """``run(arg)`` eagerly on the side stream at the first call of
        ``key`` (part, shapes...); at the next, the graph that
        ``capture(stream)`` makes, replayed on ``arg`` then and after."""
        stream = self._stream_of(device)
        graph = self.graphed.get(key)
        if graph is None and key not in self._warm:
            self._warm.add(key)
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                out = run(arg)
            current.wait_stream(stream)
            return out
        if graph is None:
            graph = self.graphed[key] = capture(stream)
            self.captures[key[0]] = self.captures.get(key[0], 0) + 1
        return graph(arg)

    def _stream_of(self, device: torch.device) -> torch.cuda.Stream:
        """The side stream that the graphs are warmed up and captured on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def embedder(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The ``gpt_backbone`` embedder's top level on NCHW ``x`` under
        autograd, in train or eval mode."""
        net = self.model.gpt_backbone_net
        return self._run(("embedder", train), lambda: _EmbedderTop(net, train), x)

    def shared_embedder(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The shared detector backbone's top level on NCHW ``x``, forward
        only, in train or eval mode: eager at the first call of its shape,
        then a :class:`ForwardGraph`."""
        module = _SharedTop(self.model.yolox.backbone, train)
        if x.numel() > MAX_GRAPHED_INPUT:
            return module(x)
        key = ("shared_embedder", train, tuple(x.shape), x.dtype)
        return self._eager_then_graph(key, x.device, module,
                                      lambda stream: ForwardGraph(module, x, stream), x)

    def detector(self, x: torch.Tensor) -> dict:
        """The detector head's outputs on NCHW ``x`` (``YOLOXHead``'s dict)."""
        outs = self._run(("detector",), lambda: _DetectorHead(self.model.yolox), x)
        head = dict(zip(_DetectorHead.KEYS, outs))
        head["grids"], head["strides"] = make_grids_and_strides(x.shape[2], x.device)
        return head

    def key_draws(self, draw, key: torch.Tensor, shapes: tuple):
        """``draw(key)``, the key route's random numbers at ``shapes``: eager
        at the first call of ``shapes``, then a :class:`KeyedGraph`."""
        return self._eager_then_graph(("key_draws",) + tuple(shapes), key.device, draw,
                                      lambda stream: KeyedGraph(draw, key, stream), key)

    def rollout(self, env, generator: torch.Generator):
        """``rollout(model, env, sample=True, generator, collect=("actions",))``:
        eager at the first call of its shapes, then a :class:`RolloutGraph`."""
        key = ("rollout", tuple(env.images.shape), env.images.dtype, tuple(env.bboxes.shape))
        return self._eager_then_graph(
            key, env.device,
            lambda e: rollout(self.model, e, sample=True, generator=generator,
                              collect=("actions",)),
            lambda stream: RolloutGraph(self.model, env, generator, stream), env)


@contextmanager
def active(graphs: Optional[TrainGraphs]):
    """Route the model's stacks of a train step through ``graphs`` inside."""
    token = gpt.TRAIN_GRAPHS.set(graphs)
    try:
        yield
    finally:
        gpt.TRAIN_GRAPHS.reset(token)
