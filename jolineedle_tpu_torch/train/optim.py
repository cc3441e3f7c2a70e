"""The two-partition optimizer: AdamW for the decision model and for the
detector, with gradient accumulation, value clipping and an optional
schedule.

The counterpart of ``jolineedle_tpu/train/optim.py`` (an optax
``multi_transform`` over parameter labels inside ``optax.MultiSteps``):

- labels ``gpt`` | ``yolox`` | ``frozen`` by parameter name
  (``optim.py:32-53``): the detector (``yolox.``) is frozen when detection
  is off, its backbone (``yolox.backbone.``) when
  ``--freeze-image-processor``; everything else, the ``gpt_backbone_net``
  embedder included, is ``gpt``;
- AdamW, betas (0.9, 0.999), eps 1e-8, weight decay on every trained
  parameter (optax's ``adamw`` decays all of them), the ``gpt`` group at
  ``--lr`` and the ``yolox`` group at ``--yolo-lr``;
- as ``MultiSteps`` does, the gradients of ``k`` micro-batches are averaged
  and only then clipped element-wise (at 1.0 in REINFORCE) and handed to
  AdamW; the update count, and the schedule that reads it, advance only on
  real updates.

``torch.optim.AdamW`` decays a parameter by ``lr * wd`` before its Adam
step, which is optax's ``-lr * (adam + wd * p)`` written in another order.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def param_labels(model, freeze_image_processor: bool, detection_enabled: bool) -> Dict[str, str]:
    """{parameter name: "gpt" | "yolox" | "frozen"} (``optim.py:32-53``)."""
    labels = {}
    for name, _ in model.named_parameters():
        if name.startswith("yolox."):
            if not detection_enabled:
                labels[name] = "frozen"
            elif freeze_image_processor and name.startswith("yolox.backbone."):
                labels[name] = "frozen"
            else:
                labels[name] = "yolox"
        else:
            labels[name] = "gpt"
    return labels


def lr_at(lr: float, update: int, schedule: str, warmup: int, decay: int) -> float:
    """optax ``warmup_cosine_decay_schedule`` to 5 % of ``lr`` (``optim.py:
    74-83``), or ``lr`` for the constant schedule; ``update`` counts
    optimizer updates.

    In float32, by optax's formulas as XLA compiles them: each multiply-add
    fused (one rounding; here exact in float64, then rounded once) and a
    division by a constant taken as a product with its reciprocal. Its warmup
    computes ``(0 - lr) * (1 - t / warmup) + lr``, which cancels early in
    the warmup, so the lr the JAX package applies there strays from ``lr *
    t / warmup`` by up to 1e-5 relative; the port applies the same one."""
    if schedule != "cosine":
        return lr
    f32 = np.float32

    def fma(a, b, c):
        return f32(np.float64(f32(a)) * np.float64(f32(b)) + np.float64(f32(c)))

    warmup = max(0, warmup)
    span = max(decay, warmup + 1) - warmup
    if update < warmup:
        return float(fma(-lr, fma(-f32(max(update, 0)), f32(1) / f32(warmup), 1), lr))
    angle = f32(min(update - warmup, span)) * (f32(np.pi) * (f32(1) / f32(span)))
    cosine = f32(0.5) * (f32(1) + f32(np.cos(np.float64(angle))))
    alpha = 0.05 * lr / lr
    return float(f32(lr) * fma(1 - alpha, cosine, alpha))


class Optimizer:
    """Accumulate ``gradient_accumulation`` backward passes, then average,
    clip and apply AdamW to the ``gpt`` and ``yolox`` groups.

    Call :meth:`step` once after every ``loss.backward()``; it returns True
    when it applied an update. Frozen parameters keep their values and their
    gradients are dropped.

    A step that replays CUDA graphs (``train/graphs.py``) first calls
    :meth:`hold_grads`: from then on every trained parameter keeps an
    allocated gradient, which each backward adds into and each update sets
    to zero. A graph's backward hands over its gradients in static buffers
    that its next replay overwrites; autograd adopts such a buffer as
    ``.grad`` when the parameter has none, and adds it into ``.grad``
    otherwise. So the window's sum is the eager one, bit for bit (``0 + g``
    is ``g``).

    Over several ranks, a train step sums each iteration's fresh gradients
    over the ranks before they join the ones accumulated here
    (``parallel.mesh.data_parallel``): the accumulated gradient, its
    checkpoint and the clip at the update are the global batch's, on every
    rank.
    """

    def __init__(
        self,
        model,
        learning_rate: float,
        yolo_lr: float,
        gradient_accumulation: int = 1,
        freeze_image_processor: bool = False,
        detection_enabled: bool = True,
        clip_value: Optional[float] = None,
        weight_decay: float = 0.01,
        lr_schedule: str = "constant",
        lr_warmup_iters: int = 0,
        lr_decay_iters: int = 1,
    ):
        self.labels = param_labels(model, freeze_image_processor, detection_enabled)
        self.params = params = dict(model.named_parameters())
        groups = []
        #: The names of ``trained_params()``, in its order.
        self.trained_names = []
        for label, lr in (("gpt", learning_rate), ("yolox", yolo_lr)):
            names = [n for n, lab in self.labels.items() if lab == label]
            if names:
                groups.append({"params": [params[n] for n in names], "lr": lr,
                               "base_lr": lr, "label": label})
                self.trained_names += names
        self.frozen = [params[n] for n, lab in self.labels.items() if lab == "frozen"]
        self.adamw = torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.every_k = max(1, int(gradient_accumulation))
        self.clip_value = clip_value
        self.schedule = (lr_schedule, lr_warmup_iters, lr_decay_iters)
        self.mini_step = 0  # backward passes accumulated since the last update
        self.updates = 0  # updates applied (optax's inner count)
        #: Set by :meth:`hold_grads`: updates zero the gradients in place.
        self.grads_held = False

    def trained_params(self):
        """The parameters of the trained groups, in the groups' order."""
        for group in self.adamw.param_groups:
            yield from group["params"]

    @torch.no_grad()
    def step(self) -> bool:
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return False
        for p in self.trained_params():
            if p.grad is None:  # optax still decays a parameter with no gradient
                p.grad = torch.zeros_like(p)
            if self.every_k > 1:
                p.grad.div_(self.every_k)
            if self.clip_value is not None:
                p.grad.clamp_(-self.clip_value, self.clip_value)
        for group in self.adamw.param_groups:
            group["lr"] = lr_at(group["base_lr"], self.updates, *self.schedule)
        self.adamw.step()
        self.zero_grad()
        self.mini_step = 0
        self.updates += 1
        return True

    def hold_grads(self) -> None:
        """Give every trained parameter a zero gradient where it has none,
        and keep the gradients allocated across updates from now on."""
        self.grads_held = True
        for p in self.trained_params():
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=not self.grads_held)
        for p in self.frozen:
            p.grad = None

    def state_dict(self) -> dict:
        """AdamW's moments and counts, the window position and the grads
        accumulated so far in it (optax's ``MultiSteps`` state)."""
        return {
            "adamw": self.adamw.state_dict(),
            "mini_step": self.mini_step,
            "updates": self.updates,
            "acc_grads": [None if p.grad is None else p.grad.detach().cpu()
                          for p in self.trained_params()],
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a ``state_dict()``: the port's own, or the JAX trainer's
        optax state converted by ``checkpoint.flax_optimizer_state``."""
        self.adamw.load_state_dict(state["adamw"])
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])
        for p, g in zip(self.trained_params(), state["acc_grads"]):
            p.grad = None if g is None else g.to(p.device, p.dtype)
