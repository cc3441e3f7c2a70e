"""A fresh model's weights, drawn as the JAX package's flax modules draw them.

The initialisers of ``jolineedle_tpu/models/gpt.py`` and ``models/yolox.py``,
as distributions (the random streams differ, so the values cannot match):

- the embeddings (``wte``, ``wpe``, ``embed_class``) and the Dense layers
  given ``DENSE_INIT`` (``c_attn``, ``c_fc``, ``embed_fpn_dense``,
  ``project_concat``, the action head): normal(0, 0.02) (``gpt.py:36-37``);
- both ``c_proj`` of each block: normal(0, 0.02 / sqrt(2 n_layer))
  (``gpt.py:92-93``, ``:119-121``);
- every conv kernel (the YOLOX convs, its head predictions and
  ``embed_fpn_conv``, which keep flax's default): lecun_normal, a normal
  truncated at two standard deviations and scaled to variance 1 / fan_in,
  with fan_in = in_channels / groups * kh * kw as flax counts it on its
  ``[kh, kw, in / groups, out]`` kernel (a depthwise 3x3 has 9);
- every bias 0; LayerNorm and BatchNorm scale 1 and bias 0; BatchNorm's
  running mean 0 and variance 1 (``yolox.py:59-64``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

DENSE_STD = 0.02
# The standard deviation of a unit normal truncated to (-2, 2): flax divides
# by it so that the truncated draw has the variance asked for.
TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_like_flax(model: nn.Module, n_layer: int) -> None:
    """Draw every parameter and buffer of the port's ``GPT`` ``model`` (a
    decoder of ``n_layer`` blocks) as the JAX package initialises it, from
    torch's default generator (``torch.manual_seed`` decides the values)."""
    proj_std = DENSE_STD / math.sqrt(2 * n_layer)
    for name, m in model.named_modules():
        if isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, DENSE_STD)
        elif isinstance(m, nn.Linear):
            std = proj_std if name.endswith("c_proj") else DENSE_STD
            nn.init.normal_(m.weight, 0.0, std)
        elif isinstance(m, nn.Conv2d):
            # lecun_normal; fan_in is one output's slice of [out, in / groups, kh, kw]
            std = math.sqrt(1.0 / m.weight[0].numel()) / TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            m.reset_parameters()  # scale 1, bias 0 (BatchNorm: running 0 / 1)
        if isinstance(m, (nn.Linear, nn.Conv2d)) and m.bias is not None:
            nn.init.zeros_(m.bias)
