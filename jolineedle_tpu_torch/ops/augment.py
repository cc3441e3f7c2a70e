"""Photometric augmentation of detection patches, on the device.

The counterpart of ``jolineedle_tpu/ops/augment.py``: planckian colour
jitter, random grayscale (p 0.2), gaussian blur (sigma 0.1-2, 3 taps), a
plasma-like multiplicative shadow (p 0.5), gaussian noise (std 0.05, p 0.5)
and a 3 px motion blur along a random compass axis (p 0.3), then a clip to
[0, 1]. The same op set, probabilities and parameter ranges; the random
numbers come from an explicit ``torch.Generator`` on the images' device, so
they differ from the JAX keys' (a distribution match, as the JAX module's own
is to kornia's). Every draw is a batched tensor op with fixed shapes: no
host synchronisation. Inside ``parallel.mesh.data_parallel`` each is drawn
for the global batch and cut to the rank's images (``mesh.draw``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import draw

_PLANCKIAN_GAINS = np.array(
    [[1.0 + 0.4 * (1 - t), 1.0, 1.0 + 0.6 * (t - 0.5)] for t in np.linspace(0.0, 1.0, 24)],
    np.float32,
)


def _uniform(gen, n, device, low=0.0, high=1.0):
    return low + (high - low) * _rand(gen, (n,), device)


def _rand(gen, shape, device):
    return draw(lambda s: torch.rand(s, generator=gen, device=device), shape)


def _where(flag, a, b):
    """Per-image choice between two [N, C, H, W] tensors."""
    return torch.where(flag[:, None, None, None], a, b)


def _separable_blur_3(img, kernel):
    """3-tap separable blur of [N, C, H, W] with per-image ``kernel [N, 3]``
    and replicated edges."""
    k = kernel / kernel.sum(-1, keepdim=True)
    k0, k1, k2 = (k[:, i, None, None, None] for i in range(3))
    pad = F.pad(img, (0, 0, 1, 1), mode="replicate")
    img = k0 * pad[:, :, :-2] + k1 * pad[:, :, 1:-1] + k2 * pad[:, :, 2:]
    pad = F.pad(img, (1, 1, 0, 0), mode="replicate")
    return k0 * pad[..., :-2] + k1 * pad[..., 1:-1] + k2 * pad[..., 2:]


def detection_augment(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """The photometric stack on ``images [..., H, W, C]`` in [0, 1] (uint8
    is scaled by 1/255 first), each image with its own draws; returns float32
    of the same shape."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    lead, (h, w, c) = images.shape[:-3], images.shape[-3:]
    img = images.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()  # [N, C, H, W]
    n, dev, gen = img.shape[0], img.device, generator

    gains = torch.from_numpy(_PLANCKIAN_GAINS).to(dev)
    pick = draw(lambda s: torch.randint(0, len(_PLANCKIAN_GAINS), s, generator=gen, device=dev),
                (n,))
    img = (img * gains[pick][:, :, None, None]).clamp(0.0, 1.0)

    gray = (0.299 * img[:, 0] + 0.587 * img[:, 1] + 0.114 * img[:, 2])[:, None].expand_as(img)
    img = _where(_uniform(gen, n, dev) < 0.2, gray, img)

    sigma = _uniform(gen, n, dev, 0.1, 2.0)
    x = torch.tensor([-1.0, 0.0, 1.0], device=dev)
    img = _separable_blur_3(img, torch.exp(-(x[None] ** 2) / (2 * sigma[:, None] ** 2)))

    coarse = _rand(gen, (n, 1, 4, 4), dev)
    field = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    intensity = _uniform(gen, n, dev, -0.2, 0.0)[:, None, None, None]
    quantity = _uniform(gen, n, dev, 0.0, 0.4)[:, None, None, None]
    shadow = 1.0 + intensity * (field < quantity).float()
    img = _where(_uniform(gen, n, dev) < 0.5, (img * shadow).clamp(0.0, 1.0), img)

    noise = draw(lambda s: torch.randn(s, generator=gen, device=dev), img.shape)
    img = _where(_uniform(gen, n, dev) < 0.5, img + 0.05 * noise, img)

    pad = F.pad(img, (1, 1, 1, 1), mode="replicate")

    def shifted(dy, dx):
        return pad[:, :, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    candidates = torch.stack([
        (shifted(0, -1) + img + shifted(0, 1)) / 3,  # horizontal
        (shifted(-1, 0) + img + shifted(1, 0)) / 3,  # vertical
        (shifted(-1, -1) + img + shifted(1, 1)) / 3,  # diagonal
        (shifted(-1, 1) + img + shifted(1, -1)) / 3,  # anti-diagonal
    ], dim=1)  # [N, 4, C, H, W]
    direction = draw(lambda s: torch.randint(0, 4, s, generator=gen, device=dev), (n,))
    blurred = candidates[torch.arange(n, device=dev), direction]
    img = _where(_uniform(gen, n, dev) < 0.3, blurred, img)

    out = img.clamp(0.0, 1.0).permute(0, 2, 3, 1)
    return out.reshape(*lead, h, w, c)
