"""Photometric augmentation of detection patches, on the device.

The counterpart of ``jolineedle_tpu/ops/augment.py``: planckian colour
jitter, random grayscale (p 0.2), gaussian blur (sigma 0.1-2, 3 taps), a
plasma-like multiplicative shadow (p 0.5), gaussian noise (std 0.05, p 0.5)
and a 3 px motion blur along a random compass axis (p 0.3), then a clip to
[0, 1]. The same op set, probabilities and parameter ranges. The random
numbers come from one of two sources:

- an explicit ``torch.Generator`` on the images' device, so they differ
  from the JAX keys' (a distribution match, as the JAX module's own is to
  kornia's). Inside ``parallel.mesh.data_parallel`` each is drawn for the
  global batch and cut to the rank's images (``mesh.draw``);
- a JAX key (``utils/jax_random.py``): the JAX function's own draws, bit
  for bit, from its own splits (a key per image, six per image, then each
  op's). One process only: it raises inside ``data_parallel``.

Every draw is a batched tensor op with fixed shapes: no host
synchronisation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.gpt import TRAIN_GRAPHS
from ..parallel import mesh
from ..parallel.mesh import draw
from ..utils import jax_random as jr

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


def _generator_draws(gen: torch.Generator, n: int, h: int, w: int, c: int, dev) -> dict:
    """The stack's random numbers for ``n`` images from ``gen``, in the
    order the stack takes them."""
    return {
        "pick": draw(lambda s: torch.randint(0, len(_PLANCKIAN_GAINS), s, generator=gen,
                                             device=dev), (n,)),
        "gray": _uniform(gen, n, dev),
        "sigma": _uniform(gen, n, dev, 0.1, 2.0),
        "coarse": _rand(gen, (n, 1, 4, 4), dev),
        "intensity": _uniform(gen, n, dev, -0.2, 0.0),
        "quantity": _uniform(gen, n, dev, 0.0, 0.4),
        "shadow": _uniform(gen, n, dev),
        "noise": draw(lambda s: torch.randn(s, generator=gen, device=dev), (n, c, h, w)),
        "noisy": _uniform(gen, n, dev),
        "direction": draw(lambda s: torch.randint(0, 4, s, generator=gen, device=dev), (n,)),
        "motion": _uniform(gen, n, dev),
    }


#: The keys the JAX stack derives from each image's six op keys
#: (``jolineedle_tpu/ops/augment.py:47-129``), as (op key, split count;
#: ``fold_in(k, i)`` is ``split(k)[i]``): the jitter's ``randint`` splits its
#: key in two, the shadow splits three ways and folds in 7, the noise and
#: the motion blur split in two. The first seven take one scalar draw each;
#: then the shadow's field, the noise and the blur direction's ``randint``.
_DERIVED = ((0, 0), (0, 1), (3, 1), (3, 2), (3, 7), (4, 1), (5, 1), (3, 0), (4, 0), (5, 0))
_DERIVED_ON = {}


def _derived_index(device) -> tuple:
    """``_DERIVED`` as index tensors on ``device``, made once."""
    if device not in _DERIVED_ON:
        _DERIVED_ON[device] = tuple(torch.tensor(col, device=device) for col in zip(*_DERIVED))
    return _DERIVED_ON[device]


def _key_draws(key: torch.Tensor, n: int, h: int, w: int, c: int) -> dict:
    """The stack's random numbers for ``n`` images from the JAX key ``key``
    (an int64 tensor [2] on the images' device), as the JAX stack draws
    them: ``split(key, n)``, then ``split(image_key, 6)``, then each op's
    own. The keys of each level are hashed together, for every image."""
    if mesh.active_size() > 1:
        raise ValueError("a JAX key draws for one process; data_parallel draws with a generator")
    ops = jr.split(jr.split(key, n), 6)  # [n, 6, 2]
    parents, counts = _derived_index(key.device)
    derived = jr.fold_in(ops[:, parents], counts)  # [n, 10, 2]
    motion_int = jr.split(derived[:, 9])  # randint splits its key in two
    # Every scalar draw hashes count 0 of its key: one pass over them all.
    bits = jr.random_bits(torch.cat([derived[:, :7], ops[:, 1:3], motion_int], 1))  # [n, 11]

    def uni(col, minval=0.0, maxval=1.0):
        return jr.uniform_from_bits(bits[:, col], minval, maxval)

    return {
        "pick": jr.randint_from_bits(bits[:, 0], bits[:, 1], 0, len(_PLANCKIAN_GAINS)),
        "gray": uni(7),
        "sigma": uni(8, 0.1, 2.0),
        "coarse": jr.uniform(derived[:, 7], (4, 4, 1)).reshape(n, 1, 4, 4),
        "intensity": uni(2, -0.2, 0.0),
        "quantity": uni(3, 0.0, 0.4),
        "shadow": uni(4),
        "noise": jr.normal(derived[:, 8], (h, w, c)).permute(0, 3, 1, 2),
        "noisy": uni(5),
        "direction": jr.randint_from_bits(bits[:, 9], bits[:, 10], 0, 4),
        "motion": uni(6),
    }


def detection_augment(generator, images: torch.Tensor) -> torch.Tensor:
    """The photometric stack on ``images [..., H, W, C]`` in [0, 1] (uint8
    is scaled by 1/255 first), each image with its own draws, from a
    ``torch.Generator`` or a JAX key (a host key or an int64 tensor [2]);
    returns float32 of the same shape."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    lead, (h, w, c) = images.shape[:-3], images.shape[-3:]
    img = images.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()  # [N, C, H, W]
    n, dev = img.shape[0], img.device
    graphs = TRAIN_GRAPHS.get()
    if isinstance(generator, torch.Generator):
        d = _generator_draws(generator, n, h, w, c, dev)
    elif graphs is None:
        d = _key_draws(jr.to_device(generator, dev), n, h, w, c)
    else:  # inside a train step on the card: the draws' graph
        d = graphs.key_draws(lambda key: _key_draws(key, n, h, w, c),
                             jr.to_device(generator, dev), ("augment", n, h, w, c))

    gains = torch.from_numpy(_PLANCKIAN_GAINS).to(dev)
    img = (img * gains[d["pick"]][:, :, None, None]).clamp(0.0, 1.0)

    gray = (0.299 * img[:, 0] + 0.587 * img[:, 1] + 0.114 * img[:, 2])[:, None].expand_as(img)
    img = _where(d["gray"] < 0.2, gray, img)

    x = torch.tensor([-1.0, 0.0, 1.0], device=dev)
    img = _separable_blur_3(img, torch.exp(-(x[None] ** 2) / (2 * d["sigma"][:, None] ** 2)))

    field = F.interpolate(d["coarse"], size=(h, w), mode="bilinear", align_corners=False)
    shadow = 1.0 + d["intensity"][:, None, None, None] * (
        field < d["quantity"][:, None, None, None]).float()
    img = _where(d["shadow"] < 0.5, (img * shadow).clamp(0.0, 1.0), img)

    img = _where(d["noisy"] < 0.5, img + 0.05 * d["noise"], img)

    pad = F.pad(img, (1, 1, 1, 1), mode="replicate")

    def shifted(dy, dx):
        return pad[:, :, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    candidates = torch.stack([
        (shifted(0, -1) + img + shifted(0, 1)) / 3,  # horizontal
        (shifted(-1, 0) + img + shifted(1, 0)) / 3,  # vertical
        (shifted(-1, -1) + img + shifted(1, 1)) / 3,  # diagonal
        (shifted(-1, 1) + img + shifted(1, -1)) / 3,  # anti-diagonal
    ], dim=1)  # [N, 4, C, H, W]
    blurred = candidates[torch.arange(n, device=dev), d["direction"]]
    img = _where(d["motion"] < 0.3, blurred, img)

    out = img.clamp(0.0, 1.0).permute(0, 2, 3, 1)
    return out.reshape(*lead, h, w, c)
