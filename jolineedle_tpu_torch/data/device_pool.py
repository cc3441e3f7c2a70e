"""Device-resident image pool: the whole training set on the device as uint8.

The counterpart of ``jolineedle_tpu/data/device_pool.py``. Under
``--device-data-cache auto`` (the default) or ``on``, a trainer decodes every
training image once, pads it to a common size and keeps the lot on its
device; each train batch then carries only sample indices, patch coordinates
and labels (``NeedleDataset.get_geometry``, ``build_supervised_batch(...,
with_pixels=False)``), and the train step gathers the pixels on the device.
``auto`` checks the budget first, from the image headers only, and streams
the pixels of each batch instead when the padded pool would exceed it
(``JOLINEEDLE_POOL_BUDGET_MB``, default 6144); ``off`` always streams.

The pool stores UN-augmented, transformed and padded pixels. The geometric
augmentations (``--augment-rotate``, ``--augment-translate``) are sampled on
the host, which remaps the boxes and labels, and replayed on the device by
:func:`aug_canvases`: the same integer pixel moves (a quarter-turn rotation
re-originated to the canvas corner, a zero-filled shift) on a fixed-shape
canvas. The three gathers are plain PyTorch indexing, one gather per call:
they are ``lax.dynamic_slice``/``jnp.roll`` code in the JAX package, not
Pallas kernels.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

#: Host staging slab of the pool's upload: the images are padded into it and
#: copied from it to the device, so that the page-locked (pinned) host memory
#: that the copy engine reads from stays this small however large the pool.
_SLAB_BYTES = 64 * 1024 * 1024


def pool_budget_bytes() -> int:
    return int(os.environ.get("JOLINEEDLE_POOL_BUDGET_MB", "6144")) * (1 << 20)


def padded_size(
    raw_h: int, raw_w: int, minimum_image_size: int, patch_size: int
) -> Tuple[int, int]:
    """Post-transform image dims without decoding pixels: the min-size
    upscale (``data/dataset.py::transform``) followed by pad-to-patch-multiple."""
    h, w = raw_h, raw_w
    if minimum_image_size and (w < minimum_image_size or h < minimum_image_size):
        ratio = w / h
        if w < minimum_image_size:
            w = minimum_image_size
            h = int(w / ratio)
        if h < minimum_image_size:
            h = minimum_image_size
            w = int(h * ratio)
    h = math.ceil(h / patch_size) * patch_size
    w = math.ceil(w / patch_size) * patch_size
    return h, w


def _pool_dims(dataset) -> Tuple[np.ndarray, int, int]:
    """Each image's post-transform (H, W), and their maxima, from the image
    headers."""
    shapes = np.zeros((len(dataset), 2), np.int32)
    for i in range(len(dataset)):
        w, h = dataset.raw_size(i)
        shapes[i] = padded_size(h, w, dataset.minimum_image_size, dataset.patch_size)
    return shapes, int(shapes[:, 0].max()), int(shapes[:, 1].max())


class DeviceImagePool:
    """All training images on one device: ``images`` ``[N, Hmax, Wmax, C]``
    uint8, zero beyond each image, and ``shapes`` ``[N, 2]`` (H, W after
    transform and pad) on the host."""

    def __init__(self, images: torch.Tensor, shapes: np.ndarray):
        self.images = images
        self.shapes = shapes

    @property
    def nbytes(self) -> int:
        return self.images.numel() * self.images.element_size()

    @staticmethod
    def eligible(dataset, mode: str) -> bool:
        """``--device-data-cache`` gate: ``on`` forces the pool, ``off``
        streams, ``auto`` checks the budget from the image headers only.
        Geometric augmentations do not disqualify: :func:`aug_canvases`
        replays them on the device."""
        if mode == "off":
            return False
        if mode == "on":
            return True
        _, hmax, wmax = _pool_dims(dataset)
        total = len(dataset) * hmax * wmax * 3
        if total > pool_budget_bytes():
            print(
                f"device pool: {total / 1e9:.2f} GB exceeds budget"
                f" ({pool_budget_bytes() / 1e9:.2f} GB), streaming instead"
            )
            return False
        return True

    @classmethod
    def build(cls, dataset, device) -> "DeviceImagePool":
        """Decode and transform every image once (augmentations off) into a
        pool allocated on ``device`` once, filled slab by slab
        (``_SLAB_BYTES``), through pinned memory when ``device`` is a card."""
        device = torch.device(device)
        dataset = copy.copy(dataset)
        dataset.rotations = dataset.translations = False
        rng = np.random.default_rng(0)  # the pixels draw nothing from it
        shapes, hmax, wmax = _pool_dims(dataset)
        n, c = len(dataset), 3
        images = torch.empty((n, hmax, wmax, c), dtype=torch.uint8, device=device)
        per_slab = min(n, max(1, _SLAB_BYTES // (hmax * wmax * c)))
        slab = torch.empty((per_slab, hmax, wmax, c), dtype=torch.uint8,
                           pin_memory=device.type == "cuda")
        host = slab.numpy()
        for start in range(0, n, per_slab):
            count = min(per_slab, n - start)
            for j in range(count):
                img = dataset.__getitem__(start + j, rng)["image"]
                if img.dtype != np.uint8 or tuple(img.shape[:2]) != tuple(shapes[start + j]):
                    raise ValueError(
                        f"image {start + j}: {img.dtype} {img.shape}; the pool holds uint8"
                        f" images of the header's padded size {tuple(shapes[start + j])}")
                h, w = img.shape[:2]
                host[j] = 0
                host[j, :h, :w] = img
            images[start : start + count].copy_(slab[:count])
        pool = cls(images, shapes)
        print(
            f"device pool: {n} images -> [{n}, {hmax}, {wmax}, {c}] uint8,"
            f" {pool.nbytes / 1e9:.2f} GB on {device}"
        )
        return pool


_WORD_DTYPES = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def _word_view(rows: torch.Tensor, *spans: int) -> torch.Tensor:
    """uint8 ``rows`` viewed as the widest words (8, 4, 2 or 1 bytes) that
    divide every byte count in ``spans``: a gather of them then moves a
    word per element instead of a byte."""
    size = next(s for s in (8, 4, 2, 1) if all(n % s == 0 for n in spans))
    return rows.view(_WORD_DTYPES[size])


def gather_pool_patches(
    pool_images: torch.Tensor,
    image_idx: torch.Tensor,
    positions: torch.Tensor,
    patch_size: int,
) -> torch.Tensor:
    """``[B, K, P, P, C]`` uint8 patches of pool images ``image_idx [B]`` at
    the (y, x) patch-grid ``positions [B, K, 2]`` (the host gather's
    contract, ``env/oracle.py::gather_patches``), in one gather of whole
    words. Each patch's start is placed as ``lax.dynamic_slice`` places it:
    a negative start counts from the end, then the start is clamped into
    the image."""
    n, h, w, c = pool_images.shape
    p = patch_size
    words = _word_view(pool_images.reshape(n, h, w * c), p * c, w * c)
    size = words.element_size()
    dev = pool_images.device

    def start(pos, extent):
        pos = pos.long() * p
        return torch.where(pos < 0, pos + extent, pos).clamp(0, max(extent - p, 0))

    y0, x0 = start(positions[..., 0], h), start(positions[..., 1], w)
    rows = y0[..., None] + torch.arange(p, device=dev)  # [B, K, P]
    cols = (x0 * c // size)[..., None] + torch.arange(p * c // size, device=dev)
    out = words[image_idx.long()[:, None, None, None], rows[..., :, None], cols[..., None, :]]
    return out.view(torch.uint8).reshape(positions.shape[:2] + (p, p, c))


def gather_canvas_patches(
    canvases: torch.Tensor, positions: torch.Tensor, patch_size: int
) -> torch.Tensor:
    """``[B, K, P, P, C]`` uint8 patches of each sample's own canvas
    (:func:`aug_canvases`): :func:`gather_pool_patches` with sample ``b``
    reading canvas ``b``."""
    idx = torch.arange(canvases.shape[0], device=canvases.device)
    return gather_pool_patches(canvases, idx, positions, patch_size)


def gather_pool_images(pool_images: torch.Tensor, image_idx: torch.Tensor) -> torch.Tensor:
    """The whole pool images ``image_idx [B]``: ``[B, Hpool, Wpool, C]``
    uint8, copied a word at a time (``jnp.take`` along axis 0)."""
    n, h, w, c = pool_images.shape
    words = _word_view(pool_images.reshape(n, h * w * c), h * w * c)
    return words.index_select(0, image_idx.long()).view(torch.uint8).reshape(-1, h, w, c)


def aug_canvases(
    pool_images: torch.Tensor,
    image_idx: torch.Tensor,
    rot_k: Optional[torch.Tensor],
    shift: Optional[torch.Tensor],
    base_hw: Optional[torch.Tensor],
    out_hw: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """A batch of pool images with the host's geometric augmentations
    replayed: ``[B, Sh, Sw, C]`` uint8 canvases, equal to what the JAX
    function computes.

    The JAX function pads each image to the canvas, then per sample:
    rotates by k quarter-turns (``rot90`` of the square canvas, then a roll
    that moves the rotated image back to the origin), shifts by (ty, tx)
    (``roll``, then a mask zeroing the wrapped strip), and zeroes everything
    beyond the POST-aug image extent (h2, w2). Here each output pixel's
    source is computed backwards through those moves and the pixels are
    gathered once. Every move maps rows to rows and columns to columns,
    except that an odd quarter-turn swaps them: the gather runs in the
    source's orientation and the odd samples are transposed after it.

    Args:
        rot_k: [B] quarter-turns, or None when rotations are off (the canvas
            then keeps the pool's rectangular shape).
        shift: [B, 2] (ty, tx) pixel shifts, or None when translations are
            off.
        base_hw: [B, 2] PRE-aug padded dims; required whenever ``rot_k`` or
            ``shift`` is given.
        out_hw: the output canvas dims; by default the square
            max(Hpool, Wpool) when rotating, else (Hpool, Wpool).
    """
    _, hp, wp, _ = pool_images.shape
    if out_hw is None:
        s = max(hp, wp)
        out_hw = (s, s) if rot_k is not None else (hp, wp)
    sh, sw = out_hw
    if sh < hp or sw < wp:
        raise ValueError(f"canvas {out_hw} smaller than the pool's images {(hp, wp)}")
    if rot_k is not None and sh != sw:
        raise ValueError(f"rotation needs a square canvas, not {out_hw}")
    augs = rot_k is not None or shift is not None
    if augs and base_hw is None:
        raise ValueError("the augmentations need base_hw for the crop mask")
    dev = pool_images.device
    idx = image_idx.long()
    zeros = torch.zeros_like(idx)
    ty, tx = shift.long().unbind(1) if shift is not None else (zeros, zeros)
    rows = torch.arange(sh, device=dev)[None, :]  # output coordinates
    cols = torch.arange(sw, device=dev)[None, :]
    ty, tx = ty[:, None], tx[:, None]

    # The shift's mask and the crop to the post-aug extent, per output row
    # and column.
    row_ok = (rows >= ty) & (rows < sh + ty)
    col_ok = (cols >= tx) & (cols < sw + tx)
    if augs:
        h, w = base_hw.long().unbind(1)
        k = rot_k.long() if rot_k is not None else zeros
        odd = k % 2 == 1
        row_ok = row_ok & (rows < torch.where(odd, w, h)[:, None])
        col_ok = col_ok & (cols < torch.where(odd, h, w)[:, None])
    # Undo the shift's roll: the rotated canvas's row i and column j.
    i = (rows - ty) % sh
    j = (cols - tx) % sw
    if rot_k is None:
        y, x, y_ok, x_ok = i, j, row_ok, col_ok
    else:
        # Undo the rotation and its re-origin roll (s = sh = sw):
        #   k = 1: y = s-1 - (j - h) mod s, x = i
        #   k = 2: y = s-1 - (i - h) mod s, x = s-1 - (j - w) mod s
        #   k = 3: y = j,                   x = s-1 - (i - w) mod s
        # For odd k, y runs along the output's columns and x along its
        # rows: the gather's axis 1 is then the output's axis 2.
        s = sh
        odd_ = odd[:, None]
        y = torch.where(odd_, j, i)
        x = torch.where(odd_, i, j)
        flip_y = ((k == 1) | (k == 2))[:, None]
        flip_x = ((k == 2) | (k == 3))[:, None]
        y = torch.where(flip_y, s - 1 - (y - h[:, None]) % s, y)
        x = torch.where(flip_x, s - 1 - (x - w[:, None]) % s, x)
        y_ok = torch.where(odd_, col_ok, row_ok)
        x_ok = torch.where(odd_, row_ok, col_ok)
    # The pad of each pool image to the canvas is zeros.
    y_ok = y_ok & (y < hp)
    x_ok = x_ok & (x < wp)
    out = pool_images[idx[:, None, None], y.clamp(max=hp - 1)[:, :, None],
                      x.clamp(max=wp - 1)[:, None, :]]
    out.masked_fill_(~y_ok[:, :, None, None], 0)
    out.masked_fill_(~x_ok[:, None, :, None], 0)
    if rot_k is not None:
        # Into a contiguous canvas: the patch gathers read it as words.
        out = torch.where(odd[:, None, None, None], out.transpose(1, 2), out,
                          out=torch.empty_like(out))
    return out
