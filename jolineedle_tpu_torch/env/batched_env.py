"""Batched glimpse environment over a batch of same-shape images, in PyTorch.

The counterpart of ``jolineedle_tpu/env/batched_env.py``: ``reset``,
``step``, ``masked_step``, ``terminated``, the rewards (with
``stop_bonus_scale``), the patch gather, the found-proportion metrics and
the detection training batch (``get_detection_batch``).
Every method is a few tensor ops on the images' device with fixed shapes and
no host synchronisation, so a rollout loop over it never waits on the card.

The bbox -> patch masks and the boxes cut to each patch are built once on
the host with the numpy ``parsing.split_boxes_to_patches`` and moved to the
device.

The glimpse pyramid (``n_glimps_levels`` L > 1, :func:`build_glimpse_pyramid`)
takes float images only, as the JAX env asserts, and ``get_patches`` then
returns the L levels' patches ``[B, L, P, P, C]``. No trainer of either
package builds one (the RL and serving paths use one level,
``reinforce.py:104``); the detection batch and ``gather_patches_at`` read
level 0.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import draw
from .actions import ACTION_DELTAS_ARRAY, Action
from .parsing import split_boxes_to_patches


class EnvState(NamedTuple):
    """Per-episode state; methods return new tensors, never edit these."""

    positions: torch.Tensor  # [B, 2] int64 (y, x) patch coords
    visited: torch.Tensor  # [B, nv, nh] bool
    steps: torch.Tensor  # [B] int64
    has_stopped: torch.Tensor  # [B] bool


def pyramid_taps(size: int, pad: int):
    """Along one axis of ``size`` pixels, a pyramid level's taps: output
    pixel o is ``sum_k weights[k, o] * input[index[k, o]]`` for the reflect
    padding by ``pad`` followed by ``jax.image.resize(method="linear")``
    from ``size + 2 pad`` back to ``size``. That resize weights the inputs
    by a triangle around each output's centre, widened by the scale when it
    shrinks (antialiasing), normalised to sum 1, all in float32
    (``compute_weight_mat`` of ``jax._src.image.scale``), as here; the
    reflection maps each padded index into the axis
    (``jnp.pad(mode="reflect")``, edge not repeated). Both ``[K, size]``,
    ``index`` int64 and ``weights`` float32."""
    f32 = np.float32
    n_in = size + 2 * pad
    inv_scale = f32(1) / (f32(size) / f32(n_in))
    width = max(inv_scale, f32(1))
    centre = (np.arange(size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    k = int(np.ceil(2 * float(width))) + 1
    index = np.floor(centre - width).astype(np.int64)[None, :] + 1 + np.arange(k)[:, None]
    weights = np.maximum(f32(0), f32(1) - np.abs(centre[None, :] - index.astype(f32)) / width)
    weights[(index < 0) | (index >= n_in)] = 0
    weights = weights / weights.sum(axis=0, keepdims=True, dtype=f32)
    period = 2 * (size - 1)
    index = np.abs(np.clip(index, 0, n_in - 1) - pad) % max(period, 1)
    index = np.where(index > size - 1, period - index, index)
    return torch.from_numpy(index), torch.from_numpy(weights.astype(f32))


def build_glimpse_pyramid(images: torch.Tensor, patch_size: int, n_levels: int) -> torch.Tensor:
    """``[B, H, W, C]`` float images -> the ``[B, L, H, W, C]`` zoom-out
    pyramid (``batched_env.py:40-58``): level 0 is the image; each next
    level reflect-pads the last by ``patch_size`` on every side and resizes
    it back to H x W, one axis after the other through
    :func:`pyramid_taps` (gathers and float32 multiply-adds in a fixed
    order, so the card and the CPU agree)."""
    h, w = images.shape[1:3]
    taps = [[t.to(images.device) for t in pyramid_taps(n, int(patch_size))] for n in (h, w)]
    levels = [images]
    for _ in range(n_levels - 1):
        current = levels[-1]
        for dim, (index, weights) in zip((1, 2), taps):
            shape = [1, 1, 1, 1]
            shape[dim] = -1
            out = None
            for k in range(index.shape[0]):
                term = current.index_select(dim, index[k]) * weights[k].view(shape)
                out = term if out is None else out + term
            current = out
        levels.append(current)
    return torch.stack(levels, dim=1)


class NeedleEnv:
    """Batched needle environment.

    Args:
        images: ``[B, H, W, C]`` uint8 (0-255) or float (0-1) images, numpy or
            tensor; H and W are multiples of ``patch_size``. uint8 stays
            uint8 on the device and patches are scaled by 1/255 at gather;
            it requires ``n_glimps_levels`` = 1 (the pyramid resizes floats).
        bboxes: ``[B, N, 4]`` padded pixel xyxy boxes (inclusive
            bottom-right); ``box_valid`` ``[B, N]``, or None for "positive
            extent".
        device: where the env's tensors live (default: the GPU).
    """

    def __init__(
        self,
        images,
        bboxes,
        patch_size: int,
        max_ep_len: int,
        n_glimps_levels: int = 1,
        stop_enabled: bool = False,
        box_valid=None,
        terminate_on_all_found: bool = True,
        stop_bonus_scale: float = 1.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.patch_size = int(patch_size)
        self.max_ep_len = int(max_ep_len)
        self.n_glimps_levels = int(n_glimps_levels)
        self.stop_enabled = bool(stop_enabled)
        self.terminate_on_all_found = bool(terminate_on_all_found)
        self.stop_bonus_scale = float(stop_bonus_scale)

        images = torch.as_tensor(images)
        if images.ndim != 4:
            raise ValueError(f"expected [B, H, W, C] images, got {tuple(images.shape)}")
        self.batch_size, self.height, self.width, self.n_channels = images.shape
        if self.height % self.patch_size or self.width % self.patch_size:
            raise ValueError(
                f"image {self.height}x{self.width} is not a multiple of patch {self.patch_size}"
            )
        if images.dtype == torch.uint8 and self.n_glimps_levels != 1:
            raise ValueError("uint8 image storage requires n_glimps_levels == 1")
        self.images = images.to(self.device)
        #: ``[B, L, H, W, C]`` with level 0 = ``images``; None at one level.
        self.pyramid = (build_glimpse_pyramid(self.images, self.patch_size, self.n_glimps_levels)
                        if self.n_glimps_levels > 1 else None)
        self.n_vertical_patches = self.height // self.patch_size
        self.n_horizontal_patches = self.width // self.patch_size

        bboxes = np.asarray(
            bboxes.cpu() if isinstance(bboxes, torch.Tensor) else bboxes, np.float32
        )
        if box_valid is None:
            box_valid = (bboxes[..., 2] > bboxes[..., 0]) & (bboxes[..., 3] > bboxes[..., 1])
        box_valid = np.asarray(box_valid, bool)
        split = [
            split_boxes_to_patches(b, v, self.n_vertical_patches, self.n_horizontal_patches,
                                   self.patch_size)
            for b, v in zip(bboxes, box_valid)
        ]
        self.bboxes = torch.from_numpy(bboxes).to(self.device)
        self.box_valid = torch.from_numpy(box_valid).to(self.device)
        # [B, nv, nh, N, 4] local xyxy and [B, nv, nh, N] validity
        self.local_bboxes = torch.from_numpy(
            np.stack([local for local, _ in split]).astype(np.float32)).to(self.device)
        self.local_valid = torch.from_numpy(np.stack([m for _, m in split])).to(self.device)
        self.bbox_masks = self.local_valid.any(dim=-1)
        self._deltas = torch.from_numpy(ACTION_DELTAS_ARRAY).long().to(self.device)
        self._rows = torch.arange(self.batch_size, device=self.device)

    #: The tensors that hold a batch; everything else follows from the shapes.
    DATA = ("images", "bboxes", "box_valid", "local_bboxes", "local_valid", "bbox_masks")

    def static_copy(self) -> "NeedleEnv":
        """This env with its own copy of the batch's tensors, for a CUDA
        graph captured on it (``train/graphs.py::RolloutGraph``)."""
        if self.pyramid is not None:
            raise ValueError("a graphed rollout takes one glimpse level")
        out = copy.copy(self)
        for name in self.DATA:
            setattr(out, name, getattr(self, name).clone())
        return out

    def copy_data_(self, other: "NeedleEnv") -> None:
        """Copy ``other``'s batch into this env's tensors, in place: an env
        of the same shapes and settings (the device's copies only)."""
        for name in self.DATA:
            getattr(self, name).copy_(getattr(other, name))

    # --- env API ----------------------------------------------------------
    def reset(
        self, positions=None, generator: Optional[torch.Generator] = None
    ) -> Tuple[EnvState, torch.Tensor, dict]:
        """Fresh state at the given ``[B, 2]`` positions, or uniform random
        ones drawn with ``generator`` (on the generator's device)."""
        if positions is None:
            if generator is None:
                raise ValueError("reset needs positions or a generator")
            kw = dict(generator=generator, device=generator.device)
            positions = torch.stack([
                draw(lambda s: torch.randint(0, self.n_vertical_patches, s, **kw),
                     (self.batch_size,)),
                draw(lambda s: torch.randint(0, self.n_horizontal_patches, s, **kw),
                     (self.batch_size,)),
            ], dim=1)
        positions = torch.as_tensor(positions).long().to(self.device)
        state = EnvState(
            positions=positions,
            visited=self._tiles_reached(positions),
            steps=torch.zeros(self.batch_size, dtype=torch.long, device=self.device),
            has_stopped=torch.zeros(self.batch_size, dtype=torch.bool, device=self.device),
        )
        return state, self.get_patches(state), {"positions": positions}

    def step(self, state: EnvState, actions: torch.Tensor):
        """Apply actions; returns (state, patches, rewards, terminated,
        truncated, infos), as ``batched_env.py:212-243``."""
        actions = actions.long()
        positions = state.positions + self._deltas[actions]
        positions = torch.stack([
            positions[:, 0].clamp(0, self.n_vertical_patches - 1),
            positions[:, 1].clamp(0, self.n_horizontal_patches - 1),
        ], dim=1)
        has_stopped = state.has_stopped | (actions == Action.STOP.value)
        # Rewards use the visited mask before this step and the positions
        # and stops after it.
        rewards = self._rewards(positions, state.visited, has_stopped)
        visited = state.visited | self._tiles_reached(positions)
        steps = state.steps + 1
        new_state = EnvState(positions, visited, steps, has_stopped)
        return (new_state, self.get_patches(new_state), rewards,
                self.terminated(new_state), steps >= self.max_ep_len,
                {"positions": positions})

    def masked_step(self, state: EnvState, actions: torch.Tensor, frozen: torch.Tensor):
        """Step, but leave the rows where ``frozen`` is True unchanged (their
        reward is 0): a fixed-length rollout keeps finished episodes still."""
        new_state, _, rewards, _, _, infos = self.step(state, actions)

        def keep(new, old):
            return torch.where(frozen.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)

        state = EnvState(*(keep(n, o) for n, o in zip(new_state, state)))
        rewards = torch.where(frozen, torch.zeros_like(rewards), rewards)
        return (state, self.get_patches(state), rewards, self.terminated(state),
                state.steps >= self.max_ep_len, infos)

    def terminated(self, state: EnvState) -> torch.Tensor:
        """STOP pressed (stop mode) or every bbox patch visited."""
        if self.stop_enabled:
            return state.has_stopped
        if not self.terminate_on_all_found:
            return torch.zeros(self.batch_size, dtype=torch.bool, device=self.device)
        return ~(self.bbox_masks & ~state.visited).flatten(1).any(dim=1)

    def _tiles_reached(self, positions: torch.Tensor) -> torch.Tensor:
        """One-hot ``[B, nv, nh]`` mask of the positions."""
        ys = torch.arange(self.n_vertical_patches, device=self.device)
        xs = torch.arange(self.n_horizontal_patches, device=self.device)
        y = ys[None, :] == positions[:, :1]
        x = xs[None, :] == positions[:, 1:]
        return y[:, :, None] & x[:, None, :]

    def _rewards(self, positions, visited, has_stopped) -> torch.Tensor:
        """+1 for a new bbox patch, -1/max_ep_len a step, and in stop mode
        the found-count STOP bonus or penalty times ``stop_bonus_scale``."""
        py, px = positions[:, 0], positions[:, 1]
        found_new = (self.bbox_masks[self._rows, py, px] & ~visited[self._rows, py, px]).float()
        rewards = found_new - 1.0 / self.max_ep_len
        if self.stop_enabled:
            found = (visited & self.bbox_masks).flatten(1).sum(1).float()
            total = self.bbox_masks.flatten(1).sum(1).float()
            found_all = (found == total).float()
            stop_eval = found_all * found + (1.0 - found_all) * (found - total)
            rewards = rewards + stop_eval * has_stopped.float() * self.stop_bonus_scale
        return rewards

    def get_patches(self, state: EnvState) -> torch.Tensor:
        """The ``[B, L, P, P, C]`` patches under the agents, float32 (uint8
        images scaled by 1/255): one gather from a strided view of the
        images (of the pyramid's L levels), no copy of the grid."""
        p = self.patch_size
        if self.pyramid is not None:
            tiled = self.pyramid.view(
                self.batch_size, self.n_glimps_levels, self.n_vertical_patches, p,
                self.n_horizontal_patches, p, self.n_channels,
            )
            return tiled[self._rows, :, state.positions[:, 0], :, state.positions[:, 1]]
        tiled = self.images.view(
            self.batch_size, self.n_vertical_patches, p, self.n_horizontal_patches, p,
            self.n_channels,
        )
        patches = tiled[self._rows, state.positions[:, 0], :, state.positions[:, 1]]
        return self._normalize(patches)[:, None]

    def gather_patches_at(self, coords: torch.Tensor) -> torch.Tensor:
        """The ``[B, K, P, P, C]`` float32 patches at ``[B, K, 2]`` (y, x)
        patch coordinates (``batched_env.py:331-344``)."""
        p = self.patch_size
        tiled = self.images.view(
            self.batch_size, self.n_vertical_patches, p, self.n_horizontal_patches, p,
            self.n_channels,
        )
        rows = self._rows[:, None].expand(coords.shape[:2])
        return self._normalize(tiled[rows, coords[..., 0], :, coords[..., 1]])

    def get_detection_batch(self, generator: torch.Generator, max_patches: int,
                            sample_neg: int = 1):
        """Fixed-shape detection training batch (``batched_env.py:375-429``):
        every patch that holds a box, plus ``sample_neg`` random negatives
        per image, capped at ``max_patches``; ``generator`` (on the env's
        device) draws the ranking noise.

        Returns ``patches [B, K, P, P, C]`` (float32), ``targets [B, K, N, 6]``
        rows (cls, x1, y1, x2, y2, obj) in local pixels, ``patch_valid
        [B, K]`` bool.
        """
        nv, nh = self.n_vertical_patches, self.n_horizontal_patches
        flat_pos = self.bbox_masks.reshape(self.batch_size, nv * nh)
        noise = draw(lambda s: torch.rand(s, generator=generator, device=self.device),
                     flat_pos.shape)
        # Negatives ranked among themselves (positives pushed to +inf).
        inf = torch.full_like(noise, float("inf"))
        neg_rank = torch.argsort(
            torch.argsort(torch.where(flat_pos, inf, noise), dim=-1, stable=True),
            dim=-1, stable=True,
        )
        score = torch.where(
            flat_pos, 2.0, torch.where(neg_rank < sample_neg, 1.0, 0.0)
        ) + 1e-3 * noise
        idx = score.topk(max_patches, dim=-1).indices  # [B, K]
        patch_valid = flat_pos.gather(1, idx) | (neg_rank.gather(1, idx) < sample_neg)

        coords = torch.stack([idx // nh, idx % nh], dim=-1)  # [B, K, 2] (y, x)
        patches = self.gather_patches_at(coords)
        rows = self._rows[:, None]
        tgt_boxes = self.local_bboxes[rows, coords[..., 0], coords[..., 1]]  # [B, K, N, 4]
        tgt_valid = self.local_valid[rows, coords[..., 0], coords[..., 1]]  # [B, K, N]
        targets = torch.cat(
            [torch.zeros_like(tgt_boxes[..., :1]), tgt_boxes, tgt_valid[..., None].float()],
            dim=-1,
        )
        targets = targets * patch_valid[..., None, None].float()
        return patches, targets, patch_valid

    def _normalize(self, patches: torch.Tensor) -> torch.Tensor:
        if patches.dtype == torch.uint8:
            return patches.float() / 255.0
        return patches

    # --- metrics ----------------------------------------------------------
    def prop_patches_found(self, state: EnvState) -> torch.Tensor:
        """Fraction of bbox patches visited."""
        count = (self.bbox_masks & state.visited).flatten(1).sum(1)
        total = self.bbox_masks.flatten(1).sum(1)
        return count.float() / total.clamp(min=1).float()

    def prop_bboxes_found(self, state: EnvState) -> torch.Tensor:
        return (self.prop_patches_found(state) > 0).float()
