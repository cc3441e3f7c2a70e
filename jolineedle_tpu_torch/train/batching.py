"""Host-side batch assembly: the supervised batches and the prefetcher.

The counterpart of ``jolineedle_tpu/train/batching.py``: the numpy oracle
(``env/oracle.py``) labels a fixed-shape episode per image, the patch pixels
are gathered by vectorized slicing, and everything is padded to static caps
(max_seq_len, max_det_patches, max_boxes). The ``Prefetcher`` overlaps that
host work (PIL decode, numpy slicing) with the device's work on the previous
batches.

A batch either carries its patches as uint8 (the streamed-pixel route), or,
with ``with_pixels=False`` (the device pool's route, ``data/device_pool.py``),
only the image indices, geometry and labels, from ``get_geometry``: the
train step gathers the pixels on the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..env.oracle import (
    OracleEnv,
    detection_patch_positions,
    gather_patches,
    generate_sample,
)


def _to_u8(x: np.ndarray) -> np.ndarray:
    """uint8 pixels: dataset images already are; float [0, 1] converts."""
    if x.dtype == np.uint8:
        return x
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)


def build_supervised_sample(
    item: dict,
    patch_size: int,
    max_seq_len: int,
    min_keypoints: int,
    max_keypoints: int,
    binomial_keypoints: bool,
    max_det_patches: int,
    max_boxes: int,
    rng: np.random.Generator,
    position=None,
    with_pixels: bool = True,
) -> Dict[str, np.ndarray]:
    """One image -> a fixed-shape oracle episode and its detector patches
    (``batching.py:32-105``): positions, actions, labels, masks and local
    boxes of the episode, and the detector's patch positions, validity and
    targets; with ``with_pixels``, also both uint8 patch sets. Without it,
    ``item`` may be a pixel-free ``get_geometry`` dict (``shape`` in place
    of ``image``)."""
    image = item.get("image")  # [H, W, C] uint8 (float in [0, 1] accepted)
    shape = item["shape"] if image is None else image.shape[:2]
    boxes = np.asarray(item["bboxes"], np.float64).reshape(-1, 4)
    env = OracleEnv(shape, patch_size, boxes, rng)

    sample = generate_sample(
        env,
        max_seq_len,
        min_keypoints=min_keypoints,
        max_keypoints=max_keypoints,
        binomial_keypoints=binomial_keypoints,
        position=position,
        max_boxes=max_boxes,
    )
    sample["class_id"] = np.int32(item["class_id"])

    det_pos, det_valid = detection_patch_positions(env, max_det_patches)
    det_boxes = np.zeros((max_det_patches, max_boxes, 6), np.float32)
    for i in range(max_det_patches):
        if det_valid[i]:
            local = env.cap_local_bboxes(env.local_bboxes(tuple(det_pos[i])), max_boxes)
            det_boxes[i, : len(local)] = local
    sample["yolox_positions"] = det_pos.astype(np.int32)
    sample["bboxes_yolox"] = det_boxes
    sample["yolox_valid"] = det_valid

    if with_pixels:
        sample["patches"] = _to_u8(gather_patches(image, sample["positions"], patch_size))
        det_patches = gather_patches(image, det_pos, patch_size)
        sample["patches_yolox"] = _to_u8(det_patches * det_valid[:, None, None, None])
    return sample


def build_supervised_batch(
    dataset,
    indices,
    config,
    rng: np.random.Generator,
    with_pixels: bool = True,
) -> Dict[str, np.ndarray]:
    """The stacked samples of ``indices`` and their reference actions
    (``batching.py:108-160``). One ``rng`` per batch draws the dataset's
    class choice and augmentations and the oracle's episodes, in order.

    ``with_pixels=False`` is the device pool's batch: no patches, the items
    from ``get_geometry`` (the same draws as ``__getitem__``, no decode), and,
    when the dataset augments, each sample's ``base_hw`` and its ``aug_rot``
    and ``aug_shift`` for the device to replay. ``image_idx`` is always
    there."""
    samples = []
    has_augs = dataset.rotations or dataset.translations
    for idx in indices:
        if with_pixels:
            item = dataset.__getitem__(int(idx), rng)
        else:
            item = dataset.get_geometry(int(idx), rng)
        sample = build_supervised_sample(
            item,
            patch_size=config.patch_size,
            max_seq_len=config.max_seq_len,
            min_keypoints=config.min_keypoints,
            max_keypoints=config.max_keypoints,
            binomial_keypoints=config.binomial_keypoints,
            max_det_patches=config.max_det_patches,
            max_boxes=config.max_boxes,
            rng=rng,
            with_pixels=with_pixels,
        )
        if not with_pixels and has_augs:
            sample["base_hw"] = np.asarray(item["base_hw"], np.int32)
            if dataset.rotations:
                sample["aug_rot"] = np.int32(item["aug_rot"])
            if dataset.translations:
                sample["aug_shift"] = np.asarray(item["aug_shift"], np.int32)
        samples.append(sample)
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    batch["image_idx"] = np.asarray(indices, np.int32)

    # Reference actions (loss mode, reference: src/supervised.py:870-879):
    # on the agent's own trajectory, each step's label is the action taken
    # next, and the last live step keeps the oracle's label.
    if getattr(config, "loss_mode", "on-optimal-trajectory") == "on-self-trajectory":
        cur, nxt, masks = batch["current_actions"], batch["next_actions"], batch["masks"]
        ref = np.zeros_like(cur)
        ref[:, :-1] = cur[:, 1:]
        last = masks.sum(axis=1).astype(np.int64) - 1
        ref[np.arange(len(ref)), last] = nxt[np.arange(len(ref)), last]
        batch["reference_actions"] = ref
    else:
        batch["reference_actions"] = batch["next_actions"]
    return batch


class Prefetcher:
    """Background-thread batch producer with a bounded queue.

    ``num_workers`` > 1 assembles batches from several threads (PIL decode
    and numpy slicing release the GIL) — the reference's DataLoader worker
    count (reference: main.py ``--num-workers``). When ``pick_work`` is
    given, it is called under an internal lock to draw the next work item
    (e.g. sample indices) and ``make_batch(work)`` runs in parallel; the
    batches come out in the order their work was picked (one built early
    waits for those before it), so every rank of a data-parallel run takes
    the same global batch at the same iteration. Without it,
    ``make_batch()`` itself must be thread-safe for num_workers > 1 and the
    batches come out as they are built. An exception in ``make_batch`` is
    raised by the ``next()`` that would have returned that batch, one in
    ``pick_work`` by the next ``next()``.
    """

    def __init__(
        self,
        make_batch,
        n_prefetch: int = 2,
        num_workers: int = 1,
        pick_work=None,
    ):
        num_workers = max(1, int(num_workers))
        self._queue: queue.Queue = queue.Queue(
            maxsize=max(n_prefetch, num_workers)
        )
        self._make_batch = make_batch
        self._pick_work = pick_work
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._active = num_workers
        self._picked = 0  # work items picked so far: the next one's number
        self._next = 0  # the number of the batch next() returns next
        self._early = {}  # batches built before their turn, by number
        self._drained = False  # the end-of-stream sentinel has come
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_workers)
        ]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            number = None
            try:
                if self._pick_work is not None:
                    with self._lock:
                        work = self._pick_work()
                        number = self._picked
                        self._picked += 1
                    batch = self._make_batch(work)
                else:
                    batch = self._make_batch()
            except StopIteration:
                # End-of-stream sentinel only once EVERY worker has drained,
                # so late batches from other workers are not cut off.
                with self._lock:
                    self._active -= 1
                    last = self._active == 0
                if last:
                    self._queue.put(None)
                return
            except Exception as exc:
                # Handed to the consumer, which raises it: a worker that died
                # silently would leave next() waiting forever.
                batch = exc
            while not self._stop.is_set():
                try:
                    self._queue.put((number, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while self._next not in self._early:
            if self._drained:  # every worker has stopped: the rest in order
                if not self._early:
                    raise StopIteration
                self._next = min(self._early)
                break
            item = self._queue.get()
            if item is None:
                self._drained = True
                continue
            number, batch = item
            if number is None:
                if isinstance(batch, Exception):
                    raise batch
                return batch
            self._early[number] = batch
        batch = self._early.pop(self._next)
        self._next += 1
        if isinstance(batch, Exception):
            raise batch
        return batch

    def close(self):
        self._stop.set()
        # Drain so workers blocked on a full queue observe the stop flag,
        # then join: no worker may still be inside make_batch (touching the
        # dataset) when the caller proceeds to eval/validation.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=30.0)
