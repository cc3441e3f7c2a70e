"""Dataset: .txt-list loader with bbox parsing, resize/pad, geometric augs.

A copy of ``jolineedle_tpu/data/dataset.py`` (numpy and PIL only), without
the collates, which the port does not use. ``get_geometry`` is the pixel-free
``__getitem__`` of the device pool's route (``data/device_pool.py``). The JAX
module is the reference data layer (reference:
src/dataset.py:18-550). File format parity: a dataset directory contains
``train.txt``/``test.txt`` (or ``paths.txt``/``all.txt``), each line
``image_path bbox_path``; a bbox file line is
``class_id xmin ymin xmax ymax`` in pixels (reference: src/dataset.py:65-93,
README.md:38).

Images are numpy ``[H, W, C]`` uint8 (NHWC). Boxes are ``[n, 4]`` float
arrays (xyxy pixels).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image


class _DecodeCache:
    """Process-wide LRU cache of decoded uint8 images, keyed by path.

    The training epoch is often just a few batches, so PNG/JPEG decode —
    not disk — dominates host batch time (the reference is disk/CPU-bound
    at ~3 s/iter for the same reason, reference:
    docs/experiment_log.md:76-78). Budget via JOLINEEDLE_DECODE_CACHE_MB
    (default 2048; 0 disables). Entries are read-only: callers copy before
    mutating (the float32 conversion in ``transform`` already does).
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._data: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, path: str):
        with self._lock:
            arr = self._data.get(path)
            if arr is not None:
                self._data.move_to_end(path)
            return arr

    def put(self, path: str, arr: np.ndarray):
        if arr.nbytes > self.max_bytes:
            return
        with self._lock:
            if path in self._data:
                return
            self._data[path] = arr
            self._bytes += arr.nbytes
            while self._bytes > self.max_bytes:
                _, old = self._data.popitem(last=False)
                self._bytes -= old.nbytes


_DECODE_CACHE = _DecodeCache(
    int(os.environ.get("JOLINEEDLE_DECODE_CACHE_MB", "2048")) * 1024 * 1024
)


class NeedleDataset:
    """Map-style dataset over (image_path, bbox_path) pairs.

    Per-sample behavior parity (reference: src/dataset.py:282-296): pick one
    random class among those present and keep only its boxes; resize up to
    ``minimum_image_size`` preserving aspect; zero-pad to a patch multiple;
    optional 90-degree rotations and bounded translations.
    """

    def __init__(
        self,
        image_paths: list,
        bbox_paths: list,
        patch_size: int,
        max_ep_len: int,
        rotations: bool,
        translations: bool,
        min_keypoints: int,
        max_keypoints: int,
        binomial_keypoints: bool,
        minimum_image_size: int,
        filter_classes: Optional[set] = None,
    ):
        assert len(image_paths) == len(bbox_paths)
        self.image_paths = [str(p) for p in image_paths]
        self.bbox_paths = [str(p) for p in bbox_paths]
        self.patch_size = patch_size
        self.max_ep_len = max_ep_len
        self.rotations = rotations
        self.translations = translations
        self.min_keypoints = min_keypoints
        self.max_keypoints = max_keypoints
        self.binomial_keypoints = binomial_keypoints
        self.minimum_image_size = minimum_image_size
        self.filter_classes = filter_classes
        if filter_classes is not None:
            self.raw_classes_to_ordered_classes = {
                c: i for i, c in enumerate(sorted(filter_classes))
            }
        self.rng = np.random.default_rng()

    def __len__(self):
        return len(self.image_paths)

    def load_image(self, index: int) -> np.ndarray:
        path = self.image_paths[index]
        image = _DECODE_CACHE.get(path)
        if image is None:
            image = np.asarray(Image.open(path).convert("RGB"))
            image.setflags(write=False)  # shared across callers
            _DECODE_CACHE.put(path, image)
        return image

    def get_all_bboxes(self, index: int) -> Tuple[list, np.ndarray]:
        classes, boxes = [], []
        with open(self.bbox_paths[index]) as f:
            for line in f:
                parts = line.strip().split(" ")
                if len(parts) < 5:
                    continue
                vals = [int(float(p)) for p in parts[:5]]
                classes.append(vals[0])
                boxes.append(vals[1:5])  # xyxy
        boxes = np.array(boxes, np.float64).reshape(-1, 4)
        if self.filter_classes is not None:
            keep = [i for i, c in enumerate(classes) if c in self.filter_classes]
            boxes = boxes[keep]
            classes = [
                self.raw_classes_to_ordered_classes[classes[i]] for i in keep
            ]
        return classes, boxes

    # --- geometric augmentation ------------------------------------------
    # Each aug is split into a parameter SAMPLER (rng draw, box-geometry
    # only) and two APPLIERS (pixels / boxes), as in the JAX module.

    @staticmethod
    def sample_rotation(rng: np.random.Generator) -> int:
        """Quarter-turns k in {0, 1, 2, 3} = 0/90/180/270 degrees (same rng
        draw as the reference, reference: src/dataset.py:95-155)."""
        return int(rng.integers(0, 4))

    @staticmethod
    def rotate_image(image: np.ndarray, k: int) -> np.ndarray:
        """Apply a k-quarter-turn rotation to [H, W, C] pixels."""
        if k == 0:
            return image
        if k == 1:
            # (y, x) -> (x, H - y): clockwise; output [W, H, C].
            image = np.flip(image.transpose(1, 0, 2), axis=1)
        elif k == 2:
            image = np.flip(image, axis=(0, 1))
        else:  # 270
            # (y, x) -> (W - x, y): counter-clockwise; output [W, H, C].
            image = np.flip(image.transpose(1, 0, 2), axis=0)
        return np.ascontiguousarray(image)

    @staticmethod
    def rotate_boxes(
        boxes: np.ndarray, k: int, h: int, w: int
    ) -> np.ndarray:
        """Box remap for a k-quarter-turn rotation of an h x w image."""
        if k == 0:
            return boxes
        x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        if k == 1:
            return np.stack([h - y2, x1, h - y1, x2], axis=1)
        if k == 2:
            return np.stack([w - x2, h - y2, w - x1, h - y1], axis=1)
        return np.stack([y1, w - x2, y2, w - x1], axis=1)

    @classmethod
    def rotate(
        cls, image: np.ndarray, boxes: np.ndarray, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Random 0/90/180/270 rotation with box remap (reference:
        src/dataset.py:95-155). Image is [H, W, C]."""
        h, w = image.shape[:2]
        k = cls.sample_rotation(rng)
        if k == 0:
            return image, boxes
        return cls.rotate_image(image, k), cls.rotate_boxes(boxes, k, h, w)

    @staticmethod
    def sample_translation(
        boxes: np.ndarray, h: int, w: int, rng: np.random.Generator
    ) -> Tuple[int, int]:
        """(tx, ty) shift bounded by the bbox margins and a third of the
        image (reference: src/dataset.py:157-226)."""
        min_x = max(int(boxes[:, 0].min()), 0)
        min_y = max(int(boxes[:, 1].min()), 0)
        max_x = min(int(boxes[:, 2].max()), w)
        max_y = min(int(boxes[:, 3].max()), h)
        left = min(w // 3, min_x)
        up = min(h // 3, min_y)
        right = min(w // 3, w - max_x)
        down = min(h // 3, h - max_y)
        tx = 0 if (left == 0 and right == 0) else int(rng.integers(-left, right))
        ty = 0 if (up == 0 and down == 0) else int(rng.integers(-up, down))
        return tx, ty

    @staticmethod
    def translate_image(image: np.ndarray, tx: int, ty: int) -> np.ndarray:
        """Shift pixels by (tx, ty) with zero fill."""
        h, w = image.shape[:2]
        out = np.zeros_like(image)
        src_y = slice(max(0, -ty), h - max(0, ty))
        src_x = slice(max(0, -tx), w - max(0, tx))
        dst_y = slice(max(0, ty), h - max(0, -ty))
        dst_x = slice(max(0, tx), w - max(0, -tx))
        out[dst_y, dst_x] = image[src_y, src_x]
        return out

    @staticmethod
    def translate_boxes(boxes: np.ndarray, tx: int, ty: int) -> np.ndarray:
        return boxes + np.array([tx, ty, tx, ty], boxes.dtype)

    @classmethod
    def translate(
        cls, image: np.ndarray, boxes: np.ndarray, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Random translation bounded by the bbox margins and a third of the
        image (reference: src/dataset.py:157-226). Zero fill."""
        h, w = image.shape[:2]
        tx, ty = cls.sample_translation(boxes, h, w, rng)
        return cls.translate_image(image, tx, ty), cls.translate_boxes(
            boxes, tx, ty
        )

    def transform(
        self,
        image: np.ndarray,
        boxes: np.ndarray,
        rng: np.random.Generator,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 HWC -> uint8 HWC, min-size upscale, pad to patch multiple,
        augment (reference: src/dataset.py:228-280). The pipeline stays
        uint8; the env scales patches by 1/255 on the device."""
        h, w = image.shape[:2]

        if self.minimum_image_size and (
            w < self.minimum_image_size or h < self.minimum_image_size
        ):
            ratio = w / h
            ow, oh = w, h
            if w < self.minimum_image_size:
                w = self.minimum_image_size
                h = int(w / ratio)
            if h < self.minimum_image_size:
                h = self.minimum_image_size
                w = int(h * ratio)
            pil = Image.fromarray(image)
            image = np.asarray(pil.resize((w, h), Image.BILINEAR))
            boxes = boxes * np.array([w / ow, h / oh, w / ow, h / oh])

        image = complete_to_patch_size(image, self.patch_size)

        if self.rotations and len(boxes):
            image, boxes = self.rotate(image, boxes, rng)
        if self.translations and len(boxes):
            image, boxes = self.translate(image, boxes, rng)
        return image, boxes

    def __getitem__(
        self, index: int, rng: Optional[np.random.Generator] = None
    ) -> dict:
        if rng is None:
            rng = self.rng
        image = self.load_image(index)
        classes, boxes = self.get_all_bboxes(index)
        class_id = int(rng.choice(classes)) if classes else 0
        boxes = boxes[[i for i, c in enumerate(classes) if c == class_id]]
        image, boxes = self.transform(image, boxes, rng)
        return {"image": image, "bboxes": boxes, "class_id": class_id}

    def raw_size(self, index: int) -> Tuple[int, int]:
        """(w, h) of the encoded image — header read only, no pixel decode."""
        if not hasattr(self, "_raw_sizes"):
            self._raw_sizes: Dict[int, Tuple[int, int]] = {}
        size = self._raw_sizes.get(index)
        if size is None:
            with Image.open(self.image_paths[index]) as im:
                size = im.size
            self._raw_sizes[index] = size
        return size

    def get_geometry(
        self, index: int, rng: Optional[np.random.Generator] = None
    ) -> dict:
        """Pixel-free ``__getitem__``: boxes, class, post-aug shape, and the
        sampled augmentation parameters — consuming the SAME rng draws in
        the same order as ``__getitem__``, so a caller that swaps one for
        the other reproduces identical episodes. This is the device-pool
        route (``data/device_pool.py``): the pixels stay on the device and
        the train step re-applies ``aug_rot``/``aug_shift`` there.

        Returns keys: ``bboxes`` (post-aug), ``class_id``, ``shape``
        (post-aug padded H, W), ``base_hw`` (pre-aug padded H, W),
        ``aug_rot`` (quarter-turns), ``aug_shift`` ((ty, tx) pixels).
        """
        if rng is None:
            rng = self.rng
        classes, boxes = self.get_all_bboxes(index)
        class_id = int(rng.choice(classes)) if classes else 0
        boxes = boxes[[i for i, c in enumerate(classes) if c == class_id]]

        # Mirror transform()'s resize+pad box math without touching pixels.
        w, h = self.raw_size(index)
        if self.minimum_image_size and (
            w < self.minimum_image_size or h < self.minimum_image_size
        ):
            ratio = w / h
            ow, oh = w, h
            if w < self.minimum_image_size:
                w = self.minimum_image_size
                h = int(w / ratio)
            if h < self.minimum_image_size:
                h = self.minimum_image_size
                w = int(h * ratio)
            boxes = boxes * np.array([w / ow, h / oh, w / ow, h / oh])
        h_pad = -(-h // self.patch_size) * self.patch_size
        w_pad = -(-w // self.patch_size) * self.patch_size

        k = 0
        ty = tx = 0
        h2, w2 = h_pad, w_pad
        if self.rotations and len(boxes):
            k = self.sample_rotation(rng)
            boxes = self.rotate_boxes(boxes, k, h_pad, w_pad)
            if k % 2 == 1:
                h2, w2 = w_pad, h_pad
        if self.translations and len(boxes):
            tx, ty = self.sample_translation(boxes, h2, w2, rng)
            boxes = self.translate_boxes(boxes, tx, ty)
        return {
            "bboxes": boxes,
            "class_id": class_id,
            "shape": (h2, w2),
            "base_hw": (h_pad, w_pad),
            "aug_rot": k,
            "aug_shift": (ty, tx),
        }



def complete_to_patch_size(image: np.ndarray, patch_size: int) -> np.ndarray:
    """Zero-pad bottom/right to a multiple of patch_size (reference:
    src/dataset.py:379-406)."""
    h, w = image.shape[:2]
    dh = (-h) % patch_size
    dw = (-w) % patch_size
    if dh or dw:
        image = np.pad(image, ((0, dh), (0, dw), (0, 0)))
    return image


def get_paths(
    dataset_directory: Path, test_pattern: str = "", seed: int = 0,
    test_size: float = 0.01,
) -> tuple:
    """Resolve train/test path lists (reference: src/dataset.py:409-475)."""
    dataset_directory = Path(dataset_directory)

    def read_list(file: Path):
        images, bboxes = [], []
        base = file.parent
        with open(file) as f:
            for line in f:
                i, b = line.split(" ")
                i, b = i.strip(), b.strip()
                if not Path(i).is_absolute():
                    i = str(base / i)
                if not Path(b).is_absolute():
                    b = str(base / b)
                images.append(i)
                bboxes.append(b)
        return images, bboxes

    if (dataset_directory / "train.txt").is_file() and (
        dataset_directory / "test.txt"
    ).is_file():
        tr_i, tr_b = read_list(dataset_directory / "train.txt")
        te_i, te_b = read_list(dataset_directory / "test.txt")
        return tr_i, tr_b, te_i, te_b

    list_file = None
    for name in ("all.txt", "paths.txt"):
        if (dataset_directory / name).is_file():
            list_file = dataset_directory / name
            break
    if list_file is None:
        raise RuntimeError(
            "Loading a new dataset, please specify the way it should be loaded."
        )

    images, bboxes = read_list(list_file)
    if test_pattern:
        tr_i, tr_b, te_i, te_b = [], [], [], []
        for i, b in zip(images, bboxes):
            if test_pattern in str(i):
                te_i.append(i)
                te_b.append(b)
            else:
                tr_i.append(i)
                tr_b.append(b)
        return tr_i, tr_b, te_i, te_b

    # Deterministic shuffled split (replaces sklearn train_test_split).
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(images))
    n_test = max(1, int(round(len(images) * test_size)))
    test_ids = set(order[:n_test].tolist())
    tr_i = [images[i] for i in range(len(images)) if i not in test_ids]
    tr_b = [bboxes[i] for i in range(len(images)) if i not in test_ids]
    te_i = [images[i] for i in order[:n_test]]
    te_b = [bboxes[i] for i in order[:n_test]]
    return tr_i, tr_b, te_i, te_b


def filter_images(classes_to_keep: set, image_paths, bbox_paths) -> tuple:
    """Keep only images containing one of the classes (reference:
    src/dataset.py:478-487)."""
    fi, fb = [], []
    for ip, bp in zip(image_paths, bbox_paths):
        with open(bp) as f:
            classes = {int(line.strip().split(" ")[0]) for line in f if line.strip()}
        if classes & classes_to_keep:
            fi.append(ip)
            fb.append(bp)
    return fi, fb


def build_datasets(
    dataset_directory: Path,
    patch_size: int,
    max_ep_len: int,
    min_keypoints: int,
    max_keypoints: int,
    rotations: bool,
    translations: bool,
    seed: int = 0,
    train_size: int = -1,
    test_size: float = 0.01,
    test_pattern: str = "",
    binomial_keypoints: bool = False,
    minimum_image_size: int = 0,
    filter_classes: Optional[set] = None,
) -> tuple:
    """(train, test) datasets (reference: src/dataset.py:490-550)."""
    tr_i, tr_b, te_i, te_b = get_paths(
        dataset_directory, test_pattern, test_size=test_size, seed=seed
    )
    if filter_classes is not None:
        tr_i, tr_b = filter_images(filter_classes, tr_i, tr_b)
        te_i, te_b = filter_images(filter_classes, te_i, te_b)

    train_size = len(tr_i) if train_size == -1 else min(train_size, len(tr_i))

    common = dict(
        patch_size=patch_size,
        max_ep_len=max_ep_len,
        rotations=rotations,
        translations=translations,
        min_keypoints=min_keypoints,
        max_keypoints=max_keypoints,
        binomial_keypoints=binomial_keypoints,
        minimum_image_size=minimum_image_size,
        filter_classes=filter_classes,
    )
    train_dataset = NeedleDataset(tr_i[:train_size], tr_b[:train_size], **common)
    test_dataset = NeedleDataset(te_i, te_b, **common)
    return train_dataset, test_dataset
