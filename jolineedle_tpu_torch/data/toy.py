"""Toy dataset generator for tests and smoke runs.

A copy of ``jolineedle_tpu/data/toy.py`` (numpy and PIL only): the same seed
writes the same files. One change: in ``runway`` mode the JAX version draws
the runway length from [192, min(384, side - 1)], which raises on an image
side below 193; here the lower bound is cut to the side too, which leaves
the draws of every size the JAX version accepts unchanged.

The reference integration tests download a hosted "toy LARD" archive
(reference: tests/test_common.py:5-27); we generate an equivalent dataset
locally instead (SURVEY.md section 4): noisy aerial-like backgrounds with one
or more bright "runway" rectangles whose bounding boxes are the targets.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image


def generate_toy_dataset(
    out_dir,
    n_train: int = 8,
    n_test: int = 4,
    image_size: tuple = (896, 1120),
    max_boxes: int = 2,
    seed: int = 0,
    context: bool = False,
    box_size: tuple = (30, 120),
    runway: bool = False,
) -> Path:
    """Write images + bbox txts + train.txt/test.txt; returns the dir.

    ``context=True`` adds a smooth brightness gradient centered on each
    target, giving every patch a directional cue toward the object — without
    it, navigation beyond random search is unlearnable by construction (in
    LARD the aerial scenery provides that context).

    ``box_size`` is the (min, max) target edge length in pixels. The default
    30-120 at patch 64 makes most boxes SPAN patches (box/patch ratio
    0.5-1.9); pass e.g. (12, 40) for a LARD-like ratio (runways are
    ~0.1-0.45 of LARD's 448 px patch, reference: docs/lard_dataset.md),
    where per-patch detections are whole boxes rather than fragments.

    ``runway=True`` switches the target TOPOLOGY to LARD's: exactly ONE
    elongated thin rectangle per image, 3-6 patch-lengths long (192-384 px
    at patch 64) and 16-40 px thick, axis-aligned horizontal or vertical —
    one contiguous object whose bbox spans several patches IN A LINE
    (reference bbox->patch semantics: src/env/simple_env.py:270-321). This
    isolates the "have I found everything?" signal: with a single
    contiguous target, full coverage is locally observable (the runway
    visibly ends), unlike scattered 1-2-patch targets. ``box_size`` and
    ``max_boxes`` are ignored in this mode."""
    out_dir = Path(out_dir)
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    (out_dir / "bboxes").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = image_size

    if h < 128 or w < 128:
        raise ValueError("toy images must be at least 128x128")

    def make_one(name: str) -> tuple:
        img = rng.integers(40, 90, (h, w, 3), dtype=np.uint8)
        # Low-frequency texture (tiled up, cropped to any image size).
        coarse = rng.integers(
            0, 60, (-(-h // 32), -(-w // 32), 3), dtype=np.uint8
        )
        img = img + np.kron(coarse, np.ones((32, 32, 1), dtype=np.uint8))[:h, :w]
        boxes = []
        n_targets = 1 if runway else int(rng.integers(1, max_boxes + 1))
        for _ in range(n_targets):
            if runway:
                # One long thin rectangle: 3-6 patch-lengths (patch 64)
                # along a random axis, sub-patch thickness.
                horizontal = bool(rng.integers(0, 2))
                axis_max = (w if horizontal else h) - 1
                length = int(rng.integers(min(192, axis_max), min(384, axis_max) + 1))
                thick = int(rng.integers(16, 41))
                bw, bh = (length, thick) if horizontal else (thick, length)
            else:
                bw = int(rng.integers(box_size[0], box_size[1]))
                bh = int(rng.integers(box_size[0], box_size[1]))
            x1 = int(rng.integers(0, w - bw))
            y1 = int(rng.integers(0, h - bh))
            if context:
                cy, cx = y1 + bh / 2, x1 + bw / 2
                yy, xx = np.meshgrid(
                    np.arange(h, dtype=np.float32),
                    np.arange(w, dtype=np.float32),
                    indexing="ij",
                )
                dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
                sigma = 0.5 * max(h, w)
                glow = (80.0 * np.exp(-(dist**2) / (2 * sigma**2))).astype(
                    np.uint8
                )
                img = np.clip(
                    img.astype(np.int32) + glow[..., None], 0, 255
                ).astype(np.uint8)
            img[y1 : y1 + bh, x1 : x1 + bw] = np.array(
                [200, 200, 210], np.uint8
            ) + rng.integers(0, 40, (bh, bw, 3), dtype=np.uint8)
            boxes.append((0, x1, y1, x1 + bw, y1 + bh))
        img_path = out_dir / "images" / f"{name}.png"
        bbox_path = out_dir / "bboxes" / f"{name}.txt"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(img_path)
        with open(bbox_path, "w") as f:
            for cls, x1, y1, x2, y2 in boxes:
                f.write(f"{cls} {x1} {y1} {x2} {y2}\n")
        return img_path, bbox_path

    for split, n in (("train", n_train), ("test", n_test)):
        lines = []
        for i in range(n):
            ip, bp = make_one(f"{split}_{i}")
            lines.append(f"images/{ip.name} bboxes/{bp.name}\n")
        with open(out_dir / f"{split}.txt", "w") as f:
            f.writelines(lines)
    return out_dir
