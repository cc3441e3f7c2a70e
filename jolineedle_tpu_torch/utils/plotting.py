"""Host-side trajectory rendering: matplotlib (Agg) for the panels, PIL for
the files.

A copy of ``jolineedle_tpu/utils/plotting.py`` (the same figure, overlay and
box colours, so the same pixels) plus the infer CLI's ``save_image``
(``infer.py:85-88``). Visited patches in a progressive red scale,
ground-truth boxes green, predictions blue, the patch grid overlaid; a panel
is an ``[C, H, W]`` float image for the dashboard.

matplotlib is optional: it is imported inside :func:`plot_model_prediction`,
never when this module (or a trainer, or a CLI) is imported, so the port runs
where it is not installed. Drawing there raises an ``ImportError`` that names
it and what asked for the plot.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .geometry import BBox, Position

MISSING = "matplotlib is not installed"


def pyplot(what: str):
    """matplotlib's pyplot on the Agg backend, or an ImportError naming
    matplotlib and ``what`` asked for the plot: a caller that will draw
    calls it before spending any work on the plot."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(f"{what} draws trajectory plots with matplotlib, but {MISSING}") from e
    return plt


def matplotlib_available() -> bool:
    """Whether matplotlib imports here (imports it when it does)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _plot_bbox(axe, bbox: BBox, color: str):
    x1, y1 = bbox.up_left.x, bbox.up_left.y
    x2, y2 = bbox.bottom_right.x, bbox.bottom_right.y
    axe.plot([x1, x1, x2, x2, x1], [y1, y2, y2, y1, y1], color=color, alpha=0.6)


def plot_model_prediction(
    image: np.ndarray,  # [H, W, C] uint8 [0, 255] or float in [0, 1]
    patches: np.ndarray,  # [n, P, P, C]
    positions: np.ndarray,  # [n, 2] (y, x) patch coords
    true_bboxes: Optional[List[BBox]] = None,
    predicted_bboxes: Optional[List[BBox]] = None,
    what: str = "plot_model_prediction",
) -> np.ndarray:
    """The trajectory panel, ``[3, H', W']`` float in [0, 1]. ``true_bboxes``
    may also hold xyxy rows. ``what`` names the caller in the ImportError
    raised without matplotlib."""
    plt = pyplot(what)
    patch_size = patches.shape[1]
    figure = plt.figure()
    axe = figure.gca()

    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img * 0.8 + 0.2
    axe.imshow(np.clip(img, 0, 1), vmin=0, vmax=1)
    axe.set_xticks(np.arange(0, img.shape[1], patch_size))
    axe.set_yticks(np.arange(0, img.shape[0], patch_size))
    axe.grid(visible=True, color="white")

    # Progressive red-scale markers over visited patches.
    overlay = np.zeros(img.shape[:2] + (4,))
    n = max(len(positions), 1)
    for i, pos in enumerate(np.asarray(positions)):
        coeff = 0.3 + (i / n) * 0.7
        y, x = int(pos[0]) * patch_size, int(pos[1]) * patch_size
        overlay[y : y + patch_size, x : x + patch_size] = [coeff, 0, 0, 0.3]
    axe.imshow(overlay)

    for bbox in predicted_bboxes or []:
        _plot_bbox(axe, bbox, "blue")
    for bbox in true_bboxes or []:
        if not isinstance(bbox, BBox):
            b = np.asarray(bbox, np.float64).reshape(-1)
            bbox = BBox(Position(y=b[1], x=b[0]), Position(y=b[3], x=b[2]))
        _plot_bbox(axe, bbox, "green")

    canvas = figure.canvas
    canvas.draw()
    data = np.frombuffer(canvas.buffer_rgba(), dtype=np.uint8)
    out = data.reshape(canvas.get_width_height()[::-1] + (4,))[..., :3]
    figure.clear()
    plt.close(figure)
    return (out.astype(np.float32) / 255.0).transpose(2, 0, 1)


def save_image(chw_image: np.ndarray, path: str):
    """[C, H, W] float in [0, 1] -> PNG (``infer.py:85-88``)."""
    from PIL import Image

    hwc = np.clip(np.asarray(chw_image).transpose(1, 2, 0) * 255, 0, 255)
    Image.fromarray(hwc.astype(np.uint8)).save(path)


def save_batch(images: np.ndarray, path: str, n_cols: int = 4):
    """Dump a batch of images as one mosaic PNG (a debugging aid; reference:
    src/utils.py:396-423, cv2 replaced by PIL).

    ``images``: [B, H, W, C] floats in [0, 1] or uint8 in [0, 255].
    """
    from PIL import Image

    images = np.asarray(images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    b, h, w, c = images.shape
    n_rows = -(-b // n_cols)
    mosaic = np.zeros((n_rows * h, n_cols * w, c), np.float32)
    for i in range(b):
        r, col = divmod(i, n_cols)
        mosaic[r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    Image.fromarray(np.clip(mosaic * 255, 0, 255).astype(np.uint8)).save(path)
