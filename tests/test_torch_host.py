"""The port's numpy host modules against the JAX package's originals.

The port keeps its own copies of the framework-free modules it needs (the JAX
package's ``__init__`` imports JAX), so each copied function is run on the
same inputs, made from a numpy seed, on both sides and must give identical
results: the copies may not drift from the reference. ``nms_mask``, the
fixed-shape NMS on tensors, gives the JAX keep mask exactly.
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jolineedle_tpu.config as jconfig
import jolineedle_tpu.data.dataset as jdataset
import jolineedle_tpu.data.toy as jtoy
import jolineedle_tpu.env.oracle as joracle
import jolineedle_tpu.env.parsing as jparsing
import jolineedle_tpu.ops.nms as jnms
import jolineedle_tpu.utils.geometry as jgeometry
import jolineedle_tpu.utils.metrics as jmetrics
import jolineedle_tpu_torch.config as tconfig
import jolineedle_tpu_torch.data.dataset as tdataset
import jolineedle_tpu_torch.data.toy as ttoy
import jolineedle_tpu_torch.env.oracle as toracle
import jolineedle_tpu_torch.env.parsing as tparsing
import jolineedle_tpu_torch.ops.nms as tnms
import jolineedle_tpu_torch.utils.geometry as tgeometry
import jolineedle_tpu_torch.utils.metrics as tmetrics

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, NV, NH = 32, 3, 4


def _boxes(rng, n, side_y=NV * P, side_x=NH * P):
    """``n`` xyxy pixel boxes inside a ``side_y x side_x`` image, 4-60 px."""
    xy = rng.integers(0, [side_x - 8, side_y - 8], (n, 2))
    wh = rng.integers(4, 60, (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, [side_x - 1, side_y - 1])], 1).astype(
        np.float32
    )


def _preds(rng, n, patch=P):
    """``n`` per-patch prediction rows (x1, y1, x2, y2, obj, cls_conf, cls)."""
    b = _boxes(rng, n, patch, patch)
    return np.concatenate([b, rng.uniform(0.1, 1, (n, 2)), np.zeros((n, 1))], 1)


def _parsing(rng):
    boxes = _boxes(rng, 5)
    valid = np.array([True, True, False, True, True])
    args = (boxes, valid, NV, NH, P)
    return [
        (f.split_boxes_to_patches(*args), f.boxes_to_patch_mask(*args),
         f.detection_targets_full_image(*args),
         [f.bbox_patch_positions(b, P, NV, NH) for b in boxes])
        for f in (jparsing, tparsing)
    ]


def _geometry(rng):
    outputs = [_preds(rng, 3), None, _preds(rng, 2), np.zeros((0, 7))]
    positions = rng.integers(0, [NV, NH], (4, 2))
    targets = np.concatenate(
        [np.zeros((4, 3, 1)), rng.uniform(0, P, (4, 3, 4)), rng.integers(0, 2, (4, 3, 1))], -1
    )
    merge_in = [np.concatenate(outputs[:3:2]), None]
    merge_targets = np.concatenate([np.zeros((5, 1)), _boxes(rng, 5)], 1)
    out = []
    for f in (jgeometry, tgeometry):
        parsed = f.parse_bbox_predictions(outputs, positions, P)
        out.append((
            [tuple(b) for b in parsed], f.bboxes_to_array(parsed),
            [tuple(b) for b in f.parse_bbox_targets(targets, positions, P)],
            f.merge_boxes_batched(merge_in, threshold=6),
            f.merge_boxes(merge_targets, threshold=6, target=True),
        ))
    return out


def _metrics(rng):
    first = _preds(rng, 4)
    outputs = [[first, None, _preds(rng, 3)], [None, _preds(rng, 2), None]]
    offsets = rng.integers(0, 3, (2, 3, 2)) * P
    masks = np.array([[True, True, False], [True, True, True]])
    # two targets the first patch's predictions hit (off by 1 px), one missed
    hits = first[:2, :4] + np.tile(offsets[0, 0], 2) + 1
    targets = [np.concatenate([np.zeros((3, 1)), np.concatenate([hits, _boxes(rng, 1)])], 1),
               np.zeros((0, 5))]
    a, b = _boxes(rng, 6), _boxes(rng, 4)
    gts = [a[:2] + 1, np.concatenate([a[4:] - 1, b[:1]])]
    out = []
    for f in (jmetrics, tmetrics):
        full = f.patch_bboxes2full_image(outputs, offsets, masks)
        out.append((full, f.compute_detection_metrics(full, targets), f.box_iou(a, b),
                    f.average_precision_50([a[:3], a[3:]], [a[:3, 0], a[3:, 1]], gts)))
    return out


def _nms(rng):
    A = 40
    xy, wh = rng.uniform(0, P, (2, A, 2)), rng.uniform(2, 20, (2, A, 2))
    boxes = np.concatenate([xy, wh], -1)
    logits = rng.normal(size=(2, A)), rng.normal(size=(2, A, 2))
    xyxy = np.concatenate([xy[0] - wh[0] / 2, xy[0] + wh[0] / 2], -1)
    out = []
    for f in (jnms, tnms):
        obj, cls = (f.sigmoid_np(x) for x in logits)
        out.append((obj, cls, f.nms_numpy(xyxy, obj[0], 0.3),
                    f.postprocess(boxes, obj, cls, conf_threshold=0.3, patch_size=P)))
    return out


def _images(rng):
    image = rng.integers(0, 256, (NV * P - 5, NH * P - 9, 3), dtype=np.uint8)
    positions = rng.integers(0, [NV, NH], (5, 2))
    out = []
    for data, oracle in ((jdataset, joracle), (tdataset, toracle)):
        padded = data.complete_to_patch_size(image, P)
        out.append((padded, oracle.gather_patches(padded, positions, P)))
    return out


def _files(directory):
    return {str(p.relative_to(directory)): p.read_bytes()
            for p in sorted(Path(directory).rglob("*")) if p.is_file()}


def _toy(rng):
    """The same seed writes the same files (images, boxes, lists)."""
    out = []
    for toy in (jtoy, ttoy):
        with tempfile.TemporaryDirectory() as tmp:
            toy.generate_toy_dataset(Path(tmp) / "a", n_train=2, n_test=1, image_size=(128, 160),
                                     seed=3, box_size=(12, 40))
            toy.generate_toy_dataset(Path(tmp) / "b", n_train=1, n_test=1, image_size=(256, 200),
                                     seed=4, runway=True, context=True)
            out.append((_files(Path(tmp) / "a"), _files(Path(tmp) / "b")))
    return out


def _dataset(rng):
    """Dataset items (resize to a minimum size, pad, rotate, translate,
    class pick) from the same list files with the same per-item seeds."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        jtoy.generate_toy_dataset(Path(tmp), n_train=3, n_test=2, image_size=(128, 176),
                                  max_boxes=3, seed=5, box_size=(12, 40))
        for data in (jdataset, tdataset):
            train, test = data.build_datasets(
                Path(tmp), patch_size=P, max_ep_len=4, min_keypoints=1, max_keypoints=2,
                rotations=True, translations=True, seed=1, minimum_image_size=150)
            items = [train.__getitem__(i, np.random.default_rng(i)) for i in range(len(train))]
            items += [test.__getitem__(i, np.random.default_rng(9)) for i in range(len(test))]
            paths = [Path(p).name for p in train.image_paths + test.image_paths]
            out.append((paths, items))
    return out


def _visualizer(rng):
    """Metric routing, the dashboard state and its pickle round trip."""
    from jolineedle_tpu.observe.logger import Logger as JLogger
    from jolineedle_tpu.observe.visualizer import VisdomPlotter as JPlotter
    from jolineedle_tpu_torch.observe.logger import Logger as TLogger
    from jolineedle_tpu_torch.observe.visualizer import VisdomPlotter as TPlotter

    names = ["yolo_map", "map", "prop_patches_found", "episode_length", "stop_used", "loss",
             "action_loss", "label_x", "returns"]
    values = rng.normal(size=(3, len(names)))
    out = []
    for logger, plotter in ((JLogger, JPlotter), (TLogger, TPlotter)):
        viz = plotter("env", offline=True)
        for row in values:
            for name, v in zip(names, row):
                viz.add_scalar(logger.route(name), name, v)
        viz.add_table("t", {"a": 1, "b": "x"})
        with tempfile.TemporaryDirectory() as tmp:
            viz.save(tmp)
            back = plotter.load(Path(tmp) / "visdom.pkl")
        out.append(([logger.route(n) for n in names], dict(back.lines), back.texts))
    return out


CASES = {"parsing": _parsing, "geometry": _geometry, "metrics": _metrics, "nms": _nms,
         "images": _images, "toy": _toy, "dataset": _dataset, "visualizer": _visualizer}


def _assert_same(got, want, path="out"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("module", sorted(CASES))
def test_host_copy_matches_jax(module):
    want, got = CASES[module](np.random.default_rng(7))
    _assert_same(got, want)


def test_toy_runway_takes_a_short_side(tmp_path):
    """The JAX generator raises on a runway image side below 193 (its
    length draw starts at 192); the port's draws a shorter runway."""
    with pytest.raises(ValueError):
        jtoy.generate_toy_dataset(tmp_path / "j", n_train=1, n_test=0, image_size=(150, 150),
                                  seed=0, runway=True)
    ttoy.generate_toy_dataset(tmp_path / "t", n_train=2, n_test=1, image_size=(150, 150),
                              seed=0, runway=True)
    for line in (tmp_path / "t" / "train.txt").read_text().splitlines():
        box = np.loadtxt(tmp_path / "t" / line.split()[1])
        assert box[3] < 150 and box[4] < 150 and max(box[3] - box[1], box[4] - box[2]) >= 16


def test_config_flags_and_defaults_match_jax(tmp_path):
    """The same flags, with the same defaults, and the same config trees."""
    cli = ["--dataset-dir", str(tmp_path), "--work-dir", str(tmp_path),
           "--model-type", "gpt-nano", "--enable-stop", "--patch-size", "64"]
    jargs, targs = jconfig.get_args(cli), tconfig.get_args(cli)
    assert vars(targs) == vars(jargs)
    for want, got in zip(jconfig.args_to_config(jargs), tconfig.args_to_config(targs)):
        assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_nms_mask_equals_jax(n, threshold):
    """Seeded overlapping boxes with invalid rows and tied scores (ties
    keep the lowest index, as ``jnp.argmax`` does); then all rows invalid
    and all boxes identical with one score."""
    rng = np.random.default_rng(n)
    xy = rng.uniform(0, 120, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (n, 2))], 1).astype(np.float32)
    boxes[rng.uniform(size=n) < 0.1, 2:] -= 80.0  # a few degenerate boxes (area 0)
    scores = rng.uniform(size=n).astype(np.float32)
    scores[rng.integers(0, n, max(n // 3, 1))] = 0.5
    valid = rng.uniform(size=n) > 0.25
    valid[0] = True
    cases = [(boxes, scores, valid), (boxes, scores, np.zeros(n, bool)),
             (np.repeat(boxes[:1], n, 0), np.full(n, 0.5, np.float32), np.ones(n, bool))]
    for b, s, v in cases:
        want = np.asarray(jnms.nms_mask(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v),
                                        threshold))
        got = tnms.nms_mask(torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(v),
                            threshold)
        assert got.dtype == torch.bool and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] and want.sum() == 1  # identical boxes: the first of the tie alone
