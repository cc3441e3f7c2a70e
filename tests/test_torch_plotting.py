"""The port's trajectory plots (jolineedle_tpu_torch/utils/plotting.py)
against the JAX package's (jolineedle_tpu/utils/plotting.py), on the CPU.

- ``plot_model_prediction`` draws the same pixels as the JAX function for
  the same inputs (uint8 and float images, with and without each box list):
  the arrays are equal exactly;
- ``save_batch`` and the infer CLI's ``save_image`` write files that decode
  to the JAX files' pixels;
- without matplotlib a drawing call raises an ImportError that names it and
  the caller;
- importing the port's trainers, CLIs and scripts does not import
  matplotlib.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jolineedle_tpu.utils.geometry as jgeometry
import jolineedle_tpu.utils.plotting as jplotting
import jolineedle_tpu_torch.utils.geometry as tgeometry
import jolineedle_tpu_torch.utils.plotting as tplotting

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
P, NV, NH = 32, 3, 5


def _inputs(seed, dtype):
    """An image of NV x NH patches, a trajectory that revisits a patch, and
    box rows (xyxy pixels)."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (NV * P, NH * P, 3), dtype=np.uint8)
    if dtype == "float":
        image = image.astype(np.float32) / 255.0
    positions = np.array([[0, 0], [0, 1], [1, 1], [1, 2], [1, 1], [2, 4]], np.int32)
    patches = rng.integers(0, 256, (len(positions), P, P, 3), dtype=np.uint8)
    xy = rng.uniform(0, [NH * P - 40, NV * P - 40], (3, 2))
    rows = np.concatenate([xy, xy + rng.uniform(5, 40, (3, 2))], 1)
    return image, patches, positions, rows


def _bboxes(geometry, rows):
    return [geometry.BBox(geometry.Position(y=b[1], x=b[0]), geometry.Position(y=b[3], x=b[2]))
            for b in rows]


@pytest.mark.parametrize("dtype", ["uint8", "float"])
@pytest.mark.parametrize("boxes", ["none", "true", "predicted", "both", "true_rows"])
def test_plot_model_prediction_equals_jax(dtype, boxes):
    image, patches, positions, rows = _inputs(7, dtype)
    drawn = {}
    for name, plotting, geometry in (("jax", jplotting, jgeometry),
                                     ("port", tplotting, tgeometry)):
        kwargs = {}
        if boxes in ("true", "both"):
            kwargs["true_bboxes"] = _bboxes(geometry, rows)
        if boxes == "true_rows":  # xyxy rows, converted by the function
            kwargs["true_bboxes"] = list(rows)
        if boxes in ("predicted", "both"):
            kwargs["predicted_bboxes"] = _bboxes(geometry, rows[::-1] + 3.0)
        drawn[name] = plotting.plot_model_prediction(image, patches, positions, **kwargs)
    assert drawn["port"].dtype == drawn["jax"].dtype == np.float32
    assert drawn["port"].shape == drawn["jax"].shape and drawn["port"].shape[0] == 3
    np.testing.assert_array_equal(drawn["port"], drawn["jax"])


def test_saved_files_decode_to_the_jax_pixels(tmp_path):
    from infer import save_image as jax_save_image

    image, patches, positions, rows = _inputs(3, "uint8")
    panel = tplotting.plot_model_prediction(image, patches, positions,
                                            true_bboxes=_bboxes(tgeometry, rows))
    jax_save_image(panel, tmp_path / "jax.png")
    tplotting.save_image(panel, tmp_path / "port.png")
    rng = np.random.default_rng(5)
    for dtype in ("uint8", "float"):
        batch = rng.integers(0, 256, (6, 16, 24, 3), dtype=np.uint8)
        if dtype == "float":
            batch = batch.astype(np.float32) / 255.0
        jplotting.save_batch(batch, tmp_path / f"jax_{dtype}.png")
        tplotting.save_batch(batch, tmp_path / f"port_{dtype}.png")
    for name in ("", "_uint8", "_float"):
        want = np.asarray(Image.open(tmp_path / f"jax{name}.png"))
        got = np.asarray(Image.open(tmp_path / f"port{name}.png"))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_drawing_without_matplotlib_raises_a_named_import_error(monkeypatch):
    image, patches, positions, _ = _inputs(1, "uint8")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not tplotting.matplotlib_available()
    with pytest.raises(ImportError, match="matplotlib is not installed") as raised:
        tplotting.plot_model_prediction(image, patches, positions, what="the test panel")
    assert "the test panel" in str(raised.value)
    with pytest.raises(ImportError, match="infer --output-dir .* matplotlib"):
        tplotting.pyplot("infer --output-dir")


def test_the_port_imports_without_matplotlib():
    """The trainers, the CLIs and the scripts import no matplotlib; only a
    drawing call does."""
    code = (
        "import sys\n"
        "import jolineedle_tpu_torch.train.reinforce, jolineedle_tpu_torch.train.supervised\n"
        "import jolineedle_tpu_torch.infer, jolineedle_tpu_torch.main\n"
        "import jolineedle_tpu_torch.scripts.eval_checkpoint, jolineedle_tpu_torch.utils.flops\n"
        "import jolineedle_tpu_torch.utils.plotting\n"
        "print('LOADED', sorted(n for n in sys.modules if n.split('.')[0] == 'matplotlib'))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "LOADED []"
