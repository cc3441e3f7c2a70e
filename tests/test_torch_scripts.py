"""The port's data and log scripts (``jolineedle_tpu_torch/scripts/``)
against their counterparts under root ``scripts/``, on the CPU.

- ``make_toyds_big``: its recipe at a few images writes the files the JAX
  package's ``generate_toy_dataset`` writes with that recipe (pixels, boxes,
  lists), with and without ``--runway``; the CLI asks the generator for
  what the JAX script asks (1,500 / 150 images, 320 x 448, seed 0, context);
- ``load_visdom``: republishes a port run's ``visdom.pkl`` with no server
  to reach, into the run's env or ``--env_name``;
- ``prepare``: on a synthesized LARD tree it writes the JAX script's lists
  and box files, and the lists load through the port's ``build_datasets``;
- ``dump_metric_curves``: reads a port run's ``visdom.pkl`` and prints what
  the JAX script prints.
"""

import csv
import importlib.util
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from jolineedle_tpu.data.toy import generate_toy_dataset as jax_generate
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.data.dataset import build_datasets
from jolineedle_tpu_torch.data.toy import generate_toy_dataset
from jolineedle_tpu_torch.main import main as train_main
from jolineedle_tpu_torch.scripts import dump_metric_curves, load_visdom, make_toyds_big

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _root_script(name):
    """A module of root ``scripts/`` (not a package), loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root: Path) -> dict:
    """Every file under ``root`` by relative path: an image's pixels, a
    text file's lines with ``root`` taken out."""
    out = {}
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        rel = str(path.relative_to(root))
        if path.suffix == ".png":
            out[rel] = np.asarray(Image.open(path))
        else:
            out[rel] = path.read_text().replace(str(root), "<root>")
    return out


@pytest.mark.parametrize("runway", [False, True], ids=["boxes", "runway"])
def test_make_toyds_big_writes_the_jax_generators_files(tmp_path, runway):
    got = make_toyds_big.make_toyds_big(tmp_path / "port", runway=runway, n_train=3, n_test=2)
    want = jax_generate(tmp_path / "jax", n_train=3, n_test=2, image_size=(320, 448), seed=0,
                        context=True, box_size=(30, 120), runway=runway)
    got, want = _files(Path(got)), _files(Path(want))
    assert got.keys() == want.keys() and len(got) > 5
    for rel, value in want.items():
        if isinstance(value, str):
            assert got[rel] == value, rel
        else:
            np.testing.assert_array_equal(got[rel], value, err_msg=rel)


@pytest.mark.parametrize("argv", [["out"], ["out", "--box-size", "12", "40"],
                                  ["out", "--runway"]])
def test_make_toyds_big_cli_asks_for_the_jax_scripts_recipe(argv, monkeypatch):
    calls = []
    record = lambda *args, **kwargs: calls.append((args, kwargs)) or Path(args[0])
    jax_script = _root_script("make_toyds_big")
    monkeypatch.setattr(jax_script, "generate_toy_dataset", record)
    monkeypatch.setattr(make_toyds_big, "generate_toy_dataset", record)
    monkeypatch.setattr(sys, "argv", ["make_toyds_big.py"] + argv)
    jax_script.main()
    make_toyds_big.main(argv)
    (jax_args, want), (port_args, got) = calls
    assert jax_args == port_args == ("out",)
    assert got == want and want["n_train"] == 1500 and want["n_test"] == 150


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port run directory: two supervised iterations with a test after
    each, so that its visdom.pkl holds two points a metric."""
    root = tmp_path_factory.mktemp("scripts")
    generate_toy_dataset(root / "toy", n_train=3, n_test=1, image_size=(128, 160), seed=1,
                         box_size=(8, 20))
    flags = [
        "--training-mode", "supervised", "--dataset-dir", str(root / "toy"),
        "--work-dir", str(root / "out"), "--env-name", "run", "--model-type", "gpt-pico",
        "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
        "--concat-embeddings", "--max-seq-len", "3", "--patch-size", "32",
        "--minimum-image-size", "0", "--batch-size", "2", "--max-det-patches", "2",
        "--max-boxes", "2", "--compute-dtype", "float32", "--max-iters", "3",
        "--test-every", "1", "--test-samples", "1", "--devices", "0",
    ]
    train_main(tconfig.get_args(flags), device="cpu")
    return root / "out" / "run"


@pytest.mark.parametrize("env_name", [None, "restored"])
def test_load_visdom_republishes_without_a_server(port_run, env_name):
    state = pickle.loads((port_run / "visdom.pkl").read_bytes())
    assert state["lines"]
    argv = [str(port_run / "visdom.pkl"), "-v"] + (["--env_name", env_name] if env_name else [])
    plotter = load_visdom.main(argv)
    assert plotter.viz is None  # no server reached: nothing published
    assert plotter.env_name == (env_name or "run")
    assert dict(plotter.lines) == state["lines"]
    assert plotter.texts == state["texts"]


@pytest.mark.parametrize("legends", [[], ["map"], ["loss", "prop"]])
def test_dump_metric_curves_reads_a_port_run(port_run, legends, monkeypatch, capsys):
    out = {}
    for name, module in (("jax", _root_script("dump_metric_curves")),
                         ("port", dump_metric_curves)):
        monkeypatch.setattr(sys, "argv", ["dump_metric_curves.py", str(port_run)] + legends)
        capsys.readouterr()
        module.main()
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    lines = out["port"].splitlines()
    if legends:
        assert lines[0].startswith("| eval # |") and len(lines) == 2 + 3  # 2 tests + the final
    else:
        assert any(line.endswith(": 3 points") for line in lines)


def _write_csv(path: Path, rows):
    """rows: [(image_rel, quad_xs, quad_ys)], as ``tests/test_prepare.py``."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "x_A", "y_A", "x_B", "y_B", "x_C", "y_C",
                                          "x_D", "y_D"], delimiter=";")
        w.writeheader()
        for image, xs, ys in rows:
            w.writerow({"image": image, **{f"x_{c}": x for c, x in zip("ABCD", xs)},
                        **{f"y_{c}": y for c, y in zip("ABCD", ys)}})


def _lard_tree(root: Path):
    """A LARD layout: three train rows (one image missing, one box too big)
    and a test image in two of the three test csvs; real 64 x 96 images."""
    rng = np.random.default_rng(0)

    def image(path):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)).save(path)

    _write_csv(root / "LARD_train.csv", [
        ("images/a.png", [10.6, 30, 20, 12.2], [5, 40.4, 18, 22]),
        ("images/missing.png", [0, 10, 10, 0], [0, 10, 10, 0]),
        ("images/big.png", [0, 500, 500, 0], [0, 500, 500, 0]),
    ])
    image(root / "images" / "a.png")
    image(root / "images" / "big.png")
    synth = root / "LARD_test_synth"
    nominal = root / "LARD_test_real/LARD_test_real_nominal_cases"
    domain = root / "LARD_test_real/LARD_test_real_domain_adaptation"
    _write_csv(synth / "LARD_test_synth.csv", [("t1.png", [41, 52, 53, 44], [4, 3, 12, 11])])
    _write_csv(nominal / "LARD_test_real_nominal_cases.csv", [])
    _write_csv(domain / "LARD_test_real_domain_adaptation.csv",
               [("t2.png", [7, 28, 29, 6], [36, 59, 58, 37])])
    image(synth / "t1.png")
    image(domain / "t2.png")


def test_prepare_writes_the_jax_scripts_lists_that_load_in_the_port(tmp_path):
    _lard_tree(tmp_path / "port")
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    runs = {
        "port": [sys.executable, "-m", "jolineedle_tpu_torch.scripts.prepare"],
        "jax": [sys.executable, str(ROOT / "scripts" / "prepare.py")],
    }
    out = {}
    for name, cmd in runs.items():
        done = subprocess.run(cmd + ["--dataset-path", str(tmp_path / name)], cwd=ROOT,
                              capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr
        out[name] = done.stdout
    assert out["port"] == out["jax"] and out["port"].rstrip().endswith("OK")
    assert "non-existent images" in out["port"] and "big bounding boxes" in out["port"]
    written = lambda name: {k: v for k, v in _files(tmp_path / name).items()
                            if k.endswith(".txt")}
    assert written("port") == written("jax")
    assert (tmp_path / "port" / "train_bboxes" / "a.txt").read_text() == "0 11 5 30 40"

    train, test = build_datasets(tmp_path / "port", patch_size=32, max_ep_len=3,
                                 min_keypoints=1, max_keypoints=1, rotations=False,
                                 translations=False)
    assert [Path(p).name for p in train.image_paths] == ["a.png"]
    assert sorted(Path(p).name for p in test.image_paths) == ["t1.png", "t2.png"]
    item = train.__getitem__(0, np.random.default_rng(0))
    assert item["image"].shape[:2] == (64, 96)
    np.testing.assert_array_equal(np.asarray(item["bboxes"]).reshape(-1, 4), [[11, 5, 30, 40]])
