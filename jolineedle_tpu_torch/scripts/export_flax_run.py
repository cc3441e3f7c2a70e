"""Export a port run directory as a JAX package run directory.

Writes ``config.json`` and ``metrics.json`` and, for each of the run's
``checkpoint_best.pt`` and ``checkpoint.pt``, the JAX package's
``checkpoint_best.msgpack`` / ``checkpoint.msgpack`` of the same weights and
BatchNorm statistics (``models/bridge.py::torch_to_flax``, the port's flax
msgpack writer), so the JAX package's own scripts can test the port's
trained weights:

    python -m jolineedle_tpu_torch.scripts.export_flax_run <run_dir> <out_dir> \\
        [--compute-dtype float32] [--dataset-dir DIR]
    JAX_PLATFORMS=cpu python scripts/eval_checkpoint.py <out_dir>

``--compute-dtype`` and ``--dataset-dir`` rewrite those entries of the
exported ``config.json`` (both its ``train`` and ``model`` sections hold the
dtype). Runs on the CPU; writes nothing into ``run_dir``.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

from .. import checkpoint as ckpt
from ..config import config_from_file
from ..env.actions import get_actions_info
from ..models.bridge import torch_to_flax
from ..models.gpt import GPT

EXPORTS = ((ckpt.CKPT_BEST, ckpt.FLAX_BEST), (ckpt.CKPT_LAST, ckpt.FLAX_LAST))


def export(run_dir: Path, out_dir: Path, compute_dtype=None, dataset_dir=None) -> list:
    """Write the JAX run directory; returns the msgpack files written."""
    out_dir.mkdir(parents=True, exist_ok=True)
    config = json.loads((run_dir / "config.json").read_text())
    if compute_dtype is not None:
        config["train"]["compute_dtype"] = config["model"]["compute_dtype"] = compute_dtype
    if dataset_dir is not None:
        config["train"]["dataset_dir"] = str(dataset_dir)
    (out_dir / "config.json").write_text(json.dumps(config, indent=4))
    if (run_dir / "metrics.json").is_file():
        shutil.copy2(run_dir / "metrics.json", out_dir / "metrics.json")
    train_config, model_config = config_from_file(out_dir / "config.json")
    written = []
    for pt, msgpack in EXPORTS:
        if (run_dir / pt).is_file():
            model = GPT.from_config(model_config, get_actions_info(train_config), device="cpu")
            ckpt.load_model_file(model, run_dir / pt)
            written.append(ckpt.write_msgpack(out_dir / msgpack,
                                              torch_to_flax(model.state_dict(), model)))
    if not written:
        raise FileNotFoundError(f"{run_dir} holds neither {EXPORTS[0][0]} nor {EXPORTS[1][0]}")
    return written


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("run_dir", type=Path)
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default=None)
    parser.add_argument("--dataset-dir", default=None)
    args = parser.parse_args(argv)
    written = export(args.run_dir, args.out_dir, args.compute_dtype, args.dataset_dir)
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
