"""Rank-0 experiment logger: metric routing + dashboard images.

The counterpart of ``jolineedle_tpu/observe/logger.py`` without JAX: the
startup summary counts the parameters of the port's modules.

Same behavior as the reference Logger (reference: src/logger.py:19-183):
startup summary (param counts replace torchinfo), argv + config tables,
substring-based metric-name -> plot-window routing (yolo -> "Yolo losses",
map -> "map", ...), the ``supervised_`` prefix marking teacher-forced vs
autoregressive eval, episode-length std line, and image panels for model
predictions / generated samples / worst failures.
"""

from __future__ import annotations

import sys

import numpy as np

from .visualizer import VisdomPlotter

LEGENDS = {
    "prop_patches_found": "average % of bbox patches found in images",
    "prop_bbox_found": "average % of bboxes found in images",
    "episode_length": "average episode length",
    "stop_used": "% of rollouts stopped by the model",
    "stop_misused": "% of rollouts stopped too early by the model",
}

MODEL_TABLE_KEYS = [
    "model_type", "block_size", "n_channels", "dropout", "patch_size",
    "image_processor", "use_pos_emb", "concat_emb", "decoder_pos_encoding",
]
TRAIN_TABLE_KEYS = [
    "loss_mode", "min_keypoints", "max_keypoints", "binomial_keypoints",
    "rotations", "translations", "learning_rate", "batch_size", "device",
    "num_workers", "stop_weight", "weight_decay",
]


class Logger:
    def __init__(self, train_config, model_config):
        self.train_config = train_config
        self.model_config = model_config
        self.visdom = VisdomPlotter(train_config.env_name)

    # --- startup ---------------------------------------------------------
    def model_summary(self, model) -> str:
        """Parameter-count summary per top-level module of ``model`` (each
        transformer block on its own line; replaces torchinfo, reference:
        src/logger.py:26-47)."""
        counts = {}
        for name, p in model.named_parameters():
            parts = name.split(".")
            key = ".".join(parts[:2]) if parts[0] == "h" else parts[0]
            counts[key] = counts.get(key, 0) + p.numel()
        lines = []
        total = 0
        for top_key, n in counts.items():
            total += n
            lines.append(f"{top_key:40s} {n:>12,d} params")
        lines.append(f"{'TOTAL':40s} {total:>12,d} params")
        text = "\n".join(lines)
        print(text)
        return text

    def log_start(self, model):
        summary = self.model_summary(model)
        self.visdom.add_table("Arguments", {"argv": " ".join(sys.argv)})
        self.visdom.add_table("Model summary", {"params": summary})
        self.visdom.add_table(
            "Model config",
            {
                k: getattr(self.model_config, k, None)
                for k in MODEL_TABLE_KEYS
            },
        )
        self.visdom.add_table(
            "Training config",
            {
                k: getattr(self.train_config, k, None)
                for k in TRAIN_TABLE_KEYS
            },
        )

    # --- per-eval ----------------------------------------------------------
    @staticmethod
    def route(name: str):
        """Metric name -> plot window (reference: src/logger.py:121-156)."""
        if "yolo" in name:
            return "Yolo losses"
        if "map" in name:
            return "map"
        if name.startswith(("stopped_inside_bbox", "prop_patches_found",
                            "prop_bbox_found")):
            return "BBox patches metrics"
        if name == "episode_length":
            return "Episode length"
        if "stop" in name:
            return "Stop action metrics"
        if "loss" in name:
            return "loss"
        if "action" in name:
            return "action"
        if "label" in name:
            return "label"
        return name

    def log_to_visdom(self, metrics: dict, images: dict, dataset_name: str):
        windows = set()
        for name, values in metrics.items():
            eval_mode = "auto-regressive"
            if name.startswith("supervised_"):
                name = name[len("supervised_"):]
                eval_mode = "on generated trajectories"
            legend = LEGENDS.get(name, name)
            plot_name = self.route(name)
            if plot_name == "BBox patches metrics":
                plot_name = f"BBox patches metrics ({dataset_name})"
            window = f"{plot_name} ({eval_mode})"
            if name == "episode_length":
                self.visdom.add_scalar(
                    window, f"episode length std ({dataset_name})", np.std(values)
                )
            value = np.mean([v for v in np.atleast_1d(values)])
            self.visdom.add_scalar(window, f"{legend} ({dataset_name})", value)
            windows.add(window)

        for window in windows:
            self.visdom.upload_lineplot(window)

        if images.get("model_images"):
            self.visdom.add_images(
                f"Model predictions ({dataset_name})", images["model_images"]
            )
        if images.get("sample_images"):
            self.visdom.add_images(
                f"Generated samples ({dataset_name})", images["sample_images"]
            )
        if images.get("worst_images"):
            self.visdom.add_images(
                f"Model failures ({dataset_name})", images["worst_images"]
            )

    def save_visdom(self, log_dir):
        self.visdom.save(log_dir)
