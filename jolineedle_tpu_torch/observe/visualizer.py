"""Stateful dashboard plotter: visdom-compatible, offline-capable.

A copy of ``jolineedle_tpu/observe/visualizer.py`` (numpy and pickle only).

Plays the role of the reference's ``VisdomPlotter`` (reference:
src/visualizer.py:15-242): line plots with full history, image grids,
hyperparameter tables, pickle persistence + reload-to-server. Unlike the
reference it degrades gracefully when no visdom server (or package) is
available — all state is buffered and persisted to ``visdom.pkl`` so a
dashboard can be (re)published later (``republish``).
"""

from __future__ import annotations

import pickle
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def _try_visdom(env_name: str, port: int = 8097):
    try:
        import visdom  # type: ignore

        viz = visdom.Visdom(port=port, env=env_name, raise_exceptions=True)
        if viz.check_connection():
            return viz
    except Exception:
        pass
    return None


class VisdomPlotter:
    def __init__(self, env_name: str, port: int = 8097, offline: bool = False):
        self.env_name = env_name
        self.port = port
        self.lines: Dict[str, Dict[str, List[float]]] = defaultdict(dict)
        self.images: Dict[str, np.ndarray] = {}
        self.texts: Dict[str, str] = {}
        self.viz = None if offline else _try_visdom(env_name, port)

    # --- plotting API -------------------------------------------------------
    def add_scalar(self, window: str, legend: str, value: float):
        self.lines[window].setdefault(legend, []).append(float(value))

    def upload_lineplot(self, window: str):
        if self.viz is None:
            return
        series = self.lines[window]
        if not series:
            return
        try:
            # One stacked call redraws the whole window — per-series calls
            # with update=None would each REPLACE the window, leaving only
            # the last legend visible (the reference stacks for the same
            # reason, reference: src/visualizer.py:113-134). Shorter series
            # are NaN-padded (plotly renders gaps).
            n = max(len(ys) for ys in series.values())
            Y = np.full((n, len(series)), np.nan)
            for j, ys in enumerate(series.values()):
                Y[: len(ys), j] = ys
            X = np.tile(np.arange(n)[:, None], (1, len(series)))
            if len(series) == 1:
                Y, X = Y[:, 0], X[:, 0]
            self.viz.line(
                Y=Y,
                X=X,
                win=window,
                update=None,
                opts=dict(title=window, legend=list(series.keys())),
            )
        except Exception:
            self.viz = None

    def add_images(self, window: str, images: List[np.ndarray]):
        """images: list of [C, H, W] float arrays in [0, 1]."""
        if not images:
            return
        h = max(im.shape[1] for im in images)
        w = max(im.shape[2] for im in images)
        padded = [
            np.pad(im, ((0, 0), (0, h - im.shape[1]), (0, w - im.shape[2])))
            for im in images
        ]
        grid = np.stack(padded)
        self.images[window] = grid
        if self.viz is not None:
            try:
                self.viz.images(grid, win=window, opts=dict(title=window))
            except Exception:
                self.viz = None

    def add_gradient_flow(self, window: str, grads: dict):
        """Per-layer gradient magnitude distribution (reference:
        src/visualizer.py:72-104 — a violin plot; here min/mean/max series
        per layer, which the reference never wires into a trainer either).

        ``grads``: flat dict name -> gradient array.
        """
        stats = {
            name: (
                float(np.abs(g).min()),
                float(np.abs(g).mean()),
                float(np.abs(g).max()),
            )
            for name, g in grads.items()
        }
        for name, (gmin, gmean, gmax) in stats.items():
            self.add_scalar(window, f"{name}/min", gmin)
            self.add_scalar(window, f"{name}/mean", gmean)
            self.add_scalar(window, f"{name}/max", gmax)
        self.upload_lineplot(window)

    def add_table(self, window: str, data: dict):
        text = "<table>" + "".join(
            f"<tr><td>{k}</td><td>{v}</td></tr>" for k, v in data.items()
        ) + "</table>"
        self.texts[window] = text
        if self.viz is not None:
            try:
                self.viz.text(text, win=window, opts=dict(title=window))
            except Exception:
                self.viz = None

    # --- persistence ----------------------------------------------------------
    def save(self, directory):
        path = Path(directory) / "visdom.pkl"
        path.parent.mkdir(parents=True, exist_ok=True)
        state = {
            "env_name": self.env_name,
            "lines": {k: dict(v) for k, v in self.lines.items()},
            "images": self.images,
            "texts": self.texts,
        }
        with open(path, "wb") as f:
            pickle.dump(state, f)

    @classmethod
    def load(cls, path, env_name: Optional[str] = None) -> "VisdomPlotter":
        with open(path, "rb") as f:
            state = pickle.load(f)
        plotter = cls(env_name or state["env_name"])
        plotter.lines = defaultdict(dict, state["lines"])
        plotter.images = state.get("images", {})
        plotter.texts = state.get("texts", {})
        return plotter

    def republish(self):
        """Re-push all buffered state to a running server (reference:
        scripts/load_visdom.py:13-32). Degrades gracefully mid-push, like
        every other upload path."""
        if self.viz is None:
            self.viz = _try_visdom(self.env_name, self.port)
        for window in list(self.lines):
            self.upload_lineplot(window)
        try:
            for window, grid in self.images.items():
                if self.viz is not None:
                    self.viz.images(grid, win=window, opts=dict(title=window))
            for window, text in self.texts.items():
                if self.viz is not None:
                    self.viz.text(text, win=window, opts=dict(title=window))
        except Exception:
            self.viz = None
