"""Dump metric curves from a run's saved ``visdom.pkl``.

A copy of ``scripts/dump_metric_curves.py`` (it imports neither package), so
that the port's package holds every script a user runs.

The trainers push every test-cycle metric into the offline visdom state
(observe/visualizer.py, window -> legend -> [values per eval]); this
prints selected legends as a markdown table, one row per eval cycle — the
offline replacement for reading curves off a live visdom dashboard
(reference equivalent: scripts/load_visdom.py + a browser).

Usage:
    python -m jolineedle_tpu_torch.scripts.dump_metric_curves <run_dir> [legend ...]

With no legends given, lists every window/legend and its series length.
Legend matching is by substring over "window/legend".
"""

import pickle
import sys


def main() -> None:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    run_dir, wanted = sys.argv[1], sys.argv[2:]
    with open(f"{run_dir}/visdom.pkl", "rb") as f:
        state = pickle.load(f)
    lines = state["lines"]

    if not wanted:
        for window, series in sorted(lines.items()):
            for legend, ys in sorted(series.items()):
                print(f"{window}/{legend}: {len(ys)} points")
        return

    cols = []
    for window, series in sorted(lines.items()):
        for legend, ys in sorted(series.items()):
            name = f"{window}/{legend}"
            if any(w in name for w in wanted):
                cols.append((name, ys))
    if not cols:
        raise SystemExit(f"no legend matched {wanted}")
    n = max(len(ys) for _, ys in cols)
    print("| eval # | " + " | ".join(name for name, _ in cols) + " |")
    print("|" + "---|" * (len(cols) + 1))
    for i in range(n):
        row = [
            f"{ys[i]:.3f}" if i < len(ys) else ""
            for _, ys in cols
        ]
        print(f"| {i + 1} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
