"""Push a pickled dashboard state back onto a live visdom server.

The counterpart of ``scripts/load_visdom.py``, with the same arguments:

    python -m jolineedle_tpu_torch.scripts.load_visdom runs/my_exp/visdom.pkl
    python -m jolineedle_tpu_torch.scripts.load_visdom state.pkl --env_name my_exp -v

The trainers keep their dashboard as ``<work_dir>/<env>/visdom.pkl``
(``observe/visualizer.py``); this restores every line plot, image panel and
table from it through ``VisdomPlotter.load(...).republish()``. Without the
``visdom`` package or a server it publishes nothing (the plotter's ``viz``
stays None).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from ..observe.visualizer import VisdomPlotter


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Restore a saved visdom.pkl dashboard onto a running visdom server.")
    parser.add_argument("file", help="path to the pickled dashboard state")
    parser.add_argument("--env_name", default=None,
                        help="visdom environment to publish into (default: the pickle's"
                        " parent directory name, i.e. the run's env)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="enable INFO-level logging")
    return parser.parse_args(argv)


def main(argv=None) -> VisdomPlotter:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING)
    env = args.env_name or Path(args.file).resolve().parent.name
    logging.info("republishing %s into env %r", args.file, env)
    plotter = VisdomPlotter.load(args.file, env)
    plotter.republish()
    return plotter


if __name__ == "__main__":
    main()
