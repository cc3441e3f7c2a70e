"""Run the train CLI with the train step's device draws seeded apart.

``--seed`` seeds every draw of a run: the host batches (the order rng and
each batch's seed, ``train/trainer.py::train_batches``), the test ids, the
eval rollouts' seeds, and the trainer's ``torch.Generator``
(``Trainer.generator``), which draws the train step's dropout masks and
photometric augmentations on the device. This launcher runs
``python -m jolineedle_tpu_torch.main`` with the same flags, but seeds that
generator with ``--stream-seed K`` once the trainer is built. Two runs of
one ``--seed`` (and one ``--init-from``) then share their initial weights
and host batches and differ only in the step's device draws, as two runs of
the JAX package that share a seed differ only in their step keys:

    python -m jolineedle_tpu_torch.scripts.stream_seed --stream-seed 2 -- \\
        --seed 1 --init-from runs/jax_init/r3_sup_yolox-nano <the recipe's flags>

The CLI itself has no such flag, as the JAX package's has none. A resumed
run (``--resume-training``) restores the generator saved with its train
state, which wins over ``K``. One process only: the ranks of a
data-parallel run start from fresh interpreters, so ``--devices`` naming
more than one device raises.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from ..config import args_to_config, get_args
from ..main import cli
from ..train.trainer import Trainer


@contextlib.contextmanager
def stream_seeded(stream_seed: int):
    """While open, every trainer built seeds its generator with
    ``stream_seed`` at the end of its construction."""
    init = Trainer.__init__

    def seeded_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.generator.manual_seed(stream_seed)

    Trainer.__init__ = seeded_init
    try:
        yield
    finally:
        Trainer.__init__ = init


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                     epilog="the CLI's flags follow --")
    parser.add_argument("--stream-seed", type=int, required=True,
                        help="the seed of the train step's device draws")
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    args, flags = parser.parse_args(argv[:cut]), argv[cut + 1:]
    train_config, _ = args_to_config(get_args(flags))
    if len(train_config.gpu_ids) > 1:
        raise ValueError(f"--stream-seed runs one process; --devices {train_config.gpu_ids}"
                         " would start ranks that do not take it")
    with stream_seeded(args.stream_seed):
        return cli(flags)


if __name__ == "__main__":
    main()
