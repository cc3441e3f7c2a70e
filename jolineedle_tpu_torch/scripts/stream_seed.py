"""Run the train CLI with the train step's device draws taken apart.

``--seed`` seeds every draw of a run: the host batches (the order rng and
each batch's seed, ``train/trainer.py::train_batches``), the test ids, the
eval rollouts' seeds, and the trainer's ``torch.Generator``
(``Trainer.generator``), which draws the train step's dropout masks and
photometric augmentations on the device. This launcher runs
``python -m jolineedle_tpu_torch.main`` with the same flags, but once the
trainer is built it changes where the step's draws come from:

- ``--stream-seed K`` seeds that generator with ``K``. Two runs of one
  ``--seed`` (and one ``--init-from``) then share their initial weights and
  host batches and differ only in the step's device draws, as two runs of
  the JAX package that share a seed differ only in their step keys;
- ``--jax-keys N`` puts the supervised step on the key route
  (``Trainer.key_stream``): it draws the JAX package's own numbers, from
  the key chain that the JAX loop of ``--steps-per-dispatch N`` hands its
  steps from ``PRNGKey(--seed)`` (``utils/jax_random.KeyStream``). The run's
  own ``--steps-per-dispatch`` still sets its chunks;
- ``--tpu-default-precision`` computes the train step's float32 Dense
  products as a TPU does at its default precision
  (``models/gpt.py::TpuDefaultDot``).

    python -m jolineedle_tpu_torch.scripts.stream_seed --jax-keys 1 -- \\
        --seed 1 --init-from runs/jax_init/r3_sup_yolox-nano <the recipe's flags>

The CLI itself has no such flags, as the JAX package's has none. A resumed
run (``--resume-training``) restores the generator or the key stream saved
with its train state, which wins over ``K`` and ``N``. One process only:
the ranks of a data-parallel run start from fresh interpreters, so
``--devices`` naming more than one device raises.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from ..config import args_to_config, get_args
from ..main import cli
from ..train.trainer import Trainer
from ..utils.jax_random import KeyStream


@contextlib.contextmanager
def stream_seeded(stream_seed=None, jax_keys=None, tpu_default_precision=False):
    """While open, every trainer built ends its construction by seeding its
    generator with ``stream_seed``, taking the key chain of ``jax_keys``
    steps a dispatch from its ``--seed``, and turning its model's
    ``tpu_default_precision`` on (each where given)."""
    init = Trainer.__init__

    def seeded_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if stream_seed is not None:
            self.generator.manual_seed(stream_seed)
        if jax_keys is not None:
            self.key_stream = KeyStream(self.config.seed, jax_keys)
        if tpu_default_precision:
            self.model.tpu_default_precision = True

    Trainer.__init__ = seeded_init
    try:
        yield
    finally:
        Trainer.__init__ = init


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                     epilog="the CLI's flags follow --")
    route = parser.add_mutually_exclusive_group()
    route.add_argument("--stream-seed", type=int, default=None,
                       help="the seed of the train step's device draws")
    route.add_argument("--jax-keys", type=int, default=None, metavar="N",
                       help="draw from the JAX loop's step keys of --steps-per-dispatch N")
    parser.add_argument("--tpu-default-precision", action="store_true",
                        help="the train step's float32 Dense products at a TPU's default "
                             "precision")
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    args, flags = parser.parse_args(argv[:cut]), argv[cut + 1:]
    if args.stream_seed is None and args.jax_keys is None and not args.tpu_default_precision:
        parser.error("give --stream-seed, --jax-keys or --tpu-default-precision")
    if args.jax_keys is not None and args.jax_keys < 1:
        parser.error(f"--jax-keys {args.jax_keys} < 1")
    train_config, _ = args_to_config(get_args(flags))
    if len(train_config.gpu_ids) > 1:
        raise ValueError(f"stream_seed runs one process; --devices {train_config.gpu_ids}"
                         " would start ranks that do not take it")
    if args.jax_keys is not None and train_config.training_mode != "supervised":
        raise ValueError("--jax-keys draws the supervised step's keys; the run trains "
                         f"{train_config.training_mode}")
    with stream_seeded(args.stream_seed, args.jax_keys, args.tpu_default_precision):
        return cli(flags)


if __name__ == "__main__":
    main()
