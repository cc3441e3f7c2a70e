"""Write the pinned 1.5k-image toy dataset, with the port's generator.

The counterpart of ``scripts/make_toyds_big.py``, with the same arguments:

    python -m jolineedle_tpu_torch.scripts.make_toyds_big [out_dir]
        [--box-size MIN MAX] [--runway]

1,500 train / 150 test context-glow images of 320 x 448 (a 5 x 7 grid at
patch 64), seed 0, written by ``data/toy.py``, which writes the same files as
the JAX package's generator. ``out_dir`` defaults to ``toyds_big`` in the
working directory (the JAX script's default is an absolute path of its own
machine). The run scripts' default ``DATASET_DIR`` is this set.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.toy import generate_toy_dataset

N_TRAIN, N_TEST, IMAGE_SIZE, SEED = 1500, 150, (320, 448), 0


def make_toyds_big(out_dir, box_size=(30, 120), runway: bool = False, n_train: int = N_TRAIN,
                   n_test: int = N_TEST) -> Path:
    """The recipe: context images of IMAGE_SIZE from SEED, targets of
    ``box_size`` pixels a side, or with ``runway`` one elongated target
    across 3-6 patches in a line; ``n_train`` and ``n_test`` images."""
    return generate_toy_dataset(out_dir, n_train=n_train, n_test=n_test, image_size=IMAGE_SIZE,
                                seed=SEED, context=True, box_size=tuple(box_size),
                                runway=runway)


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out_dir", nargs="?", default="toyds_big",
                        help="destination directory (default: toyds_big)")
    parser.add_argument("--box-size", nargs=2, type=int, default=(30, 120),
                        metavar=("MIN", "MAX"),
                        help="target edge-length range in px; 12 40 gives the LARD-like"
                        " sub-patch box/patch ratio variant")
    parser.add_argument("--runway", action="store_true",
                        help="LARD runway TOPOLOGY variant: one elongated contiguous target"
                        " spanning 3-6 patches in a line per image (overrides --box-size)")
    return parser.parse_args(argv)


def main(argv=None) -> Path:
    args = get_args(argv)
    path = make_toyds_big(args.out_dir, args.box_size, args.runway)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
