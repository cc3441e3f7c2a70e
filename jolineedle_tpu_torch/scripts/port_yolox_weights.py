"""Convert an upstream (Megvii) YOLOX torch checkpoint to the JAX package's
ported-weights file, without JAX.

The counterpart of ``scripts/port_yolox_weights.py``, with the same flags:

    python -m jolineedle_tpu_torch.scripts.port_yolox_weights \\
        --checkpoint yolox_s.pth --variant yolox-s \\
        --output yolox_s_coco.msgpack [--backbone-only]

It maps the checkpoint onto a fresh port ``NeedleYOLOX`` of ``--variant``
with ``--num-classes`` classes (``models/port.py``, not strict: a missing
key and class predictions of another class count keep the fresh init) and
writes ``{"params": ..., "batch_stats": ...}`` of its flax tree with the
port's msgpack writer: the file the JAX script writes, which either
package's ``--detection-checkpoint`` loads. With ``--backbone-only`` it
holds the YOLOPAFPN subtree only. ``--patch-size`` is accepted for the JAX
script's sake (its init traces a patch); no weight depends on it. Runs on
the CPU.
"""

from __future__ import annotations

import argparse

from ..checkpoint import write_msgpack
from ..models.bridge import yolox_torch_to_flax
from ..models.init import init_like_flax
from ..models.port import load_torch_checkpoint, port_yolox_state_dict
from ..models.yolox import NeedleYOLOX


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkpoint", required=True, help="torch .pth file")
    parser.add_argument("--variant", default="yolox-s", help="yolox size variant of the ckpt")
    parser.add_argument("--patch-size", type=int, default=448)
    parser.add_argument("--num-classes", type=int, default=1)
    parser.add_argument("--output", required=True, help="output .msgpack path")
    parser.add_argument(
        "--backbone-only", action="store_true",
        help="emit only the YOLOPAFPN subtree (for --gpt-backbone loading)",
    )
    return parser.parse_args(argv)


def main(argv=None) -> list:
    """Write ``--output``; returns the skipped keys."""
    args = get_args(argv)
    state_dict = load_torch_checkpoint(args.checkpoint)
    model = NeedleYOLOX(args.variant, num_classes=args.num_classes, device="cpu")
    init_like_flax(model, n_layer=1)  # flax's initialisers (no Dense layer here)
    ported, skipped = port_yolox_state_dict(
        state_dict, model.state_dict(), args.variant, include_head=not args.backbone_only,
        num_classes=args.num_classes, strict=False)
    model.load_state_dict(ported, strict=True)
    tree = yolox_torch_to_flax(model.state_dict(), model)
    if skipped:
        print(f"skipped {len(skipped)} keys (first 5): {skipped[:5]}")
    if args.backbone_only:
        tree = {"params": tree["params"]["backbone"],
                "batch_stats": tree["batch_stats"].get("backbone", {})}
    write_msgpack(args.output, tree)
    print(f"wrote {args.output}")
    return skipped


if __name__ == "__main__":
    main()
