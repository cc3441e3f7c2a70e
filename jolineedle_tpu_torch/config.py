"""Configuration system: CLI argument surface and config trees.

A copy of ``jolineedle_tpu/config.py`` (pure argparse/json), so the port
reads the same ``config.json`` model dirs without importing the JAX package.

CLI-flag parity with the reference train CLI (reference: main.py:24-307) and
the reference's `args_to_config` field mapping (reference: main.py:310-388).
Configs serialize to ``config.json`` with the same two-tree ``{"model": ...,
"train": ...}`` schema (reference: main.py:436-449) and round-trip for
inference (reference: infer.py:58-73).
"""

from __future__ import annotations

import argparse
import json
import math
from ast import literal_eval
from pathlib import Path


class CfgNode:
    """A lightweight attr-dict configuration node (yacs-style).

    Same public surface as the reference's CfgNode (reference:
    src/utils.py:15-92): attribute access, ``to_dict``, ``merge_from_dict``
    and ``merge_from_args`` for ``--a.b=value`` command line overrides.
    """

    def __init__(self, **kwargs):
        self.__dict__.update(kwargs)

    def __str__(self):
        return self._str_helper(0)

    def __contains__(self, key):
        return key in self.__dict__

    def _str_helper(self, indent: int) -> str:
        parts = []
        for k, v in self.__dict__.items():
            if isinstance(v, CfgNode):
                parts.append(f"{k}:\n")
                parts.append(v._str_helper(indent + 1))
            else:
                parts.append(f"{k}: {v}\n")
        return "".join(" " * (indent * 4) + p for p in parts)

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, CfgNode) else v
            for k, v in self.__dict__.items()
        }

    def merge_from_dict(self, d: dict):
        self.__dict__.update(d)

    def merge_from_args(self, args):
        """Apply ``--a.b=value`` style overrides from a list of CLI strings."""
        for arg in args:
            keyval = arg.split("=")
            assert len(keyval) == 2, f"expected --arg=value, got {arg}"
            key, val = keyval
            try:
                val = literal_eval(val)
            except (ValueError, SyntaxError):
                pass
            assert key[:2] == "--"
            keys = key[2:].split(".")
            obj = self
            for k in keys[:-1]:
                obj = getattr(obj, k)
            leaf = keys[-1]
            assert hasattr(obj, leaf), f"{key} does not exist in the config"
            setattr(obj, leaf, val)


# Model-size table (reference: src/models/gpt.py:191-217).
MODEL_SIZES = {
    "openai-gpt": dict(n_layer=12, n_head=12, n_embd=768),
    "gpt2": dict(n_layer=12, n_head=12, n_embd=768),
    "gpt2-medium": dict(n_layer=24, n_head=16, n_embd=1024),
    "gpt2-large": dict(n_layer=36, n_head=20, n_embd=1280),
    "gpt2-xl": dict(n_layer=48, n_head=25, n_embd=1600),
    "gopher-44m": dict(n_layer=8, n_head=16, n_embd=512),
    "gpt-mini": dict(n_layer=6, n_head=6, n_embd=192),
    "gpt-micro": dict(n_layer=4, n_head=4, n_embd=128),
    "gpt-nano": dict(n_layer=3, n_head=3, n_embd=48),
    "gpt-pico": dict(n_layer=2, n_head=2, n_embd=32),
}

YOLOX_SIZES = {
    "yolox",
    "yolox-nano",
    "yolox-tiny",
    "yolox-s",
    "yolox-m",
    "yolox-l",
    "yolox-x",
}


def get_args(args=None) -> argparse.Namespace:
    """Training CLI. Flag-for-flag parity with reference main.py:24-307."""
    parser = argparse.ArgumentParser(description="JoliNeedle-TPU")

    # Model configs
    parser.add_argument(
        "--training-mode",
        type=str,
        default="supervised",
        choices=["supervised", "reinforce"],
        help="Which algorithm should be used to train the model",
    )
    parser.add_argument("--model-type", type=str, default="gpt-mini")
    parser.add_argument("--max-seq-len", type=int, default=32)
    parser.add_argument("--test-max-seq-len", type=int)
    parser.add_argument("--patch-size", type=int, default=224)
    parser.add_argument("--minimum-image-size", type=int, default=224 * 5)
    parser.add_argument(
        "--no-detection", action="store_false", dest="detection_enabled"
    )
    parser.add_argument(
        "--image-processor", type=str, default="yolox", choices=YOLOX_SIZES
    )
    parser.add_argument(
        "--gpt-backbone", type=str, choices=YOLOX_SIZES - {"yolox"}
    )
    parser.add_argument("--freeze-image-processor", action="store_true")
    parser.add_argument("--detector-conf-threshold", type=float, default=0.5)
    parser.add_argument("--use-positional-embedding", action="store_true")
    parser.add_argument("--no-patch-embedding", action="store_true")
    parser.add_argument("--concat-embeddings", action="store_true")
    parser.add_argument("--decoder-pos-encoding", action="store_true")
    parser.add_argument("--dropout", type=float, default=0.1)

    # Training configs
    parser.add_argument("--enable-stop", action="store_true")
    # Default 0.01, NOT the reference's parsed 0.0: the reference's AdamW
    # constructors omit weight_decay (src/models/gpt.py:552-560) so torch's
    # 0.01 default ALWAYS applies there (its resume-time
    # `optim.weight_decay = ...` sets a dead attribute, main.py:552-557).
    # 0.01 is therefore the behavioral-parity default; the flag itself is
    # live here (reference parses it but cannot act on it).
    parser.add_argument("--weight-decay", type=float, default=0.01)
    parser.add_argument("--stop-weight", type=float, default=1.0)
    parser.add_argument(
        "--no-reward-norm", action="store_false", dest="reward_norm"
    )
    parser.add_argument("--entropy-weight", type=float, default=0.01)
    # Reward shaping for the from-scratch STOP probe: scales the env's
    # found-count STOP bonus/penalty in TRAINING rewards (1.0 = the
    # reference reward, src/env/general_env.py:321-358). No reference
    # equivalent.
    parser.add_argument("--stop-bonus-scale", type=float, default=1.0)
    parser.add_argument("--binomial-keypoints", action="store_true")
    parser.add_argument("--min-keypoints", type=int, default=0)
    parser.add_argument("--max-keypoints", type=int, default=0)
    parser.add_argument("--merge-bboxes", action="store_true")
    parser.add_argument(
        "--loss",
        choices={"on-self-trajectory", "on-optimal-trajectory"},
        default="on-optimal-trajectory",
    )
    parser.add_argument("--yolo-lr", type=float, default=1e-4)
    parser.add_argument("--augment-rotate", action="store_true")
    parser.add_argument("--augment-translate", action="store_true")
    parser.add_argument(
        "--devices",
        nargs="+",
        type=int,
        help="CUDA device indices; more than one trains data-parallel, one rank per"
        " device (under torchrun: this host's devices, one per local rank)",
    )
    parser.add_argument("--port-ddp", type=int, default=12355,
                        help="Kept for CLI parity; the ranks meet at a file:// rendezvous"
                        " (or torchrun's MASTER_PORT)")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--max-iters", type=int, default=1000)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--gradient-accumulation", type=int, default=1)
    # TPU-rebuild extension: run N train iterations per jitted dispatch
    # (lax.scan over N prefetched batches). Amortizes per-dispatch RPC
    # latency on tunneled/remote runtimes; semantics are identical (the
    # REINFORCE return-normalization window requires N to divide
    # --gradient-accumulation, enforced at startup).
    parser.add_argument("--steps-per-dispatch", type=int, default=1)
    parser.add_argument("--env-name", type=str, default="test")
    parser.add_argument("--group", type=str, default="")
    parser.add_argument("--work-dir", type=str, default="./out/")
    parser.add_argument("--test-size", type=float, default=0.01)
    parser.add_argument("--test-samples", type=int, default=100)
    parser.add_argument("--test-pattern", type=str, default="")
    parser.add_argument("--test-every", type=int, default=500)
    parser.add_argument("--failure-select-rate", type=float, default=0.1)
    parser.add_argument("--eval-training-set", action="store_true")
    parser.add_argument("--resume-training", type=str, required=False)
    # TPU-rebuild extension (not in the reference CLI): warm-start model
    # params/batch-stats from another run's checkpoint with FRESH optimizer
    # state — the cross-mode path (e.g. REINFORCE fine-tuning of a
    # supervised policy), where --resume-training cannot apply because the
    # two modes' optimizer pytrees differ (clip/MultiSteps wrappers).
    parser.add_argument("--init-from", type=str, required=False)
    # TPU-rebuild extension: which test metric drives best-checkpoint
    # tracking. The reference hardcodes "map" (supervised, src/supervised.py:81)
    # and "prop_patches_found" (REINFORCE, src/reinforce.py:67); the RL
    # default is conservative — on the toy task it repeatedly picks
    # lower-stop checkpoints whose mAP trails the eval peak by ~0.03
    # (docs/experiment_log.md 2026-08-20 "commitment frontier") — so
    # recipes can track e.g. ``--best-metric map`` instead.
    parser.add_argument("--best-metric", type=str, required=False)
    # TPU-rebuild extension: keep the whole dataset in HBM as uint8 and
    # gather patch pixels inside the jitted step (data/device_pool.py) —
    # removes per-iteration host->device pixel transfers. ``auto`` enables
    # when the pool fits the memory budget and geometric augs are off.
    parser.add_argument(
        "--device-data-cache",
        type=str,
        default="auto",
        choices=["auto", "on", "off"],
    )
    parser.add_argument("--detection-checkpoint", type=str)
    parser.add_argument("--dataset-dir", type=Path, required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--train-size", type=int, default=-1)
    parser.add_argument("--num-workers", type=int, default=1)
    parser.add_argument("--generated-sample-eval-size", type=int, default=500)
    parser.add_argument("--filter-classes", action="append")
    parser.add_argument("--measure-flops", action="store_true")
    parser.add_argument("--no-recurrent-embedding", action="store_true")

    # TPU-specific additions (not in the reference)
    parser.add_argument(
        "--compute-dtype",
        type=str,
        default="bfloat16",
        choices=["bfloat16", "float32"],
        help="Activation dtype on the compute path (params stay float32)",
    )
    parser.add_argument(
        "--max-det-patches",
        type=int,
        default=12,
        help="Static cap on per-sample YOLOX training patches (pad+mask)",
    )
    parser.add_argument(
        "--max-boxes",
        type=int,
        default=8,
        help="Static cap on bounding boxes per patch/image (pad+mask)",
    )
    parser.add_argument(
        "--profile-dir",
        type=str,
        default="",
        help="If set, capture a profiler trace of a few train steps here",
    )
    # TPU-repo extension (the reference has no lr schedule; constant default
    # keeps parity). Counts OPTIMIZER updates: divide train iterations by
    # --gradient-accumulation when setting --lr-decay-iters.
    parser.add_argument(
        "--lr-schedule",
        type=str,
        default="constant",
        choices=["constant", "cosine"],
        help="Learning-rate schedule (cosine = linear warmup + cosine decay"
        " to 5%% of peak; applies to both optimizers)",
    )
    parser.add_argument(
        "--lr-warmup-iters",
        type=int,
        default=0,
        help="Warmup optimizer updates for --lr-schedule cosine",
    )
    parser.add_argument(
        "--lr-decay-iters",
        type=int,
        default=None,
        help="Total decay horizon in optimizer updates"
        " (default: --max-iters / --gradient-accumulation)",
    )

    return parser.parse_args(args)


def get_default_train_config() -> CfgNode:
    """Default train config (reference: src/supervised.py:42-57)."""
    return CfgNode(
        device="auto",
        num_workers=1,
        max_iters=None,
        batch_size=64,
        epoch_length=100,
        learning_rate=1e-4,
        betas=(0.9, 0.95),
        weight_decay=0.1,
        grad_norm_clip=1.0,
    )


def get_default_model_config() -> CfgNode:
    """Default model config (reference: src/models/gpt.py:146-160)."""
    return CfgNode(
        model_type="gpt",
        n_layer=None,
        n_head=None,
        n_embd=None,
        block_size=None,
        embd_pdrop=0.1,
        resid_pdrop=0.1,
        attn_pdrop=0.1,
    )


def args_to_config(args) -> tuple:
    """Build (train_config, model_config) from CLI args.

    Field mapping parity with reference main.py:310-388, including the
    ``image_cols = ceil(2064 / patch_size)`` quirk (reference:
    main.py:364-366) that sizes the learned positional-embedding table.
    """
    train_config = get_default_train_config()
    train_config.training_mode = args.training_mode
    train_config.rotations = args.augment_rotate
    train_config.translations = args.augment_translate
    train_config.learning_rate = args.lr
    train_config.max_iters = args.max_iters
    train_config.batch_size = args.batch_size
    train_config.detection_enabled = args.detection_enabled
    train_config.gradient_accumulation = args.gradient_accumulation
    train_config.steps_per_dispatch = args.steps_per_dispatch
    train_config.env_name = args.env_name
    train_config.work_dir = args.work_dir
    train_config.test_size = args.test_size
    train_config.test_samples = args.test_samples
    train_config.test_pattern = args.test_pattern
    train_config.test_every = args.test_every
    train_config.failure_select_rate = args.failure_select_rate
    train_config.eval_training_set = args.eval_training_set
    train_config.resume_training = args.resume_training
    train_config.init_from = args.init_from
    train_config.best_metric = args.best_metric
    # Recorded so a saved run validates standalone: scripts/eval_checkpoint.py
    # reads it back when --dataset-dir is not given (round-3 verdict item 7;
    # the reference's config.json has the same gap).
    train_config.dataset_dir = str(args.dataset_dir)
    train_config.device_data_cache = args.device_data_cache
    train_config.detection_checkpoint = args.detection_checkpoint
    train_config.merge_bboxes = args.merge_bboxes
    train_config.seed = args.seed
    train_config.train_size = args.train_size
    train_config.num_workers = args.num_workers
    train_config.min_keypoints = args.min_keypoints
    train_config.max_keypoints = args.max_keypoints
    train_config.loss_mode = args.loss
    train_config.yolo_lr = args.yolo_lr
    train_config.binomial_keypoints = args.binomial_keypoints
    train_config.generated_sample_eval_size = args.generated_sample_eval_size
    train_config.weight_decay = args.weight_decay
    train_config.stop_weight = args.stop_weight
    train_config.entropy_weight = args.entropy_weight
    train_config.stop_bonus_scale = args.stop_bonus_scale
    train_config.reward_norm = args.reward_norm
    train_config.minimum_image_size = args.minimum_image_size
    train_config.filter_classes = (
        set(int(c) for c in args.filter_classes)
        if args.filter_classes is not None
        else None
    )
    train_config.port_ddp = args.port_ddp
    train_config.measure_flops = args.measure_flops
    train_config.gpu_ids = args.devices if args.devices is not None else [0]
    train_config.world_size = len(train_config.gpu_ids)
    train_config.max_seq_len = args.max_seq_len
    train_config.test_max_seq_len = (
        args.test_max_seq_len if args.test_max_seq_len else args.max_seq_len
    )
    train_config.patch_size = args.patch_size
    train_config.n_channels = 3
    train_config.stop_enabled = args.enable_stop
    # XXX parity quirk: 2064 is the reference dataset image width
    # (reference: main.py:364-366)
    train_config.image_cols = math.ceil(2064 / train_config.patch_size)
    train_config.freeze_image_processor = args.freeze_image_processor
    train_config.compute_dtype = args.compute_dtype
    train_config.max_det_patches = args.max_det_patches
    train_config.max_boxes = args.max_boxes
    train_config.profile_dir = args.profile_dir
    train_config.lr_schedule = args.lr_schedule
    train_config.lr_warmup_iters = args.lr_warmup_iters
    train_config.lr_decay_iters = (
        args.lr_decay_iters
        if args.lr_decay_iters is not None
        else max(1, args.max_iters // max(1, args.gradient_accumulation))
    )

    model_config = get_default_model_config()
    model_config.model_type = args.model_type
    model_config.image_processor = args.image_processor
    model_config.gpt_backbone = args.gpt_backbone
    model_config.freeze_image_processor = args.freeze_image_processor
    model_config.detector_conf_threshold = args.detector_conf_threshold
    model_config.use_pos_emb = args.use_positional_embedding
    model_config.no_patch_emb = args.no_patch_embedding
    model_config.concat_emb = args.concat_embeddings
    model_config.decoder_pos_encoding = args.decoder_pos_encoding
    model_config.pos_emb_size = train_config.image_cols**2
    model_config.dropout = args.dropout
    model_config.block_size = train_config.max_seq_len
    model_config.n_channels = train_config.n_channels
    model_config.patch_size = train_config.patch_size
    model_config.image_cols = train_config.image_cols
    model_config.no_recurrent_embedding = args.no_recurrent_embedding
    model_config.compute_dtype = args.compute_dtype
    if model_config.model_type is not None:
        model_config.merge_from_dict(MODEL_SIZES[model_config.model_type])

    return train_config, model_config


def save_config(model_config: CfgNode, train_config: CfgNode):
    """Write config.json with the reference schema (reference: main.py:436-449)."""
    train_folder = Path(train_config.work_dir) / train_config.env_name
    train_folder.mkdir(parents=True, exist_ok=True)

    def _clean(d: dict) -> dict:
        out = {}
        for k, v in d.items():
            if isinstance(v, set):
                v = sorted(v)
            elif isinstance(v, Path):
                v = str(v)
            elif isinstance(v, tuple):
                v = list(v)
            out[k] = v
        return out

    config_json = {
        "model": _clean(model_config.to_dict()),
        "train": _clean(train_config.to_dict()),
    }
    with open(train_folder / "config.json", "w") as f:
        json.dump(config_json, f, indent=4)


def config_from_file(config_path) -> tuple:
    """Round-trip a saved config.json (reference: infer.py:58-73)."""
    with open(config_path) as f:
        config_json = json.load(f)
    train_config = get_default_train_config()
    train_config.merge_from_dict(config_json["train"])
    model_config = get_default_model_config()
    model_config.merge_from_dict(config_json["model"])
    return train_config, model_config
