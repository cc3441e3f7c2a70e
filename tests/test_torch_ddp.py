"""Data-parallel training of the port (``parallel/mesh.py``) on the CPU, two
ranks joined by gloo, against the JAX package's mesh and against one rank.

gpt-pico with a yolox-nano embedder and detector, patch 32, float32 (the
JAX supervised loss in float64, as ``tests/test_torch_supervised_loss.py``
computes it for train-mode BatchNorm). The ranks are spawned processes
(``mesh.launch``; a ``file://`` rendezvous in ``tmp_path``, or in a
temporary directory when the CLI spawns them) that run programs of the
port (``parallel/ranks.py``, ``main.train_rank``): a child that imported
this file would import JAX. One PyTorch thread per rank.

- the supervised loss (decision CE with dropout 0 on un-augmented patches,
  then ``yolox_losses``) of JAX under ``value_and_grad`` with the batch
  sharded over a 2-device mesh, against the port's two ranks: the sum of
  the ranks' gradients and the BN statistics both ranks hold;
- the REINFORCE loss on one rollout record split over two ranks, against
  JAX's loss on the whole record;
- a guard: with the two halves' statistics far apart, the synced BatchNorm
  is the global one and a rank's own misses it by far more than the
  tolerance, so the comparisons above can fail;
- whole train steps at W = 2 x B against W = 1 x 2B in both modes, with
  the geometric and photometric augmentations, dropout in the supervised
  mode, accumulation 2, 4 iterations: losses, weights, BN statistics, each
  kernel wrapper's calls per iteration, and every rank's full state
  bit-equal to rank 0's after every iteration; the same at W = 4 x B / 2
  against that W = 1 run (each rank's rows interleave with three peers'
  in the global batch, and the BN sums and counts add four terms);
- the train CLI with ``--devices 0 1`` in each mode: it trains, tests and
  writes the files of a one-device run, once; a resume at W = 2 from a
  checkpoint taken inside an accumulation window continues as the resume of
  the one-device run at the global batch does; a resume at W = 2 from a
  JAX run directory (``checkpoint.flax_train_state`` of a REINFORCE run
  inside its window) leaves every rank's state equal; a repeated index is
  refused; no rank imports JAX;
- torchrun's route: two processes that join through ``RANK`` and
  ``WORLD_SIZE`` train with equal losses, those of the one-device run.

Post-update tolerance: train-mode BatchNorm at these sizes amplifies
float32 rounding (summing its statistics in two halves at W = 1 moves the
gradient by about 2e-4 relative), and Adam's first update turns a flipped
sign of a near-zero gradient into 2 lr. The train steps' losses after the
first update differ by up to 3.1e-4 relative in the supervised mode and
1.2e-5 in REINFORCE (before it: 1.6e-6 and 3.7e-7), so a loss after an
update is held at rtol 1e-3 here, as ``tests/test_dp_equivalence.py`` holds
its post-update loss, and the losses before it at 1e-4. ``chip_smoke.py``
holds the flagship's at 1e-4 on both sides.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.ops import simota as jsimota
from jolineedle_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from jolineedle_tpu.train import supervised as jsup
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.checkpoint import (flax_train_state, load_model_file,
                                           load_train_state, write_msgpack)
from jolineedle_tpu_torch.data.toy import generate_toy_dataset
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.env.batched_env import NeedleEnv
from jolineedle_tpu_torch.main import main as train_main
from jolineedle_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.models.yolox import batch_norm_train
from jolineedle_tpu_torch.parallel import mesh, ranks
from jolineedle_tpu_torch.train.rollout import rollout

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
P, NV, NH, T, B, K = 32, 2, 3, 4, 4, 3
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
STOP_WEIGHT = 2.0
RET_MEAN, RET_STD = 0.3, 1.7
CPU2 = ["cpu", "cpu"]


def _cli(mode, extra=()):
    return [
        "--training-mode", mode, "--dataset-dir", "/nonexistent", "--work-dir", "/nonexistent",
        "--model-type", "gpt-pico", "--image-processor", "yolox-nano",
        "--gpt-backbone", "yolox-nano", "--concat-embeddings", "--decoder-pos-encoding",
        "--use-positional-embedding", "--enable-stop", "--stop-weight", str(STOP_WEIGHT),
        "--max-seq-len", str(T), "--patch-size", str(P), "--minimum-image-size", "0",
        "--batch-size", str(B), "--dropout", "0.0", "--max-det-patches", str(K),
        "--max-boxes", "4", "--compute-dtype", "float32",
    ] + list(extra)


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.array(v) for k, v in tree.items()}


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): v})
    return out


def _randomize_bn(variables, seed):
    """Random BN terms and statistics; a sharper action head."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "mean":
                node[k] = (rng.normal(size=v.shape) * 0.3).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif path and path[-1] == "BatchNorm_0":
                value = (rng.uniform(0.5, 1.5, v.shape) if k == "scale"
                         else rng.normal(size=v.shape) * 0.1)
                node[k] = value.astype(np.float32)

    walk(variables["batch_stats"], ())
    walk(variables["params"], ())
    variables["params"]["action_head"]["Dense_0"]["kernel"] *= 5.0
    return variables


def _jax_model(mode):
    train_config, model_config = args_to_config(get_args(_cli(mode)))
    jmodel = JaxGPT.from_config(model_config, get_actions_info(train_config))
    variables = jax.jit(lambda rng: jmodel.init(
        rng, jnp.zeros((1, 1, P, P, 3)), jnp.zeros((1, 1), jnp.int32),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, 2), jnp.int32), jnp.zeros((1, P, P, 3)),
        method=JaxGPT.init_all))(jax.random.PRNGKey(0))
    return jmodel, _randomize_bn(_np_tree(variables), 3)


def _port_state(mode, variables):
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(_cli(mode)))
    model = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu")
    flax_to_torch(variables, model)
    return model, {k: v.clone() for k, v in model.state_dict().items()}


def _summed_grads(model, results):
    """The ranks' gradients summed, as a JAX ``params`` tree."""
    grads = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    for name in results[0]["grads"]:
        grads[name] = sum(r["grads"][name] for r in results)
    return _flat(torch_to_flax(grads, model)["params"])


def _assert_close_to_scale(got, want, err_msg=""):
    """Per leaf: max |got - want| <= rtol * max |want| + atol (GRAD_TOL)."""
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = np.abs(np.asarray(got[path], np.float64) - np.asarray(w)).max()
        limit = GRAD_TOL["rtol"] * np.abs(np.asarray(w)).max() + GRAD_TOL["atol"]
        assert err <= limit, f"{err_msg}{'/'.join(path)}: max error {err} > {limit}"


# --- the supervised loss against the JAX package's mesh ------------------------------------
def _sup_batch(seed):
    """A supervised batch of B episodes (already augmented float patches):
    live prefixes of different lengths, STOP among the labels, a padded
    detector patch and boxes in the valid ones; the halves differ."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((B, T), np.float32)
    for b, n in enumerate((T, T - 1, 2, T)):
        masks[b, :n] = 1
    ref = rng.integers(0, 9, (B, T)).astype(np.int32)
    ref[0, 1] = ref[3, 0] = 8
    valid = np.ones((B, K), bool)
    valid[1, K - 1] = valid[2, K - 1] = False
    boxes = np.zeros((B, K, 4, 6), np.float32)
    boxes[:, :, 0] = [0, 4, 5, 20, 15, 1]
    boxes[0, 1, 1] = [0, 15, 17, 30, 31, 1]
    boxes[3, 0, 1] = [0, 2, 2, 12, 28, 1]
    boxes[~valid] = 0
    det = rng.random((B, K, P, P, 3)).astype(np.float32)
    det[~valid] = 0
    return {
        "patches": rng.random((B, T, P, P, 3)).astype(np.float32),
        "current_actions": rng.integers(0, 9, (B, T)).astype(np.int32),
        "class_id": np.zeros((B,), np.int32),
        "positions": np.stack([rng.integers(0, NV, (B, T)), rng.integers(0, NH, (B, T))],
                              -1).astype(np.int32),
        "reference_actions": ref,
        "masks": masks,
        "patches_yolox": det,
        "bboxes_yolox": boxes,
        "yolox_valid": valid,
    }


@pytest.fixture(scope="module")
def supervised_case(tmp_path_factory):
    jmodel, variables = _jax_model("supervised")
    batch = _sup_batch(4)
    class_weight = np.ones((9,), np.float32)
    class_weight[8] = STOP_WEIGHT
    jmodel64 = jmodel.clone(compute_dtype=jnp.float64)

    def loss_fn(params, batch_stats, b):
        (logits, _), mut = jmodel64.apply(
            {"params": params, "batch_stats": batch_stats}, b["patches"],
            b["current_actions"], b["class_id"], b["positions"], train=True,
            mutable=["batch_stats"])
        action_loss, _ = jsup.action_ce_metrics(logits, b["reference_actions"], b["masks"],
                                                jnp.asarray(class_weight, jnp.float64))
        (head, _), mut2 = jmodel64.apply(
            {"params": params, "batch_stats": mut["batch_stats"]},
            b["patches_yolox"].reshape((B * K, P, P, 3)), True,
            method=JaxGPT.yolox_outputs, mutable=["batch_stats"])
        ylo = jsimota.yolox_losses(head, b["bboxes_yolox"].reshape(B * K, 4, 6),
                                   b["yolox_valid"].reshape(-1))
        return action_loss + ylo["total_loss"], mut2["batch_stats"]

    with jax.enable_x64():
        f64 = lambda x: np.asarray(x, np.float64) if np.asarray(x).dtype == np.float32 else x
        mesh2 = make_mesh([0, 1])
        v64 = replicate(mesh2, jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                                      variables))
        sharded = shard_batch(mesh2, {k: f64(v) for k, v in batch.items()})
        assert len(sharded["patches"].sharding.device_set) == 2
        (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"], v64["batch_stats"], sharded)
        want = jax.device_get({"loss": loss, "stats": stats, "grads": grads})

    model, state = _port_state("supervised", variables)
    spec = {"mode": "supervised", "flags": _cli("supervised"), "state": state, "batch": batch,
            "class_weight": class_weight}
    got = mesh.launch(ranks.loss_rank, (spec,), CPU2,
                      rendezvous_dir=tmp_path_factory.mktemp("sup_loss"))
    return model, variables, want, got


def test_supervised_loss_over_two_ranks_matches_the_jax_mesh(supervised_case):
    model, _, want, got = supervised_case
    np.testing.assert_allclose(sum(r["loss"] for r in got), float(want["loss"]), **GRAD_TOL)
    assert all(r["loss"] > 0 for r in got)
    _assert_close_to_scale(_summed_grads(model, got), _flat(want["grads"]), "grad ")


def test_supervised_bn_statistics_over_two_ranks_match_the_jax_mesh(supervised_case):
    """Both ranks hold the same new statistics (from the global batch's
    sums), those of the JAX step over the mesh."""
    model, variables, want, got = supervised_case
    for name, value in got[0]["state"].items():
        assert torch.equal(value, got[1]["state"][name]), name
    stats = _flat(torch_to_flax(got[0]["state"], model)["batch_stats"])
    w = _flat(want["stats"])
    assert stats.keys() == w.keys()
    for path, value in w.items():
        np.testing.assert_allclose(np.asarray(stats[path]), np.asarray(value), **GRAD_TOL,
                                   err_msg="/".join(path))
    before = _flat(variables["batch_stats"])
    assert all(not np.array_equal(stats[p], before[p]) for p in stats)


# --- the REINFORCE loss on a record split over two ranks -------------------------------------
@pytest.fixture(scope="module")
def reinforce_case(tmp_path_factory):
    jmodel, variables = _jax_model("reinforce")
    model, state = _port_state("reinforce", variables)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, NV * P, NH * P, 3), dtype=np.uint8)
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[:, 0] = [5, 5, 35, 20]
    boxes[:, 1] = [70, 35, 85, 50]
    boxes[2:, 1] = [40, 2, 60, 30]
    env = NeedleEnv(images, boxes, P, T, 1, True, device="cpu")
    ro = rollout(model, env, sample=True, generator=torch.Generator().manual_seed(5),
                 collect=("actions",))
    ro.pop("final_state")
    record = {k: v.numpy() for k, v in ro.items()}
    assert (record["actions"] != record["actions"][:, :1]).any(), "the episodes should move"
    assert len(set(record["logit_masks"].sum(1))) > 1, "the episodes should end apart"

    actions = jnp.asarray(record["actions"], jnp.int32)
    positions = jnp.asarray(record["positions"], jnp.int32)

    def loss_fn(params, batch_stats):
        v = {"params": params, "batch_stats": batch_stats}
        jenv = JaxEnv(jnp.asarray(images), jnp.asarray(boxes), P, T, 1, True)
        patches = jenv.gather_patches_at(positions[:, :T])
        prev = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), actions[:, :-1]], 1)
        logits, _ = jmodel.apply(v, patches, prev, jnp.zeros((B,), jnp.int32), positions[:, :T])
        logp_all = jax.nn.log_softmax(logits.astype(jnp.float32))
        logprobs = jnp.take_along_axis(logp_all, actions[..., None], -1)[..., 0]
        entropies = -(jnp.exp(logp_all) * logp_all).sum(-1)
        masks = jnp.asarray(record["logit_masks"])
        adv = (jnp.asarray(record["returns"]) - RET_MEAN) / (RET_STD + 1e-8)
        msum = jnp.maximum(masks.sum(), 1.0)
        ent_w = 0.01
        return (-(logprobs * adv * masks).sum() / msum
                - ent_w * (entropies * masks).sum() / msum)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"],
                                                       variables["batch_stats"])
    spec = {"mode": "reinforce", "flags": _cli("reinforce", ["--entropy-weight", "0.01"]),
            "state": state, "images": images, "boxes": boxes, "record": record,
            "return_mean": RET_MEAN, "return_std": RET_STD}
    got = mesh.launch(ranks.loss_rank, (spec,), CPU2,
                      rendezvous_dir=tmp_path_factory.mktemp("rl_loss"))
    return model, jax.device_get((loss, grads)), got


def test_reinforce_loss_over_two_ranks_matches_jax(reinforce_case):
    """Each rank's share divides by the global mask sum: the shares add up
    to the loss on the whole record, and so do the gradients."""
    model, (want_loss, want_grads), got = reinforce_case
    np.testing.assert_allclose(sum(r["loss"] for r in got), float(want_loss), **GRAD_TOL)
    summed = _summed_grads(model, got)
    want = _flat(want_grads)
    assert summed.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(np.asarray(summed[path]), np.asarray(w), **GRAD_TOL,
                                   err_msg="/".join(path))
    assert all(np.abs(v).max() == 0 for p, v in summed.items() if p[0] == "yolox")


# --- the guard: unsynced statistics would fail --------------------------------------------------
BN_TOL = dict(rtol=1e-5, atol=1e-5)


def test_synced_batch_norm_is_the_global_one_and_a_ranks_own_is_not(tmp_path):
    rng = np.random.default_rng(7)
    C = 5
    x = np.concatenate([rng.normal(0.0, 1.0, (3, C, 4, 4)),
                        rng.normal(4.0, 3.0, (3, C, 4, 4))]).astype(np.float32)
    bn = torch.nn.BatchNorm2d(C, eps=1e-3, momentum=0.03)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        bn.bias.normal_(generator=torch.Generator().manual_seed(2))
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    want_y = batch_norm_train(bn, torch.from_numpy(x)).detach()
    got = mesh.launch(ranks.batch_norm_rank, (torch.from_numpy(x), state), CPU2,
                      rendezvous_dir=tmp_path)
    synced = torch.cat([r["synced"]["y"] for r in got])
    local = torch.cat([r["local"]["y"] for r in got])
    torch.testing.assert_close(synced, want_y, **BN_TOL)
    for r in got:
        for name in ("running_mean", "running_var"):
            torch.testing.assert_close(r["synced"]["state"][name], getattr(bn, name), **BN_TOL)
    miss = (local - want_y).abs().max().item()
    assert miss > 100 * (BN_TOL["atol"] + BN_TOL["rtol"] * want_y.abs().max().item()), miss
    stat_miss = (got[0]["local"]["state"]["running_mean"] - bn.running_mean).abs().max().item()
    assert stat_miss > 100 * BN_TOL["atol"], stat_miss


# --- whole train steps: W = 2 x B against W = 1 x 2B ----------------------------------------
@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    generate_toy_dataset(root, n_train=8, n_test=2, image_size=(128, 160), seed=0,
                         box_size=(8, 30))
    return root


def _train_flags(mode, toy, work_dir, batch, extra=()):
    flags = _cli(mode) + [
        "--work-dir", str(work_dir), "--seed", "3", "--gradient-accumulation", "2",
        "--test-every", "1000", "--test-samples", "2", "--num-workers", "1",
        "--env-name", mode, "--augment-rotate", "--augment-translate",
        "--max-seq-len", "3",
    ] + list(extra)
    flags[flags.index("--dataset-dir") + 1] = str(toy)
    flags[flags.index("--batch-size") + 1] = str(batch)
    if mode == "supervised":
        flags[flags.index("--dropout") + 1] = "0.1"
    return flags


def _lr_of(name):
    return 1e-4  # --lr and --yolo-lr default


STEP_MODES = ("supervised", "reinforce")
STEP_ITERS = 4


@pytest.fixture(scope="module")
def step_runs(toy, tmp_path_factory):
    """Each mode's W = 1 x 2B run, and both modes' W = 2 x B runs in one
    launch of the two ranks (one process start for both)."""
    root = tmp_path_factory.mktemp("steps")
    jobs = lambda run, batch: [{"flags": _train_flags(m, toy, root / run, batch),
                                "iters": STEP_ITERS} for m in STEP_MODES]
    one = ranks.train_rank_steps(mesh.single("cpu"), jobs("one", 2 * 2))
    two = mesh.launch(ranks.train_rank_steps, (jobs("two", 2),), CPU2,
                      rendezvous_dir=root)
    return {m: (one[i], [r[i] for r in two]) for i, m in enumerate(STEP_MODES)}


@pytest.mark.parametrize("mode", STEP_MODES)
def test_two_ranks_take_the_steps_of_one_at_the_global_batch(mode, step_runs):
    one, (r0, r1) = step_runs[mode]
    # every rank's whole state equals rank 0's after every iteration; the
    # losses, weights, BN statistics and wrapper calls are W = 1's
    misses, numbers = ranks.compare_runs(one, [r0, r1], 2, _lr_of, after_rtol=1e-3)
    assert not misses, (misses, numbers)
    assert len(set(r0["digests"])) == STEP_ITERS
    assert r0["losses"] == r1["losses"] and r0["metrics"] == r1["metrics"]
    for key in one["metrics"][0]:
        np.testing.assert_allclose([m[key] for m in r0["metrics"][:2]],
                                   [m[key] for m in one["metrics"][:2]],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    assert r0["calls"][0]["flash_attention"] > 0
    # the collectives of a step: one gradient and one metric all-reduce,
    # a BN sync per train-mode BatchNorm, the denominators
    steps = r0["collectives"]
    assert all(c["gradients"] == 1 and c["metrics"] == 1 and c["bn"] > 50 for c in steps)
    assert all(c["count"] == 2 for c in steps)  # the loss's denominator, num_fg
    assert not one["collectives"][0]


@pytest.fixture(scope="module")
def four_rank_runs(toy, tmp_path_factory):
    """Both modes' runs at W = 4 x 1 row, in one launch of four ranks: the
    global batch of ``step_runs``' W = 1 run, which is not repeated."""
    root = tmp_path_factory.mktemp("steps4")
    jobs = [{"flags": _train_flags(m, toy, root / "four", 1), "iters": STEP_ITERS}
            for m in STEP_MODES]
    four = mesh.launch(ranks.train_rank_steps, (jobs,), ["cpu"] * 4, rendezvous_dir=root)
    return {m: [r[i] for r in four] for i, m in enumerate(STEP_MODES)}


@pytest.mark.parametrize("mode", STEP_MODES)
def test_four_ranks_take_the_steps_of_one_at_the_global_batch(mode, step_runs, four_rank_runs):
    one, _ = step_runs[mode]
    rs = four_rank_runs[mode]
    # the W = 2 case's checks and tolerances, with three peers to each rank
    misses, numbers = ranks.compare_runs(one, rs, 2, _lr_of, after_rtol=1e-3)
    assert not misses, (misses, numbers)
    assert len(set(rs[0]["digests"])) == STEP_ITERS
    assert all(r["losses"] == rs[0]["losses"] and r["metrics"] == rs[0]["metrics"] for r in rs)
    for key in one["metrics"][0]:
        np.testing.assert_allclose([m[key] for m in rs[0]["metrics"][:2]],
                                   [m[key] for m in one["metrics"][:2]],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    steps = rs[0]["collectives"]
    assert all(c["gradients"] == 1 and c["metrics"] == 1 and c["bn"] > 50 for c in steps)
    assert all(c["count"] == 2 for c in steps)


# --- the CLI -----------------------------------------------------------------------------------
def _cli_run(flags, capfd):
    capfd.readouterr()
    result = train_main(tconfig.get_args(flags), device="cpu")
    return result, capfd.readouterr().out


def _relative(want, got):
    """The relative L2 distance of two lists of tensors, all together."""
    diff = sum(float((a.double() - b.double()).norm()) ** 2 for a, b in zip(want, got))
    return (diff / sum(float(a.double().norm()) ** 2 for a in want)) ** 0.5


def _moments(state):
    adamw = state["optimizer"]["adamw"]["state"]
    return [adamw[i]["exp_avg"] for i in sorted(adamw)]


@pytest.mark.parametrize("mode", ["supervised", "reinforce"])
def test_cli_trains_tests_and_resumes_on_two_ranks(mode, toy, tmp_path, capfd):
    """``--devices 0 1``: one iteration (the checkpoint inside an
    accumulation window of 2), the final test, the run directory; then a
    resume that completes the window. Each against the one-device run at the
    global batch: the checkpoint holds the global batch's accumulated
    gradient on every rank, and the resumed update adds the next one's to
    it (Adam's first moments, magnitudes and not only signs, agree)."""
    iters = "2" if mode == "supervised" else "1"  # the supervised loop runs max_iters - 1
    flags = lambda w, b, extra=(): _train_flags(mode, toy, tmp_path / w, b,
                                                ["--max-iters", iters, *extra])
    two, out2 = _cli_run(flags("two", 2, ["--devices", "0", "1"]), capfd)
    one, out1 = _cli_run(flags("one", 4), capfd)
    assert [s["rank"] for s in two] == [0, 1] and two[0]["world_size"] == 2
    assert two[0]["digest"] == two[1]["digest"] is not None
    assert all(s["step"] == 1 and s["mini_step"] == 1 and s["updates"] == 0 for s in two)
    assert two[0]["losses"] == two[1]["losses"]
    np.testing.assert_allclose(two[0]["losses"], [float(v) for v in one.loss_history], rtol=1e-4)
    for s in two:
        assert "jax" not in s["packages"] and "jolineedle_tpu" not in s["packages"]
    dir1, dir2 = tmp_path / "one" / mode, tmp_path / "two" / mode
    assert sorted(p.name for p in dir2.iterdir()) == sorted(p.name for p in dir1.iterdir())
    assert {"checkpoint.pt", "train_state.pt", "metrics.json", "visdom.pkl"} <= {
        p.name for p in dir2.iterdir()}
    # rank 0 alone printed: the lines of one test, as at W = 1
    for line in ("\nparam_global_norm ", "training env_name", '"param_global_norm"'):
        assert out2.count(line) == out1.count(line) == 1, line
    acc1 = [g for g in load_train_state(dir1)["optimizer"]["acc_grads"] if g is not None]
    acc2 = [g for g in load_train_state(dir2)["optimizer"]["acc_grads"] if g is not None]
    assert len(acc1) == len(acc2) > 0 and _relative(acc1, acc2) < 1e-2

    two_r, _ = _cli_run(flags("two", 2, ["--devices", "0", "1", "--resume-training", str(dir2)]),
                        capfd)
    one_r, _ = _cli_run(flags("one", 4, ["--resume-training", str(dir1)]), capfd)
    assert all(s["step"] == 2 and s["updates"] == 1 and s["mini_step"] == 0 for s in two_r)
    assert two_r[0]["digest"] == two_r[1]["digest"]
    np.testing.assert_allclose(two_r[0]["losses"], [float(v) for v in one_r.loss_history],
                               rtol=1e-4)
    assert _relative(_moments(load_train_state(dir1)), _moments(load_train_state(dir2))) < 1e-2
    state2 = torch.load(dir2 / "checkpoint.pt", weights_only=True)
    state1 = torch.load(dir1 / "checkpoint.pt", weights_only=True)
    assert not ranks.weights_disagree(state1, state2, _lr_of)
    assert ranks.stats_relative(state1, state2) < 1e-4


def test_cli_resumes_a_jax_format_run_on_two_ranks(toy, tmp_path, capfd):
    """``--devices 0 1 --resume-training`` on a JAX run directory (a
    REINFORCE train state inside an accumulation window, with the clip
    level, as ``checkpoint.flax_train_state`` writes it): every rank reads
    the file, and their states agree after the iteration that completes
    the window."""
    flags = lambda w, b, extra=(): _train_flags("reinforce", toy, tmp_path / w, b,
                                                ["--max-iters", "1", *extra])
    one, _ = _cli_run(flags("one", 4), capfd)
    run_dir = tmp_path / "one" / "reinforce"
    load_model_file(one.model, run_dir / "checkpoint.pt")  # the last state, not the best
    jax_dir = tmp_path / "jax" / "reinforce"
    write_msgpack(jax_dir / "checkpoint.msgpack",
                  flax_train_state(one.model, one.optimizer, one.step))
    (jax_dir / "config.json").write_bytes((run_dir / "config.json").read_bytes())
    assert {p.name for p in jax_dir.iterdir()} == {"checkpoint.msgpack", "config.json"}

    two, _ = _cli_run(flags("two", 2, ["--devices", "0", "1", "--resume-training",
                                       str(jax_dir)]), capfd)
    assert [s["rank"] for s in two] == [0, 1]
    assert all(s["step"] == 2 and s["updates"] == 1 and s["mini_step"] == 0 for s in two)
    assert two[0]["digest"] == two[1]["digest"] is not None
    assert two[0]["losses"] == two[1]["losses"] and np.isfinite(two[0]["losses"]).all()


def test_cli_refuses_a_repeated_device(toy, tmp_path):
    flags = _train_flags("reinforce", toy, tmp_path, 2, ["--devices", "0", "0"])
    with pytest.raises(ValueError, match="repeats an index"):
        train_main(tconfig.get_args(flags), device="cpu")
    assert not (tmp_path / "reinforce").exists()


# --- torchrun's route --------------------------------------------------------------------------
TORCHRUN_TIMEOUT = 180


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torchrun_ranks_train_with_equal_losses(toy, tmp_path):
    """Two processes join through torchrun's variables and train two
    iterations at W = 2 x 2; each writes its losses: they are equal, and
    they are the one-device run's at the global batch."""
    flags = _train_flags("reinforce", toy, tmp_path / "tr", 2,
                         ["--max-iters", "2", "--devices", "0", "1"])
    code = ("import json, sys, torch; torch.set_num_threads(1);"
            " from jolineedle_tpu_torch.config import get_args;"
            " from jolineedle_tpu_torch.main import main;"
            " t = main(get_args(json.loads(sys.argv[1])), device='cpu');"
            " open(sys.argv[2], 'w').write(json.dumps([float(v) for v in t.loss_history]))")
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, json.dumps(flags),
                               str(tmp_path / f"losses{r}.json")],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=TORCHRUN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    losses = [json.loads((tmp_path / f"losses{r}.json").read_text()) for r in range(2)]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    one = train_main(tconfig.get_args(_train_flags("reinforce", toy, tmp_path / "one", 4,
                                                   ["--max-iters", "2"])), device="cpu")
    np.testing.assert_allclose(losses[0], [float(v) for v in one.loss_history], rtol=1e-4)


def test_a_held_job_waits_for_its_go_file(tmp_path, monkeypatch):
    """``chip_smoke.py``'s hold on two ranks' timed jobs: ``wait_for``
    writes ``<go>.ready<rank>`` at once and returns only once ``go``
    exists (with no ``go`` it gives up after its timeout); two spawned
    ranks running ``held_rank_steps`` (pickled by name, as the script
    launches them) both reach the go file and finish once it is there."""
    import importlib.util
    import threading
    import time

    monkeypatch.syspath_prepend(str(ROOT))  # the spawned ranks import the script by name
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    spec.loader.exec_module(smoke)

    def ready(go, ranks_, thread):
        deadline = time.monotonic() + 120.0
        while not all(Path(f"{go}.ready{r}").exists() for r in ranks_):
            assert thread.is_alive() and time.monotonic() < deadline, box.get("err")
            time.sleep(0.01)

    go = tmp_path / "timed.go"
    done = threading.Event()
    waiter = threading.Thread(target=lambda: (smoke.wait_for(go, 1, timeout=30.0), done.set()),
                              daemon=True)
    waiter.start()
    box = {}
    ready(go, [1], waiter)
    time.sleep(0.2)
    assert not done.is_set()
    go.touch()
    waiter.join(timeout=10.0)
    assert done.is_set()
    with pytest.raises(TimeoutError):
        smoke.wait_for(tmp_path / "never.go", 0, timeout=0.2)
    assert (tmp_path / "never.go.ready0").exists()

    go = tmp_path / "ranks.go"

    def run():
        try:
            box["out"] = mesh.launch(smoke.held_rank_steps, ([], [], str(go)), CPU2,
                                     backend="gloo", rendezvous_dir=tmp_path)
        except BaseException as err:  # re-raised below
            box["err"] = err

    launch = threading.Thread(target=run, daemon=True)
    launch.start()
    ready(go, [0, 1], launch)
    assert launch.is_alive()
    go.touch()
    launch.join(timeout=120.0)
    assert "err" not in box, box.get("err")
    assert box["out"] == [[], []]
