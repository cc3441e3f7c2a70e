"""``--resume-training`` on a run directory the JAX package wrote.

The port reads the JAX trainer's whole train state (``checkpoint.py::
load_flax_train_state``): the weights, and the optax state as the port's
``Optimizer`` state (``flax_optimizer_state``), whose inverse
(``optimizer_to_flax``) writes a port optimizer in optax's layout.

- the optimizer of ``_Tiny``'s three partitions (a detector backbone, a
  detector head, a decoder part held as a Dense kernel, so transposed) at
  accumulation 1 / 2, clip none / 1.0, schedule constant / cosine and
  ``--freeze-image-processor`` off / on (the half of the 16 cases in which
  every pair of settings occurs): three gradients through optax, its state
  through flax's bytes into the port, one more gradient in both; the
  parameters agree within 1e-6, and the port's state written back is
  optax's (bit for bit without accumulation; the window's running mean
  within 1e-7 with it);
- the JAX train CLI (root ``main.py``) trains the supervised mode 3
  iterations at ``--gradient-accumulation 2 --lr-schedule cosine``, so
  that its checkpoint holds one update and a half-full window; the port's
  trainer resumed from that directory holds its moments bit for bit
  (``torch_to_flax`` of each ``exp_avg``/``exp_avg_sq``), its counts, step
  and window, and its accumulated gradients within 1e-7 relative, then
  trains one iteration on the CPU;
- an optax state another optimizer's flags made (accumulation, training
  mode, schedule, frozen backbone, detection) is refused by both packages:
  the port raises a ValueError naming the flag; a directory with a best
  checkpoint and no last one is refused too;
- a resume into the JAX run's own directory writes the port's files beside
  the msgpack ones and records the msgpack it resumed from; that directory
  resumes again and serves, the msgpack files stay byte-identical, and a
  directory whose msgpack no longer matches the record raises.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from jolineedle_tpu.train.optim import make_optimizer
from jolineedle_tpu_torch import checkpoint as ckpt
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.infer import get_infer_args, infer, load_model_dir
from jolineedle_tpu_torch.main import build_trainer
from jolineedle_tpu_torch.main import main as port_main
from jolineedle_tpu_torch.models.bridge import gpt_param_entries, torch_to_flax
from jolineedle_tpu_torch.parallel import mesh
from jolineedle_tpu_torch.train.optim import Optimizer
from tests.test_torch_jax_run import _cli
from tests.test_torch_train import _Tiny

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

# _Tiny's parameters in the flax layout: "h" as a Dense kernel, [in, out].
ENTRIES = [("yolox.backbone.w", ("yolox", "backbone", "w"), "copy"),
           ("yolox.head.w", ("yolox", "head", "w"), "copy"),
           ("h.w", ("h", "w"), "dense")]
RESUME_FLAGS = ["--gradient-accumulation", "2", "--lr-schedule", "cosine", "--max-iters", "4"]


def _flax_tree(v):
    return {"yolox": {"backbone": {"w": v["backbone"]}, "head": {"w": v["head"]}},
            "h": {"w": v["h"].T}}


def _tiny_case(seed=5):
    rng = np.random.default_rng(seed)
    values = {k: rng.normal(size=(3, 4)).astype(np.float32) for k in ("backbone", "head", "h")}
    grads = [{k: (rng.normal(size=(3, 4)) * 2).astype(np.float32) for k in values}
             for _ in range(4)]
    return values, grads


def _kw(acc=2, clip=1.0, schedule="cosine", freeze=False, detection=True):
    return dict(learning_rate=1e-2, yolo_lr=3e-3, gradient_accumulation=acc,
                freeze_image_processor=freeze, detection_enabled=detection, clip_value=clip,
                weight_decay=0.05, lr_schedule=schedule, lr_warmup_iters=1, lr_decay_iters=5)


def _optax_bytes(kw, values, grads):
    """optax's state after ``grads``, as the JAX trainer writes it
    (``device_get``, then flax's bytes), and the params it reached."""
    params = jax.tree_util.tree_map(jnp.asarray, _flax_tree(values))
    tx = make_optimizer(params, **kw)
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, _flax_tree(g)),
                                   state, params)
        params = optax.apply_updates(params, updates)
    return tx, state, params, serialization.to_bytes(jax.device_get(state))


def _torch_values(params):
    return {"backbone": np.asarray(params["yolox"]["backbone"]["w"]),
            "head": np.asarray(params["yolox"]["head"]["w"]),
            "h": np.asarray(params["h"]["w"]).T}


def _leaves(tree, prefix=()):
    """{path: leaf}; an empty dict (a masked leaf, a stateless transform) is a leaf."""
    if isinstance(tree, dict) and tree:
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _assert_opt_trees(got, want, acc_rel):
    """Same structure; every leaf bit for bit, the accumulated gradients of
    the trained leaves within ``acc_rel`` (frozen ones: the port keeps none)."""
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if "acc_grads" in path:
            if np.any(g):
                np.testing.assert_allclose(g, w, rtol=acc_rel, atol=0, err_msg=str(path))
            continue
        if isinstance(w, dict):
            assert g == {}, path
            continue
        assert type(g) is type(w) and g.dtype == w.dtype and g.shape == w.shape, path
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), path


# Accumulation x clip x schedule, with the frozen backbone on in half: every
# pair of settings occurs.
TINY_CASES = [(acc, clip, schedule, (acc == 2) ^ (clip is not None) ^ (schedule == "cosine"))
              for acc in (1, 2) for clip in (None, 1.0) for schedule in ("constant", "cosine")]


@pytest.mark.parametrize("acc,clip,schedule,freeze", TINY_CASES)
def test_next_update_after_reading_optax_state_matches_optax(acc, clip, schedule, freeze):
    kw = _kw(acc, clip, schedule, freeze)
    values, grads = _tiny_case()
    tx, state, params, data = _optax_bytes(kw, values, grads[:3])

    model = _Tiny(_torch_values(params))
    opt = Optimizer(model, **kw)
    opt.load_state_dict(ckpt.flax_optimizer_state(ckpt.msgpack_restore(data), opt, ENTRIES))
    assert opt.updates == (3 if acc == 1 else 1) and opt.mini_step == 3 % acc
    written = ckpt.msgpack_serialize(ckpt.optimizer_to_flax(opt, ENTRIES))
    if acc == 1:
        assert written == data
    _assert_opt_trees(ckpt.msgpack_restore(written), ckpt.msgpack_restore(data), acc_rel=1e-7)

    updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, _flax_tree(grads[3])),
                               state, params)
    want = _torch_values(optax.apply_updates(params, updates))
    for name, p in (("backbone", model.yolox.backbone.w), ("head", model.yolox.head.w),
                    ("h", model.h.w)):
        g = torch.from_numpy(grads[3][name])
        p.grad = g.clone() if p.grad is None else p.grad + g
    assert opt.step()
    for name, p in (("backbone", model.yolox.backbone.w), ("head", model.yolox.head.w),
                    ("h", model.h.w)):
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, rtol=0,
                                   err_msg=name)
    assert not np.allclose(want["head"], _torch_values(params)["head"])


MISMATCHES = [
    ("--gradient-accumulation", dict(acc=2), dict(acc=1)),
    ("--training-mode", dict(clip=1.0), dict(clip=None)),
    ("--lr-schedule", dict(schedule="cosine"), dict(schedule="constant")),
    ("--freeze-image-processor", dict(freeze=False), dict(freeze=True)),
    ("--no-detection", dict(detection=True), dict(detection=False)),
]


@pytest.mark.parametrize("flag,a,b", MISMATCHES, ids=[m[0] for m in MISMATCHES])
@pytest.mark.parametrize("direction", ["forward", "back"])
def test_another_optimizers_state_is_refused_by_both(flag, a, b, direction):
    """The file of one setting, read under the other: flax's ``from_bytes``
    (or, where it grafts a masked leaf, optax's first update) fails; the
    port raises a ValueError naming the flag."""
    stored, current = (a, b) if direction == "forward" else (b, a)
    values, grads = _tiny_case()
    _, _, params, data = _optax_bytes(_kw(**stored), values, grads[:1])

    tx = make_optimizer(params, **_kw(**current))
    with pytest.raises(Exception):
        restored = serialization.from_bytes(tx.init(params), data)
        tx.update(jax.tree_util.tree_map(jnp.asarray, _flax_tree(grads[1])), restored, params)

    opt = Optimizer(_Tiny(_torch_values(params)), **_kw(**current))
    with pytest.raises(ValueError, match=flag):
        ckpt.flax_optimizer_state(ckpt.msgpack_restore(data), opt, ENTRIES)


# --- a directory the JAX train CLI wrote ------------------------------------------------
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    import main as jax_main
    from jolineedle_tpu.data.toy import generate_toy_dataset

    root = tmp_path_factory.mktemp("resume_jax")
    toy = generate_toy_dataset(root / "toy", n_train=4, n_test=2, image_size=(192, 256), seed=7)
    trainer = jax_main.main(jax_main.get_args(
        _cli(toy, root / "out", "supervised", RESUME_FLAGS)))
    run_dir = trainer.checkpoint_dir
    raw = ckpt.read_msgpack(run_dir / ckpt.FLAX_LAST)
    assert int(raw["step"]) == 3 and int(raw["opt_state"]["mini_step"]) == 1
    return dict(root=root, toy=toy, run_dir=run_dir, raw=raw)


def _port_flags(jax_run, work_dir, extra=()):
    return _cli(jax_run["toy"], work_dir, "supervised", RESUME_FLAGS + list(extra))


def test_resumed_trainer_holds_the_jax_train_state(jax_run):
    flags = _port_flags(jax_run, jax_run["root"] / "port",
                        ["--resume-training", str(jax_run["run_dir"])])
    train_config, model_config = tconfig.args_to_config(tconfig.get_args(flags))
    trainer = build_trainer(mesh.single("cpu"), train_config, model_config,
                            str(jax_run["toy"]), log=False)
    raw, opt, model = jax_run["raw"], trainer.optimizer, trainer.model
    adam = raw["opt_state"]["inner_opt_state"]["inner_states"]
    assert trainer.step == 3 and opt.updates == 1 and opt.mini_step == 1
    assert trainer.jax_origin["name"] == ckpt.FLAX_LAST

    # each trained parameter's moments, in the flax layout, are the file's
    state = opt.adamw.state_dict()["state"]
    for part in ("gpt", "yolox"):
        mine = [i for i, n in enumerate(opt.trained_names) if opt.labels[n] == part]
        assert mine
        assert all(float(state[i]["step"]) == 1.0 for i in mine)
        for moment, key in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            tree = torch_to_flax({opt.trained_names[i]: state[i][moment] for i in mine},
                                 model, strict=False)["params"]
            stored = _leaves(adam[part]["inner_state"]["0"][key])
            got = _leaves(tree)
            assert got and all(isinstance(stored[p], np.ndarray) for p in got)
            assert sum(isinstance(v, np.ndarray) for v in stored.values()) == len(got)
            for path, value in got.items():
                assert value.dtype == stored[path].dtype and value.shape == stored[path].shape
                assert value.tobytes() == stored[path].tobytes(), (part, key, path)
        assert int(adam[part]["inner_state"]["0"]["count"]) == opt.updates
        assert int(adam[part]["inner_state"]["2"]["count"]) == opt.updates

    # the window: every trained grad is acc_grads x mini_step
    grads = {name: opt.params[name].grad for name in opt.trained_names}
    acc = _leaves(torch_to_flax(grads, model, strict=False)["params"])
    stored = _leaves(raw["opt_state"]["acc_grads"])
    assert acc.keys() == stored.keys()
    for path, value in acc.items():
        want = stored[path] * int(raw["opt_state"]["mini_step"])
        np.testing.assert_allclose(value, want, rtol=1e-7, atol=0, err_msg=str(path))

    # the port's writer gives the file's optax state back
    _assert_opt_trees(ckpt.optimizer_to_flax(opt, gpt_param_entries(model)), raw["opt_state"],
                      acc_rel=1e-7)

    # one iteration on the CPU completes the window
    trainer.train_loop([1])
    assert trainer.step == 4 and opt.updates == 2 and opt.mini_step == 0
    assert np.isfinite(float(trainer.loss_history[-1]))


def test_resume_in_the_jax_runs_own_directory(jax_run, tmp_path, capfd):
    run_dir = tmp_path / "supervised"
    shutil.copytree(jax_run["run_dir"], run_dir)
    jax_bytes = {n: (run_dir / n).read_bytes() for n in (ckpt.FLAX_LAST, ckpt.FLAX_BEST)}
    flags = lambda: _port_flags(jax_run, tmp_path, ["--resume-training", str(run_dir),
                                                    "--max-iters", "2"])

    first = port_main(tconfig.get_args(flags()), device="cpu")
    out = capfd.readouterr().out
    assert f"Loading best checkpoint for validation: {run_dir / ckpt.FLAX_BEST}" in out
    assert first.checkpoint_dir == run_dir and first.step == 4
    names = {p.name for p in run_dir.iterdir()}
    assert {ckpt.CKPT_LAST, ckpt.CKPT_BEST, ckpt.TRAIN_STATE, *jax_bytes} <= names
    assert ckpt.load_train_state(run_dir)["jax_origin"] == first.jax_origin
    assert ckpt.resumed_here(run_dir)
    assert ckpt.model_file(run_dir, best=False) == run_dir / ckpt.CKPT_LAST
    assert ckpt.model_file(run_dir, best=True) == run_dir / ckpt.CKPT_BEST

    second = port_main(tconfig.get_args(flags()), device="cpu")
    assert second.step == 5 and second.optimizer.updates == 2
    assert second.jax_origin == first.jax_origin and ckpt.resumed_here(run_dir)
    capfd.readouterr()
    infer(get_infer_args(["--model-dir", str(run_dir), "--dataset",
                          str(jax_run["toy"] / "test.txt")]), device="cpu")
    assert "map" in capfd.readouterr().out
    _, _, served = load_model_dir(run_dir, device="cpu")
    saved = torch.load(run_dir / ckpt.CKPT_BEST, weights_only=True)
    for key, value in served.state_dict().items():
        torch.testing.assert_close(value, saved[key], rtol=0, atol=0, msg=key)
    for name, data in jax_bytes.items():
        assert (run_dir / name).read_bytes() == data, name

    # once the msgpack is not the one recorded (a JAX run went on there), the
    # two kinds are ambiguous
    other = tmp_path / "other"
    shutil.copytree(run_dir, other)
    tree = ckpt.read_msgpack(other / ckpt.FLAX_LAST)
    tree["step"] = np.asarray(9, np.int32)
    ckpt.write_msgpack(other / ckpt.FLAX_LAST, tree)
    assert not ckpt.resumed_here(other)
    with pytest.raises(ValueError, match="holds both"):
        load_model_dir(other, device="cpu")
    with pytest.raises(ValueError, match="holds both"):
        port_main(tconfig.get_args(flags()[:-4] + ["--resume-training", str(other)]),
                  device="cpu")
