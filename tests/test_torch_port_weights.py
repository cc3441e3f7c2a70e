"""Upstream (Megvii) YOLOX weights: the port's ``models/port.py`` and
``scripts/port_yolox_weights.py`` against the JAX package's.

A synthetic upstream state dict of yolox-nano (every key of
``yolox_key_map``, random values, an 80-class ``cls_preds`` as COCO's) is
mapped by both packages:

- ``port_yolox_state_dict`` equals JAX's ``port_yolox_state_dict``
  followed by ``yolox_flax_to_torch`` on every mapped leaf, with the same
  skipped keys (the 80-class predictions), also with ``include_head=False``;
  ``strict`` raises on a missing key in both;
- the two scripts' msgpack files hold the same tree (through flax's
  reader) on every leaf that is not skipped, also with ``--backbone-only``;
- either script's file loads through either package's
  ``load_detection_params``.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from jolineedle_tpu import checkpoint as jckpt
from jolineedle_tpu.models import port as jport
from jolineedle_tpu.models.yolox import NeedleYOLOX as JaxYOLOX
from jolineedle_tpu.train.trainer import TrainState
from jolineedle_tpu_torch import checkpoint as ckpt
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info
from jolineedle_tpu_torch.models import port as tport
from jolineedle_tpu_torch.models.bridge import yolox_flax_to_torch, yolox_key_map
from jolineedle_tpu_torch.models.gpt import GPT
from jolineedle_tpu_torch.models.yolox import NeedleYOLOX
from jolineedle_tpu_torch.scripts import port_yolox_weights as tscript

ROOT = Path(__file__).resolve().parents[1]
VARIANT, P, COCO = "yolox-nano", 64, 80
CLS_PREDS = [f"head.cls_preds.{i}.{leaf}" for i in range(3) for leaf in ("weight", "bias")]


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """A Megvii-layout state dict with COCO's class count, its .pth file,
    and JAX's fresh NeedleYOLOX variables (the JAX script's init)."""
    torch.manual_seed(0)
    own = NeedleYOLOX(VARIANT, device="cpu").state_dict()
    gen = torch.Generator().manual_seed(1)
    sd = {}
    for tkey, _, _, _ in yolox_key_map(VARIANT):
        shape = list(own[tkey].shape)
        if tkey in CLS_PREDS:
            shape[0] = COCO
        value = torch.randn(shape, generator=gen)
        sd[tkey] = value.abs() + 0.5 if tkey.endswith("running_var") else value
        # an upstream file also holds BN's counters, which map to nothing
        if tkey.endswith("bn.running_mean"):
            sd[tkey.replace("running_mean", "num_batches_tracked")] = torch.tensor(7)
    path = tmp_path_factory.mktemp("upstream") / "yolox_nano.pth"
    torch.save({"model": sd}, path)
    variables = jax.device_get(JaxYOLOX(variant=VARIANT, num_classes=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, P, P, 3))))
    return dict(sd=sd, path=path, variables=variables, root=path.parent)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("include_head", [True, False])
def test_port_state_dict_matches_jax(upstream, include_head):
    sd, variables = upstream["sd"], upstream["variables"]
    params, stats, want_skipped = jport.port_yolox_state_dict(
        _np(sd), variables["params"], variables["batch_stats"], VARIANT,
        include_head=include_head, num_classes=1)
    target = NeedleYOLOX(VARIANT, device="cpu").state_dict()
    got, skipped = tport.port_yolox_state_dict(sd, target, VARIANT, include_head=include_head,
                                               num_classes=1)
    assert skipped == want_skipped == (CLS_PREDS if include_head else [])
    want = yolox_flax_to_torch({"params": params, "batch_stats": stats},
                               NeedleYOLOX(VARIANT, device="cpu"))
    n = 0
    for tkey, _, _, _ in yolox_key_map(VARIANT, include_head):
        if tkey in skipped:
            torch.testing.assert_close(got[tkey], target[tkey], rtol=0, atol=0)
            continue
        torch.testing.assert_close(got[tkey], want[tkey], rtol=0, atol=0, msg=tkey)
        torch.testing.assert_close(got[tkey], sd[tkey], rtol=0, atol=0, msg=tkey)
        n += 1
    assert n == len(yolox_key_map(VARIANT, include_head)) - len(skipped) > 100


def test_strict_raises_on_a_missing_key_in_both(upstream):
    sd = dict(upstream["sd"])
    del sd["backbone.C3_p3.conv1.bn.bias"]
    variables = upstream["variables"]
    with pytest.raises(KeyError, match="backbone.C3_p3.conv1.bn.bias"):
        jport.port_yolox_state_dict(_np(sd), variables["params"], variables["batch_stats"],
                                    VARIANT)
    with pytest.raises(KeyError, match="backbone.C3_p3.conv1.bn.bias"):
        tport.port_yolox_state_dict(sd, NeedleYOLOX(VARIANT, device="cpu").state_dict(),
                                    VARIANT)
    _, skipped = tport.port_yolox_state_dict(
        sd, NeedleYOLOX(VARIANT, device="cpu").state_dict(), VARIANT, strict=False)
    assert skipped[0] == "backbone.C3_p3.conv1.bn.bias" and skipped[1:] == CLS_PREDS
    assert tport.load_torch_checkpoint(upstream["path"]).keys() == upstream["sd"].keys()


def _run_jax_script(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_port_yolox_weights", ROOT / "scripts" / "port_yolox_weights.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["port_yolox_weights.py"] + argv)
    script.main()


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


@pytest.mark.parametrize("backbone_only", [False, True])
def test_scripts_write_the_same_file(upstream, backbone_only, monkeypatch):
    root = upstream["root"]
    flags = ["--checkpoint", str(upstream["path"]), "--variant", VARIANT,
             "--patch-size", str(P)] + (["--backbone-only"] if backbone_only else [])
    tag = "bb" if backbone_only else "full"
    _run_jax_script(flags + ["--output", str(root / f"jax_{tag}.msgpack")], monkeypatch)
    skipped = tscript.main(flags + ["--output", str(root / f"port_{tag}.msgpack")])
    assert skipped == ([] if backbone_only else CLS_PREDS)
    want = _flat(serialization.msgpack_restore((root / f"jax_{tag}.msgpack").read_bytes()))
    got = _flat(serialization.msgpack_restore((root / f"port_{tag}.msgpack").read_bytes()))
    assert got.keys() == want.keys()
    n_skipped = 0
    for path, value in want.items():
        assert got[path].dtype == value.dtype and got[path].shape == value.shape, path
        if any(p.startswith("cls_pred_") for p in path):
            n_skipped += 1  # each package's fresh init
            continue
        np.testing.assert_array_equal(got[path], value, err_msg="/".join(path))
    assert n_skipped == (0 if backbone_only else 6)


def test_either_file_loads_in_either_package(upstream, monkeypatch):
    root = upstream["root"]
    flags = ["--checkpoint", str(upstream["path"]), "--variant", VARIANT, "--patch-size", str(P)]
    _run_jax_script(flags + ["--output", str(root / "jax.msgpack")], monkeypatch)
    tscript.main(flags + ["--output", str(root / "port.msgpack")])
    cli = ["--model-type", "gpt-nano", "--image-processor", VARIANT, "--patch-size", str(P),
           "--concat-embeddings", "--decoder-pos-encoding", "--enable-stop",
           "--max-seq-len", "4", "--compute-dtype", "float32", "--dataset-dir", "/nonexistent"]
    train_config, model_config = tconfig.args_to_config(tconfig.get_args(cli))
    variables = upstream["variables"]
    for name in ("jax.msgpack", "port.msgpack"):
        # the port
        torch.manual_seed(0)
        model = GPT.from_config(model_config, get_actions_info(train_config), device="cpu")
        wte = model.wte.weight.detach().clone()
        ckpt.load_detection_params(root / name, model)
        state = model.yolox.state_dict()
        for key, value in upstream["sd"].items():
            if key not in CLS_PREDS and not key.endswith("num_batches_tracked"):
                torch.testing.assert_close(state[key], value, rtol=0, atol=0, msg=key)
        torch.testing.assert_close(model.wte.weight, wte, rtol=0, atol=0)
        # the JAX package, on a state holding a fresh yolox tree
        target = TrainState(params={"yolox": variables["params"]},
                            batch_stats={"yolox": variables["batch_stats"]},
                            opt_state=None, step=jnp.zeros((), jnp.int32))
        loaded = jckpt.load_detection_params(root / name, target)
        got = yolox_flax_to_torch({"params": loaded.params["yolox"],
                                   "batch_stats": loaded.batch_stats["yolox"]},
                                  NeedleYOLOX(VARIANT, device="cpu"))
        for key, value in upstream["sd"].items():
            if key not in CLS_PREDS and not key.endswith("num_batches_tracked"):
                torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)
