"""Weights carried between the JAX package and the port.

``flax_to_torch`` takes the JAX ``{"params", "batch_stats"}`` trees of a
``GPT`` (as ``GPT.init_all`` makes them, leaves as numpy arrays) and loads
them into the port's :class:`~jolineedle_tpu_torch.models.gpt.GPT`;
``torch_to_flax`` goes the other way. The mapping is an explicit list of
(torch key, flax collection, flax path, transform) entries, so a leaf that
is unmapped or left unused raises instead of being dropped.
``yolox_flax_to_torch`` and ``yolox_torch_to_flax`` do the same for a
``NeedleYOLOX`` alone (the JAX ``yolox`` subtree: ``--detection-checkpoint``
files).

The YOLOX entries invert a copy of ``jolineedle_tpu/models/port.py``'s
``yolox_key_map`` (``port.py:43-189``): the Megvii attribute names of the
port's modules against the call-order names of the flax modules. Leaf
transforms:

- ``conv``: HWIO <-> OIHW (a depthwise ``[3, 3, 1, C]`` is ``[C, 1, 3, 3]``);
- ``dense``: a Dense kernel ``[in, out]`` is a Linear weight ``[out, in]``;
- ``copy``: BatchNorm ``scale/bias/mean/var`` are ``weight/bias/
  running_mean/running_var``, LayerNorm ``scale`` is ``weight``, Embed
  ``embedding`` is ``weight``, biases are biases.

BatchNorm's ``num_batches_tracked`` has no flax counterpart: it is set to 0
one way and skipped the other.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from .yolox import YOLOX_VARIANTS

MapEntry = Tuple[str, str, Tuple[str, ...], str]

_CONV_LEAVES = (("conv.weight", "params", ("Conv_0", "kernel"), "conv"),)
_BN_LEAVES = (
    ("bn.weight", "params", ("BatchNorm_0", "scale"), "copy"),
    ("bn.bias", "params", ("BatchNorm_0", "bias"), "copy"),
    ("bn.running_mean", "batch_stats", ("BatchNorm_0", "mean"), "copy"),
    ("bn.running_var", "batch_stats", ("BatchNorm_0", "var"), "copy"),
)


# --- YOLOX (copy of jolineedle_tpu/models/port.py:43-189) ---------------------
def _base_conv(tprefix: str, fpath: Tuple[str, ...]) -> Iterator[MapEntry]:
    for suffix, coll, leaf, tf in _CONV_LEAVES + _BN_LEAVES:
        yield f"{tprefix}.{suffix}", coll, fpath + leaf, tf


def _dw_conv(tprefix, fpath) -> Iterator[MapEntry]:
    yield from _base_conv(f"{tprefix}.dconv", fpath + ("ConvBnAct_0",))
    yield from _base_conv(f"{tprefix}.pconv", fpath + ("ConvBnAct_1",))


def _conv(tprefix, fpath, depthwise: bool) -> Iterator[MapEntry]:
    yield from (_dw_conv if depthwise else _base_conv)(tprefix, fpath)


def _bottleneck(tprefix, fpath, depthwise: bool) -> Iterator[MapEntry]:
    yield from _base_conv(f"{tprefix}.conv1", fpath + ("ConvBnAct_0",))
    if depthwise:
        yield from _dw_conv(f"{tprefix}.conv2", fpath + ("DWConv_0",))
    else:
        yield from _base_conv(f"{tprefix}.conv2", fpath + ("ConvBnAct_1",))


def _csp_layer(tprefix, fpath, n: int, depthwise: bool) -> Iterator[MapEntry]:
    yield from _base_conv(f"{tprefix}.conv1", fpath + ("ConvBnAct_0",))
    yield from _base_conv(f"{tprefix}.conv2", fpath + ("ConvBnAct_1",))
    for i in range(n):
        yield from _bottleneck(f"{tprefix}.m.{i}", fpath + (f"Bottleneck_{i}",), depthwise)
    yield from _base_conv(f"{tprefix}.conv3", fpath + ("ConvBnAct_2",))


def _darknet(tprefix, fpath, depth: float, depthwise: bool) -> Iterator[MapEntry]:
    base_depth = max(round(depth * 3), 1)
    conv_name = "DWConv" if depthwise else "ConvBnAct"
    # Upstream Focus holds a BaseConv even in the depthwise variants.
    yield from _base_conv(f"{tprefix}.stem.conv", fpath + ("Focus_0", "ConvBnAct_0"))
    for i, dark in enumerate(("dark2", "dark3", "dark4")):
        n = base_depth if dark == "dark2" else base_depth * 3
        yield from _conv(f"{tprefix}.{dark}.0", fpath + (f"{conv_name}_{i}",), depthwise)
        yield from _csp_layer(f"{tprefix}.{dark}.1", fpath + (f"CSPLayer_{i}",), n, depthwise)
    yield from _conv(f"{tprefix}.dark5.0", fpath + (f"{conv_name}_3",), depthwise)
    yield from _base_conv(f"{tprefix}.dark5.1.conv1", fpath + ("SPPBottleneck_0", "ConvBnAct_0"))
    yield from _base_conv(f"{tprefix}.dark5.1.conv2", fpath + ("SPPBottleneck_0", "ConvBnAct_1"))
    yield from _csp_layer(f"{tprefix}.dark5.2", fpath + ("CSPLayer_3",), base_depth, depthwise)


def _pafpn(tprefix, fpath, depth: float, depthwise: bool) -> Iterator[MapEntry]:
    n = max(round(depth * 3), 1)
    yield from _darknet(f"{tprefix}.backbone", fpath + ("CSPDarknet_0",), depth, depthwise)
    # Call-order names of YOLOPAFPN (jolineedle_tpu/models/yolox.py:238-260):
    # the laterals are plain ConvBnAct; the bottom-up convs follow depthwise.
    yield from _base_conv(f"{tprefix}.lateral_conv0", fpath + ("ConvBnAct_0",))
    yield from _csp_layer(f"{tprefix}.C3_p4", fpath + ("CSPLayer_0",), n, depthwise)
    yield from _base_conv(f"{tprefix}.reduce_conv1", fpath + ("ConvBnAct_1",))
    yield from _csp_layer(f"{tprefix}.C3_p3", fpath + ("CSPLayer_1",), n, depthwise)
    bu = ("DWConv_0", "DWConv_1") if depthwise else ("ConvBnAct_2", "ConvBnAct_3")
    yield from _conv(f"{tprefix}.bu_conv2", fpath + (bu[0],), depthwise)
    yield from _csp_layer(f"{tprefix}.C3_n3", fpath + ("CSPLayer_2",), n, depthwise)
    yield from _conv(f"{tprefix}.bu_conv1", fpath + (bu[1],), depthwise)
    yield from _csp_layer(f"{tprefix}.C3_n4", fpath + ("CSPLayer_3",), n, depthwise)


def _head(tprefix, fpath, depthwise: bool) -> Iterator[MapEntry]:
    for level in range(3):
        yield from _base_conv(f"{tprefix}.stems.{level}", fpath + (f"stem_{level}",))
        for branch in ("cls", "reg"):
            for j in range(2):
                yield from _conv(
                    f"{tprefix}.{branch}_convs.{level}.{j}",
                    fpath + (f"{branch}_conv{j}_{level}",),
                    depthwise,
                )
        for pred in ("cls", "reg", "obj"):
            name = f"{pred}_pred_{level}"
            yield f"{tprefix}.{pred}_preds.{level}.weight", "params", fpath + (name, "kernel"), "conv"
            yield f"{tprefix}.{pred}_preds.{level}.bias", "params", fpath + (name, "bias"), "copy"


def yolox_key_map(variant: str, include_head: bool = True) -> List[MapEntry]:
    """(torch key, collection, flax path, transform) for an upstream-named
    YOLOX (``backbone.*`` PAFPN, ``head.*``) of the given size variant."""
    depth, _, depthwise = YOLOX_VARIANTS[variant]
    entries = list(_pafpn("backbone", ("backbone",), depth, depthwise))
    if include_head:
        entries += list(_head("head", ("head",), depthwise))
    return entries


# --- GPT ------------------------------------------------------------------------
def _dense(tname: str, fpath: Tuple[str, ...], bias: bool = True) -> Iterator[MapEntry]:
    yield f"{tname}.weight", "params", fpath + ("kernel",), "dense"
    if bias:
        yield f"{tname}.bias", "params", fpath + ("bias",), "copy"


def _layer_norm(tname: str, fpath: Tuple[str, ...]) -> Iterator[MapEntry]:
    yield f"{tname}.weight", "params", fpath + ("scale",), "copy"
    yield f"{tname}.bias", "params", fpath + ("bias",), "copy"


def gpt_key_map(model) -> List[MapEntry]:
    """Every (torch key, collection, flax path, transform) of the port's
    ``GPT`` ``model`` against the JAX ``GPT`` of the same config."""
    entries: List[MapEntry] = [
        ("wte.weight", "params", ("wte", "embedding"), "copy"),
        ("embed_class.weight", "params", ("embed_class", "embedding"), "copy"),
    ]
    if not model.decoder_pos_encoding:
        entries.append(("wpe.weight", "params", ("wpe", "embedding"), "copy"))
    for tkey, coll, fpath, tf in yolox_key_map(model.yolox.variant):
        entries.append((f"yolox.{tkey}", coll, ("yolox",) + fpath, tf))
    if model.gpt_backbone:
        for tkey, coll, fpath, tf in yolox_key_map(model.gpt_backbone, include_head=False):
            # "backbone.<rest>" / ("backbone", ...) -> the bare PAFPN
            tkey = "gpt_backbone_net." + tkey.split(".", 1)[1]
            entries.append((tkey, coll, ("gpt_backbone_net",) + fpath[1:], tf))
    if not model.no_patch_emb:
        entries.append(("embed_fpn_conv.weight", "params", ("embed_fpn_conv", "kernel"), "conv"))
        entries += _dense("embed_fpn_dense", ("embed_fpn_dense",))
    if model.concat_emb:
        entries += _dense("project_concat", ("project_concat",))
    for i in range(model.n_layer):
        t, f = f"h.{i}", (f"h_{i}",)
        entries += _layer_norm(f"{t}.ln_1", f + ("ln_1",))
        entries += _dense(f"{t}.attn.c_attn", f + ("attn", "c_attn"))
        entries += _dense(f"{t}.attn.c_proj", f + ("attn", "c_proj"))
        entries += _layer_norm(f"{t}.ln_2", f + ("ln_2",))
        entries += _dense(f"{t}.c_fc", f + ("c_fc",))
        entries += _dense(f"{t}.c_proj", f + ("c_proj",))
    entries += _layer_norm("ln_f", ("ln_f",))
    entries += _dense("action_head.dense", ("action_head", "Dense_0"), bias=False)
    return entries


def gpt_param_entries(model) -> List[Tuple[str, Tuple[str, ...], str]]:
    """(torch parameter name, flax ``params`` path, transform) of every
    parameter of the port's ``GPT`` ``model``: ``gpt_key_map`` without the
    batch statistics. optax's per-parameter trees (the AdamW moments, the
    accumulated gradients) have this layout."""
    return [(tkey, fpath, tf) for tkey, coll, fpath, tf in gpt_key_map(model)
            if coll == "params"]


# --- leaf transforms -------------------------------------------------------------
def _to_torch(value: np.ndarray, how: str) -> np.ndarray:
    value = np.asarray(value, np.float32)
    if how == "conv":
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if how == "dense":
        return value.T  # [in, out] -> [out, in]
    return value


def _to_flax(value: np.ndarray, how: str) -> np.ndarray:
    if how == "conv":
        return value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    if how == "dense":
        return value.T
    return value


def _flat_leaves(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _load_flax(variables_np: dict, module, entries: List[MapEntry]) -> Dict[str, torch.Tensor]:
    trees = {c: _flat_leaves(variables_np.get(c, {})) for c in ("params", "batch_stats")}
    used = {c: set() for c in trees}
    own = module.state_dict()
    state: Dict[str, torch.Tensor] = {}
    for tkey, coll, fpath, tf in entries:
        if fpath not in trees[coll]:
            raise KeyError(f"flax tree has no {coll}/{'/'.join(fpath)} (for {tkey})")
        if tkey not in own:
            raise KeyError(f"the port's model has no {tkey} (for {coll}/{'/'.join(fpath)})")
        value = torch.from_numpy(np.array(_to_torch(trees[coll][fpath], tf)))
        if tuple(value.shape) != tuple(own[tkey].shape):
            raise ValueError(
                f"{tkey}: {tuple(value.shape)} from {'/'.join(fpath)},"
                f" expected {tuple(own[tkey].shape)}"
            )
        state[tkey] = value
        used[coll].add(fpath)
    for coll, leaves in trees.items():
        unused = sorted("/".join(p) for p in set(leaves) - used[coll])
        if unused:
            raise KeyError(f"flax {coll} leaves with no port counterpart: {unused}")
    for tkey, value in own.items():
        if tkey.endswith(".num_batches_tracked"):
            state[tkey] = torch.zeros_like(value)
    module.load_state_dict(state, strict=True)
    return state


def _to_flax_tree(state_dict: Dict[str, torch.Tensor], entries: List[MapEntry],
                  strict: bool) -> dict:
    out = {"params": {}, "batch_stats": {}}
    mapped = set()
    for tkey, coll, fpath, tf in entries:
        if tkey not in state_dict:
            if strict:
                raise KeyError(f"state_dict is missing {tkey}")
            continue
        node = out[coll]
        for p in fpath[:-1]:
            node = node.setdefault(p, {})
        node[fpath[-1]] = _to_flax(state_dict[tkey].detach().cpu().float().numpy(), tf)
        mapped.add(tkey)
    extra = sorted(
        k for k in state_dict if k not in mapped and not k.endswith(".num_batches_tracked")
    )
    if extra and strict:
        raise KeyError(f"state_dict keys with no flax counterpart: {extra}")
    return out


def flax_to_torch(variables_np: dict, model) -> Dict[str, torch.Tensor]:
    """Load JAX ``{"params", "batch_stats"}`` (nested numpy dicts) into the
    port's ``GPT`` ``model`` with ``strict=True`` and return the state_dict
    that was loaded. Raises on a missing, unused or misshapen leaf."""
    return _load_flax(variables_np, model, gpt_key_map(model))


def torch_to_flax(state_dict: Dict[str, torch.Tensor], model, strict: bool = True) -> dict:
    """The port's ``GPT`` state_dict -> JAX ``{"params", "batch_stats"}`` as
    nested numpy dicts. Raises on a torch key that has no flax leaf or a
    leaf with no torch key; with ``strict=False`` it leaves out the leaves
    ``state_dict`` lacks and ignores its other keys (another config's
    checkpoint, grafted by ``checkpoint.load_params_only``)."""
    return _to_flax_tree(state_dict, gpt_key_map(model), strict)


def yolox_flax_to_torch(variables_np: dict, yolox) -> Dict[str, torch.Tensor]:
    """``flax_to_torch`` for a ``NeedleYOLOX`` alone: the JAX ``yolox``
    subtree (``{"params", "batch_stats"}`` with ``backbone`` and ``head``)
    into the port's ``yolox`` module, strictly."""
    return _load_flax(variables_np, yolox, yolox_key_map(yolox.variant))


def yolox_torch_to_flax(state_dict: Dict[str, torch.Tensor], yolox) -> dict:
    """``torch_to_flax`` for a ``NeedleYOLOX`` alone, strictly: the JAX
    ``yolox`` subtree, as ``scripts/port_yolox_weights.py`` writes it."""
    return _to_flax_tree(state_dict, yolox_key_map(yolox.variant), True)
