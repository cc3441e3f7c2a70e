"""Checkpoints of the port, and the JAX package's msgpack files.

A model directory holds ``config.json`` (``config.save_config``) beside the
last and the best checkpoint. The port writes ``checkpoint.pt`` and
``checkpoint_best.pt``, each the model's ``state_dict``, and a trainer adds
``train_state.pt``, the rest of its state at the last checkpoint (optimizer,
step count, return window, random generator), which ``--resume-training``
restores with ``checkpoint.pt``.

The JAX package writes ``checkpoint.msgpack`` and ``checkpoint_best.msgpack``
instead: flax's msgpack encoding of its whole train state (``params``,
``batch_stats``, ``opt_state``, ``step``; ``jolineedle_tpu/checkpoint.py``).
The port reads them with its own codec (``msgpack_restore``, stdlib and
numpy only) and loads the model part through ``models/bridge.py``: for
serving (``load_model_file``), for ``--init-from`` (``load_params_only``,
which grafts across a changed action count) and for
``--detection-checkpoint`` (``load_detection_params``). The JAX optimizer
state is not carried across, so ``--resume-training`` takes only the port's
own files.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .models.bridge import (
    flax_to_torch,
    torch_to_flax,
    yolox_flax_to_torch,
    yolox_torch_to_flax,
)

CKPT_LAST = "checkpoint.pt"
CKPT_BEST = "checkpoint_best.pt"
TRAIN_STATE = "train_state.pt"
FLAX_LAST = "checkpoint.msgpack"
FLAX_BEST = "checkpoint_best.msgpack"


# --- flax's msgpack ----------------------------------------------------------------
# The counterpart of flax's ``serialization.msgpack_restore`` and
# ``msgpack_serialize``: msgpack maps, arrays, strings, binaries, ints,
# floats, nil and bools, and three ext types (flax's ``_MsgpackExtType``):
# an ndarray (an inner msgpack ``(shape, dtype name, C-order bytes)``), a
# complex (an inner ``(real, imag)``) and a numpy scalar (an ndarray of
# shape ``()``).
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_KEY = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes that are not a whole msgpack tree this reader handles."""


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(f"truncated: {n} bytes needed at offset {self.pos},"
                               f" {len(self.data) - self.pos} left")
        out = self.data[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# first byte -> struct format of the length that follows
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_NUMBER = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
           0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _decode(r: _Reader, path: tuple):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if b in _NUMBER:
        return r.unpack(_NUMBER[b])
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if 0xA0 <= b <= 0xBF or b in _STR:
        n = b & 0x1F if b <= 0xBF else r.unpack(_STR[b])
        return str(r.take(n), "utf-8")
    if b in _BIN:
        return bytes(r.take(r.unpack(_BIN[b])))
    if 0x90 <= b <= 0x9F or b in _ARRAY:
        n = b & 0x0F if b <= 0x9F else r.unpack(_ARRAY[b])
        return [_decode(r, path + (str(i),)) for i in range(n)]
    if 0x80 <= b <= 0x8F or b in _MAP:
        n = b & 0x0F if b <= 0x8F else r.unpack(_MAP[b])
        out = {}
        for _ in range(n):
            key = _decode(r, path)
            if not isinstance(key, (str, bytes)):
                raise MsgpackError(f"a map key at /{'/'.join(path)} is {type(key).__name__}")
            out[key] = _decode(r, path + (str(key),))
        if CHUNKED_KEY in out:
            raise MsgpackError(
                f"/{'/'.join(path)} is a chunked array ({CHUNKED_KEY}: a leaf over 2**30"
                " bytes), which this reader does not join")
        return out
    if b in _FIXEXT or b in _EXT:
        n = _FIXEXT[b] if b in _FIXEXT else r.unpack(_EXT[b])
        code = r.unpack(">b")
        return _decode_ext(code, r.take(n), path)
    raise MsgpackError(f"byte 0x{b:02x} at offset {r.pos - 1} starts no msgpack object")


def _decode_whole(data, path: tuple):
    r = _Reader(data)
    out = _decode(r, path)
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object"
                           f" at /{'/'.join(path)}")
    return out


def _ndarray(payload, path: tuple) -> np.ndarray:
    parts = _decode_whole(payload, path)
    if not (isinstance(parts, list) and len(parts) == 3):
        raise MsgpackError(f"/{'/'.join(path)}: an ndarray ext holds {parts!r:.80}")
    shape, name, buf = parts
    if name == "bfloat16":
        # bfloat16 is the top half of a float32: widen exactly.
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise MsgpackError(f"/{'/'.join(path)}: unknown dtype {name!r}") from e
        if dtype.hasobject or len(buf) % dtype.itemsize:
            raise MsgpackError(f"/{'/'.join(path)}: {len(buf)} bytes of {name}")
        arr = np.frombuffer(buf, dtype).copy()
    if arr.size != math.prod(shape):
        raise MsgpackError(f"/{'/'.join(path)}: {arr.size} elements for shape {shape}")
    return arr.reshape(shape)


def _decode_ext(code: int, payload, path: tuple):
    if code == EXT_NDARRAY:
        return _ndarray(payload, path)
    if code == EXT_NPSCALAR:
        return _ndarray(payload, path)[()]
    if code == EXT_COMPLEX:
        real, imag = _decode_whole(payload, path)
        return complex(real, imag)
    raise MsgpackError(f"/{'/'.join(path)}: ext type {code} is none of flax's")


def msgpack_restore(data: bytes):
    """flax's ``serialization.msgpack_restore`` without flax or msgpack:
    nested dicts (str keys), lists (flax's tuples), numpy arrays and
    scalars, Python numbers, str, bytes, None, bool and complex. A
    ``bfloat16`` leaf comes back as float32 (exactly). Raises MsgpackError
    on a truncated file, trailing bytes or a chunked array."""
    return _decode_whole(data, ())


def _header(out: bytearray, n: int, fix: Optional[tuple], wide: tuple) -> None:
    """``fix`` = (first byte, largest n); ``wide`` = ((byte, fmt), ...) by size."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] | n)
        return
    for byte, fmt in wide:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} does not fit msgpack")


def _encode_int(out: bytearray, x: int) -> None:
    if 0 <= x <= 0x7F or -32 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
        return
    kinds = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if x >= 0 else \
        ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for byte, fmt in kinds:
        bits = 8 * struct.calcsize(fmt)
        if (x < 1 << bits) if x >= 0 else (x >= -(1 << (bits - 1))):
            out.append(byte)
            out += struct.pack(fmt, x)
            return
    raise MsgpackError(f"integer {x} does not fit msgpack")


def _encode_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(fix[n])
    else:
        _header(out, n, None, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    out += struct.pack(">b", code)
    out += payload


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError(f"dtype {arr.dtype} cannot be written")
    return msgpack_serialize((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _encode(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        if x.nbytes > 2**30:  # flax would write it as a chunked dict
            raise MsgpackError(f"a {x.nbytes}-byte leaf, which flax would chunk")
        _encode_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _encode_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif isinstance(x, dict):
        _header(out, len(x), (0x80, 0x0F), ((0xDE, ">H"), (0xDF, ">I")))
        for key in sorted(x):  # flax's tree_map copy rebuilds dicts in key order
            _encode(out, key)
            _encode(out, x[key])
    elif isinstance(x, int):
        _encode_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _header(out, len(data), (0xA0, 0x1F), ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out += data
    elif isinstance(x, bytes):
        _header(out, len(x), None, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out += x
    elif isinstance(x, (list, tuple)):
        _header(out, len(x), (0x90, 0x0F), ((0xDC, ">H"), (0xDD, ">I")))
        for item in x:
            _encode(out, item)
    else:
        raise MsgpackError(f"cannot write a {type(x).__name__}")


def msgpack_serialize(tree) -> bytes:
    """flax's ``serialization.msgpack_serialize`` for the trees this model
    writes: nested str-keyed dicts of numpy arrays and scalars (and Python
    numbers, str, None). The same bytes as flax, whose copy of the tree
    orders every dict by key. Leaves over 2**30 bytes, which flax would
    chunk, are refused."""
    out = bytearray()
    _encode(out, tree)
    return bytes(out)


def read_msgpack(path):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def write_msgpack(path, tree) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = msgpack_serialize(tree)
    with open(path, "wb") as f:
        f.write(data)
    return path


# --- the port's own files -------------------------------------------------------------
def save_model(model: torch.nn.Module, directory, best: bool = False) -> Path:
    """Write ``model.state_dict()`` (moved to the CPU) into ``directory``."""
    path = Path(directory) / (CKPT_BEST if best else CKPT_LAST)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def load_model(model: torch.nn.Module, directory, best: bool = True) -> torch.nn.Module:
    """Load ``directory``'s best (or last) ``.pt`` checkpoint into ``model``, strictly."""
    load_model_file(model, Path(directory) / (CKPT_BEST if best else CKPT_LAST))
    return model


def save_train_state(state: dict, directory) -> Path:
    """Write a trainer's non-model state (tensors, numbers, lists, dicts)."""
    path = Path(directory) / TRAIN_STATE
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, path)
    return path


def load_train_state(directory) -> dict:
    return torch.load(Path(directory) / TRAIN_STATE, map_location="cpu", weights_only=True)


# --- either package's files -------------------------------------------------------------
def model_file(directory, best: bool) -> Optional[Path]:
    """The best (or last) checkpoint of ``directory``, the port's ``.pt`` or
    the JAX package's ``.msgpack``; None if neither is there. Raises if
    both are: which one was meant cannot be told."""
    names = (CKPT_BEST, FLAX_BEST) if best else (CKPT_LAST, FLAX_LAST)
    present = [Path(directory) / n for n in names if (Path(directory) / n).exists()]
    if len(present) == 2:
        raise ValueError(f"{directory} holds both {names[0]} and {names[1]}; remove the one"
                         " that is not meant")
    return present[0] if present else None


def load_flax_model(model, path) -> dict:
    """The model part of a JAX train-state msgpack (``raw["params"]`` and
    ``raw["batch_stats"]``, ``jolineedle_tpu/checkpoint.py:138-141``) into
    the port's ``GPT`` ``model``, strictly. Returns the state_dict loaded."""
    raw = read_msgpack(path)
    return flax_to_torch({"params": raw["params"], "batch_stats": raw["batch_stats"]}, model)


def load_model_file(model, path) -> None:
    """Load a ``.pt`` or a JAX ``.msgpack`` checkpoint into ``model``, strictly."""
    path = Path(path)
    if path.suffix == ".msgpack":
        load_flax_model(model, path)
    else:
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                              strict=True)


def _graft_overlap(target, ckpt, path=""):
    """Recursively merge a raw checkpoint state-dict into a target
    state-dict, tolerating leaf-shape mismatches (a copy of
    ``jolineedle_tpu/checkpoint.py:144-178``, with its messages).

    Where shapes agree the checkpoint value wins. Where ranks agree but a
    dimension differs (e.g. warm-starting a 9-action head from an 8-action
    checkpoint: the action-embedding table grows on dim 0, the head kernel
    on dim 1 — STOP is always the LAST action id), the overlapping
    hyperrectangle is copied and the rest keeps the fresh initialization.
    Missing keys / rank mismatches keep the target leaf.
    """
    if isinstance(target, dict):
        out = {}
        for key, tval in target.items():
            if isinstance(ckpt, dict) and key in ckpt:
                out[key] = _graft_overlap(tval, ckpt[key], f"{path}/{key}")
            else:
                print(f"init-from: no checkpoint value for {path}/{key},"
                      " keeping fresh init")
                out[key] = tval
        return out
    tgt = np.asarray(target)
    src = np.asarray(ckpt)
    if tgt.shape == src.shape:
        return src
    if tgt.ndim != src.ndim:
        print(f"init-from: rank mismatch at {path} "
              f"({src.shape} -> {tgt.shape}), keeping fresh init")
        return target
    region = tuple(slice(0, min(a, b)) for a, b in zip(src.shape, tgt.shape))
    merged = np.array(tgt)
    merged[region] = src[region].astype(tgt.dtype)
    print(f"init-from: shape mismatch at {path} ({src.shape} -> {tgt.shape}),"
          f" grafted overlap {tuple(s.stop for s in region)}")
    return merged


def load_params_only(path, model) -> dict:
    """``--init-from``: the weights of another run's checkpoint, a JAX
    ``.msgpack`` or a port ``.pt``, grafted into ``model`` in the flax
    layout (``jolineedle_tpu/checkpoint.py:181-205``).

    The target is ``torch_to_flax`` of the model's own state; the source is
    the msgpack tree or ``torch_to_flax`` of the ``.pt`` state dict (a leaf
    it lacks keeps the fresh init). So a head that grows on flax's dim 1
    grows on torch's dim 0 with no code of its own. Returns the state_dict
    loaded."""
    path = Path(path)
    if path.suffix == ".msgpack":
        source = read_msgpack(path)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        source = torch_to_flax(state, model, strict=False)
    target = torch_to_flax(model.state_dict(), model)
    grafted = {c: _graft_overlap(target[c], source.get(c, {})) for c in ("params", "batch_stats")}
    return flax_to_torch(grafted, model)


def load_detection_params(path, model) -> dict:
    """``--detection-checkpoint``: the ``yolox`` weights of a JAX msgpack into
    the port's ``GPT`` ``model``, strictly, leaving every other weight
    (``jolineedle_tpu/checkpoint.py:208-235``).

    Takes a full train-state checkpoint (it has ``opt_state``: its
    ``params["yolox"]`` and ``batch_stats["yolox"]``) or a ported-weights
    file (``{"params", "batch_stats"}`` of the YOLOX tree, as either
    package's ``scripts/port_yolox_weights.py`` writes it). A file without
    batch statistics keeps the model's. Returns the yolox state_dict
    loaded."""
    raw = read_msgpack(path)
    if "opt_state" in raw:
        params = raw["params"]["yolox"]
        stats = raw.get("batch_stats", {}).get("yolox", {})
    else:
        params = raw["params"]
        stats = raw.get("batch_stats", {})
    variables = yolox_torch_to_flax(model.yolox.state_dict(), model.yolox)
    variables["params"] = params
    if stats:
        variables["batch_stats"] = stats
    return yolox_flax_to_torch(variables, model.yolox)
