"""The port's checkpoints against the JAX package's: its own flax msgpack
codec (``jolineedle_tpu_torch/checkpoint.py``) against flax's, the
``--init-from`` graft against ``jolineedle_tpu.checkpoint._graft_overlap``,
and a warm start across an action-count change.

- Reader: bytes that flax writes (``msgpack_serialize`` and ``to_bytes``)
  decode to flax's own ``msgpack_restore`` tree, leaf for leaf with the same
  types and bits (a bfloat16 leaf as the float32 it widens to), through
  every msgpack size class and flax's three ext types; a truncated file,
  trailing bytes and a chunked array raise.
- Writer: flax's exact bytes for a params/batch_stats tree and for a tree
  of mixed leaves, and, by hypothesis, for random small trees.
- Graft: the copy prints and returns what the JAX function does on the
  inputs of ``tests/test_init_from.py``.
- The repaired fault: a REINFORCE ``--enable-stop`` trainer (9 actions)
  warm-starts from a supervised port run (8 actions) with
  ``load_params_checkpoint``; the 8 move rows of ``wte`` and of the action
  head are the checkpoint's, the STOP row keeps its fresh init, the
  optimizer stays fresh.
"""

import struct

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
from flax import serialization

from jolineedle_tpu.checkpoint import _graft_overlap as jax_graft
from jolineedle_tpu_torch import checkpoint as ckpt
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info
from jolineedle_tpu_torch.models.bridge import torch_to_flax
from jolineedle_tpu_torch.models.gpt import GPT
from jolineedle_tpu_torch.train.reinforce import ReinforceTrainer

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P = 64


def _cli(mode, work_dir, stop):
    return [
        "--training-mode", mode, "--dataset-dir", "/nonexistent", "--work-dir", str(work_dir),
        "--model-type", "gpt-nano", "--image-processor", "yolox-nano",
        "--gpt-backbone", "yolox-nano", "--concat-embeddings", "--decoder-pos-encoding",
        "--use-positional-embedding", "--max-seq-len", "4", "--patch-size", str(P),
        "--minimum-image-size", "0", "--batch-size", "2", "--dropout", "0.0",
        "--compute-dtype", "float32", "--devices", "0", "--env-name", mode,
    ] + (["--enable-stop"] if stop else [])


def _model(mode, work_dir, stop, seed):
    """(train_config, model_config, a fresh port GPT from ``seed``)."""
    train_config, model_config = tconfig.args_to_config(tconfig.get_args(_cli(mode, work_dir, stop)))
    torch.manual_seed(seed)
    model = GPT.from_config(model_config, get_actions_info(train_config), device="cpu")
    return train_config, model_config, model


# --- the codec against flax -------------------------------------------------------------
def _same(got, want, path="root"):
    """Same structure, types and bits; a bfloat16 leaf of flax's as the
    float32 it widens to."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) or want.dtype == ml_dtypes.bfloat16, (path, type(got))
        if want.dtype == ml_dtypes.bfloat16:
            want = np.asarray(want).astype(np.float32)
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, float):
        assert type(got) is float and struct.pack(">d", got) == struct.pack(">d", want), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def _mixed_tree():
    """Every leaf kind and size class the reader must take."""
    rng = np.random.default_rng(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    return {
        "params": {
            "dense": {"kernel": rng.normal(size=(5, 7)).astype(np.float32),
                      "bias": np.zeros((7,), np.float32)},
            "bf16": rng.normal(size=(3, 4)).astype(ml_dtypes.bfloat16),
            "f64": rng.normal(size=(2, 2)),
            "big": rng.normal(size=(20_000,)).astype(np.float32),  # ext32
            "mid": rng.normal(size=(100,)).astype(np.float32),  # ext16
        },
        "batch_stats": {},
        "leaves": {
            "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
            "i64": np.array([-(2**40), 2**40], np.int64),
            "u8": rng.integers(0, 256, (4, 4), dtype=np.uint8),
            "mask": np.array([True, False, True]),
            "bool6": np.zeros(6, bool),  # a 16-byte payload: fixext 16
            "empty": np.zeros((0, 3), np.float32),
            "none": None,
            "t": True, "f": False,
            "s_f32": np.float32(1.5), "s_i32": np.int32(-7), "s_u8": np.uint8(200),
            "s_bool": np.bool_(True), "s_f64": np.float64(2.25), "s_bf16": ml_dtypes.bfloat16(3.0),
            "step": np.zeros((), np.int32),
            "float": 0.1, "neg_float": -1e300,
            "ints": {f"i{n}": v for n, v in enumerate(ints)},
            "fixstr": "a", "str8": "é" * 40, "str16": "x" * 300, "str32": "y" * 70_000,
            "bin8": b"\x00\x01", "bin16": bytes(300), "bin32": bytes(70_000),
            "complex": 1.5 - 2j,
            "array16": list(range(20)), "array32": [7] * 70_000,
            "map16": {f"k{i:02d}": i for i in range(20)},
            "map32": {f"k{i:05d}": None for i in range(70_000)},
            "nested": {"": {"a": {}}},
        },
    }


def _flax_bytes(tree):
    return msgpack.packb(tree, default=serialization._msgpack_ext_pack, strict_types=True)


def test_reader_matches_flax_on_every_size_class():
    tree = _mixed_tree()
    for data in (serialization.msgpack_serialize(tree), serialization.to_bytes(tree),
                 _flax_bytes(tree)):
        want = serialization.msgpack_restore(data)
        _same(ckpt.msgpack_restore(data), want)
    got = ckpt.msgpack_restore(serialization.msgpack_serialize(tree))
    assert got["params"]["bf16"].dtype == np.float32
    np.testing.assert_array_equal(got["params"]["bf16"], tree["params"]["bf16"].astype(np.float32))
    # fixext 4 and 8 (flax's complex ext on small ints), and ext types with a
    # 1- or 2-byte payload, which flax never writes: the length is read, the
    # code refused.
    for value in ((1, 200), (200, -(2**31))):
        data = msgpack.packb({"c": msgpack.ExtType(2, msgpack.packb(value))})
        assert data[3] in (0xD6, 0xD7)
        _same(ckpt.msgpack_restore(data), serialization.msgpack_restore(data))
    for payload in (b"\x01", b"\x01\x02"):
        data = msgpack.packb({"odd": msgpack.ExtType(7, payload)})
        with pytest.raises(ckpt.MsgpackError, match="ext type 7"):
            ckpt.msgpack_restore(data)


def test_writer_gives_flax_bytes():
    _, _, model = _model("reinforce", "/nonexistent", True, 0)
    variables = torch_to_flax(model.state_dict(), model)
    assert ckpt.msgpack_serialize(variables) == serialization.msgpack_serialize(variables)
    tree = _mixed_tree()
    del tree["params"]["bf16"], tree["leaves"]["s_bf16"], tree["leaves"]["complex"]
    assert ckpt.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    # a float32 tree survives the round trip bit for bit
    _same(ckpt.msgpack_restore(ckpt.msgpack_serialize(variables)),
          serialization.msgpack_restore(serialization.msgpack_serialize(variables)))


def test_truncated_trailing_and_chunked_raise():
    data = serialization.msgpack_serialize({"a": {"b": np.arange(5, dtype=np.float32)},
                                            "c": [1, "two", None]})
    for cut in range(len(data)):
        with pytest.raises(ckpt.MsgpackError):
            ckpt.msgpack_restore(data[:cut])
    with pytest.raises(ckpt.MsgpackError, match="1 trailing bytes"):
        ckpt.msgpack_restore(data + b"\xc0")
    chunked = {"params": {"wte": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
                                  "chunks": {"0": np.zeros(2, np.float32)}}}}
    with pytest.raises(ckpt.MsgpackError, match="/params/wte is a chunked array"):
        ckpt.msgpack_restore(_flax_bytes(chunked))
    with pytest.raises(ckpt.MsgpackError, match="starts no msgpack object"):
        ckpt.msgpack_restore(b"\xc1")


_DTYPES = st.sampled_from([np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_])
_ARRAYS = _DTYPES.flatmap(lambda dt: hnp.arrays(dt, hnp.array_shapes(min_dims=0, max_dims=3,
                                                                     max_side=4)))
_LEAVES = st.one_of(
    _ARRAYS, st.none(), st.booleans(), st.integers(-(2**63), 2**64 - 1),
    st.floats(allow_nan=False), st.text(max_size=40),
    _ARRAYS.filter(lambda a: a.ndim == 0).map(lambda a: a[()]),
)
_TREES = st.recursive(_LEAVES, lambda inner: st.dictionaries(st.text(max_size=8), inner,
                                                               max_size=20), max_leaves=40)


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text(max_size=8), _TREES, max_size=5))
def test_random_trees_match_flax(tree):
    data = serialization.msgpack_serialize(tree)
    assert ckpt.msgpack_serialize(tree) == data
    _same(ckpt.msgpack_restore(data), serialization.msgpack_restore(data))


# --- the graft against the JAX package's ------------------------------------------------
def _graft_cases():
    rng = np.random.default_rng(0)
    # tests/test_init_from.py:65-101: wte grows on dim 0, the head kernel on
    # dim 1, a matching leaf passes through, a missing leaf keeps the init.
    target = {
        "wte": rng.normal(size=(9, 16)).astype(np.float32),
        "head": {"kernel": rng.normal(size=(16, 9)).astype(np.float32)},
        "same": np.zeros((4,), np.float32),
        "new_layer": np.full((3,), 7.0, np.float32),
    }
    source = {
        "wte": rng.normal(size=(8, 16)).astype(np.float32),
        "head": {"kernel": rng.normal(size=(16, 8)).astype(np.float32)},
        "same": np.ones((4,), np.float32),
    }
    rank = ({"x": np.zeros((2, 2), np.float32)}, {"x": np.ones((4,), np.float32)})
    shrink = ({"w": np.zeros((3, 5), np.float32)}, {"w": np.ones((4, 2), np.float64)})
    return [(target, source), rank, shrink, ({"a": {"b": np.ones(2)}}, {"a": 3.0})]


@pytest.mark.parametrize("case", range(4))
def test_graft_matches_jax(case, capsys):
    target, source = _graft_cases()[case]
    want = jax_graft(target, source)
    want_out = capsys.readouterr().out
    got = ckpt._graft_overlap(target, source)
    assert capsys.readouterr().out == want_out and want_out

    def same(g, w):
        if isinstance(w, dict):
            assert list(g) == list(w)
            for k in w:
                same(g[k], w[k])
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)

    same(got, want)


# --- the repaired fault: --init-from across the STOP action ------------------------------
def test_enable_stop_warm_starts_from_a_supervised_run(tmp_path, capsys):
    _, _, sup = _model("supervised", tmp_path, stop=False, seed=1)
    assert sup.n_actions == 8
    run_dir = tmp_path / "sup_run"
    ckpt.save_model(sup, run_dir, best=True)
    saved = {k: v.clone() for k, v in sup.state_dict().items()}

    rl_config, _, rl_model = _model("reinforce", tmp_path, stop=True, seed=2)
    assert rl_model.n_actions == 9
    fresh = {k: v.clone() for k, v in rl_model.state_dict().items()}
    trainer = ReinforceTrainer(rl_config, rl_model, None, None, None, device="cpu")
    fresh_opt = trainer.optimizer.state_dict()
    trainer.load_params_checkpoint(run_dir)
    out = capsys.readouterr().out
    assert "shape mismatch at /wte/embedding ((8, 48) -> (9, 48)), grafted overlap (8, 48)" in out
    assert "/action_head/Dense_0/kernel ((48, 8) -> (48, 9))" in out

    state = rl_model.state_dict()
    for key in ("wte.weight", "action_head.dense.weight"):
        torch.testing.assert_close(state[key][:8], saved[key], rtol=0, atol=0)
        torch.testing.assert_close(state[key][8], fresh[key][8], rtol=0, atol=0)
        assert not torch.equal(fresh[key][:8], saved[key])
    for key, value in state.items():
        if key not in ("wte.weight", "action_head.dense.weight") \
                and not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(value, saved[key], rtol=0, atol=0, msg=key)
    assert trainer.step == 0
    assert str(trainer.optimizer.state_dict()) == str(fresh_opt)


def test_model_directory_of_either_format(tmp_path):
    """A directory with both formats raises; a msgpack-only one serves the
    same weights, cannot be resumed without a last checkpoint, and raises
    when its file is cut short."""
    from jolineedle_tpu_torch.infer import load_model_dir

    train_config, model_config, model = _model("reinforce", tmp_path, True, 0)
    tconfig.save_config(model_config, train_config)
    run_dir = tmp_path / "reinforce"
    ckpt.save_model(model, run_dir, best=True)
    ckpt.write_msgpack(run_dir / ckpt.FLAX_BEST, torch_to_flax(model.state_dict(), model))
    with pytest.raises(ValueError, match="holds both checkpoint_best.pt and"):
        load_model_dir(run_dir, device="cpu")
    trainer = ReinforceTrainer(train_config, model, None, None, None, device="cpu")
    with pytest.raises(ValueError, match="holds both"):
        trainer.load_params_checkpoint(run_dir)
    (run_dir / ckpt.CKPT_BEST).unlink()
    _, _, served = load_model_dir(run_dir, device="cpu")
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(served.state_dict()[key], value, rtol=0, atol=0)
    # a directory with a best checkpoint and no last one cannot be resumed
    with pytest.raises(ValueError, match="holds a best checkpoint but no last one"):
        trainer.load_checkpoint(run_dir)
    (run_dir / ckpt.FLAX_BEST).write_bytes(b"\x81\xa6params")  # truncated
    with pytest.raises(ckpt.MsgpackError, match="truncated"):
        load_model_dir(run_dir, device="cpu")
