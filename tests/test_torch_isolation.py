"""The port stands alone: it imports neither JAX nor the JAX package, nor
flax's ``msgpack`` and ``ml_dtypes`` (nor does ``chip_smoke.py``, which drives it on the card), its entry points refuse
to continue on the CPU when the card is asked for and absent, and its weight
bridge carries every leaf both ways.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jolineedle_tpu_torch
from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.env.batched_env import NeedleEnv
from jolineedle_tpu_torch.infer import get_infer_args, infer
from jolineedle_tpu_torch.main import main as train_main
from jolineedle_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from jolineedle_tpu_torch.models.gpt import GPT
from jolineedle_tpu_torch.models.yolox import NeedleYOLOX
from jolineedle_tpu_torch.train.reinforce import ReinforceTrainer
from jolineedle_tpu_torch.train.rollout import eval_rollout

ROOT = Path(__file__).resolve().parents[1]

P = 64
CLI = [
    "--training-mode", "reinforce", "--dataset-dir", "/nonexistent",
    "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--enable-stop", "--max-seq-len", "4", "--patch-size", str(P),
    "--minimum-image-size", "0", "--batch-size", "2", "--dropout", "0.0",
    "--compute-dtype", "float32", "--devices", "0",
]

PORT_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(jolineedle_tpu_torch.__path__, "jolineedle_tpu_torch.")
)


def test_every_module_imports_without_jax():
    """With ``jax``, ``flax``, ``msgpack``, ``ml_dtypes`` and
    ``jolineedle_tpu`` blocked, every port module (the train CLI, the
    checkpoint reader and the scripts among them) and ``chip_smoke.py``
    import, and none of them (nor a submodule) is loaded after."""
    for name in ("ops.conv", "ops.attention", "main", "scripts.smoke_conv",
                 "train.reinforce", "checkpoint", "models.port",
                 "scripts.port_yolox_weights"):
        assert f"jolineedle_tpu_torch.{name}" in PORT_MODULES
    code = (
        "import importlib, importlib.util, sys\n"
        "blocked = ('jax', 'jaxlib', 'flax', 'msgpack', 'ml_dtypes', 'jolineedle_tpu')\n"
        "for name in blocked:\n"
        "    sys.modules[name] = None\n"
        f"for name in {PORT_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "smoke = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(smoke)\n"
        "smoke.import_port()\n"
        "loaded = [n for n, m in sys.modules.items() if m is not None\n"
        "          and n.split('.')[0] in blocked]\n"
        "print('LOADED', loaded)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "LOADED []"


@pytest.fixture
def no_card(monkeypatch):
    """As on a machine without a GPU, also where one is present."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _configs():
    return tconfig.args_to_config(tconfig.get_args(CLI))


def _with_work_dir(path):
    return [str(path) if f == "/nonexistent" else f for f in CLI]


@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_points_refuse_the_cpu(no_card, device, tmp_path):
    train_config, model_config = _configs()
    images = np.zeros((1, 2 * P, 2 * P, 3), np.uint8)
    boxes = np.zeros((1, 1, 4), np.float32)
    calls = [
        lambda: jolineedle_tpu_torch.resolve_device(device),
        lambda: NeedleYOLOX("yolox-nano", device=device),
        lambda: GPT.from_config(model_config, t_actions_info(train_config), device=device),
        lambda: NeedleEnv(images, boxes, P, 4, device=device),
        lambda: eval_rollout(None, images, boxes, train_config, device=device),
        lambda: infer(get_infer_args(["--model-dir", str(tmp_path)]), device=device),
        lambda: train_main(tconfig.get_args(_with_work_dir(tmp_path)), device=device),
        lambda: ReinforceTrainer(train_config, None, None, None, None, device=device),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="runs on a CUDA device"):
            call()


def test_entry_points_run_on_the_cpu_when_asked():
    train_config, model_config = _configs()
    model = GPT.from_config(model_config, t_actions_info(train_config), device="cpu")
    assert model.device == torch.device("cpu")
    assert next(model.yolox.parameters()).device == torch.device("cpu")


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): v})
    return out


def test_bridge_round_trip_loses_no_leaf():
    train_config, model_config = args_to_config(get_args(CLI))
    jmodel = JaxGPT.from_config(model_config, get_actions_info(train_config))
    variables = jax.jit(
        lambda rng: jmodel.init(
            rng,
            jnp.zeros((1, 1, P, P, 3)),
            jnp.zeros((1, 1), jnp.int32),
            jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 1, 2), jnp.int32),
            jnp.zeros((1, P, P, 3)),
            method=JaxGPT.init_all,
        )
    )(jax.random.PRNGKey(0))
    want = {c: _flat(jax.device_get(variables[c])) for c in ("params", "batch_stats")}

    t_train, t_model = _configs()
    tmodel = GPT.from_config(t_model, t_actions_info(t_train), device="cpu")
    state = flax_to_torch({c: jax.device_get(variables[c]) for c in want}, tmodel)
    back = torch_to_flax(state, tmodel)
    for c in want:
        got = _flat(back[c])
        assert got.keys() == want[c].keys(), c
        for path, value in want[c].items():
            np.testing.assert_array_equal(got[path], np.asarray(value), err_msg="/".join(path))
    # every torch parameter and buffer came from a flax leaf
    assert state.keys() == tmodel.state_dict().keys()


def test_bridge_raises_on_an_unused_leaf():
    t_train, t_model = _configs()
    tmodel = GPT.from_config(t_model, t_actions_info(t_train), device="cpu")
    flax = torch_to_flax(tmodel.state_dict(), tmodel)
    flax["params"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="stray"):
        flax_to_torch(flax, tmodel)
    del flax["params"]["stray"]
    del flax["params"]["ln_f"]["scale"]
    with pytest.raises(KeyError, match="ln_f"):
        flax_to_torch(flax, tmodel)
