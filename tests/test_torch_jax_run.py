"""A run directory written by the JAX package's trainer, read by the port.

The JAX train CLI (root ``main.py``) trains one supervised iteration on a
toy dataset (gpt-nano, yolox-nano embedder and detector, patch 64, 4 steps,
8 actions: no STOP, float32, on the CPU), as ``tests/test_init_from.py``
does, and leaves ``config.json`` and flax msgpack checkpoints. Then:

- the port's reader gives flax's own tree of the best checkpoint, every
  leaf bit for bit (``opt_state`` included), and ``infer.load_model_dir``
  loads a state dict whose every leaf equals ``flax_to_torch`` of its
  params and batch statistics;
- served from that directory, the port's greedy rollout agrees with JAX's
  ``_rollout_scan`` on the same weights (positions equal, logits within
  ``LOGIT_TOL``) and the detector's outputs on the visited patches agree
  within the tolerances of ``test_torch_serve.py``; the infer CLI serves
  the directory, also with ``--detection-checkpoint``;
- ``--init-from`` that directory into a port REINFORCE ``--enable-stop``
  trainer (9 actions) equals JAX's ``load_params_only`` on the grafted
  region, and STOP keeps the port's fresh init;
- ``--detection-checkpoint`` with the JAX train state and with a
  ported-weights file written by flax loads the detector leaf for leaf as
  ``flax_to_torch`` does, in the train CLI and in ``infer``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from jolineedle_tpu import checkpoint as jckpt
from jolineedle_tpu.config import args_to_config
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.train.reinforce import ReinforceTrainer as JaxReinforce
from jolineedle_tpu_torch import checkpoint as ckpt
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.env.oracle import gather_patches
from jolineedle_tpu_torch.infer import get_infer_args, infer, load_model_dir
from jolineedle_tpu_torch.models.bridge import flax_to_torch, yolox_flax_to_torch
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.train.reinforce import ReinforceTrainer
from jolineedle_tpu_torch.train.rollout import eval_rollout, to_numpy
from tests.test_torch_checkpoint import _same

P, T, NV, NH, B = 64, 4, 2, 3, 2
LOGIT_TOL = 1e-4  # tests/test_torch_serve.py


def _cli(toy_dir, work_dir, mode, extra=()):
    return [
        "--seed", "11", "--dataset-dir", str(toy_dir), "--training-mode", mode,
        "--work-dir", str(work_dir), "--max-iters", "2", "--test-every", "1000",
        "--test-samples", "1", "--env-name", mode, "--model-type", "gpt-nano",
        "--gpt-backbone", "yolox-nano", "--image-processor", "yolox-nano",
        "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
        "--max-seq-len", str(T), "--batch-size", "2", "--dropout", "0.0",
        "--patch-size", str(P), "--minimum-image-size", "0", "--devices", "0",
        "--max-det-patches", "4", "--max-boxes", "4", "--compute-dtype", "float32",
        "--detector-conf-threshold", "0.05", *extra,
    ]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    import main as jax_main
    from jolineedle_tpu.data.toy import generate_toy_dataset

    root = tmp_path_factory.mktemp("jax_run")
    toy = generate_toy_dataset(root / "toy", n_train=4, n_test=2, image_size=(192, 256), seed=7)
    trainer = jax_main.main(jax_main.get_args(_cli(toy, root / "out", "supervised")))
    run_dir = trainer.checkpoint_dir
    best = run_dir / jckpt.CKPT_BEST
    assert best.exists() and not (run_dir / ckpt.CKPT_BEST).exists()
    raw = serialization.msgpack_restore(best.read_bytes())
    assert int(raw["step"]) == 1
    return dict(root=root, toy=toy, run_dir=run_dir, best=best, raw=raw, trainer=trainer)


def _jax_trainer(jax_run, work, mode, extra=()):
    """A JAX ReinforceTrainer (no data) of the run's flags, as ``infer.py`` builds one."""
    import main as jax_main

    train_config, model_config = args_to_config(
        jax_main.get_args(_cli(jax_run["toy"], jax_run["root"] / work, mode, extra)))
    model = JaxGPT.from_config(model_config, get_actions_info(train_config))
    return JaxReinforce(train_config, model, None, None, None)


def _variables(raw):
    return {"params": raw["params"], "batch_stats": raw["batch_stats"]}


def _fresh_port(jax_run, mode="supervised", extra=(), seed=0):
    cli = _cli(jax_run["toy"], jax_run["root"] / "port", mode, extra)
    train_config, model_config = tconfig.args_to_config(tconfig.get_args(cli))
    torch.manual_seed(seed)
    model = TorchGPT.from_config(model_config, t_actions_info(train_config), device="cpu")
    return train_config, model


def test_reader_and_load_model_dir_match_flax(jax_run):
    _same(ckpt.read_msgpack(jax_run["best"]), jax_run["raw"])
    assert "opt_state" in jax_run["raw"]
    _, _, served = load_model_dir(jax_run["run_dir"], device="cpu")
    assert served.n_actions == 8
    _, want = _fresh_port(jax_run)
    want_state = flax_to_torch(_variables(jax_run["raw"]), want)
    got_state = served.state_dict()
    assert got_state.keys() == want_state.keys()
    for key, value in want_state.items():
        torch.testing.assert_close(got_state[key], value, rtol=0, atol=0, msg=key)


def test_serving_the_jax_run_matches_jax(jax_run):
    jtrainer = jax_run["trainer"]  # its _rollout_scan and _yolox_predict take any weights
    variables = jax.tree_util.tree_map(jnp.asarray, _variables(jax_run["raw"]))

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, NV * P, NH * P, 3), dtype=np.uint8)
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[:, 0] = [10, 10, 70, 40]
    start = np.array([[0, 0], [1, 2]], np.int32)
    env = JaxEnv(jnp.asarray(images), jnp.asarray(boxes), P, T, 1, False)
    jro = jax.device_get(jtrainer._rollout_scan(variables, env, jax.random.PRNGKey(0),
                                                sample=False, collect=("logits", "actions"),
                                                positions=jnp.asarray(start)))

    t_train, _, model = load_model_dir(jax_run["run_dir"], device="cpu")
    tro = to_numpy(eval_rollout(model, images, boxes, t_train, positions=torch.from_numpy(start),
                                device="cpu", collect=("logits", "actions")))
    logits = np.sort(jro["logits"], axis=-1)
    assert (logits[..., -1] - logits[..., -2]).min() > 10 * LOGIT_TOL, "a near-tie"
    np.testing.assert_allclose(tro["logits"], jro["logits"], atol=LOGIT_TOL, rtol=0)
    for name in ("actions", "positions", "masks"):
        np.testing.assert_array_equal(tro[name], jro[name], err_msg=name)

    for b in range(B):
        patches = gather_patches(images[b], tro["positions"][b], P)
        want = jax.device_get(jtrainer._yolox_predict(variables, jnp.asarray(patches)))
        with torch.no_grad():
            got = model.yolox_outputs(torch.from_numpy(patches))[0]
        for name in ("boxes", "obj_logits", "cls_logits"):
            np.testing.assert_allclose(got[name].numpy(), want[name], atol=2e-4, rtol=1e-3,
                                       err_msg=name)


def test_init_from_the_jax_run_matches_jax_graft(jax_run, capsys):
    extra = ["--enable-stop", "--init-from", str(jax_run["run_dir"])]
    train_config, model = _fresh_port(jax_run, "reinforce", extra, seed=5)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = ReinforceTrainer(train_config, model, None, None, None, device="cpu")
    trainer.load_params_checkpoint(jax_run["run_dir"])
    assert "grafted overlap (8, 48)" in capsys.readouterr().out

    jrl = _jax_trainer(jax_run, "jrl", "reinforce", ["--enable-stop"])
    state = jckpt.load_params_only(jax_run["best"], jrl.state)
    _, want_model = _fresh_port(jax_run, "reinforce", extra)
    want = flax_to_torch(jax.device_get({"params": state.params,
                                         "batch_stats": state.batch_stats}), want_model)
    got = model.state_dict()
    grown = ("wte.weight", "action_head.dense.weight")
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key in grown:  # the 8 moves grafted, STOP (row 8) the fresh init of each package
            torch.testing.assert_close(got[key][:8], value[:8], rtol=0, atol=0, msg=key)
            torch.testing.assert_close(got[key][8], fresh[key][8], rtol=0, atol=0, msg=key)
        else:
            torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)


def _yolox_state(raw_yolox, seed=9):
    """``yolox_flax_to_torch`` of a YOLOX subtree into a fresh port detector."""
    torch.manual_seed(seed)
    from jolineedle_tpu_torch.models.yolox import NeedleYOLOX

    return yolox_flax_to_torch(raw_yolox, NeedleYOLOX("yolox-nano", device="cpu"))


def test_detection_checkpoint_loads_like_flax_to_torch(jax_run, tmp_path):
    raw = jax_run["raw"]
    # a ported-weights file (scripts/port_yolox_weights.py's layout), by flax,
    # with other values than the run's, so a load is seen
    ported = jax.tree_util.tree_map(lambda x: np.asarray(x) * 0.5 + 0.25,
                                    {"params": raw["params"]["yolox"],
                                     "batch_stats": raw["batch_stats"]["yolox"]})
    ported_path = tmp_path / "ported.msgpack"
    ported_path.write_bytes(serialization.msgpack_serialize(ported))
    for path, yolox in ((jax_run["best"], {"params": raw["params"]["yolox"],
                                           "batch_stats": raw["batch_stats"]["yolox"]}),
                        (ported_path, ported)):
        _, model = _fresh_port(jax_run, seed=3)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        ckpt.load_detection_params(path, model)
        want = _yolox_state(yolox)
        for key, value in want.items():
            torch.testing.assert_close(model.yolox.state_dict()[key], value, rtol=0, atol=0,
                                       msg=key)
        for key, value in model.state_dict().items():
            if not key.startswith("yolox."):
                torch.testing.assert_close(value, before[key], rtol=0, atol=0, msg=key)

    # infer: the JAX run served with the ported detector
    from PIL import Image

    image = Image.open(sorted((jax_run["toy"] / "images").iterdir())[0])
    image.save(tmp_path / "img.png")
    (tmp_path / "img.txt").write_text("0 10 10 70 40\n")
    (tmp_path / "list.txt").write_text("img.png img.txt\n")
    metrics = infer(get_infer_args(["--model-dir", str(jax_run["run_dir"]), "--dataset",
                                    str(tmp_path / "list.txt"), "--detection-checkpoint",
                                    str(ported_path)]), device="cpu")
    assert "map" in metrics and all(np.isfinite(v[0]) for v in metrics.values())
    t_train, _, model = load_model_dir(jax_run["run_dir"], "cpu", str(ported_path))
    assert t_train.detection_enabled
    for key, value in _yolox_state(ported).items():
        torch.testing.assert_close(model.yolox.state_dict()[key], value, rtol=0, atol=0)

    # the train CLI: no iteration (--max-iters 1), the final test, the loaded detector
    from jolineedle_tpu_torch.main import main as train_main

    cli = _cli(jax_run["toy"], tmp_path / "out", "supervised",
               ["--detection-checkpoint", str(ported_path)])
    cli[cli.index("--max-iters") + 1] = "1"
    trainer = train_main(tconfig.get_args(cli), device="cpu")
    assert trainer.step == 0
    for key, value in _yolox_state(ported).items():
        torch.testing.assert_close(trainer.model.yolox.state_dict()[key], value, rtol=0, atol=0)
