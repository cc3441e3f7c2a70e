"""The serving slice end to end, port against JAX: a greedy eval rollout from
fixed reset positions with bridged weights, its metrics, then detection on
the visited patches, postprocess and full-image boxes.

The JAX side is ``ReinforceTrainer._rollout_scan`` of a trainer built as
bench.py builds it (gpt-nano, yolox-nano embedder and detector, concat
embeddings, sinusoidal positions, STOP), here at patch 64 on a 2x3 grid,
episode length 4, batch 2, float32 on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.env.batched_env import NeedleEnv as JaxEnv
from jolineedle_tpu.env.oracle import gather_patches as jax_gather
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.ops.nms import postprocess as jax_postprocess, sigmoid_np
from jolineedle_tpu.train.reinforce import ReinforceTrainer
from jolineedle_tpu.utils.metrics import patch_bboxes2full_image as jax_to_full
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.env.oracle import gather_patches
from jolineedle_tpu_torch.models.bridge import flax_to_torch
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.ops.nms import postprocess
from jolineedle_tpu_torch.train.rollout import compute_rollout_metrics, eval_rollout, to_numpy
from jolineedle_tpu_torch.utils.metrics import patch_bboxes2full_image

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P, NV, NH, T, B = 64, 2, 3, 4, 2
LOGIT_TOL = 1e-4


def _cli(work_dir):
    return [
        "--training-mode", "reinforce", "--dataset-dir", "/nonexistent",
        "--work-dir", str(work_dir), "--model-type", "gpt-nano",
        "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
        "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
        "--enable-stop", "--max-seq-len", str(T), "--patch-size", str(P),
        "--minimum-image-size", "0", "--batch-size", str(B), "--dropout", "0.0",
        "--max-det-patches", "4", "--max-boxes", "4", "--devices", "0",
        "--compute-dtype", "float32", "--detector-conf-threshold", "0.05",
    ]


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.array(v) for k, v in tree.items()}


def _randomize(variables, seed):
    """Random BN statistics and affine terms; a sharper action head with a
    damped STOP column, so greedy episodes walk, with clear margins."""
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
    head = variables["params"]["action_head"]["Dense_0"]["kernel"]
    head *= 50.0
    head[:, 8] *= 0.2
    return variables


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cli = _cli(tmp_path_factory.mktemp("serve"))
    train_config, model_config = args_to_config(get_args(cli))
    jmodel = JaxGPT.from_config(model_config, get_actions_info(train_config))
    trainer = ReinforceTrainer(train_config, jmodel, None, None, None)
    variables = _randomize(_np_tree(trainer.eval_variables()), 3)

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (B, NV * P, NH * P, 3), dtype=np.uint8)
    boxes = np.zeros((B, 4, 4), np.float32)
    boxes[:, 0] = [10, 10, 70, 40]
    boxes[:, 1] = [140, 70, 170, 100]
    start = np.array([[0, 0], [1, 2]], np.int32)

    @jax.jit
    def jax_rollout(v, images, boxes, positions):
        env = JaxEnv(images, boxes, P, T, 1, True)
        ro = trainer._rollout_scan(v, env, jax.random.PRNGKey(0), sample=False,
                                   collect=("logits", "actions"), positions=positions)
        state = ro.pop("final_state")
        ro["prop_patches_found"] = env.prop_patches_found(state)
        ro["prop_bboxes_found"] = env.prop_bboxes_found(state)
        ro["terminated"] = env.terminated(state)
        return ro

    jro = jax.device_get(jax_rollout(variables, jnp.asarray(images), jnp.asarray(boxes),
                                     jnp.asarray(start)))

    t_train, t_model = tconfig.args_to_config(tconfig.get_args(cli))
    tmodel = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu").eval()
    flax_to_torch(variables, tmodel)
    tro = to_numpy(eval_rollout(tmodel, images, boxes, t_train, sample=False,
                                positions=torch.from_numpy(start), device="cpu",
                                collect=("logits", "actions")))
    return dict(trainer=trainer, variables=variables, train_config=train_config,
                t_train=t_train, t_model=t_model, tmodel=tmodel, images=images,
                jro=jro, tro=tro)


def test_greedy_rollout_matches_jax(served):
    jro, tro = served["jro"], served["tro"]
    logits = np.sort(jro["logits"], axis=-1)
    gap = (logits[..., -1] - logits[..., -2]).min()
    assert gap > 50 * LOGIT_TOL, f"a near-tie ({gap}) could flip an argmax"
    np.testing.assert_allclose(tro["logits"], jro["logits"], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_array_equal(tro["actions"], jro["actions"])
    np.testing.assert_array_equal(tro["positions"], jro["positions"])
    assert tro["positions"].shape == (B, T + 1, 2)
    for name in ("rewards", "returns", "logit_masks"):
        np.testing.assert_allclose(tro[name], jro[name], atol=1e-6, rtol=0, err_msg=name)
    # functions of the logits: they agree as far as the logits do
    for name in ("logprobs", "entropies"):
        np.testing.assert_allclose(tro[name], jro[name], atol=LOGIT_TOL, rtol=0, err_msg=name)
    for name in ("masks", "terminated", "prop_patches_found", "prop_bboxes_found"):
        np.testing.assert_array_equal(tro[name], jro[name], err_msg=name)
    # the episodes move: the comparison covers more than the reset patch
    assert (np.abs(np.diff(jro["positions"], axis=1)).sum(-1) > 0).any()


def test_rollout_metrics_match_jax(served):
    jro, tro, trainer = served["jro"], served["tro"], served["trainer"]
    for b in range(B):
        row = lambda ro: {k: v[b:b + 1] for k, v in ro.items()}
        want = trainer.compute_rollout_metrics(row(jro))
        got = compute_rollout_metrics(row(tro), served["t_train"])
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=1e-5, rtol=1e-6,
                                       err_msg=name)


def test_detection_on_visited_patches_matches_jax(served):
    jro, tro, trainer = served["jro"], served["tro"], served["trainer"]
    tmodel = served["tmodel"]
    n_found = 0
    for b in range(B):
        positions = tro["positions"][b]
        n_valid = int(tro["masks"][b].sum())
        patches = gather_patches(served["images"][b], positions[:n_valid], P)
        np.testing.assert_array_equal(
            patches, jax_gather(served["images"][b], jro["positions"][b][:n_valid], P))

        want = jax.device_get(trainer._yolox_predict(served["variables"], jnp.asarray(patches)))
        with torch.no_grad():
            got = {k: v.numpy() for k, v in tmodel.yolox_outputs(torch.from_numpy(patches))[0].items()}
        for name in ("boxes", "obj_logits", "cls_logits"):
            np.testing.assert_allclose(got[name], want[name], atol=2e-4, rtol=1e-3, err_msg=name)

        kw = dict(conf_threshold=tmodel.detector_conf_threshold, patch_size=P)
        want_preds = jax_postprocess(want["boxes"], sigmoid_np(want["obj_logits"]),
                                     sigmoid_np(want["cls_logits"]), **kw)
        got_preds = postprocess(got["boxes"], sigmoid_np(got["obj_logits"]),
                                sigmoid_np(got["cls_logits"]), **kw)
        offsets = positions[:n_valid][:, [1, 0]] * P
        want_full = jax_to_full([want_preds], offsets[None], np.ones((1, n_valid), bool))
        got_full = patch_bboxes2full_image([got_preds], offsets[None], np.ones((1, n_valid), bool))
        if want_full[0] is None:
            assert got_full[0] is None
            continue
        _assert_same_rows(got_full[0], want_full[0], atol=2e-4)
        n_found += len(want_full[0])
    assert n_found > 0, "no box passed the threshold: the comparison holds nothing"


def _assert_same_rows(got, want, atol):
    """The same detections, each row within ``atol``, in any order. Random
    weights give the head scores that tie to ~1e-8, so two rows whose
    scores differ by less than the float error may leave NMS swapped. A
    patch visited twice repeats its rows, so rows are counted: each row has
    as many matches among the port's rows as among the reference's."""
    assert got.shape == want.shape
    close = lambda a, b: (np.abs(a[:, None, :] - b[None, :, :]).max(-1) < atol).sum(1)
    np.testing.assert_array_equal(close(want, got), close(want, want))
    np.testing.assert_array_equal(close(got, want), close(got, got))
    assert (close(want, got) > 0).all()


def test_infer_cli_serves_a_dataset_on_cpu(served, tmp_path):
    """The CLI body on a model dir written by the port (config.json and the
    checkpoint) and a dataset list of one PNG with its targets: it prints
    the JAX CLI's metrics, each image's rollout and detection scored. With
    ``--output-dir`` it writes one ``result<N>.png`` per image, the
    trajectory plot of that image's own rollout (no targets, its
    full-image predictions)."""
    from PIL import Image

    from jolineedle_tpu_torch.checkpoint import save_model
    from jolineedle_tpu_torch.infer import get_infer_args, infer, load_bboxes

    t_train = served["t_train"]
    tconfig.save_config(served["t_model"], t_train)
    model_dir = f"{t_train.work_dir}/{t_train.env_name}"
    save_model(served["tmodel"], model_dir, best=True)
    Image.fromarray(served["images"][0]).save(tmp_path / "img.png")
    (tmp_path / "img.txt").write_text("0 10 10 70 40\n0 140 70 170 100\n")
    (tmp_path / "list.txt").write_text("img.png img.txt\n")

    metrics = infer(get_infer_args(["--model-dir", model_dir, "--dataset",
                                    str(tmp_path / "list.txt")]), device="cpu")
    want = set(served["trainer"].compute_rollout_metrics(
        {k: v[:1] for k, v in served["jro"].items()})) | {"map"}
    assert set(metrics) == want
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in metrics.values())

    from jolineedle_tpu_torch.infer import infer_image, load_model_dir
    from jolineedle_tpu_torch.utils.geometry import parse_bbox_predictions
    from jolineedle_tpu_torch.utils.plotting import plot_model_prediction, save_image

    Image.fromarray(served["images"][1]).save(tmp_path / "img1.png")
    out_dir = tmp_path / "plots"
    infer(get_infer_args(["--model-dir", model_dir, "--dataset", str(tmp_path / "list.txt"),
                          "--input-images", str(tmp_path / "img1.png"),
                          "--output-dir", str(out_dir)]), device="cpu")
    assert sorted(p.name for p in out_dir.iterdir()) == ["result0.png", "result1.png"]
    train_config, _, model = load_model_dir(model_dir, device="cpu")
    boxes = [load_bboxes(tmp_path / "img.txt"), None]
    for i, image in enumerate(served["images"][:2]):
        out = infer_image(model, train_config, image, boxes[i], seed=i)
        save_image(plot_model_prediction(
            out["image"], out["patches"], out["positions"][: out["n_valid"]], true_bboxes=[],
            predicted_bboxes=parse_bbox_predictions([out["preds"]])), tmp_path / f"want{i}.png")
        np.testing.assert_array_equal(np.asarray(Image.open(out_dir / f"result{i}.png")),
                                      np.asarray(Image.open(tmp_path / f"want{i}.png")))


def test_infer_output_dir_without_matplotlib_raises_first(served, tmp_path, monkeypatch):
    """Without matplotlib ``--output-dir`` raises before the model loads and
    any rollout runs."""
    import sys

    from jolineedle_tpu_torch.infer import get_infer_args, infer
    from jolineedle_tpu_torch.ops import conv as kconv

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    kconv.reset_counts()
    with pytest.raises(ImportError, match="infer --output-dir .* matplotlib is not installed"):
        infer(get_infer_args(["--model-dir", str(tmp_path / "absent"), "--output-dir",
                              str(tmp_path / "plots")]), device="cpu")
    assert kconv.dwblock_bn_silu.calls == 0 and not (tmp_path / "plots").exists()
