"""The device data pool of the port against the JAX package, on the CPU.

At the sizes of ``tests/test_device_pool.py`` (6 + 2 toy images of 192x256,
patch 64, ``--max-seq-len 4``), bit for bit:

- ``NeedleDataset.get_geometry`` for every index, augmentations off, rotate,
  translate and both: the same geometry as JAX, the same boxes as the
  port's own ``__getitem__``, and the same next draw of the generator after
  each (so both routes take the same draws);
- ``padded_size``, the pool's pixels, and the three gathers
  (``gather_pool_patches``, ``aug_canvases`` on the square and the
  rectangular canvas and at REINFORCE's ``out_hw``, and
  ``gather_canvas_patches``) against JAX's jitted functions and against the
  host gather of the same batch;
- ``build_supervised_batch(with_pixels=False)`` key by key;
- one supervised and one REINFORCE ``train_step`` fed from the pool and one
  fed with streamed pixels, on copies of one model: the losses and every
  entry of the state dict equal;
- eligibility under ``auto``/``on``/``off`` and a budget of 0 MB.

JAX's own pool step is pinned against its streaming step by
``tests/test_device_pool.py``; no JAX train step runs here.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.data import device_pool as jpool
from jolineedle_tpu.data.dataset import build_datasets as jax_build_datasets
from jolineedle_tpu.parallel.mesh import make_mesh
from jolineedle_tpu.train import batching as jbatching
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.data import device_pool as tpool
from jolineedle_tpu_torch.env.actions import get_actions_info
from jolineedle_tpu_torch.models.gpt import GPT
from jolineedle_tpu_torch.train import batching as tbatching
from jolineedle_tpu_torch.train.reinforce import ReinforceTrainer
from jolineedle_tpu_torch.train.supervised import SupervisedTrainer

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P = 64
CLI = [
    "--training-mode", "supervised", "--dataset-dir", "/nonexistent",
    "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--enable-stop", "--max-seq-len", "4", "--batch-size", "2", "--patch-size", str(P),
    "--minimum-image-size", "0", "--devices", "0", "--max-det-patches", "4",
    "--max-boxes", "4", "--compute-dtype", "float32", "--dropout", "0.1",
]
AUGS = {
    "off": [],
    "rotate": ["--augment-rotate"],
    "translate": ["--augment-translate"],
    "both": ["--augment-rotate", "--augment-translate"],
}


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    from jolineedle_tpu.data.toy import generate_toy_dataset

    root = tmp_path_factory.mktemp("toypool")
    generate_toy_dataset(root / "toy", n_train=6, n_test=2, image_size=(192, 256), seed=3)
    return root


def _setup(toy, augs, extra=()):
    """Each package's training set and the port's train config, from one
    command line with the augmentations ``AUGS[augs]``."""
    from jolineedle_tpu_torch.main import build_both_datasets

    flags = list(CLI) + AUGS[augs] + list(extra)
    flags[flags.index("--dataset-dir") + 1] = str(toy / "toy")
    flags[flags.index("--work-dir") + 1] = str(toy / "out")
    j_train, j_model = args_to_config(get_args(flags))
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(flags))
    jds, _ = jax_build_datasets(
        toy / "toy", patch_size=j_model.patch_size, max_ep_len=j_model.block_size,
        min_keypoints=j_train.min_keypoints, max_keypoints=j_train.max_keypoints,
        rotations=j_train.rotations, translations=j_train.translations,
        test_size=j_train.test_size, test_pattern=j_train.test_pattern, seed=j_train.seed,
        train_size=j_train.train_size, binomial_keypoints=j_train.binomial_keypoints,
        minimum_image_size=j_train.minimum_image_size, filter_classes=j_train.filter_classes)
    tds, _ = build_both_datasets(t_train, t_model, toy / "toy")
    return jds, tds, j_train, t_train, t_model


@pytest.fixture(scope="module")
def pools(toy):
    """The JAX pool (numpy) and the port's, of the un-augmented set."""
    jds, tds, *_ = _setup(toy, "off")
    want = np.asarray(jax.device_get(jpool.DeviceImagePool.build(jds, make_mesh([0])).images))
    return want, tpool.DeviceImagePool.build(tds, "cpu")


def _assert_same(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("augs", list(AUGS))
def test_get_geometry_equals_jax_and_takes_getitems_draws(toy, augs):
    jds, tds, *_ = _setup(toy, augs)
    j_rng, t_rng, item_rng = (np.random.default_rng(17) for _ in range(3))
    for i in range(len(tds)):
        want = jds.get_geometry(i, j_rng)
        got = tds.get_geometry(i, t_rng)
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k], f"{augs} image {i}: {k}")
        item = tds.__getitem__(i, item_rng)
        _assert_same(got["bboxes"], item["bboxes"], f"{augs} image {i}: __getitem__ boxes")
        assert got["class_id"] == item["class_id"]
        assert got["shape"] == item["image"].shape[:2]
        draws = {int(r.integers(2**31)) for r in (j_rng, t_rng, item_rng)}
        assert len(draws) == 1, f"{augs} image {i}: the generators diverged"


@pytest.mark.parametrize("raw_hw,minimum", [
    ((192, 256), 0), ((200, 130), 0), ((100, 300), 448), ((500, 90), 256), ((64, 64), 64),
])
def test_padded_size_equals_jax(raw_hw, minimum):
    assert tpool.padded_size(*raw_hw, minimum, P) == jpool.padded_size(*raw_hw, minimum, P)


def test_pool_holds_the_jax_pixels(pools):
    want, pool = pools
    _assert_same(pool.images.numpy(), want)
    assert pool.nbytes == want.size and pool.images.device.type == "cpu"
    assert (pool.shapes == np.array(want.shape[1:3])).all()


def _batches(toy, augs, indices, seed):
    jds, tds, _, t_cfg, _ = _setup(toy, augs)
    with_px = tbatching.build_supervised_batch(tds, indices, t_cfg, np.random.default_rng(seed))
    no_px = tbatching.build_supervised_batch(tds, indices, t_cfg, np.random.default_rng(seed),
                                             with_pixels=False)
    return jds, tds, t_cfg, with_px, no_px


@pytest.mark.parametrize("augs", list(AUGS))
def test_pixel_free_batch_equals_jax(toy, augs):
    indices = [0, 3, 5, 1, 2, 4]
    jds, tds, t_cfg, with_px, no_px = _batches(toy, augs, indices, 23)
    want = jbatching.build_supervised_batch(jds, indices, _setup(toy, augs)[2],
                                            np.random.default_rng(23), with_pixels=False)
    assert no_px.keys() == want.keys()
    for k in want:
        _assert_same(no_px[k], want[k], k)
    assert "patches" not in no_px and "patches_yolox" not in no_px
    assert ("aug_rot" in no_px) == ("--augment-rotate" in AUGS[augs])
    assert ("aug_shift" in no_px) == ("--augment-translate" in AUGS[augs])
    for k in set(with_px) - {"patches", "patches_yolox"}:
        _assert_same(no_px[k], with_px[k], k)


def test_gather_pool_patches_equals_jax_and_host(toy, pools):
    want_pool, pool = pools
    *_, with_px, no_px = _batches(toy, "off", [0, 3, 5, 1], 11)
    gather = jax.jit(jpool.gather_pool_patches, static_argnums=3)
    for positions, host in (("positions", "patches"), ("yolox_positions", "patches_yolox")):
        want = np.asarray(gather(want_pool, no_px["image_idx"], no_px[positions], P))
        got = tpool.gather_pool_patches(pool.images, torch.from_numpy(no_px["image_idx"]),
                                        torch.from_numpy(no_px[positions]), P).numpy()
        _assert_same(got, want, positions)
        if host == "patches_yolox":
            got = got * no_px["yolox_valid"][:, :, None, None, None].astype(np.uint8)
        _assert_same(got, with_px[host], host)


@pytest.mark.parametrize("patch,channels", [(64, 3), (6, 3), (5, 3), (4, 1)],
                         ids=["words8", "words2", "bytes", "words4"])
def test_gathers_move_whole_words_as_jax_slices(patch, channels):
    """Random pools whose rows take 8-, 2-, 1- and 4-byte words, positions
    past the grid included (``lax.dynamic_slice`` clamps them): the patch
    and image gathers against JAX's."""
    rng = np.random.default_rng(patch)
    n, hg, wg, b, k = 3, 4, 5, 4, 6
    pool = rng.integers(0, 256, (n, hg * patch, wg * patch, channels), dtype=np.uint8)
    idx = rng.integers(0, n, b).astype(np.int32)
    pos = rng.integers(-1, 7, (b, k, 2)).astype(np.int32)
    want = jax.jit(jpool.gather_pool_patches, static_argnums=3)(pool, idx, pos, patch)
    got = tpool.gather_pool_patches(torch.from_numpy(pool), torch.from_numpy(idx),
                                    torch.from_numpy(pos), patch)
    _assert_same(got.numpy(), np.asarray(want))
    got = tpool.gather_canvas_patches(torch.from_numpy(pool), torch.from_numpy(pos[:n]), patch)
    want = jax.jit(jpool.gather_canvas_patches, static_argnums=2)(pool, pos[:n], patch)
    _assert_same(got.numpy(), np.asarray(want))
    got = tpool.gather_pool_images(torch.from_numpy(pool), torch.from_numpy(idx))
    _assert_same(got.numpy(), np.asarray(jnp.take(pool, idx, axis=0)))


@pytest.mark.parametrize("augs,out_hw", [
    ("rotate", None), ("translate", None), ("both", None), ("both", (320, 320)),
    ("off", (256, 320)),
], ids=["square", "rectangular", "both", "out_hw", "pad_only"])
def test_aug_canvases_equal_jax_and_host(toy, pools, augs, out_hw):
    """The canvases and their patches against JAX's jitted functions; the
    patches also against the host's gather of the augmented images."""
    want_pool, pool = pools
    *_, with_px, no_px = _batches(toy, augs, [0, 3, 5, 1, 2, 4], 23)
    args = [no_px.get(k) for k in ("aug_rot", "aug_shift", "base_hw")]
    canvases = jax.jit(jpool.aug_canvases, static_argnums=5)(
        want_pool, no_px["image_idx"], *args, out_hw)
    got = tpool.aug_canvases(pool.images, torch.from_numpy(no_px["image_idx"]),
                             *[None if a is None else torch.from_numpy(a) for a in args],
                             out_hw)
    _assert_same(got.numpy(), np.asarray(canvases), "canvases")
    gather = jax.jit(jpool.gather_canvas_patches, static_argnums=2)
    for positions, host in (("positions", "patches"), ("yolox_positions", "patches_yolox")):
        want = np.asarray(gather(canvases, no_px[positions], P))
        patches = tpool.gather_canvas_patches(got, torch.from_numpy(no_px[positions]), P).numpy()
        _assert_same(patches, want, positions)
        if host == "patches_yolox":
            patches = patches * no_px["yolox_valid"][:, :, None, None, None].astype(np.uint8)
        _assert_same(patches, with_px[host], host)


def _trainers(toy, augs, cls, mode):
    """Two trainers of ``cls`` on copies of one model, the second with the
    port's pool of the (augmenting) training set."""
    _, tds, _, t_cfg, t_model = _setup(toy, augs, ["--training-mode", mode, "--seed", "5"])
    torch.manual_seed(0)
    model = GPT.from_config(t_model, get_actions_info(t_cfg), device="cpu")
    streams = cls(t_cfg, model, None, tds, tds, device="cpu")
    pooled = cls(t_cfg, copy.deepcopy(model), None, tds, tds, device="cpu")
    pooled.pool = tpool.DeviceImagePool.build(tds, "cpu")
    return streams, pooled


def _assert_same_models(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("augs", ["off", "both"])
def test_supervised_step_from_the_pool_equals_streamed(toy, augs):
    streams, pooled = _trainers(toy, augs, SupervisedTrainer, "supervised")
    batches = [tbatching.build_supervised_batch(streams.train_dataset, [0, 2], streams.config,
                                                np.random.default_rng(4), with_pixels=px)
               for px in (True, False)]
    assert "patches" not in batches[1]
    init = copy.deepcopy(streams.model.state_dict())
    want = streams.train_step(batches[0])
    got = pooled.train_step(batches[1])
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _assert_same_models(pooled.model, streams.model)
    assert streams.optimizer.updates == 1
    assert not torch.equal(init["h.0.attn.c_attn.weight"], pooled.model.h[0].attn.c_attn.weight)


@pytest.mark.parametrize("augs", ["off", "both"])
def test_reinforce_step_from_the_pool_equals_streamed(toy, augs):
    streams, pooled = _trainers(toy, augs, ReinforceTrainer, "reinforce")
    batches = [streams._build_env_batch([1, 4], seed=2, with_pixels=px) for px in (True, False)]
    assert "image" not in batches[1] and "image_idx" in batches[1]
    _assert_same(pooled._batch_images(batches[1]).numpy(), batches[0]["image"], "images")
    for _ in range(2):  # the second step starts from the first's update
        want = streams.train_step(batches[0])
        got = pooled.train_step(batches[1])
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert streams.optimizer.updates == pooled.optimizer.updates == 2
    _assert_same_models(pooled.model, streams.model)


@pytest.mark.parametrize("mode,budget_mb,rotations,eligible", [
    ("auto", None, False, True), ("on", None, False, True), ("off", None, False, False),
    ("auto", "0", False, False), ("on", "0", False, True), ("auto", None, True, True),
])
def test_eligibility(toy, monkeypatch, capsys, mode, budget_mb, rotations, eligible):
    """``on`` forces the pool, ``off`` streams, ``auto`` streams over the
    budget with JAX's line; geometric augmentations do not disqualify."""
    jds, tds, *_ = _setup(toy, "rotate" if rotations else "off")
    if budget_mb is not None:
        monkeypatch.setenv("JOLINEEDLE_POOL_BUDGET_MB", budget_mb)
    assert tpool.DeviceImagePool.eligible(tds, mode) is eligible
    port_out = capsys.readouterr().out
    assert jpool.DeviceImagePool.eligible(jds, mode) is eligible
    assert port_out == capsys.readouterr().out
    assert ("streaming instead" in port_out) == (mode == "auto" and not eligible)
