"""``jolineedle_tpu_torch/utils/jax_random.py`` against ``jax.random``, and
the key route's two draw sites against the JAX package's:

- (a) the bits: ``split``, ``fold_in``, ``random_bits``, ``uniform`` (with
  bounds), ``bernoulli`` and ``randint`` bit-equal to ``jax.random`` over
  several keys, shapes (0-d and odd sizes) and batched keys; ``normal``
  within ``NORMAL_ULPS`` (XLA's ``log1p`` and ``erfinv`` are emulated, not
  called), the worst printed;
- (b) the key chain: ``KeyStream`` against the JAX supervised loop's keys
  (``jolineedle_tpu/train/supervised.py:346``, ``:365-366``) for 100
  iterations at one step a dispatch and 25 dispatches of 4 with a tail
  chunk, and resumed at any step;
- (c) dropout: the port's GPT forward in train mode under a dropout key
  against the JAX GPT's ``apply(..., rngs={"dropout": key})`` at dropout
  0.1 in float32, with no mask injected: every site's key is flax's (the
  site paths read off the JAX model);
- (d) the photometric augmentation on the key route against JAX's
  ``detection_augment(key, images)``.
"""

import hashlib

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from flax import config as flax_config
from flax.core import scope as flax_scope

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.ops.augment import detection_augment as jax_detection_augment
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.models.bridge import flax_to_torch
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.ops.augment import detection_augment
from jolineedle_tpu_torch.utils import jax_random as jr

# The suite runs in several test processes that share the cores.
torch.set_num_threads(1)

SEEDS = (0, 1, 42, 123456789)
SHAPES = ((), (1,), (7,), (4, 5), (3, 7, 3))
NORMAL_ULPS = 2
# The augmentation's float32 arithmetic (exp, the bilinear field, the
# blurs) in another order than XLA's: measured 3.6e-7 at most.
AUG_ATOL = 1e-6
# The train-mode forward in float32 (batch-statistics BN in the embedder,
# the convs and the attention in another order than XLA's): measured 1.2e-5
# at dropout 0.1, and about as much at dropout 0, this forward's float32
# floor.
LOGIT_ATOL = 2e-5


def _key(seed: int):
    return jax.random.PRNGKey(seed), jr.to_device(jr.prng_key(seed), "cpu")


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _ulps(a, b) -> np.ndarray:
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_equal_jax(seed):
    jkey, tkey = _key(seed)
    assert jr.prng_key(seed) == tuple(_u32(jkey).tolist())
    for num in (1, 2, 3, 7):
        want = _u32(jax.random.split(jkey, num))
        np.testing.assert_array_equal(jr.split(tkey, num).numpy(), want)
        assert jr.split(jr.prng_key(seed), num) == [tuple(k) for k in want.tolist()]
    np.testing.assert_array_equal(jr.split(tkey, (2, 3)).numpy(),
                                  _u32(jax.random.split(jkey, (2, 3))))
    for data in (0, 7, 2 ** 31 + 5, 2 ** 32 - 1):
        want = _u32(jax.random.fold_in(jkey, data))
        np.testing.assert_array_equal(jr.fold_in(tkey, data).numpy(), want)
        assert jr.fold_in(jr.prng_key(seed), data) == tuple(want.tolist())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_equal_jax_bit_for_bit(seed, shape):
    jkey, tkey = _key(seed)
    np.testing.assert_array_equal(jr.random_bits(tkey, shape).numpy(),
                                  _u32(jax.random.bits(jkey, shape)))
    for lo, hi in ((0.0, 1.0), (0.1, 2.0), (-0.2, 0.0), (0.0, 0.4)):
        got = jr.uniform(tkey, shape, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jkey, shape, minval=lo, maxval=hi))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(jr.bernoulli(tkey, 0.9, shape).numpy(),
                                  np.asarray(jax.random.bernoulli(jkey, 0.9, shape)))
    for lo, hi in ((0, 24), (0, 4), (-3, 1000)):
        np.testing.assert_array_equal(jr.randint(tkey, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.randint(jkey, shape, lo, hi)))


def test_batched_keys_draw_as_vmap():
    jkeys = jax.random.split(jax.random.PRNGKey(5), (2, 3))
    tkeys = torch.from_numpy(_u32(jkeys))
    for sample, want in (
            (lambda k: jr.uniform(k, (4,), -1.0, 1.0),
             jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (4,), minval=-1.0, maxval=1.0)))),
            (lambda k: jr.randint(k, (), 0, 24),
             jax.vmap(jax.vmap(lambda k: jax.random.randint(k, (), 0, 24)))),
            (lambda k: jr.split(k, 6), jax.vmap(jax.vmap(lambda k: jax.random.split(k, 6)))),
    ):
        got, want = sample(tkeys).numpy(), np.asarray(want(jkeys))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_normal_within_ulps_of_jax():
    worst, differ, total = 0, 0, 0
    for seed in SEEDS:
        jkey, tkey = _key(seed)
        for shape in SHAPES + ((100_000,),):
            got, want = jr.normal(tkey, shape).numpy(), np.asarray(jax.random.normal(jkey, shape))
            ulps = _ulps(got, want)
            if ulps.size:
                worst = max(worst, int(ulps.max()))
                differ, total = differ + int((ulps > 0).sum()), total + ulps.size
    print(f"normal: worst {worst} ulp; {differ} of {total} draws differ")
    assert worst <= NORMAL_ULPS


def _jax_loop_keys(seed: int, n_iters: int, spd: int) -> list:
    """The step keys of the JAX supervised loop (``supervised.py:341-385``)
    for ``n_iters`` iterations at ``--steps-per-dispatch`` ``spd``."""
    key, keys, start = jax.random.PRNGKey(seed), [], 1
    if spd == 1:
        for _ in range(n_iters):
            key, step_key = jax.random.split(key)
            keys.append(step_key)
        return [tuple(_u32(k).tolist()) for k in keys]
    max_iters = n_iters + 1
    while start < max_iters:
        n = min(spd, max_iters - start)
        key, sub = jax.random.split(key)
        keys += list(jax.random.split(sub, spd)[:n])
        start += n
    return [tuple(_u32(k).tolist()) for k in keys]


@pytest.mark.parametrize("spd,n_iters", [(1, 100), (4, 98)])
def test_key_stream_equals_the_jax_loop(spd, n_iters):
    """At spd 4, 98 iterations are 24 dispatches of 4 and a tail of 2."""
    want = _jax_loop_keys(1, n_iters, spd)
    stream = jr.KeyStream(1, spd)
    assert [stream.step_key(s) for s in range(n_iters)] == want
    # resumed at any step, forwards or backwards, from its state alone
    for step in (57, 3, 97, 0):
        assert jr.KeyStream(**stream.state_dict()).step_key(step) == want[step]
        assert stream.step_key(step) == want[step]


def test_flax_site_keys_equal_flaxs_own():
    key = jax.random.PRNGKey(3)
    for path in (("drop",), ("h_0", "attn", "Dropout_0"), ("h_2", "Dropout_0")):
        for counter in (1, 2, 300):
            want = flax_scope.LazyRng.create(key, *path, counter).as_jax_rng()
            assert jr.flax_rng(jr.prng_key(3), path, counter) == tuple(_u32(want).tolist())
    # the port's SHA-1 word is flax's with no separators (its default)
    assert not flax_config.flax_fix_rng_separator
    assert jr._fold_static(("h_0", "Dropout_0", 1)) == int.from_bytes(
        hashlib.sha1(b"h_0Dropout_0\x01").digest()[:4], "big")


P, T, B = 64, 8, 3
CLI = [
    "--training-mode", "supervised", "--dataset-dir", "/nonexistent", "--work-dir",
    "/nonexistent", "--model-type", "gpt-nano", "--image-processor", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--max-seq-len", str(T), "--patch-size", str(P), "--minimum-image-size", "0",
    "--batch-size", str(B), "--dropout", "0.1", "--compute-dtype", "float32", "--devices", "0",
]


@pytest.fixture(scope="module")
def models():
    """The recipe's shared yolox-nano pairing at dropout 0.1 in float32: the
    JAX GPT with flax's initial draw and the port's GPT with its weights."""
    train_config, model_config = args_to_config(get_args(CLI))
    jmodel = JaxGPT.from_config(model_config, get_actions_info(train_config))
    variables = jax.jit(lambda rng: jmodel.init(
        rng, jnp.zeros((1, 1, P, P, 3)), jnp.zeros((1, 1), jnp.int32),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, 2), jnp.int32), jnp.zeros((1, P, P, 3)),
        method=JaxGPT.init_all))(jax.random.PRNGKey(1))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(CLI))
    tmodel = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu")
    flax_to_torch(variables, tmodel)
    assert jmodel.dropout == tmodel.dropout == 0.1
    return jmodel, variables, tmodel


def _inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return dict(patches=rng.random((B, T, P, P, 3)).astype(np.float32),
                actions=rng.integers(0, 8, (B, T)).astype(np.int32),
                classes=np.zeros((B,), np.int32),
                positions=rng.integers(0, 3, (B, T, 2)).astype(np.int32))


def test_train_forward_under_a_dropout_key_equals_jax(models):
    """(c) The logits of the train-mode forward (batch-statistics BN in the
    embedder, every dropout site on) under the same key, within
    ``LOGIT_ATOL``; under another key they move by far more. The sites
    the JAX model calls, in order, are the port's ``dropout_sites``."""
    jmodel, variables, tmodel = models
    x = _inputs(0)
    names = ("patches", "actions", "classes", "positions")
    sites = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            sites.append(tuple(context.module.path))
        return next_fun(*args, **kwargs)

    def jax_logits(key):
        with fnn.intercept_methods(record):
            (logits, _), _ = jmodel.apply(variables, *(jnp.asarray(x[k]) for k in names),
                                          train=True, rngs={"dropout": key},
                                          mutable=["batch_stats"])
        return np.asarray(logits)

    def port_logits(key):
        flax_to_torch(variables, tmodel)  # the BN running statistics as they were
        with torch.no_grad():
            return tmodel(*(torch.from_numpy(x[k]).long() if x[k].dtype == np.int32
                            else torch.from_numpy(x[k]) for k in names),
                          train=True, generator=key)[0].numpy()

    k_drop = jax.random.split(jax.random.PRNGKey(1), 3)[2]
    want = jax_logits(k_drop)
    assert sites == tmodel.dropout_sites()
    got = port_logits(tuple(_u32(k_drop).tolist()))
    print(f"train forward under a dropout key: {np.abs(got - want).max():.3g} from JAX's")
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    other = port_logits(jr.fold_in(tuple(_u32(k_drop).tolist()), 1))
    assert np.abs(other - want).max() > 100 * LOGIT_ATOL


@pytest.mark.parametrize("seed,shape", [(1, (2, 3, 64, 64, 3)), (5, (4, 32, 32, 3)),
                                        (9, (1, 1, 17, 23, 3))], ids=str)
def test_augment_on_the_key_route_equals_jax(seed, shape):
    """(d) ``detection_augment`` on a key against JAX's on the same key and
    uint8 images, within ``AUG_ATOL`` (the noise term holds ``normal``'s
    ulps); a host key and a device key draw alike."""
    images = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.jit(jax_detection_augment)(key, jnp.asarray(images, jnp.float32) / 255))
    got = detection_augment(jr.prng_key(seed), torch.from_numpy(images))
    assert got.shape == images.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=AUG_ATOL, rtol=0)
    assert torch.equal(detection_augment(jr.to_device(jr.prng_key(seed), "cpu"),
                                         torch.from_numpy(images)), got)
