"""The probe option ``GPT.tpu_default_precision`` (``models/gpt.py::
TpuDefaultDot``) against a TPU-default-precision reference built here from
the JAX package.

On a TPU, XLA computes a float32 ``dot_general`` at its default precision
as one pass on bfloat16-rounded operands with float32 accumulation, and the
transposed products of its backward likewise, on a rounded cotangent. XLA's
CPU backend ignores ``jax_default_matmul_precision``, so the reference
rounds the operands itself: ``_tpu_dot`` is a ``jax.custom_vjp`` around
``jax.lax.dot_general`` that rounds both operands in the forward and the
cotangent in the backward, monkeypatched over ``jax.lax.dot_general``
(which flax's Dense calls) before the functions are traced. The bf16
recipe's step holds float32 products only in the three Dense layers
(``test_torch_jax_keys_step.py``), so there every float32 product is
patched; in float32 only those three layers' (the option's scope).

The decision loss of the supervised step (the recipe's shared pairing,
dropout 0.1 on the key route, so both packages draw the same masks) is
where the option acts: the gradients of every parameter it reaches, with
the option on and off.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu.train.supervised import action_ce_metrics
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.models.bridge import flax_to_torch, torch_to_flax
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.models.gpt import TpuDefaultDot
from jolineedle_tpu_torch.train import supervised as tsup

# The suite runs in several test processes that share the cores.
torch.set_num_threads(1)

P, T, B = 64, 8, 4
N_ACTIONS = 8
#: The Dense layers the option covers, by flax module name.
SITES = ("embed_fpn_dense", "project_concat", "action_head")
# Float32 (the option's layers rounded, all else float32): per leaf, the
# RMS of the gradient's distance from the reference over the reference's
# RMS. Measured with the option on: a median of 2.1e-4 over the leaves,
# 1.8e-3 at most on the three layers' kernels; off: a median of 2.6e-3,
# 2.8e-3 at least on those kernels.
F32_MEDIAN, F32_SITE = 1e-3, 2.5e-3
# bf16: the two packages' bf16 convolutions, BN and blocks round apart by
# a median of 2.8 % of a leaf's RMS (the option on or off alike), more than
# the TPU precision moves JAX's own step (0.6 %): the option is held
# to the spread the bf16 step has without it, and the loss terms within
# the trajectory's 1e-3.
BF16_MEDIAN, LOSS_RTOL = 0.05, 1e-3


def _bf16(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _tpu_dot(lhs, rhs, dimension_numbers):
    return _ORIGINAL_DOT(_bf16(lhs), _bf16(rhs), dimension_numbers)


def _tpu_dot_fwd(lhs, rhs, dimension_numbers):
    lhs, rhs = _bf16(lhs), _bf16(rhs)
    return _ORIGINAL_DOT(lhs, rhs, dimension_numbers), (lhs, rhs)


def _tpu_dot_bwd(dimension_numbers, residuals, cotangent):
    _, vjp = jax.vjp(lambda a, b: _ORIGINAL_DOT(a, b, dimension_numbers), *residuals)
    return vjp(_bf16(cotangent))


_tpu_dot.defvjp(_tpu_dot_fwd, _tpu_dot_bwd)
_ORIGINAL_DOT = jax.lax.dot_general


@pytest.fixture
def tpu_reference(monkeypatch):
    """Patches ``jax.lax.dot_general``; returns ``traced(fn, everywhere)``,
    which runs ``fn`` with every float32 product at the TPU's default
    precision (``everywhere``) or only those of ``SITES`` (through flax's
    method interceptor)."""
    active = {"on": False}

    def dot_general(lhs, rhs, dimension_numbers, precision=None, preferred_element_type=None,
                    **kwargs):
        if (active["on"] and precision is None and lhs.dtype == jnp.float32
                and rhs.dtype == jnp.float32):
            return _tpu_dot(lhs, rhs, dimension_numbers)
        return _ORIGINAL_DOT(lhs, rhs, dimension_numbers, precision=precision,
                             preferred_element_type=preferred_element_type, **kwargs)

    def at_sites(next_fun, args, kwargs, context):
        if context.method_name != "__call__" or context.module.name not in SITES:
            return next_fun(*args, **kwargs)
        active["on"] = True
        try:
            return next_fun(*args, **kwargs)
        finally:
            active["on"] = False

    def traced(fn, everywhere: bool):
        active["on"] = everywhere
        try:
            if everywhere:
                return fn()
            with fnn.intercept_methods(at_sites):
                return fn()
        finally:
            active["on"] = False

    monkeypatch.setattr(jax.lax, "dot_general", dot_general)
    return traced


def test_tpu_default_dot_rounds_operands_and_cotangent():
    """``TpuDefaultDot`` of an ``nn.Linear``'s layout against ``_tpu_dot``
    of flax's: the forward, the input's and the weight's gradients, within
    float32's order of summation; the plain float32 product lies further."""
    rng = np.random.default_rng(0)
    x, w, g = (rng.normal(size=s).astype(np.float32) for s in ((2, 5, 48), (16, 48), (2, 5, 16)))
    dn = (((2,), (0,)), ((), ()))
    want, vjp = jax.vjp(lambda a, b: _tpu_dot(a, b, dn), jnp.asarray(x), jnp.asarray(w.T))
    want_dx, want_dw = vjp(jnp.asarray(g))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    got = TpuDefaultDot.apply(xt, wt)
    got.backward(torch.from_numpy(g))
    for name, a, b in (("forward", got.detach(), want), ("dx", xt.grad, want_dx),
                       ("dw", wt.grad.T, want_dw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5, err_msg=name)
    plain = torch.from_numpy(x) @ torch.from_numpy(w).T
    assert (plain - got.detach()).abs().max() > 1e-3


def _cli(dtype: str) -> list:
    return ["--training-mode", "supervised", "--dataset-dir", "/nonexistent", "--work-dir",
            "/nonexistent", "--model-type", "gpt-nano", "--image-processor", "yolox-nano",
            "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
            "--max-seq-len", str(T), "--patch-size", str(P), "--minimum-image-size", "0",
            "--batch-size", str(B), "--compute-dtype", dtype, "--devices", "0"]


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return dict(patches=rng.random((B, T, P, P, 3)).astype(np.float32),
                actions=rng.integers(0, N_ACTIONS, (B, T)).astype(np.int32),
                classes=np.zeros((B,), np.int32),
                positions=rng.integers(0, 3, (B, T, 2)).astype(np.int32),
                targets=rng.integers(0, N_ACTIONS, (B, T)).astype(np.int32),
                masks=(rng.random((B, T)) < 0.9).astype(np.float32))


def _flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if hasattr(v, "items")
                   else {prefix + (k,): np.asarray(v, np.float64)})
    return out


def _rel_rms(got: dict, want: dict) -> dict:
    return {k: float(np.sqrt(np.mean((got[k] - v) ** 2)) / np.sqrt(np.mean(v ** 2)))
            for k, v in want.items() if np.any(v)}


def _decision_grads(dtype: str, traced) -> dict:
    """The decision loss and its gradients: the JAX reference (``traced``
    with every float32 product at the TPU's precision in bf16, the three
    layers' in float32) and the port with the option on and off, all from
    flax's initial draw of seed 1, under one dropout key."""
    train_config, model_config = args_to_config(get_args(_cli(dtype)))
    jmodel = JaxGPT.from_config(model_config, get_actions_info(train_config))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(lambda rng: jmodel.init(
        rng, jnp.zeros((1, 1, P, P, 3)), jnp.zeros((1, 1), jnp.int32),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 1, 2), jnp.int32), jnp.zeros((1, P, P, 3)),
        method=JaxGPT.init_all))(jax.random.PRNGKey(1)))
    x, k_drop = _inputs(), jax.random.split(jax.random.PRNGKey(1), 3)[2]
    weight = np.ones((N_ACTIONS,), np.float32)

    def loss(params):
        (logits, _), _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *(jnp.asarray(x[k]) for k in ("patches", "actions", "classes", "positions")),
            train=True, rngs={"dropout": k_drop}, mutable=["batch_stats"])
        return action_ce_metrics(logits, jnp.asarray(x["targets"]), jnp.asarray(x["masks"]),
                                 jnp.asarray(weight))[0]

    value, grads = traced(lambda: jax.jit(jax.value_and_grad(loss))(variables["params"]),
                          everywhere=dtype == "bfloat16")
    out = {"reference": (float(value), _flat(grads))}
    if dtype == "bfloat16":  # JAX's own step at the CPU's float32 products
        value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
        out["jax"] = (float(value), _flat(grads))
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(_cli(dtype)))
    tmodel = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu")
    batch = {"current_actions": torch.from_numpy(x["actions"]),
             "class_id": torch.from_numpy(x["classes"]),
             "positions": torch.from_numpy(x["positions"]),
             "reference_actions": torch.from_numpy(x["targets"]),
             "masks": torch.from_numpy(x["masks"])}
    for option in (True, False):
        flax_to_torch(variables, tmodel)
        tmodel.zero_grad(set_to_none=True)
        tmodel.tpu_default_precision = option
        value, _ = tsup.decision_loss(tmodel, torch.from_numpy(x["patches"]), batch,
                                      torch.from_numpy(weight),
                                      tuple(np.asarray(k_drop).astype(np.int64).tolist()))
        value.backward()
        value = value.detach()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in tmodel.named_parameters()}
        out["on" if option else "off"] = (float(value), _flat(
            torch_to_flax(grads, tmodel, strict=False)["params"]))
    return out


def test_option_equals_the_tpu_reference_in_float32(tpu_reference):
    runs = _decision_grads("float32", tpu_reference)
    ref_loss, ref = runs["reference"]
    summary = {}
    for name in ("on", "off"):
        loss, grads = runs[name]
        rel = _rel_rms(grads, ref)
        sites = [rel[k] for k in (("embed_fpn_dense", "kernel"), ("project_concat", "kernel"),
                                  ("action_head", "Dense_0", "kernel"))]
        summary[name] = (float(np.median(list(rel.values()))), sites, abs(loss / ref_loss - 1))
    print("float32, median / three kernels / loss:", summary)
    median, sites, _ = summary["on"]
    assert median <= F32_MEDIAN and max(sites) <= F32_SITE
    median, sites, _ = summary["off"]  # the negative control
    assert median > F32_MEDIAN and min(sites) > F32_SITE


def test_option_at_the_recipes_bf16(tpu_reference):
    runs = _decision_grads("bfloat16", tpu_reference)
    ref_loss, ref = runs["reference"]
    medians = {name: float(np.median(list(_rel_rms(runs[name][1], ref).values())))
               for name in ("on", "off", "jax")}
    loss = runs["on"][0]
    print(f"bf16, median distance from the TPU reference: {medians}; the option's loss"
          f" {abs(loss / ref_loss - 1):.2e} from it")
    assert medians["on"] <= BF16_MEDIAN and abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)


def test_option_leaves_the_eval_forward_in_float32():
    """The option covers the train step's products only: the eval forward
    (rollouts, tests, ``eval_checkpoint``) is the same with it on."""
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(_cli("float32")))
    tmodel = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu").eval()
    x = _inputs()
    args = (torch.from_numpy(x["patches"]), torch.from_numpy(x["actions"]).long(),
            torch.from_numpy(x["classes"]).long(), torch.from_numpy(x["positions"]).long())
    with torch.no_grad():
        off = tmodel(*args)[0]
        tmodel.tpu_default_precision = True
        assert torch.equal(tmodel(*args)[0], off)
