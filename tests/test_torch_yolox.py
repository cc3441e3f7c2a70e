"""The port's YOLOX (jolineedle_tpu_torch/models/yolox.py) against the JAX
NeedleYOLOX with bridged nano weights and random BN statistics, and against
the upstream-named torch modules of tests/torch_yolox_ref.py.

float32 on the CPU, where the fused conv wrappers compute their plain
versions; the wrappers' call counters show that the eval-mode module tree
goes through them the expected number of times.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.models.bridge import flax_to_torch
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.models.yolox import NeedleYOLOX
from jolineedle_tpu_torch.ops import conv as tconv

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P = 64
TOL = dict(atol=2e-4, rtol=1e-3)  # as tests/test_port_golden.py

CLI = [
    "--training-mode", "reinforce", "--dataset-dir", "/nonexistent",
    "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
    "--image-processor", "yolox-nano", "--gpt-backbone", "yolox-nano",
    "--concat-embeddings", "--decoder-pos-encoding", "--use-positional-embedding",
    "--enable-stop", "--max-seq-len", "4", "--patch-size", str(P),
    "--minimum-image-size", "0", "--batch-size", "2", "--dropout", "0.0",
    "--compute-dtype", "float32", "--devices", "0",
]


def _np_tree(tree):
    return {k: _np_tree(v) if hasattr(v, "items") else np.array(v) for k, v in tree.items()}


def _randomize_bn(variables, seed):
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
    return variables


@pytest.fixture(scope="module")
def models():
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
    variables = _randomize_bn(_np_tree(variables), 7)
    t_train, t_model = tconfig.args_to_config(tconfig.get_args(CLI))
    tmodel = TorchGPT.from_config(t_model, t_actions_info(t_train), device="cpu").eval()
    flax_to_torch(variables, tmodel)
    return jmodel, variables, tmodel


def _patches(seed, n=3):
    return np.random.default_rng(seed).random((n, P, P, 3)).astype(np.float32)


def _nchw(level):
    return np.asarray(level).transpose(0, 3, 1, 2)


def test_detector_matches_jax(models):
    jmodel, variables, tmodel = models
    x = _patches(1)
    want, want_fpn = jmodel.apply(variables, jnp.asarray(x), method=JaxGPT.yolox_outputs)
    calls = (tconv.dwblock_bn_silu.calls, tconv.conv3x3_bn_silu.calls)
    with torch.no_grad():
        got, got_fpn = tmodel.yolox_outputs(torch.from_numpy(x))
    # 12 stride-1 DWConvs in the PAFPN and 12 in the head; the Focus stem.
    assert tconv.dwblock_bn_silu.calls == calls[0] + 24
    assert tconv.conv3x3_bn_silu.calls == calls[1] + 1
    for lvl, (g, w) in enumerate(zip(got_fpn, want_fpn)):
        np.testing.assert_allclose(g.numpy(), _nchw(w), **TOL, err_msg=f"FPN level {lvl}")
    for name in ("raw_reg", "obj_logits", "cls_logits", "boxes", "grids", "strides"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), **TOL,
                                   err_msg=name)


def test_embedder_backbone_matches_jax(models):
    """The gpt_backbone PAFPN that embeds every rollout step."""
    jmodel, variables, tmodel = models
    x = _patches(2, n=2)
    want = jmodel.apply(variables, jnp.asarray(x),
                        method=lambda m, v: m.gpt_backbone_net(v, False))
    calls = (tconv.dwblock_bn_silu.calls, tconv.conv3x3_bn_silu.calls)
    with torch.no_grad():
        got = tmodel.gpt_backbone_net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tconv.dwblock_bn_silu.calls == calls[0] + 12
    assert tconv.conv3x3_bn_silu.calls == calls[1] + 1
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), _nchw(w), **TOL, err_msg=f"FPN level {lvl}")


def test_upstream_state_dict_loads_unchanged():
    """Megvii-named torch modules' state_dict loads strictly into the port,
    and both compute the same FPN levels and head outputs."""
    from tests.torch_yolox_ref import TorchYOLOX

    ref = TorchYOLOX(0.33, 0.25, True, num_classes=1)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
    ref.eval()
    port = NeedleYOLOX("yolox-nano", num_classes=1, device="cpu").eval()
    port.load_state_dict(ref.state_dict(), strict=True)

    x = torch.from_numpy(_patches(3, n=2)).permute(0, 3, 1, 2)
    with torch.no_grad():
        want_fpn, want_head = ref(x)
        got, got_fpn = port(x)
    for g_, w in zip(got_fpn, want_fpn):
        torch.testing.assert_close(g_, w, atol=2e-4, rtol=1e-3)
    flat = lambda t: t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, t.shape[1])
    want_reg = torch.cat([flat(r) for r, _, _ in want_head], dim=1)
    want_obj = torch.cat([flat(o) for _, o, _ in want_head], dim=1)[..., 0]
    torch.testing.assert_close(got["raw_reg"], want_reg, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(got["obj_logits"], want_obj, atol=2e-4, rtol=1e-3)


def test_train_mode_raises():
    """Train mode no longer raises: it takes PyTorch convs with batch
    statistics (never the eval-only kernel wrappers) and moves the running
    statistics; only an explicit ``autograd``/``train`` changes the route."""
    port = NeedleYOLOX("yolox-nano", device="cpu")
    x = torch.from_numpy(_patches(4, n=2)).permute(0, 3, 1, 2)
    before = port.backbone.backbone.stem.conv.bn.running_var.clone()
    calls = (tconv.dwblock_bn_silu.calls, tconv.conv3x3_bn_silu.calls)
    head, _ = port(x, train=True)
    assert (tconv.dwblock_bn_silu.calls, tconv.conv3x3_bn_silu.calls) == calls
    assert not torch.equal(port.backbone.backbone.stem.conv.bn.running_var, before)
    assert head["obj_logits"].requires_grad
    port(x, autograd=True)
    assert (tconv.dwblock_bn_silu.calls, tconv.conv3x3_bn_silu.calls) == calls
    with torch.no_grad():
        port(x)
    assert tconv.dwblock_bn_silu.calls == calls[0] + 24
