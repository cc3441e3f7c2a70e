"""The port's ``--measure-flops`` report (jolineedle_tpu_torch/utils/flops.py)
against the JAX package's (jolineedle_tpu/utils/flops.py), on the CPU.

- every number of the report (FLOPs of the backbone and YOLOX on one patch
  and on an 8P x 8P image, of the complete model at each sequence length,
  and the parameter count of each part) equals the JAX report's on the same
  config: the parameter counts exactly, the FLOPs to a relative 1e-6; the
  printed lines are the same text;
- the count runs on ``meta`` tensors: the fused conv wrappers and the flash
  wrapper take their plain versions there and launch nothing;
- ``main --measure-flops`` prints the report and returns without training:
  no checkpoint is written.

gpt-nano widths at patch 64, float32.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import jolineedle_tpu.utils.flops as jflops
from jolineedle_tpu.config import args_to_config, get_args
from jolineedle_tpu.env import get_actions_info
from jolineedle_tpu.models.gpt import GPT as JaxGPT
from jolineedle_tpu_torch import config as tconfig
from jolineedle_tpu_torch.env.actions import get_actions_info as t_actions_info
from jolineedle_tpu_torch.models.bridge import torch_to_flax
from jolineedle_tpu_torch.models.gpt import GPT as TorchGPT
from jolineedle_tpu_torch.ops import attention as kattn
from jolineedle_tpu_torch.ops import conv as kconv
from jolineedle_tpu_torch.utils.flops import measure_flops

# The suite runs in several test processes that share the cores: one PyTorch
# intra-op thread each keeps their thread pools from spinning against each other.
torch.set_num_threads(1)

P = 64
FLOP_RTOL = 1e-6


def _cli(seq_len, extra):
    return [
        "--training-mode", "reinforce", "--dataset-dir", "/nonexistent",
        "--work-dir", "/nonexistent", "--model-type", "gpt-nano",
        "--image-processor", "yolox-nano", "--decoder-pos-encoding",
        "--use-positional-embedding", "--enable-stop", "--max-seq-len", str(seq_len),
        "--patch-size", str(P), "--minimum-image-size", "0", "--batch-size", "2",
        "--dropout", "0.0", "--compute-dtype", "float32", "--devices", "0", *extra,
    ]


def _jax_report(cli, tmodel, capsys):
    """The JAX report's printed lines and its numbers in report order, for
    the weights of the port's ``tmodel`` carried over by the bridge (every
    flax leaf, so the JAX tree has the JAX model's own shapes)."""
    train_config, model_config = args_to_config(get_args(cli))
    model = JaxGPT.from_config(model_config, get_actions_info(train_config))
    variables = jax.tree_util.tree_map(jnp.asarray, torch_to_flax(tmodel.state_dict(), tmodel))
    flops = []
    counted = jflops._flops

    def record(fn, *args):
        flops.append(counted(fn, *args))
        return flops[-1]

    trainer = types.SimpleNamespace(model=model, eval_variables=lambda: variables)
    params = variables["params"]
    counts = {"backbone": jflops.count_params(params["yolox"]["backbone"]),
              "head": jflops.count_params(params["yolox"]["head"]),
              "yolox": jflops.count_params(params["yolox"]),
              "gpt": jflops.count_params({k: v for k, v in params.items() if k != "yolox"})}
    capsys.readouterr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jflops, "_flops", record)
        jflops.measure_flops(trainer, model_config, train_config)
    return capsys.readouterr().out, flops, counts


@pytest.mark.parametrize("seq_len,extra", [
    (4, ["--gpt-backbone", "yolox-nano", "--concat-embeddings"]),  # the flagship's embeddings
    (9, []),  # the detector's backbone as embedder, mean-fused tokens; seq 1-8
])
def test_report_equals_jax(seq_len, extra, capsys):
    cli = _cli(seq_len, extra)
    train_config, model_config = tconfig.args_to_config(tconfig.get_args(cli))
    model = TorchGPT.from_config(model_config, t_actions_info(train_config), device="cpu")
    want_out, want_flops, want_params = _jax_report(cli, model, capsys)
    kconv.reset_counts()
    kattn.reset_counts()
    report = measure_flops(types.SimpleNamespace(model=model), model_config, train_config)
    got_out = capsys.readouterr().out
    assert report["params"] == want_params
    seq_lens = [n for n in (1, 2, 4, 8, 16) if n <= seq_len]
    assert list(report["seq_len"]) == seq_lens
    got_flops = ([report["backbone"], report["yolox"]] + [report["seq_len"][n] for n in seq_lens]
                 + [report["backbone_image"], report["yolox_image"]])
    np.testing.assert_allclose(got_flops, want_flops, rtol=FLOP_RTOL, atol=0)
    assert got_out == want_out
    # The attention went through the flash wrapper's plain version on meta
    # tensors (one call per layer per forward), launching nothing.
    assert kattn.flash_attention.calls == model.n_layer * len(seq_lens)
    assert kattn.flash_attention.launches == 0
    assert all(fn.launches == 0 for fn in (kconv.dwblock_bn_silu, kconv.conv3x3_bn_silu))


def test_wrappers_take_their_plain_versions_on_meta_tensors():
    """A meta tensor carries shapes only: each wrapper computes its plain
    version there (the output's shape and dtype), counts the call and
    launches nothing."""
    kconv.reset_counts()
    kattn.reset_counts()
    meta = dict(device="meta")
    B, H, W, C, K = 2, 8, 8, 16, 32
    x = torch.zeros((B, H, W, C), dtype=torch.bfloat16, **meta)
    bn = lambda n: [torch.ones(n, **meta) for _ in range(4)]
    outs = [
        kconv.dwblock_bn_silu(x, torch.zeros((3, 3, 1, C), **meta), *bn(C),
                              torch.zeros((1, 1, C, K), **meta), *bn(K)),
        kconv.conv3x3_bn_silu(x, torch.zeros((3, 3, C, K), **meta), *bn(K)),
        kconv.conv3x3(x, torch.zeros((3, 3, C, K), **meta)),
    ]
    for out in outs:
        assert out.device.type == "meta" and out.shape == (B, H, W, K)
        assert out.dtype == torch.bfloat16
    q = torch.zeros((B, 3, 21, 16), **meta, requires_grad=True)
    y = kattn.flash_attention(q, q, q)
    assert y.device.type == "meta" and y.shape == q.shape
    y = kattn.FlashAttention.apply(q, q, q)  # the autograd function's forward too
    assert y.device.type == "meta" and y.shape == q.shape
    for fn in (kconv.dwblock_bn_silu, kconv.conv3x3_bn_silu, kconv.conv3x3,
               kattn.flash_attention):
        assert fn.launches == 0
    assert [fn.calls for fn in (kconv.dwblock_bn_silu, kconv.conv3x3_bn_silu, kconv.conv3x3,
                                kattn.flash_attention)] == [1, 1, 1, 1]


def test_main_measure_flops_returns_without_training(tmp_path, capsys):
    from jolineedle_tpu_torch.data.toy import generate_toy_dataset
    from jolineedle_tpu_torch.main import main

    toy = generate_toy_dataset(tmp_path / "toy", n_train=2, n_test=1, image_size=(128, 192),
                               seed=0, box_size=(12, 40))
    cli = _cli(4, ["--gpt-backbone", "yolox-nano", "--concat-embeddings", "--measure-flops",
                   "--env-name", "flops"])
    cli[cli.index("--dataset-dir") + 1] = str(toy)
    cli[cli.index("--work-dir") + 1] = str(tmp_path / "out")
    trainer = main(tconfig.get_args(cli), device="cpu")
    out = capsys.readouterr().out
    assert "Computing FLOPs for patch size = 64 and batch size = 1" in out
    assert "Seq len: 4, Complete Model FLOPs:" in out and "Yolox total FLOPs:" in out
    assert trainer.step == 0 and trainer.iter_num == 0
    assert trainer.flops_report["seq_len"][4] > 0
    assert sorted(p.name for p in (tmp_path / "out" / "flops").iterdir()) == ["config.json"]
