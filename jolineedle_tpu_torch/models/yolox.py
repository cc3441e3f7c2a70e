"""YOLOX in PyTorch: CSPDarknet backbone, PAFPN neck, decoupled head.

The counterpart of ``jolineedle_tpu/models/yolox.py``, with the module and
attribute names of upstream Megvii YOLOX (BaseConv ``conv``/``bn``, DWConv
``dconv``/``pconv``, CSPLayer ``conv1``/``conv2``/``conv3``/``m``, ...), so a
COCO state_dict loads unchanged. BatchNorm eps is 1e-3 (``yolox.py:59-64``).

Layout: activations are NCHW tensors held in ``torch.channels_last`` memory,
so the NHWC view that the fused kernels of ``ops/conv.py`` take
(``x.permute(0, 2, 3, 1)``) is free, and PyTorch's own convs, pools and
upsampling work on the same tensors. The convs run in the input's dtype (the
model's compute dtype); BatchNorm and SiLU are applied in float32.

Every ``forward`` takes two explicit flags, passed down the tree:

- ``train``: BatchNorm on batch statistics, as flax's
  ``BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)``:
  mean and biased variance (E[x^2] - E[x]^2, clipped at 0) over N, H, W in
  float32, and the running statistics updated in place with the biased
  variance (torch's own ``running_var`` update would use the unbiased one);
- ``autograd``: PyTorch convs that autograd can differentiate, with eval
  BatchNorm.

With neither, the stride-1 3x3 blocks run the eval-only fused kernels (the
serving path and the no-grad rollout). With either, every conv is a PyTorch
conv: the JAX trainer ran these convs in XLA outside any Pallas kernel, and
the kernels have no backward. The caller chooses; nothing catches a kernel's
error to switch routes.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..ops.conv import conv3x3_bn_silu, dwblock_bn_silu, fold_bn
from ..parallel.mesh import active_size, global_sum

# (depth, width, depthwise) per variant (jolineedle_tpu/models/yolox.py:24-32).
YOLOX_VARIANTS = {
    "yolox": (0.33, 0.25, True),
    "yolox-nano": (0.33, 0.25, True),
    "yolox-tiny": (0.33, 0.375, False),
    "yolox-s": (0.33, 0.50, False),
    "yolox-m": (0.67, 0.75, False),
    "yolox-l": (1.0, 1.0, False),
    "yolox-x": (1.33, 1.25, False),
}

STRIDES = (8, 16, 32)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC view (free for channels_last memory)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return y.permute(0, 3, 1, 2)


def _hwio(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> the HWIO layout of the JAX package's kernels."""
    return weight.permute(2, 3, 1, 0)


def _bn_args(bn: nn.BatchNorm2d):
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


def _chain(modules, x, train: bool, autograd: bool):
    """Apply ``modules`` in order, passing both flags to each."""
    for m in modules:
        x = m(x, train, autograd)
    return x


def batch_norm_train(bn: nn.BatchNorm2d, y: torch.Tensor) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=False)`` on NCHW ``y``, in
    float32: normalise by the batch mean and biased variance (E[y^2] -
    E[y]^2, clipped at 0, flax's fast variance) and update the running
    statistics in place, ``r = (1 - m) r + m * stat`` with torch's momentum
    ``m = 1 - 0.97`` and the biased variance (``yolox.py:59-64``).

    The statistics come from the per-channel sums of ``y`` and ``y^2``:
    inside ``parallel.mesh.data_parallel`` those are summed over the ranks
    (differentiably) and the count is the global batch's, as the JAX step's
    statistics span its mesh."""
    yf = y.float()
    c = yf.shape[1]
    sums = global_sum(torch.cat([yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))]))
    count = yf.numel() // c * active_size()
    mean = sums[:c] / count
    var = (sums[c:] / count - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean.detach(), alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var.detach(), alpha=bn.momentum)
        bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (yf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


class ConvBnAct(nn.Module):
    """Conv (no bias) + BatchNorm + SiLU (upstream ``BaseConv``).

    In eval mode without autograd a dense 3x3 stride-1 conv (``groups ==
    1``) runs as one call of ``ops.conv.conv3x3_bn_silu``, the Hopper kernel
    that replaces the Pallas ``conv3x3_bn_silu``; on yolox-nano that is only
    the Focus stem (224x224, 12 -> 16 at 448 px). Every other shape — 1x1
    convs, stride-2 downsamples, the depthwise half of a DWConv — and every
    conv under ``train`` or ``autograd`` is a PyTorch conv followed by BN
    (folded, or batch statistics) and SiLU: the JAX package left those to
    XLA outside any Pallas kernel.
    """

    def __init__(self, in_ch: int, out_ch: int, ksize: int = 1, stride: int = 1,
                 groups: int = 1):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.conv = nn.Conv2d(in_ch, out_ch, ksize, stride, (ksize - 1) // 2,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3, momentum=0.03)

    @property
    def uses_conv3x3_kernel(self) -> bool:
        return self.conv.kernel_size == (3, 3) and self.stride == 1 and self.groups == 1

    def forward(self, x: torch.Tensor, train: bool = False,
                autograd: bool = False) -> torch.Tensor:
        if self.uses_conv3x3_kernel and not (train or autograd):
            return _nchw(conv3x3_bn_silu(
                _nhwc(x), _hwio(self.conv.weight), *_bn_args(self.bn),
                eps=self.bn.eps,
            ))
        y = F.conv2d(x, self.conv.weight.to(x.dtype), None, self.conv.stride,
                     self.conv.padding, 1, self.groups)
        if train:
            y = batch_norm_train(self.bn, y)
        else:
            scale, bias = fold_bn(*_bn_args(self.bn), self.bn.eps)
            y = y.float() * scale[:, None, None] + bias[:, None, None]
        return F.silu(y).to(x.dtype)


class DWConv(nn.Module):
    """Depthwise 3x3 + pointwise 1x1, each with BN and SiLU (nano variant).

    At stride 1 the whole block runs as one call of
    ``ops.conv.dwblock_bn_silu``, the Hopper kernel that replaces the Pallas
    ``dwblock_bn_silu``: on yolox-nano at 448 px that is every Bottleneck's
    DWConv (112²·16, 56²·32, 28²·64, 14²·128) and every head conv (64
    channels at 56², 28², 14²), in eval mode without autograd. At stride 2
    (the downsamples), and under ``train`` or ``autograd``, the two halves
    are PyTorch convs, as XLA computed them outside Pallas.
    """

    def __init__(self, in_ch: int, out_ch: int, ksize: int = 3, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.dconv = ConvBnAct(in_ch, in_ch, ksize, stride, groups=in_ch)
        self.pconv = ConvBnAct(in_ch, out_ch, 1, 1)

    @property
    def uses_dwblock_kernel(self) -> bool:
        return self.stride == 1 and self.dconv.conv.kernel_size == (3, 3)

    def forward(self, x: torch.Tensor, train: bool = False,
                autograd: bool = False) -> torch.Tensor:
        if self.uses_dwblock_kernel and not (train or autograd):
            d, p = self.dconv, self.pconv
            return _nchw(dwblock_bn_silu(
                _nhwc(x), _hwio(d.conv.weight), *_bn_args(d.bn),
                _hwio(p.conv.weight), *_bn_args(p.bn), eps=d.bn.eps,
            ))
        return self.pconv(self.dconv(x, train, autograd), train, autograd)


def _base_conv(depthwise: bool):
    return DWConv if depthwise else ConvBnAct


class Bottleneck(nn.Module):
    def __init__(self, in_ch, out_ch, shortcut=True, expansion=0.5, depthwise=False):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.conv1 = ConvBnAct(in_ch, hidden, 1, 1)
        self.conv2 = _base_conv(depthwise)(hidden, out_ch, 3, 1)
        self.use_add = shortcut and in_ch == out_ch

    def forward(self, x, train=False, autograd=False):
        y = self.conv2(self.conv1(x, train, autograd), train, autograd)
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    def __init__(self, in_ch, out_ch, n=1, shortcut=True, expansion=0.5,
                 depthwise=False):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.conv1 = ConvBnAct(in_ch, hidden, 1, 1)
        self.conv2 = ConvBnAct(in_ch, hidden, 1, 1)
        self.conv3 = ConvBnAct(2 * hidden, out_ch, 1, 1)
        self.m = nn.Sequential(
            *[Bottleneck(hidden, hidden, shortcut, 1.0, depthwise) for _ in range(n)]
        )

    def forward(self, x, train=False, autograd=False):
        x1 = _chain(self.m, self.conv1(x, train, autograd), train, autograd)
        x2 = self.conv2(x, train, autograd)
        return self.conv3(torch.cat((x1, x2), dim=1), train, autograd)


class SPPBottleneck(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_sizes: Sequence[int] = (5, 9, 13)):
        super().__init__()
        hidden = in_ch // 2
        self.conv1 = ConvBnAct(in_ch, hidden, 1, 1)
        self.m = nn.ModuleList(
            [nn.MaxPool2d(k, stride=1, padding=k // 2) for k in kernel_sizes]
        )
        self.conv2 = ConvBnAct(hidden * (len(kernel_sizes) + 1), out_ch, 1, 1)

    def forward(self, x, train=False, autograd=False):
        x = self.conv1(x, train, autograd)
        return self.conv2(torch.cat([x] + [m(x) for m in self.m], dim=1), train, autograd)


class Focus(nn.Module):
    """Space-to-depth stem: [C, H, W] -> [4C, H/2, W/2] -> 3x3 conv.
    The concat order is tl, bl, tr, br (``yolox.py:166-170``)."""

    def __init__(self, in_ch, out_ch, ksize=1, stride=1):
        super().__init__()
        self.conv = ConvBnAct(in_ch * 4, out_ch, ksize, stride)

    def forward(self, x, train=False, autograd=False):
        tl = x[..., ::2, ::2]
        bl = x[..., 1::2, ::2]
        tr = x[..., ::2, 1::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat((tl, bl, tr, br), dim=1), train, autograd)


class CSPDarknet(nn.Module):
    def __init__(self, depth: float, width: float, depthwise: bool = False):
        super().__init__()
        Conv = _base_conv(depthwise)
        base_ch = int(width * 64)
        base_depth = max(round(depth * 3), 1)
        self.stem = Focus(3, base_ch, ksize=3)
        self.dark2 = nn.Sequential(
            Conv(base_ch, base_ch * 2, 3, 2),
            CSPLayer(base_ch * 2, base_ch * 2, base_depth, depthwise=depthwise),
        )
        self.dark3 = nn.Sequential(
            Conv(base_ch * 2, base_ch * 4, 3, 2),
            CSPLayer(base_ch * 4, base_ch * 4, base_depth * 3, depthwise=depthwise),
        )
        self.dark4 = nn.Sequential(
            Conv(base_ch * 4, base_ch * 8, 3, 2),
            CSPLayer(base_ch * 8, base_ch * 8, base_depth * 3, depthwise=depthwise),
        )
        self.dark5 = nn.Sequential(
            Conv(base_ch * 8, base_ch * 16, 3, 2),
            SPPBottleneck(base_ch * 16, base_ch * 16),
            CSPLayer(base_ch * 16, base_ch * 16, base_depth, shortcut=False,
                     depthwise=depthwise),
        )

    def forward(self, x, train=False, autograd=False):
        x = _chain(self.dark2, self.stem(x, train, autograd), train, autograd)
        c3 = _chain(self.dark3, x, train, autograd)
        c4 = _chain(self.dark4, c3, train, autograd)
        c5 = _chain(self.dark5, c4, train, autograd)
        return c3, c4, c5


class YOLOPAFPN(nn.Module):
    """FPN + bottom-up path aggregation over (stride 8, 16, 32) features."""

    def __init__(self, depth: float, width: float, depthwise: bool = False):
        super().__init__()
        Conv = _base_conv(depthwise)
        self.backbone = CSPDarknet(depth, width, depthwise)
        ch = [int(256 * width), int(512 * width), int(1024 * width)]
        n = max(round(3 * depth), 1)
        self.upsample = nn.Upsample(scale_factor=2, mode="nearest")
        self.lateral_conv0 = ConvBnAct(ch[2], ch[1], 1, 1)
        self.C3_p4 = CSPLayer(2 * ch[1], ch[1], n, False, depthwise=depthwise)
        self.reduce_conv1 = ConvBnAct(ch[1], ch[0], 1, 1)
        self.C3_p3 = CSPLayer(2 * ch[0], ch[0], n, False, depthwise=depthwise)
        self.bu_conv2 = Conv(ch[0], ch[0], 3, 2)
        self.C3_n3 = CSPLayer(2 * ch[0], ch[1], n, False, depthwise=depthwise)
        self.bu_conv1 = Conv(ch[1], ch[1], 3, 2)
        self.C3_n4 = CSPLayer(2 * ch[1], ch[2], n, False, depthwise=depthwise)

    def forward(self, x, train: bool = False, autograd: bool = False):
        f = dict(train=train, autograd=autograd)
        x2, x1, x0 = self.backbone(x.contiguous(memory_format=torch.channels_last), **f)
        fpn_out0 = self.lateral_conv0(x0, **f)
        f_out0 = self.C3_p4(torch.cat([self.upsample(fpn_out0), x1], 1), **f)
        fpn_out1 = self.reduce_conv1(f_out0, **f)
        pan_out2 = self.C3_p3(torch.cat([self.upsample(fpn_out1), x2], 1), **f)
        pan_out1 = self.C3_n3(torch.cat([self.bu_conv2(pan_out2, **f), fpn_out1], 1), **f)
        pan_out0 = self.C3_n4(torch.cat([self.bu_conv1(pan_out1, **f), fpn_out0], 1), **f)
        return pan_out2, pan_out1, pan_out0


def make_grids_and_strides(patch_size: int, device=None):
    """Anchor-point grid (x, y) and stride per anchor, all levels flattened."""
    grids, strides = [], []
    for s in STRIDES:
        n = patch_size // s
        yy, xx = torch.meshgrid(
            torch.arange(n, device=device), torch.arange(n, device=device),
            indexing="ij",
        )
        grids.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1))
        strides.append(torch.full((n * n,), float(s), device=device))
    return torch.cat(grids).float(), torch.cat(strides)


class YOLOXHead(nn.Module):
    """Decoupled head. Returns raw per-anchor (reg, obj, cls) plus decoded
    boxes (``yolox.py:321-339``)."""

    def __init__(self, num_classes: int = 1, width: float = 1.0, depthwise: bool = False):
        super().__init__()
        Conv = _base_conv(depthwise)
        hidden = int(256 * width)
        self.num_classes = num_classes
        self.stems = nn.ModuleList()
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        for c in (int(256 * width), int(512 * width), int(1024 * width)):
            self.stems.append(ConvBnAct(c, hidden, 1, 1))
            self.cls_convs.append(
                nn.Sequential(Conv(hidden, hidden, 3, 1), Conv(hidden, hidden, 3, 1))
            )
            self.reg_convs.append(
                nn.Sequential(Conv(hidden, hidden, 3, 1), Conv(hidden, hidden, 3, 1))
            )
            self.cls_preds.append(nn.Conv2d(hidden, num_classes, 1))
            self.reg_preds.append(nn.Conv2d(hidden, 4, 1))
            self.obj_preds.append(nn.Conv2d(hidden, 1, 1))

    def forward(self, features, train: bool = False, autograd: bool = False) -> dict:
        def pred(conv, feat):  # 1x1 conv with bias, in the compute dtype
            y = F.conv2d(feat, conv.weight.to(feat.dtype), conv.bias.to(feat.dtype))
            return y.permute(0, 2, 3, 1).reshape(feat.shape[0], -1, conv.out_channels)

        raw_regs, obj_logits, cls_logits = [], [], []
        for i, f in enumerate(features):
            x = self.stems[i](f, train, autograd)
            cls_feat = _chain(self.cls_convs[i], x, train, autograd)
            reg_feat = _chain(self.reg_convs[i], x, train, autograd)
            cls_logits.append(pred(self.cls_preds[i], cls_feat))
            raw_regs.append(pred(self.reg_preds[i], reg_feat))
            obj_logits.append(pred(self.obj_preds[i], reg_feat)[..., 0])

        raw_reg = torch.cat(raw_regs, dim=1).float()
        obj = torch.cat(obj_logits, dim=1).float()
        cls = torch.cat(cls_logits, dim=1).float()

        patch = features[0].shape[2] * STRIDES[0]
        grids, strides = make_grids_and_strides(patch, raw_reg.device)
        xy = (raw_reg[..., :2] + grids[None]) * strides[None, :, None]
        wh = torch.exp(raw_reg[..., 2:4]) * strides[None, :, None]
        return {
            "boxes": torch.cat([xy, wh], dim=-1),  # [B, A, 4] cxcywh pixels
            "obj_logits": obj,  # [B, A]
            "cls_logits": cls,  # [B, A, nc]
            "raw_reg": raw_reg,  # [B, A, 4]
            "grids": grids,  # [A, 2] (x, y)
            "strides": strides,  # [A]
        }


class NeedleYOLOX(nn.Module):
    """Backbone + head; ``forward`` returns (head_outputs, fpn_outs).

    Its parameters stay float32 on ``device`` (default: the GPU); the convs
    run in the dtype of the patches given to ``forward``.
    """

    def __init__(self, variant: str = "yolox-s", num_classes: int = 1, device=None):
        super().__init__()
        depth, width, depthwise = YOLOX_VARIANTS[variant]
        self.variant = variant
        self.backbone = YOLOPAFPN(depth, width, depthwise)
        self.head = YOLOXHead(num_classes, width, depthwise)
        self.to(resolve_device(device))

    def forward(self, patches, train: bool = False, autograd: bool = False):
        fpn_outs = self.backbone(patches, train, autograd)
        return self.head(fpn_outs, train, autograd), fpn_outs
