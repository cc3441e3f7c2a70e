"""GPT-style causal decision decoder with fused multi-modal token embeddings.

The counterpart of ``jolineedle_tpu/models/gpt.py``: the input token fuses
the action token, the sequence position, the patch embedding (YOLOX FPN top
level -> 1x1 conv -> ReLU -> flatten -> Dense) and the 2D grid position; a
class token is prepended and its logit dropped. ``init_cache`` /
``decode_step`` run one token at a time against a KV cache.

Numerics follow the JAX module: parameters are float32; the convs, the
attention and the block Dense layers run in the compute dtype; LayerNorm
(eps 1e-6) and everything from the patch-embedding flatten up to the token
fusion are float32; GELU is the tanh approximation; attention masks with
-1e30 and takes its softmax in float32. Dense kernels ``[in, out]`` of the
JAX package are ``nn.Linear`` weights ``[out, in]`` here (see
``models/bridge.py``).

The teacher-forced ``forward`` attends through ``ops.attention.
causal_attention``: the flash kernel on the card. ``train=True`` turns on
dropout (drawn from an explicit ``torch.Generator``, flax's keep-and-rescale)
and batch-statistics BatchNorm in the embedder. The YOLOX convs take the
fused eval kernels only when neither ``train`` nor autograd needs them
(``models/yolox.py``): the no-grad rollout runs the kernels, a forward that
is differentiated runs PyTorch convs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device
from ..ops.attention import NEG_INF, causal_attention
from .init import init_like_flax
from .positional import positional_encoding_1d, positional_encoding_2d
from .yolox import YOLOPAFPN, YOLOX_VARIANTS, NeedleYOLOX

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Dense layer computed in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.LayerNorm()``: float32 result, eps 1e-6."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class CausalSelfAttention(nn.Module):
    def __init__(self, n_head: int, n_embd: int, dtype: torch.dtype):
        super().__init__()
        self.n_head, self.dtype = n_head, dtype
        self.c_attn = nn.Linear(n_embd, 3 * n_embd)
        self.c_proj = nn.Linear(n_embd, n_embd)

    def forward(self, x, cache: Optional[dict] = None, cache_index: Optional[int] = None,
                drop=None):
        B, T, C = x.shape
        hd = C // self.n_head
        q, k, v = _dense(self.c_attn, x, self.dtype).split(C, dim=-1)
        q = q.reshape(B, T, self.n_head, hd)
        k = k.reshape(B, T, self.n_head, hd)
        v = v.reshape(B, T, self.n_head, hd)
        if cache is None:
            y = causal_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            ).transpose(1, 2)
        else:
            # Single-token decode (T == 1). The cache is a preallocated
            # [B, S, H, hd] tensor per layer, written in place at
            # cache_index (the JAX module returns a new array instead).
            if T != 1:
                raise ValueError(f"decode takes one token at a time, got T={T}")
            ck, cv = cache["k"], cache["v"]
            ck[:, cache_index] = k[:, 0]
            cv[:, cache_index] = v[:, 0]
            att = torch.einsum("bqhd,bkhd->bhqk", q, ck) / torch.tensor(
                math.sqrt(hd), dtype=q.dtype, device=q.device
            )
            visible = torch.arange(ck.shape[1], device=x.device) <= cache_index
            att = att.masked_fill(~visible, NEG_INF)
            att = torch.softmax(att.float(), dim=-1).to(q.dtype)
            y = torch.einsum("bhqk,bkhd->bqhd", att, cv)
        y = _dense(self.c_proj, y.reshape(B, T, C), self.dtype)
        return y if drop is None else drop(y)


class Block(nn.Module):
    """Pre-LN transformer block (``gpt.py:98-124``)."""

    def __init__(self, n_head: int, n_embd: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(n_embd, eps=1e-6)
        self.attn = CausalSelfAttention(n_head, n_embd, dtype)
        self.ln_2 = nn.LayerNorm(n_embd, eps=1e-6)
        self.c_fc = nn.Linear(n_embd, 4 * n_embd)
        self.c_proj = nn.Linear(4 * n_embd, n_embd)

    def forward(self, x, cache=None, cache_index=None, drop=None):
        x = x + self.attn(_layer_norm(self.ln_1, x), cache, cache_index, drop)
        h = _dense(self.c_fc, _layer_norm(self.ln_2, x), self.dtype)
        h = _dense(self.c_proj, F.gelu(h, approximate="tanh"), self.dtype)
        return x + (h if drop is None else drop(h))


class ActionHead(nn.Module):
    """Bias-free linear head (``gpt.py:127-135``)."""

    def __init__(self, n_embd: int, n_actions: int):
        super().__init__()
        self.dense = nn.Linear(n_embd, n_actions, bias=False)

    def forward(self, x):
        return self.dense(x)


class GPT(nn.Module):
    """Decision decoder + embedded YOLOX detector (``gpt.py:138-402``).

    Construct with :meth:`from_config` from a model config. Parameters are
    drawn as the JAX package's modules draw them (``models/init.py``),
    float32 on ``device`` (default: the GPU; ``device="cpu"`` runs the plain
    PyTorch versions of the kernels).
    """

    token_offset = 1  # class-conditional token

    def __init__(
        self,
        n_layer: int,
        n_head: int,
        n_embd: int,
        block_size: int,
        n_actions: int,
        patch_size: int,
        n_channels: int,
        image_processor: str,
        gpt_backbone: Optional[str],
        use_pos_emb: bool,
        no_patch_emb: bool,
        concat_emb: bool,
        decoder_pos_encoding: bool,
        pos_emb_size: int,
        dropout: float = 0.0,
        detector_conf_threshold: float = 0.5,
        compute_dtype: torch.dtype = torch.float32,
        no_recurrent_embedding: bool = False,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.n_layer, self.n_head, self.n_embd = n_layer, n_head, n_embd
        self.block_size, self.n_actions = block_size, n_actions
        self.patch_size, self.n_channels = patch_size, n_channels
        self.gpt_backbone = gpt_backbone
        self.use_pos_emb, self.no_patch_emb = use_pos_emb, no_patch_emb
        self.concat_emb = concat_emb
        self.dropout = float(dropout)
        self.decoder_pos_encoding = decoder_pos_encoding
        self.detector_conf_threshold = detector_conf_threshold
        self.compute_dtype = compute_dtype
        #: The rollout runs the full forward over the whole history every
        #: step instead of the KV-cache decode (``train/rollout.py``).
        self.no_recurrent_embedding = no_recurrent_embedding

        self.wte = nn.Embedding(n_actions, n_embd)
        if not decoder_pos_encoding:
            self.wpe = nn.Embedding(pos_emb_size, n_embd)
        self.embed_class = nn.Embedding(100, n_embd)

        self.yolox = NeedleYOLOX(image_processor, num_classes=1, device="cpu")
        if gpt_backbone:
            depth, width, depthwise = YOLOX_VARIANTS[gpt_backbone]
            self.gpt_backbone_net = YOLOPAFPN(depth, width, depthwise)
            top_width = width
        else:
            top_width = YOLOX_VARIANTS[image_processor][1]

        if not no_patch_emb:
            top = patch_size // 32
            self.embed_fpn_conv = nn.Conv2d(int(1024 * top_width), n_embd, 1, bias=False)
            self.embed_fpn_dense = nn.Linear(top * top * n_embd, n_embd)

        if concat_emb:
            n_embeddings = 2 + (not no_patch_emb) + use_pos_emb
            self.project_concat = nn.Linear(n_embeddings * n_embd, n_embd)

        self.h = nn.ModuleList(
            [Block(n_head, n_embd, compute_dtype) for _ in range(n_layer)]
        )
        self.ln_f = nn.LayerNorm(n_embd, eps=1e-6)
        self.action_head = ActionHead(n_embd, n_actions)
        init_like_flax(self, n_layer)
        self.to(device)

    @classmethod
    def from_config(cls, model_config, actions_info, compute_dtype=None, device=None):
        dtype = DTYPES[compute_dtype or getattr(model_config, "compute_dtype", "float32")]
        return cls(
            n_layer=model_config.n_layer,
            n_head=model_config.n_head,
            n_embd=model_config.n_embd,
            block_size=model_config.block_size,
            n_actions=actions_info[0].nclasses,
            patch_size=model_config.patch_size,
            n_channels=model_config.n_channels,
            image_processor=model_config.image_processor,
            gpt_backbone=model_config.gpt_backbone,
            use_pos_emb=model_config.use_pos_emb,
            no_patch_emb=model_config.no_patch_emb,
            concat_emb=model_config.concat_emb,
            decoder_pos_encoding=model_config.decoder_pos_encoding,
            pos_emb_size=model_config.pos_emb_size,
            dropout=model_config.dropout,
            detector_conf_threshold=model_config.detector_conf_threshold,
            compute_dtype=dtype,
            no_recurrent_embedding=getattr(model_config, "no_recurrent_embedding", False),
            device=device,
        )

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    # --- embedding fusion ---------------------------------------------------
    def _to_compute(self, patches: torch.Tensor) -> torch.Tensor:
        """NHWC patches (uint8 or float in [0, 1]) -> NCHW compute dtype."""
        if patches.dtype == torch.uint8:
            patches = patches.float() / 255.0
        return patches.to(self.compute_dtype).permute(0, 3, 1, 2)

    def embed_patches(self, patches: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, T, P, P, C] -> [B, T, D] via the backbone's FPN top level
        (``gpt.py:246-267``). With a shared detector (no ``gpt_backbone``)
        the gradient stops at the FPN, so the decision loss never reaches
        the detector; a ``gpt_backbone`` embedder is trained by it."""
        B, T = patches.shape[:2]
        flat = self._to_compute(patches.reshape((B * T,) + patches.shape[2:]))
        autograd = train or torch.is_grad_enabled()
        if self.gpt_backbone:
            top = self.gpt_backbone_net(flat, train, autograd)[-1]
        else:
            top = self.yolox.backbone(flat, train, autograd)[-1].detach()
        x = F.conv2d(top, self.embed_fpn_conv.weight.to(top.dtype))
        x = F.relu(x)
        # The JAX module flattens NHWC: permute before flattening, or the
        # bridged embed_fpn_dense weight would not match.
        x = x.permute(0, 2, 3, 1).reshape(B * T, -1).float()
        return self.embed_fpn_dense(x).reshape(B, T, self.n_embd)

    def embed_token_positions(self, seq_positions: torch.Tensor) -> torch.Tensor:
        if self.decoder_pos_encoding:
            return positional_encoding_1d(seq_positions, self.n_embd)
        return self.wpe(seq_positions)

    def _fuse_tokens(self, actions, seq_positions, patches, positions, train=False):
        """Concat order: wte, seq-pos, patch, grid-pos (``gpt.py:281-297``)."""
        embeddings = [self.wte(actions), self.embed_token_positions(seq_positions)]
        if not self.no_patch_emb:
            embeddings.append(self.embed_patches(patches, train))
        if self.use_pos_emb:
            embeddings.append(positional_encoding_2d(positions, self.n_embd))
        if self.concat_emb:
            return self.project_concat(torch.cat(embeddings, dim=-1))
        return torch.stack(embeddings, dim=2).mean(dim=2)

    # --- full (teacher-forced) forward ---------------------------------------
    def _dropout(self, train: bool, generator: Optional[torch.Generator]):
        """flax ``nn.Dropout``: keep with probability 1 - p and rescale by
        1 / (1 - p); None where it is the identity."""
        if not train or self.dropout == 0.0:
            return None
        if generator is None:
            raise ValueError("train=True with dropout > 0 needs a torch.Generator")
        keep = 1.0 - self.dropout

        def drop(x):
            mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
            return torch.where(mask, x / keep, torch.zeros_like(x))

        return drop

    def forward(self, patches, actions, classes, positions=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """Returns (action_logits [B, T, n_actions], final embeddings).

        ``train`` turns on dropout (drawn from ``generator``) and
        batch-statistics BatchNorm in the embedder (``gpt.py:300-326``)."""
        B, T = actions.shape
        if T > self.block_size:
            raise ValueError(f"seq len {T} > block size {self.block_size}")
        drop = self._dropout(train, generator)
        seq_positions = torch.arange(T, device=actions.device).expand(B, T)
        tokens = self._fuse_tokens(actions, seq_positions, patches, positions, train)
        x = torch.cat([self.embed_class(classes)[:, None, :], tokens], dim=1)
        if drop is not None:
            x = drop(x)
        x = x.to(self.compute_dtype)
        for block in self.h:
            x = block(x, drop=drop)
        x = _layer_norm(self.ln_f, x)
        logits = self.action_head(x)
        return logits[:, self.token_offset :], x

    # --- incremental decode ---------------------------------------------------
    def empty_cache(self, batch_size: int) -> dict:
        s = self.block_size + self.token_offset
        hd = self.n_embd // self.n_head
        shape = (batch_size, s, self.n_head, hd)
        kw = dict(dtype=self.compute_dtype, device=self.device)
        return {
            "layers": [
                {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}
                for _ in range(self.n_layer)
            ],
            "index": 0,
        }

    def _decode_token(self, x: torch.Tensor, cache: dict):
        """Run one [B, 1, D] token through the stack, writing the cache in
        place at ``cache["index"]`` (a host integer: no device sync)."""
        idx = cache["index"]
        x = x.to(self.compute_dtype)
        for block, layer_cache in zip(self.h, cache["layers"]):
            x = block(x, layer_cache, idx)
        logits = self.action_head(_layer_norm(self.ln_f, x))[:, 0]
        cache["index"] = idx + 1
        return logits, cache

    def init_cache(self, classes: torch.Tensor) -> dict:
        """Process the class-conditional token into a fresh KV cache."""
        cache = self.empty_cache(classes.shape[0])
        _, cache = self._decode_token(self.embed_class(classes)[:, None, :], cache)
        return cache

    def decode_step(self, cache: dict, patch, action, position, step: int):
        """One rollout step: embed the newest token only, attend via cache.

        patch [B, P, P, C]; action [B]; position [B, 2] or None; step is the
        0-based action-token index."""
        B = action.shape[0]
        seq_positions = torch.full((B, 1), step, dtype=torch.long, device=action.device)
        tokens = self._fuse_tokens(
            action[:, None],
            seq_positions,
            None if self.no_patch_emb else patch[:, None],
            None if position is None else position[:, None],
        )
        return self._decode_token(tokens, cache)

    # --- detector -------------------------------------------------------------
    def yolox_outputs(self, patches: torch.Tensor, train: bool = False):
        """Raw YOLOX head outputs and FPN levels on [B, P, P, C] patches.
        ``train``: batch-statistics BatchNorm (the detection loss of a train
        step); the fused kernels run only with neither ``train`` nor grad."""
        autograd = train or torch.is_grad_enabled()
        return self.yolox(self._to_compute(patches), train, autograd)
