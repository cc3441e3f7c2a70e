"""The glimpse rollout: decode, action choice and env step per step.

The counterparts of ``Trainer._rollout_scan`` (``trainer.py:484-635``), of
the batched eval rollout (``reinforce.py:509-532``) and of
``ReinforceTrainer.compute_rollout_metrics`` (``reinforce.py:545-583``).

``rollout`` is a Python loop over ``max_ep_len`` steps with fixed shapes: the
env freezes finished rows instead of the loop breaking, the step index is a
host integer, and sampling is Gumbel-max on uniforms drawn from an explicit
``torch.Generator``, so nothing in the loop waits on the card. It runs under
``torch.no_grad``: the serving path needs no gradient, and the fused conv
kernels have no backward.

Each step decodes one token against a KV cache (``GPT.decode_step``), or,
for a model with ``no_recurrent_embedding`` (``--no-recurrent-embedding``),
runs the full teacher-forced forward over the zero-padded history of all
``max_ep_len`` steps and takes the logits of the current one
(``trainer.py:516-567``): ``max_ep_len`` times the work, the same numbers,
an equivalence oracle for the cache. Causal attention makes the logits at
step t depend on tokens up to t only, so the padding is inert. Both
branches draw the same random numbers in the same order.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..env.batched_env import NeedleEnv


@torch.no_grad()
def rollout(
    model,
    env: NeedleEnv,
    sample: bool,
    generator: Optional[torch.Generator] = None,
    classes: Optional[torch.Tensor] = None,
    collect: tuple = (),
    positions=None,
) -> Dict[str, object]:
    """One batched rollout of ``env.max_ep_len`` steps.

    Args:
        sample: sample from the categorical (True) or take the argmax.
        generator: draws the reset positions (when ``positions`` is None)
            and the samples; it lives on the env's device.
        classes: ``[B]`` class-token ids (None -> zeros, as in RL).
        collect: extra per-step outputs, a subset of {"logits", "actions"}.
        positions: optional ``[B, 2]`` reset positions.

    Returns ``[B, T]`` rewards, logprobs, entropies, logit_masks; ``[B, T+1]``
    masks; ``[B, T+1, 2]`` positions; ``[B, T]`` returns; and final_state.
    """
    B = env.batch_size
    dev = env.device
    if sample and generator is None:
        raise ValueError("sampling needs a generator")
    state, patches, _ = env.reset(positions=positions, generator=generator)
    if classes is None:
        classes = torch.zeros(B, dtype=torch.long, device=dev)
    full_prefix = model.no_recurrent_embedding
    if full_prefix:
        T = env.max_ep_len
        hist_patches = patches.new_zeros((B, T) + patches.shape[2:])
        hist_actions = torch.zeros((B, T), dtype=torch.long, device=dev)
        hist_positions = state.positions.new_zeros((B, T, 2))
    else:
        cache = model.init_cache(classes)
    init_positions = state.positions
    action = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    ys = {k: [] for k in ("rewards", "logprobs", "entropies", "logit_masks", "alive",
                          "positions", *collect)}
    for t in range(env.max_ep_len):
        if full_prefix:
            hist_patches[:, t] = patches[:, 0]
            hist_actions[:, t] = action
            hist_positions[:, t] = state.positions
            logits = model(hist_patches, hist_actions, classes, hist_positions)[0][:, t]
        else:
            logits, cache = model.decode_step(cache, patches[:, 0], action, state.positions, t)
        logits = logits.float()
        if sample:
            u = torch.rand(logits.shape, generator=generator, device=dev)
            action = (logits - torch.log(-torch.log(u))).argmax(-1)
        else:
            action = logits.argmax(-1)
        logp_all = F.log_softmax(logits, dim=-1)
        ys["logprobs"].append(logp_all.gather(1, action[:, None])[:, 0])
        ys["entropies"].append(-(logp_all.exp() * logp_all).sum(-1))
        ys["logit_masks"].append(~done)
        state, patches, rewards, terminated, _, _ = env.masked_step(state, action, done)
        done = done | terminated
        ys["rewards"].append(rewards)
        ys["alive"].append(~terminated)
        ys["positions"].append(state.positions)
        if "logits" in collect:
            ys["logits"].append(logits)
        if "actions" in collect:
            ys["actions"].append(action)

    out = {k: torch.stack(v, dim=1) for k, v in ys.items()}
    logit_masks = out.pop("logit_masks").float()
    # masks[:, 0] is True at reset, then ~terminated after each step.
    out["masks"] = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=dev),
                              out.pop("alive")], dim=1)
    out["positions"] = torch.cat([init_positions[:, None], out["positions"]], dim=1)
    out["logit_masks"] = logit_masks
    out["returns"] = (out["rewards"] * logit_masks).flip(1).cumsum(1).flip(1)
    out["final_state"] = state
    return out


def eval_rollout(
    model,
    images,
    boxes,
    train_config,
    sample: bool = False,
    generator: Optional[torch.Generator] = None,
    positions=None,
    device=None,
    collect: tuple = (),
) -> Dict[str, torch.Tensor]:
    """A batched eval rollout over ``images [B, H, W, C]`` with padded
    ``boxes [B, N, 4]``: the env of ``reinforce.py:516-523`` (one glimpse
    level), ``rollout``, then the found proportions and termination.

    Runs on ``device`` (default: the GPU), where ``model`` must already be.
    """
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"the model lies on {model.device}, the rollout runs on {dev}")
    env = NeedleEnv(
        images,
        boxes,
        train_config.patch_size,
        train_config.max_seq_len,
        1,
        train_config.stop_enabled,
        device=dev,
    )
    ro = rollout(model, env, sample=sample, generator=generator, collect=collect,
                 positions=positions)
    state = ro.pop("final_state")
    ro["prop_patches_found"] = env.prop_patches_found(state)
    ro["prop_bboxes_found"] = env.prop_bboxes_found(state)
    ro["terminated"] = env.terminated(state)
    return ro


def compute_rollout_metrics(
    ro: Dict[str, np.ndarray],
    train_config,
    return_mean: float = 0.0,
    return_std: float = 1.0,
) -> Dict[str, float]:
    """Host metrics of a fetched SINGLE-episode rollout (numpy arrays).

    ``return_mean``/``return_std`` are the return-normalisation window of a
    trainer (``reinforce.py:559-561``); a fresh trainer has 0 and 1.
    """
    if np.shape(ro["rewards"])[0] != 1:
        raise ValueError(
            "compute_rollout_metrics expects a single-episode rollout;"
            f" got batch {np.shape(ro['rewards'])[0]}"
        )
    masks = ro["logit_masks"]
    returns = ro["returns"]
    if train_config.reward_norm:
        advantages = (returns - return_mean) / (return_std + 1e-8)
    else:
        advantages = returns
    msum = max(masks.sum(), 1.0)
    metrics = {}
    metrics["action_loss"] = float(-(ro["logprobs"] * advantages * masks).sum() / msum)
    metrics["entropy_loss"] = float(-(ro["entropies"] * masks).sum() / msum)
    metrics["loss"] = metrics["action_loss"] + train_config.entropy_weight * metrics["entropy_loss"]
    metrics["returns"] = float((ro["rewards"] * masks).sum(axis=1).mean())
    metrics["episode_length"] = float(masks.sum(axis=1).mean())
    metrics["prop_patches_found"] = float(ro["prop_patches_found"][0])
    metrics["prop_bbox_found"] = float(ro["prop_bboxes_found"][0])
    if train_config.stop_enabled:
        stop_used = bool(ro["terminated"][0])
        metrics["stop_used"] = float(stop_used)
        metrics["stop_misused"] = float(stop_used and metrics["prop_patches_found"] < 1)
    return metrics


def to_numpy(ro: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Fetch a rollout's tensors to the host (one synchronisation)."""
    return {k: v.cpu().numpy() for k, v in ro.items() if isinstance(v, torch.Tensor)}
