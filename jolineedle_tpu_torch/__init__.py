"""JoliNeedle in PyTorch and CUDA for an NVIDIA H100.

The counterpart of ``jolineedle_tpu`` (JAX on a TPU), module for module: a
small GPT decoder walks a grid of image patches and a YOLOX detector runs on
the patches it visited. This package holds the serving path (glimpse rollout,
detection on visited patches, postprocess, metrics; ``infer.py``) and both
training modes (``main.py``: ``train/supervised.py``, ``train/reinforce.py``). The kernels that
the JAX package wrote in Pallas are hand-written CUDA kernels for Hopper
(``ops/conv.py``, ``ops/attention.py``, sources under ``csrc/``).

The package imports no JAX and nothing of ``jolineedle_tpu``: the numpy-only
modules it needs are copies. Its entry points run on the CUDA device unless
the caller passes ``device="cpu"``; with no device given and no GPU present
they raise instead of continuing on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA (with its index) unless the
    caller names one.

    Raises when the card is asked for (explicitly, or by passing no device)
    and no CUDA device is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "jolineedle_tpu_torch runs on a CUDA device and none is present;"
                " pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:  # "cuda" -> "cuda:<current>", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
