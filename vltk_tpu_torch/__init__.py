"""PyTorch / CUDA port of vltk-tpu.

A second package beside ``vltk_tpu`` (the JAX reference). It mirrors the
reference layout (``ops/``, ``models/``, ``adapters/``) so each module's
counterpart is found by name, and it imports nothing of ``vltk_tpu`` or
JAX: what it needs from the reference's host-side code it keeps as its own
copy.

Public tensors keep the reference's layouts so the two packages compare
like with like: images and feature maps NHWC, boxes xyxy (N, P, 4).
Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request they raise instead of falling back.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only
    when asked for. Raises when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vltk_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain CPU path"
        )
    return dev


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch state dict file, unwrapped when a training checkpoint keeps
    it under ``"model"``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    inner = sd.get("model") if isinstance(sd, Mapping) else None
    return dict(inner if isinstance(inner, Mapping) else sd)


__all__ = ["read_state_dict", "resolve_device"]
