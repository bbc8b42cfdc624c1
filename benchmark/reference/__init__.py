"""Plain PyTorch references the cells are held against, and what they share:
the float32 mode they run in and the int8 round trip of their controls.
Nothing here imports the program."""

from __future__ import annotations

import torch


def reference_mode():
    """float32 products without TF32, for the reference; returns a thunk
    that puts the settings back."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return restore


def fake_int8(x: torch.Tensor, per_channel: bool) -> torch.Tensor:
    """Symmetric int8 round trip, round half to even: one scale for the
    tensor, or (``per_channel``) one for each slice along the first axis,
    as an int8 path scales activations and output channels of weights;
    straight-through gradient."""
    a = x.detach().abs()
    m = a.amax(dim=tuple(range(1, x.dim())), keepdim=True) if per_channel else a.amax()
    s = torch.where(m > 0, m / 127.0, torch.ones_like(m))
    q = torch.clamp(torch.round(x.detach() / s), -127, 127) * s
    return x + (q - x).detach()
