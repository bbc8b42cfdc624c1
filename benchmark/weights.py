"""Seeded weights, made on the device in one draw.

A spec lists (name, shape, init) with init ("normal", std) or ("const",
value). One ``randn`` over every normal entry, from a generator on the
device seeded with ``--seed``, is cut into views and scaled in place, so
the same seed gives the same weights on every call, and the program and
the reference get them from the same function.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def seeded(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2 ** 63))
    total = sum(math.prod(shape) for _, shape, (kind, _) in spec if kind == "normal")
    flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, (kind, value) in spec:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(value)
            off += n
        else:
            out[name] = torch.full(shape, float(value), device=dev)
    return out
