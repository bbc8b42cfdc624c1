"""JAX (flax) FRCNN params -> the port's state dict under reference names.

The inverse of the reference's ``torch_frcnn_to_jax``: it takes the flax
param tree of the JAX package's FRCNN (nested dicts of arrays) and returns
a flat state dict of float32 tensors that ``vltk_tpu_torch.models.FRCNN``
(and the reference torch module) loads:

  conv   kernel (kH, kW, I, O) -> weight (O, I, kH, kW)
  linear kernel (I, O)         -> weight (O, I)
  embed  embedding (V, D)      -> weight (V, D)
  frozen norm scale/bias/mean/var -> weight/bias/running_mean/running_var

The backbone and RoI-head convs sit inside a ``conv`` child in flax
(ConvNorm); the RPN head's convs are plain ``nn.Conv`` leaves.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_PREFIX = {
    "backbone": "backbone.",
    "rpn_head": "proposal_generator.rpn_head.",
    "roi_heads": "roi_heads.",
}

_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def jax_frcnn_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax FRCNN ``params`` -> reference-named torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        top, *mods, leaf = path
        if top not in _PREFIX:
            raise KeyError(f"unexpected FRCNN param path {'/'.join(path)}")
        arr = np.asarray(value, dtype=np.float32)
        if mods and mods[-1] == "norm":
            name, arr_t = ".".join(mods + [_NORM_LEAF[leaf]]), arr
        elif leaf == "kernel" and arr.ndim == 4:
            if top != "rpn_head" and mods and mods[-1] == "conv":
                mods = mods[:-1]  # ConvNorm's inner nn.Conv
            name, arr_t = ".".join(mods + ["weight"]), arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            name, arr_t = ".".join(mods + ["weight"]), arr.T
        elif leaf == "embedding":
            name, arr_t = ".".join(mods + ["weight"]), arr
        elif leaf == "bias":
            name, arr_t = ".".join(mods + ["bias"]), arr
        else:
            raise KeyError(f"unexpected FRCNN param leaf {'/'.join(path)}")
        out[_PREFIX[top] + name] = torch.from_numpy(np.array(arr_t, order="C"))
    return out
