"""JAX (flax) params -> the port's state dicts under reference names.

``jax_frcnn_to_torch`` is the inverse of the reference's
``torch_frcnn_to_jax``: it takes the flax param tree of the JAX package's
FRCNN (nested dicts of arrays) and returns a flat state dict of float32
tensors that ``vltk_tpu_torch.models.FRCNN`` (and the reference torch
module) loads:

  conv   kernel (kH, kW, I, O) -> weight (O, I, kH, kW)
  linear kernel (I, O)         -> weight (O, I)
  embed  embedding (V, D)      -> weight (V, D)
  frozen norm scale/bias/mean/var -> weight/bias/running_mean/running_var

The backbone and RoI-head convs sit inside a ``conv`` child in flax
(ConvNorm); the RPN head's convs are plain ``nn.Conv`` leaves.

``jax_layoutlm_to_torch`` is the inverse of the reference's
``torch_layoutlm_to_jax``: flax LayoutLM params (the bare encoder, or a
token-classification / span-QA model with its ``layoutlm`` child) -> the HF
``transformers`` LayoutLM names the port's modules carry (no pooler: the
flax model has none).
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


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


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
        out[_PREFIX[top] + name] = _tensor(arr_t)
    return out


# flax module path inside a LayoutLM layer -> HF module path
_LAYOUTLM_LAYER = {
    ("att", "query"): "attention.self.query",
    ("att", "key"): "attention.self.key",
    ("att", "value"): "attention.self.value",
    ("att", "att_out"): "attention.output.dense",
    ("att", "ln"): "attention.output.LayerNorm",
    ("ffn", "intermediate"): "intermediate.dense",
    ("ffn", "mlp_out"): "output.dense",
    ("ffn", "ln"): "output.LayerNorm",
}
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight", "embedding": "weight"}
_HEADS = ("classifier", "qa_outputs")


def _layoutlm_name(path) -> str:
    """flax path inside the encoder (``embeddings/...`` or
    ``layer_i/...``) -> HF name without the ``layoutlm.`` prefix."""
    top, *mods, leaf = path
    if top == "embeddings":
        mod = "LayerNorm" if mods == ["ln"] else ".".join(mods)
        return f"embeddings.{mod}.{_LEAF[leaf]}"
    if top.startswith("layer_") and tuple(mods) in _LAYOUTLM_LAYER:
        i = int(top[len("layer_"):])
        return f"encoder.layer.{i}.{_LAYOUTLM_LAYER[tuple(mods)]}.{_LEAF[leaf]}"
    raise KeyError(f"unexpected LayoutLM param path {'/'.join(path)}")


def jax_layoutlm_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax LayoutLM params -> the port's (HF-named) state dict of float32
    tensors. A tree with a ``layoutlm`` child (``LayoutLMForTokenClassification``
    / ``LayoutLMForSpanQA``) gives ``layoutlm.``-prefixed encoder names plus
    its ``classifier`` / ``qa_outputs`` head; a bare encoder tree gives
    unprefixed names (``LayoutLM``)."""
    headed = "layoutlm" in params
    encoder = params["layoutlm"] if headed else params
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(encoder):
        arr = np.asarray(value, dtype=np.float32)
        name = ("layoutlm." if headed else "") + _layoutlm_name(path)
        out[name] = _tensor(arr.T if path[-1] == "kernel" else arr)
    for head in _HEADS:
        if head in params:
            out[f"{head}.weight"] = _tensor(np.asarray(params[head]["kernel"]).T)
            out[f"{head}.bias"] = _tensor(params[head]["bias"])
    unknown = set(params) - {"layoutlm", *_HEADS} if headed else set()
    if unknown:
        raise KeyError(f"unexpected LayoutLM param keys {sorted(unknown)}")
    return out
