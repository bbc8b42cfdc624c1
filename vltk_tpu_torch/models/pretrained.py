"""Checkpoint resolution and loading (``from_pretrained``) of the port.

Counterpart of ``vltk_tpu/models/pretrained.py``:

* a local file, or a directory holding the first of ``_WEIGHT_NAMES``;
  a hub id goes through ``huggingface_hub`` and raises
  ``FileNotFoundError`` when it is missing or offline;
* torch ``.bin/.pt/.pth`` files (loaded on the CPU, weights only) and
  detectron ``.pkl`` pickles (``{"model": {name: ndarray}}``, latin1);
* the gamma/beta -> weight/bias rewrite of the reference FRCNN's names.

The JAX package converts the names into flax trees. The port's modules
keep the reference torch names, so here a checkpoint loads by name: into
``FRCNN`` (the reference names), ``LxmertForVQA`` or ``Lxmert``,
``LayoutLMForTokenClassification``, ``LayoutLMForSpanQA`` or ``LayoutLM``,
``VisualBertForClassification`` or ``VisualBert``, and ``ViT`` (HF names),
the headed class where the checkpoint has its head. Every weight of the
module must be there: a missing one raises ``KeyError`` naming it.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from vltk_tpu_torch import DeviceLike, resolve_device

_WEIGHT_NAMES = (
    "pytorch_model.bin",
    "model.pt",
    "model.pth",
    "model.pkl",
    "weights.pkl",
)

ARCHS = ("frcnn", "layoutlm", "lxmert", "visualbert", "vit")


def resolve_checkpoint(name_or_path: str, cache_dir: Optional[str] = None) -> str:
    """-> a local file: the file itself, the first known weight file of a
    directory, or a hub repo id's file (needs ``huggingface_hub`` and the
    network)."""
    if os.path.isfile(name_or_path):
        return name_or_path
    if os.path.isdir(name_or_path):
        for fname in _WEIGHT_NAMES:
            cand = os.path.join(name_or_path, fname)
            if os.path.isfile(cand):
                return cand
        raise FileNotFoundError(f"no known weight file in {name_or_path!r} (looked for {_WEIGHT_NAMES})")
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as exc:
        raise FileNotFoundError(
            f"{name_or_path!r} is not a local file/dir and huggingface_hub is unavailable"
        ) from exc
    last_exc: Optional[Exception] = None
    for fname in _WEIGHT_NAMES:
        try:
            return hf_hub_download(name_or_path, fname, cache_dir=cache_dir)
        except Exception as exc:  # noqa: BLE001 - try the next file name
            last_exc = exc
    raise FileNotFoundError(f"could not resolve {name_or_path!r} from the hub") from last_exc


def _rewrite_gamma_beta(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """gamma/beta -> weight/bias in every key."""
    out = {}
    for key, value in state_dict.items():
        new = key
        if "gamma" in new:
            new = new.replace("gamma", "weight")
        if "beta" in new:
            new = new.replace("beta", "bias")
        out[new] = value
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch or detectron-pkl checkpoint -> a flat dict of CPU tensors
    (the dtypes of the file), gamma/beta renamed. A training checkpoint's
    ``"state_dict"`` or ``"model"`` entry is unwrapped."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        model = data.get("model", data)
        sd = {
            k: torch.from_numpy(np.array(v)) for k, v in model.items()
            if isinstance(v, np.ndarray) or np.isscalar(v)
        }
    else:
        data = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("state_dict", "model"):
            if isinstance(data, Mapping) and isinstance(data.get(key), Mapping):
                data = data[key]
        sd = {k: torch.as_tensor(v) for k, v in data.items()}
    return _rewrite_gamma_beta(sd)


def _load_by_name(make, sd: Mapping[str, torch.Tensor], rename, required: str, path: str,
                  what: str) -> Dict[str, torch.Tensor]:
    """A checkpoint's tensors under the names of ``make()``'s state dict,
    float32. ``rename`` maps a checkpoint key to the model's name; keys
    the model does not have are skipped. Every name that starts with
    ``required`` must be there, else ``KeyError`` naming the first five
    missing and their count: the JAX package fails on a missing
    parameter."""
    with torch.device("meta"):
        names = set(make().state_dict())
    out = {}
    for key, value in sd.items():
        name = rename(key)
        if name in names:
            out[name] = value.float()
    missing = sorted(k for k in names if k.startswith(required) and k not in out)
    if missing:
        more = f" and {len(missing) - 5} more" if len(missing) > 5 else ""
        raise KeyError(f"{path} lacks {len(missing)} {what} weights: {', '.join(missing[:5])}{more}")
    return out


def _materialise(make, params: Optional[Mapping[str, torch.Tensor]], init, seed: int, device) -> torch.nn.Module:
    """``make()`` in eval mode on ``device``: with ``params`` (the model's
    own names, loaded strictly), or seeded random weights when None. A
    model that loads is built without weights first, so no random draws
    are spent on what the load overwrites."""
    if params is None:
        return init(make(), seed=seed).eval().to(device)
    with torch.device("meta"):
        model = make().eval()
    model.to_empty(device=device)
    model.load_state_dict(params)
    return model


def _renamer(sd: Mapping[str, Any], ckpt_root: str, model_root: str) -> Callable[[str], str]:
    """Checkpoint key -> model name: the checkpoint's root prefix (HF's
    ``lxmert.`` etc., or none for a bare encoder) swapped for the model's;
    head keys outside the root stay as they are."""
    has_root = any(k.startswith(ckpt_root) for k in sd)

    def rename(key: str) -> str:
        if has_root:
            return model_root + key[len(ckpt_root):] if key.startswith(ckpt_root) else key
        return model_root + key

    return rename


def _head_width(sd: Mapping[str, torch.Tensor], key: str) -> Optional[int]:
    return int(sd[key].shape[0]) if key in sd else None


def _frcnn(sd, config):
    from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig

    cfg = config or FRCNNConfig.vg_extraction()
    sd = {k: v for k, v in sd.items() if "anchor_generator" not in k and "num_batches_tracked" not in k}
    return (lambda: FRCNN(cfg)), sd, str


def _lxmert(sd, config):
    import dataclasses

    from vltk_tpu_torch.models.lxmert import Lxmert, LxmertConfig, LxmertForVQA

    cfg = config or LxmertConfig()
    width = _head_width(sd, "answer_head.logit_fc.3.weight")
    if width is None:
        return (lambda: Lxmert(cfg)), sd, _renamer(sd, "lxmert.", "")
    if cfg.num_answers != width:
        cfg = dataclasses.replace(cfg, num_answers=width)
    return (lambda: LxmertForVQA(cfg)), sd, _renamer(sd, "lxmert.", "lxmert.")


def _layoutlm(sd, config):
    import dataclasses

    from vltk_tpu_torch.models.layoutlm import (
        LayoutLM,
        LayoutLMConfig,
        LayoutLMForSpanQA,
        LayoutLMForTokenClassification,
    )

    cfg = config or LayoutLMConfig()
    width = _head_width(sd, "classifier.weight")
    if width is not None:
        if cfg.num_labels != width:
            cfg = dataclasses.replace(cfg, num_labels=width)
        return (lambda: LayoutLMForTokenClassification(cfg)), sd, _renamer(sd, "layoutlm.", "layoutlm.")
    if "qa_outputs.weight" in sd:
        return (lambda: LayoutLMForSpanQA(cfg)), sd, _renamer(sd, "layoutlm.", "layoutlm.")
    return (lambda: LayoutLM(cfg)), sd, _renamer(sd, "layoutlm.", "")


def _visualbert(sd, config):
    import dataclasses

    from vltk_tpu_torch.models.visualbert import VisualBert, VisualBertConfig, VisualBertForClassification

    cfg = config or VisualBertConfig()
    width = _head_width(sd, "cls.weight")
    if width is None:
        return (lambda: VisualBert(cfg)), sd, _renamer(sd, "visual_bert.", "")
    if cfg.num_labels != width:
        cfg = dataclasses.replace(cfg, num_labels=width)
    return (lambda: VisualBertForClassification(cfg)), sd, _renamer(sd, "visual_bert.", "visual_bert.")


def _vit(sd, config):
    from vltk_tpu_torch.models.vit import ViT, ViTConfig

    cfg = config or ViTConfig()
    return (lambda: ViT(cfg)), sd, _renamer(sd, "vit.", "")


_BUILDERS = {"frcnn": _frcnn, "layoutlm": _layoutlm, "lxmert": _lxmert, "visualbert": _visualbert, "vit": _vit}


def pretrained_state_dict(arch: str, name_or_path: str, cache_dir: Optional[str] = None, *, config=None):
    """(make, state dict under the module's names): what ``from_pretrained``
    loads, without building the module. ``make()`` builds the module of
    the checkpoint's kind (the headed class where its head is there, the
    head sized to it)."""
    if arch not in _BUILDERS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {sorted(_BUILDERS)}")
    path = resolve_checkpoint(name_or_path, cache_dir)
    make, sd, rename = _BUILDERS[arch](load_state_dict(path), config)
    return make, _load_by_name(make, sd, rename, "", path, arch)


def from_pretrained(
    arch: str,
    name_or_path: str,
    cache_dir: Optional[str] = None,
    *,
    config=None,
    device: DeviceLike = None,
) -> torch.nn.Module:
    """Resolve, load and build: the port's module for ``arch`` ("frcnn":
    the reference FRCNN, default geometry ``FRCNNConfig.vg_extraction()``;
    "lxmert", "layoutlm", "visualbert", "vit": the HF families) with the
    checkpoint's weights, in eval mode on ``device`` (CUDA unless "cpu" is
    asked for). ``config`` overrides the architecture (default the base
    size); a head's width follows the checkpoint."""
    dev = resolve_device(device)
    make, params = pretrained_state_dict(arch, name_or_path, cache_dir, config=config)
    return _materialise(make, params, None, 0, dev)
