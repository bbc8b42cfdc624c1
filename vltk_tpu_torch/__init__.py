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

The reference's flow::

    import vltk_tpu_torch as vltk
    vltk.Adapters.get("coco2014").extract(datadir)
    vltk.Adapters.get("vqa").extract(datadir)
    vltk.Adapters.get("frcnn").extract(datadir, dataset_name="coco2014", preset="parity_300")
    train_loader, eval_loader = vltk.build(config)  # config.data.extractor = "frcnn"

``Adapters``, ``Processors``, the adapter and processor bases, the
predictors and ``MicroBatchServer`` load on first use.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

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


def build(config):
    """One config -> (train loader, eval loader)."""
    from vltk_tpu_torch.data.builder import init_datasets

    return init_datasets(config)


# name -> (module, attribute), imported on first use
_LAZY = {
    "Adapters": ("vltk_tpu_torch.adapters", "Adapters"),
    "Processors": ("vltk_tpu_torch.processing", "Processors"),
    "VisnDataset": ("vltk_tpu_torch.adapters.visn", "VisnDataset"),
    "VisnLangDataset": ("vltk_tpu_torch.adapters.visnlang", "VisnLangDataset"),
    "VisnExtraction": ("vltk_tpu_torch.adapters.extraction", "VisnExtraction"),
    "VisnProcessor": ("vltk_tpu_torch.processing.processor", "VisnProcessor"),
    "LangProcessor": ("vltk_tpu_torch.processing.processor", "LangProcessor"),
    "VisnLangProcessor": ("vltk_tpu_torch.processing.processor", "VisnLangProcessor"),
    "VQAPredictor": ("vltk_tpu_torch.predict", "VQAPredictor"),
    "DocTokenClassifier": ("vltk_tpu_torch.predict", "DocTokenClassifier"),
    "DocSpanQA": ("vltk_tpu_torch.predict", "DocSpanQA"),
    "MicroBatchServer": ("vltk_tpu_torch.serving", "MicroBatchServer"),
    "Features": ("vltk_tpu_torch.features", "Features"),
    "Config": ("vltk_tpu_torch.config", "Config"),
    "DataConfig": ("vltk_tpu_torch.config", "DataConfig"),
    "LangConfig": ("vltk_tpu_torch.config", "LangConfig"),
    "TrainConfig": ("vltk_tpu_torch.config", "TrainConfig"),
    "VisionConfig": ("vltk_tpu_torch.config", "VisionConfig"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if name in ("adapters", "processing", "serving"):
        import importlib

        return importlib.import_module(f"vltk_tpu_torch.{name}")
    raise AttributeError(f"module 'vltk_tpu_torch' has no attribute {name!r}")


__all__ = ["build", "resolve_device"]
