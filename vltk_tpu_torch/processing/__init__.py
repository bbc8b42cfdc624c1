"""Processors and the host image pipeline of the port.

Counterpart of ``vltk_tpu/processing/__init__.py``: the ``Processors``
registry (``Processors.get(name)`` -> class: the mask, OCR and box
processors of ``visn.py``, ``Span`` of ``visnlang.py``) and
``build_image_pipeline``, which composes the image transforms a
``VisionConfig`` names, each given the config fields its constructor
declares.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Type

from vltk_tpu_torch.inspection import collect_args_to_func
from vltk_tpu_torch.processing import image as image_mod
from vltk_tpu_torch.processing.processor import LangProcessor, Processor, VisnLangProcessor, VisnProcessor
from vltk_tpu_torch.processing.visn import (
    AuxTokenize,
    OCRBox,
    OCRBoxFixed,
    PolygonProcessor,
    RemoveBox,
    RLEProcessor,
    TokenLabels,
    XYWHtoXYXY,
)
from vltk_tpu_torch.processing.visnlang import Span


class _ProcessorRegistry:
    def __init__(self):
        self._classes: Dict[str, Type[Processor]] = {}

    def add(self, *classes: Type[Processor]) -> None:
        for cls in classes:
            self._classes[cls.name()] = cls

    def get(self, name: str) -> Type[Processor]:
        key = name.lower()
        if key not in self._classes:
            raise KeyError(f"unknown processor {name!r}; available: {self.avail()}")
        return self._classes[key]

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._classes

    def avail(self) -> List[str]:
        return sorted(self._classes)


Processors = _ProcessorRegistry()
Processors.add(AuxTokenize, OCRBox, OCRBoxFixed, PolygonProcessor, RemoveBox, RLEProcessor, Span, TokenLabels,
               XYWHtoXYXY)

_IMAGE_TRANSFORMS: Dict[str, Callable] = {
    "fromfile": image_mod.FromFile,
    "totensor": image_mod.ToTensor,
    "topilimage": image_mod.ToTensor,
    "resize": image_mod.ResizeTensor,
    "resizetensor": image_mod.ResizeTensor,
    "normalize": image_mod.Normalize,
    "pad": image_mod.Pad,
    "grayscale": image_mod.GrayScale,
    "randfeats": image_mod.RandFeats,
}


def build_image_pipeline(config) -> Callable[[Any], Dict[str, Any]]:
    """VisionConfig (or its dict) -> one callable, filepath or entry ->
    processed entry. Unless the device owns resize and pad
    (``device_fused``), the pipeline ends on the fixed canvas
    (``canvas_for(size)`` unless given)."""
    cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config)
    if cfg.get("canvas") is None:
        cfg["canvas"] = image_mod.canvas_for(cfg.get("size", (800, 1333)))
    stages = []
    for name in cfg.get("transforms", ()):
        cls = _IMAGE_TRANSFORMS.get(str(name).lower())
        if cls is None:
            raise KeyError(f"unknown image transform {name!r}; available: {sorted(_IMAGE_TRANSFORMS)}")
        stages.append(cls(**collect_args_to_func(cls.__init__, cfg)))
    if not any(isinstance(s, image_mod.Pad) for s in stages) and not cfg.get("device_fused", False):
        stages.append(image_mod.Pad(canvas=cfg["canvas"], pad_value=cfg.get("pad_value", 0.0)))

    def pipeline(entry):
        for stage in stages:
            entry = stage(entry)
        return entry

    pipeline.stages = stages
    return pipeline


__all__ = ["LangProcessor", "Processor", "Processors", "VisnLangProcessor", "VisnProcessor", "build_image_pipeline"]
