"""Experiment registry of the port.

Counterpart of ``vltk_tpu/experiments/__init__.py``: ``Experiments.get(name)``
returns the class. Every experiment of the JAX package is ported: ``data``
(``DataExperiment``), ``docvqa_span`` (``DocVQASpanExperiment``),
``frcnn_detect`` (``FRCNNDetectExperiment``), ``lxmert_pretrain``
(``LxmertPretrainExperiment``), ``lxmert_vqa`` (``LxmertVQAExperiment``) and
``ocr_tokens`` (``OCRTokenExperiment``).
"""

from __future__ import annotations

from typing import Dict, List

from vltk_tpu_torch.experiments.data import DataExperiment
from vltk_tpu_torch.experiments.docvqa_span import DocVQASpanExperiment
from vltk_tpu_torch.experiments.frcnn_detect import FRCNNDetectExperiment
from vltk_tpu_torch.experiments.lxmert_pretrain import LxmertPretrainExperiment
from vltk_tpu_torch.experiments.lxmert_vqa import LxmertVQAExperiment
from vltk_tpu_torch.experiments.ocr_tokens import OCRTokenExperiment


class _ExperimentRegistry:
    def __init__(self):
        self._classes: Dict[str, type] = {}

    def add(self, *classes: type) -> None:
        for cls in classes:
            self._classes[cls.name.lower()] = cls

    def get(self, name: str) -> type:
        key = name.lower()
        if key not in self._classes:
            raise KeyError(f"unknown experiment {name!r}; available: {self.avail()}")
        return self._classes[key]

    def avail(self) -> List[str]:
        return sorted(self._classes)


Experiments = _ExperimentRegistry()
Experiments.add(
    DataExperiment, DocVQASpanExperiment, FRCNNDetectExperiment, LxmertPretrainExperiment, LxmertVQAExperiment,
    OCRTokenExperiment,
)

__all__ = [
    "DataExperiment",
    "DocVQASpanExperiment",
    "Experiments",
    "FRCNNDetectExperiment",
    "LxmertPretrainExperiment",
    "LxmertVQAExperiment",
    "OCRTokenExperiment",
]
