"""Experiment registry of the port.

Counterpart of ``vltk_tpu/experiments/__init__.py``: ``Experiments.get(name)``
returns the class. Ported: ``data`` (``DataExperiment``), ``docvqa_span``
(``DocVQASpanExperiment``),
``lxmert_pretrain`` (``LxmertPretrainExperiment``), ``lxmert_vqa``
(``LxmertVQAExperiment``) and ``ocr_tokens`` (``OCRTokenExperiment``). The
JAX package's ``frcnn_detect`` waits for its slice; asking for it raises
``KeyError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, List

from vltk_tpu_torch.experiments.data import DataExperiment
from vltk_tpu_torch.experiments.docvqa_span import DocVQASpanExperiment
from vltk_tpu_torch.experiments.lxmert_pretrain import LxmertPretrainExperiment
from vltk_tpu_torch.experiments.lxmert_vqa import LxmertVQAExperiment
from vltk_tpu_torch.experiments.ocr_tokens import OCRTokenExperiment

# experiments of the JAX package not ported yet, and the item that ports each
UNPORTED = {"frcnn_detect": "ROADMAP A.12"}


class _ExperimentRegistry:
    def __init__(self):
        self._classes: Dict[str, type] = {}

    def add(self, *classes: type) -> None:
        for cls in classes:
            self._classes[cls.name.lower()] = cls

    def get(self, name: str) -> type:
        key = name.lower()
        if key in UNPORTED:
            raise KeyError(f"experiment {name!r} is not ported yet ({UNPORTED[key]}); available: {self.avail()}")
        if key not in self._classes:
            raise KeyError(f"unknown experiment {name!r}; available: {self.avail()}")
        return self._classes[key]

    def avail(self) -> List[str]:
        return sorted(self._classes)


Experiments = _ExperimentRegistry()
Experiments.add(DataExperiment, DocVQASpanExperiment, LxmertPretrainExperiment, LxmertVQAExperiment, OCRTokenExperiment)

__all__ = [
    "DataExperiment",
    "DocVQASpanExperiment",
    "Experiments",
    "LxmertPretrainExperiment",
    "LxmertVQAExperiment",
    "OCRTokenExperiment",
]
