"""Experiment registry of the port.

Counterpart of ``vltk_tpu/experiments/__init__.py``: ``Experiments.get(name)``
returns the class. Ported so far: ``ocr_tokens`` (``OCRTokenExperiment``);
the others wait for their slices (ROADMAP A.11-A.13).
"""

from __future__ import annotations

from typing import Dict, List

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
Experiments.add(OCRTokenExperiment)

__all__ = ["Experiments", "OCRTokenExperiment"]
