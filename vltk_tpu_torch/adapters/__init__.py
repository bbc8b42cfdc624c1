"""Adapter registry of the port.

Counterpart of ``vltk_tpu/adapters/__init__.py``: ``Adapters.get(name)``
returns the adapter class; ``Adapters.add`` registers a user's. The
JAX package's eleven: ``clevr``, ``clevrref``, ``coco2014``,
``cococaptions``, ``docvqa``, ``docvqavisn``, ``funsd``, ``gqa``,
``vgqa``, ``visualgenome``, ``vqa``; and the extraction adapter ``frcnn``
(``FRCNN``, registered on first use: it pulls in the model stack).
"""

from __future__ import annotations

from typing import Dict, List, Type

from vltk_tpu_torch.adapters.base import Adapter
from vltk_tpu_torch.adapters.clevr import CLEVR
from vltk_tpu_torch.adapters.clevrref import CLEVRREF
from vltk_tpu_torch.adapters.coco2014 import Coco2014
from vltk_tpu_torch.adapters.cococaptions import COCOCaptions
from vltk_tpu_torch.adapters.docvqa import DocVQA, DocVQAVisn
from vltk_tpu_torch.adapters.extraction import VisnExtraction
from vltk_tpu_torch.adapters.funsd import FUNSD
from vltk_tpu_torch.adapters.gqa import GQA
from vltk_tpu_torch.adapters.vgqa import VGQA
from vltk_tpu_torch.adapters.visn import VisnDataset
from vltk_tpu_torch.adapters.visnlang import VisnLangDataset
from vltk_tpu_torch.adapters.visualgenome import VisualGenome
from vltk_tpu_torch.adapters.vqa import VQA


class _AdapterRegistry:
    def __init__(self):
        self._classes: Dict[str, Type[Adapter]] = {}

    def add(self, *classes: Type[Adapter]) -> None:
        for cls in classes:
            self._classes[cls.name()] = cls

    def get(self, name: str) -> Type[Adapter]:
        key = name.lower()
        if key not in self._classes and key == "frcnn":
            register_frcnn()
        if key not in self._classes:
            raise KeyError(f"unknown adapter {name!r}; available: {self.avail()}")
        return self._classes[key]

    def __contains__(self, name: str) -> bool:
        return name.lower() in self._classes

    def avail(self) -> List[str]:
        return sorted(self._classes)

    def is_visnlang(self, name: str) -> bool:
        return issubclass(self.get(name), VisnLangDataset)

    def is_extraction(self, name: str) -> bool:
        return issubclass(self.get(name), VisnExtraction)

    def is_visn(self, name: str) -> bool:
        cls = self.get(name)
        return issubclass(cls, VisnDataset) and not issubclass(cls, VisnExtraction)


Adapters = _AdapterRegistry()
Adapters.add(CLEVR, CLEVRREF, Coco2014, COCOCaptions, DocVQA, DocVQAVisn, FUNSD, GQA, VGQA, VisualGenome, VQA)


def register_frcnn():
    """Register the FRCNN extraction adapter (imports the model stack)."""
    from vltk_tpu_torch.adapters.frcnn import FRCNN

    Adapters.add(FRCNN)
    return FRCNN


__all__ = ["Adapter", "Adapters", "CLEVR", "CLEVRREF", "COCOCaptions", "Coco2014", "DocVQA", "DocVQAVisn", "FUNSD",
           "GQA", "VGQA", "VQA", "VisnDataset", "VisnExtraction", "VisnLangDataset", "VisualGenome", "register_frcnn"]
