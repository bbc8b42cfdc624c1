"""Adapter registry of the port.

Counterpart of ``vltk_tpu/adapters/__init__.py``: ``Adapters.get(name)``
returns the adapter class; ``Adapters.add`` registers a user's. Ported:
``coco2014`` (``Coco2014``), ``vqa`` (``VQA``) and the extraction adapter
``frcnn`` (``FRCNN``, registered on first use: it pulls in the model
stack). The JAX package's other adapters wait for their slice; asking for
one raises ``KeyError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, List, Type

from vltk_tpu_torch.adapters.base import Adapter
from vltk_tpu_torch.adapters.coco2014 import Coco2014
from vltk_tpu_torch.adapters.extraction import VisnExtraction
from vltk_tpu_torch.adapters.visn import VisnDataset
from vltk_tpu_torch.adapters.visnlang import VisnLangDataset
from vltk_tpu_torch.adapters.vqa import VQA

# adapters of the JAX package not ported yet, and the item that ports them
UNPORTED = {
    name: "ROADMAP A.8(b)"
    for name in ("clevr", "clevrref", "cococaptions", "docvqa", "docvqavisn", "funsd", "gqa", "vgqa",
                 "visualgenome")
}


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
            if key in UNPORTED:
                raise KeyError(f"adapter {name!r} is not ported yet ({UNPORTED[key]}); available: {self.avail()}")
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
Adapters.add(Coco2014, VQA)


def register_frcnn():
    """Register the FRCNN extraction adapter (imports the model stack)."""
    from vltk_tpu_torch.adapters.frcnn import FRCNN

    Adapters.add(FRCNN)
    return FRCNN


__all__ = ["Adapter", "Adapters", "Coco2014", "VQA", "VisnDataset", "VisnExtraction", "VisnLangDataset",
           "register_frcnn"]
