"""Processor base: per-entry modality transforms.

Counterpart of ``vltk_tpu/processing/processor.py``. A processor declares
the entry ``keys`` it needs; ``__call__`` skips the entry when one is
absent, filters kwargs to the subclass ``forward`` signature and checks
that ``forward`` returns the entry dict.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from vltk_tpu_torch.inspection import collect_args_to_func


class Processor:
    _type = "processor"
    keys: Sequence[str] = ()

    @classmethod
    def name(cls) -> str:
        return getattr(cls, "_name", None) or cls.__name__.lower()

    def __init__(self, **kwargs):
        if hasattr(self, "setup"):
            self.setup(**collect_args_to_func(self.setup, kwargs))
        self._kwargs = kwargs

    def __call__(self, entry: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        for key in self.keys:
            if key not in entry:
                return entry  # contract: skip silently when inputs absent
        merged = dict(self._kwargs)
        merged.update(kwargs)
        out = self.forward(entry, **collect_args_to_func(self.forward, merged))
        if not isinstance(out, dict):
            raise TypeError(f"{type(self).__name__}.forward must return the entry dict")
        return out

    def forward(self, entry: Dict[str, Any], **kwargs) -> Dict[str, Any]:
        raise NotImplementedError


class VisnProcessor(Processor):
    _type = "visn"


class LangProcessor(Processor):
    _type = "lang"


class VisnLangProcessor(Processor):
    _type = "visnlang"
