"""Processor base: per-entry modality transforms.

Counterpart of ``vltk_tpu/processing/processor.py``. A processor declares
the entry ``keys`` it needs; ``__call__`` skips the entry when one is
absent, filters kwargs to the subclass ``forward`` signature and checks
that ``forward`` returns the entry dict.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Mapping, Sequence


def collect_args_to_func(func: Callable, kwargs: Mapping[str, Any]) -> Dict[str, Any]:
    """Filter ``kwargs`` down to the parameters ``func`` declares (all of
    them when it takes ``**kwargs``); a copy of
    ``vltk_tpu/inspection.py:collect_args_to_func``."""
    params = inspect.signature(func).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return dict(kwargs)
    skip = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    return {
        name: kwargs[name]
        for name, p in params.items()
        if name not in ("self", "cls") and p.kind not in skip and name in kwargs
    }


class Processor:
    _type = "processor"
    keys: Sequence[str] = ()

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
