"""Signature-filtered keyword passing: a copy of
``vltk_tpu/inspection.py:collect_args_to_func``. Adapters' ``schema`` /
``forward`` / ``setup``, processors' ``setup`` / ``forward`` and image
transforms get exactly the keyword arguments they declare."""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Mapping


def collect_args_to_func(func: Callable, kwargs: Mapping[str, Any], mandatory: bool = False) -> Dict[str, Any]:
    """Filter ``kwargs`` down to the parameters ``func`` declares (all of
    them when it takes ``**kwargs``). With ``mandatory``, a declared
    parameter without a default that ``kwargs`` lacks raises ValueError."""
    params = inspect.signature(func).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return dict(kwargs)
    out: Dict[str, Any] = {}
    for name, param in params.items():
        if name in ("self", "cls") or param.kind is inspect.Parameter.VAR_POSITIONAL:
            continue
        if name in kwargs:
            out[name] = kwargs[name]
        elif mandatory and param.default is inspect.Parameter.empty:
            raise ValueError(
                f"{func.__qualname__} requires argument {name!r} but it was not provided; available: {sorted(kwargs)}"
            )
    return out
