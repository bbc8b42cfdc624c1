"""Metrics. Counterpart of ``vltk_tpu/train/metrics.py:accuracy``."""

from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax hits."""
    return (logits.argmax(-1) == labels).float().mean()
