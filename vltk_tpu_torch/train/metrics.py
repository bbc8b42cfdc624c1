"""Metrics. Counterpart of ``vltk_tpu/train/metrics.py``: ``accuracy`` and
``vqa_score``."""

from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax hits."""
    return (logits.argmax(-1) == labels).float().mean()


def vqa_score(logits: torch.Tensor, target_scores: torch.Tensor) -> torch.Tensor:
    """VQA accuracy: the soft score (0.3 / 0.6 / 0.9 / 1.0) of the
    predicted answer, averaged over the batch."""
    pred = logits.argmax(-1)
    return target_scores.gather(1, pred[:, None]).mean()
