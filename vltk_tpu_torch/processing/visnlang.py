"""Cross-modal processors: counterpart of ``vltk_tpu/processing/visnlang.py``."""

from __future__ import annotations

import numpy as np

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.processing.processor import VisnLangProcessor


class Span(VisnLangProcessor):
    """A word-level (start, end) answer span -> sub-token ``span_start`` /
    ``span_end`` through the tokenmap (``ignore_id`` when the span starts
    past the words)."""

    keys = (V.span, V.tokenmap)

    def setup(self, max_visual_seq_length: int = 128, ignore_id: int = -100, add_visual_cls: bool = False):
        self.max_len = max_visual_seq_length
        self.ignore_id = ignore_id
        self.add_visual_cls = add_visual_cls

    def forward(self, entry, **kwargs):
        start, end = (int(x) for x in entry.pop(V.span))
        if self.add_visual_cls:
            # a CLS word was put before the words: indices shift by one
            start += 1
            end += 1
        tokenmap = np.asarray(entry[V.tokenmap])
        valid = tokenmap != self.ignore_id
        counts = np.where(valid, tokenmap, 0)
        offsets = np.concatenate(([0], np.cumsum(counts)[:-1]))
        n_words = int(valid.sum())
        if start >= n_words:
            entry["span_start"] = np.int32(self.ignore_id)
            entry["span_end"] = np.int32(self.ignore_id)
            return entry
        end = min(end, n_words - 1)
        entry["span_start"] = np.int32(min(int(offsets[start]), self.max_len - 1))
        entry["span_end"] = np.int32(min(int(offsets[end] + counts[end] - 1), self.max_len - 1))
        return entry
