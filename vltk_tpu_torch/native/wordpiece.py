"""ctypes wrapper over the native WordPiece tokenizer (src/wordpiece.cpp).

Counterpart of ``vltk_tpu/native/wordpiece.py``: the fixed-length batch
encode of questions, the per-word encode of the OCR path and the
special-token ids, with the same C ABI.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Sequence

import numpy as np

from vltk_tpu_torch import native


class NativeWordPiece:
    """First-party C++ WordPiece encoder. Raises when the library cannot
    be built or the vocabulary cannot be read."""

    def __init__(
        self,
        vocab_path: str,
        lowercase: bool = True,
        max_seq_length: int = 128,
    ):
        self._lib = native.lib()
        self._h = self._lib.vltk_wp_new(vocab_path.encode(), int(lowercase))
        if not self._h:
            raise RuntimeError(f"failed to load vocab from {vocab_path!r}")
        self.max_seq_length = int(max_seq_length)
        self.n_threads = min(os.cpu_count() or 1, 8)

        tid = lambda t: int(self._lib.vltk_wp_token_id(self._h, t.encode()))  # noqa: E731
        self.cls_id, self.sep_id = tid("[CLS]"), tid("[SEP]")
        self.pad_id, self.mask_id, self.unk_id = tid("[PAD]"), tid("[MASK]"), tid("[UNK]")
        self.vocab_size = int(self._lib.vltk_wp_vocab_size(self._h))

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.vltk_wp_free(self._h)
            self._h = None

    def encode_batch(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        """-> {input_ids, type_ids, attention_mask}: (N, L) int32, L =
        ``max_seq_length``; [CLS] ids... [SEP], truncated so [SEP] fits."""
        n, seq = len(texts), self.max_seq_length
        ids = np.empty((n, seq), np.int32)
        mask = np.empty((n, seq), np.int32)
        type_ids = np.empty((n, seq), np.int32)
        arr = (ctypes.c_char_p * n)(*[t.encode() for t in texts])
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.vltk_wp_encode_batch(
            self._h, arr, n, seq, 1,
            ids.ctypes.data_as(i32p), mask.ctypes.data_as(i32p), type_ids.ctypes.data_as(i32p),
            self.n_threads,
        )
        return {"input_ids": ids, "type_ids": type_ids, "attention_mask": mask}

    def encode_words(self, words: Sequence[str]) -> List[List[int]]:
        """Per-word sub-token ids, no specials or padding (OCR path)."""
        n = len(words)
        if n == 0:
            return []
        arr = (ctypes.c_char_p * n)(*[w.encode() for w in words])
        lens = np.empty(n, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        cap = max(16, 8 * n)
        while True:
            flat = np.empty(cap, np.int32)
            total = int(
                self._lib.vltk_wp_encode_words(
                    self._h, arr, n, flat.ctypes.data_as(i32p), cap, lens.ctypes.data_as(i32p)
                )
            )
            if total <= cap:
                break
            cap = total
        out, pos = [], 0
        for ln in lens:
            out.append(flat[pos : pos + int(ln)].tolist())
            pos += int(ln)
        return out
