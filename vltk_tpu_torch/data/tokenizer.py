"""Tokenizer facade of the port.

Counterpart of ``vltk_tpu/data/tokenizer.py:Tokenizer`` for the
``NativeWordPiece`` backend (the first-party C++ WordPiece), which is all
the document path uses: the special-token ids and the per-word encode of
the OCR chain. The HF ``tokenizers`` / ``transformers`` backends raise
``NotImplementedError``: neither package is part of the port's
environment.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from vltk_tpu_torch import vars as V


class Tokenizer:
    def __init__(
        self,
        name: str = "NativeWordPiece",
        from_transformers: bool = False,
        vocab_path: Optional[str] = None,
        lowercase: bool = True,
        max_seq_length: int = 128,
    ):
        if name != "NativeWordPiece" or from_transformers:
            raise NotImplementedError(
                f"tokenizer {name!r} (from_transformers={from_transformers}): the port "
                "ships only the native WordPiece; pass name='NativeWordPiece'"
            )
        from vltk_tpu_torch.native.wordpiece import NativeWordPiece

        self.name = name
        self.lowercase = bool(lowercase)
        self.max_seq_length = int(max_seq_length)
        self._vocab_path = vocab_path or V.VOCABPATH
        self._tok = NativeWordPiece(self._vocab_path, lowercase=lowercase)
        self.cls_token, self.sep_token = "[CLS]", "[SEP]"
        self.pad_token, self.mask_token, self.unk_token = "[PAD]", "[MASK]", "[UNK]"
        self.cls_id = self._tok.cls_id
        self.sep_id = self._tok.sep_id
        self.pad_id = self._tok.pad_id
        self.mask_id = self._tok.mask_id
        self.unk_id = self._tok.unk_id
        self.vocab_size = self._tok.vocab_size

    def encode_words(self, words: Sequence[str]) -> List[List[int]]:
        """Per-word sub-token ids, no special tokens, no padding: the
        AuxTokenize OCR path."""
        return self._tok.encode_words(list(words))
