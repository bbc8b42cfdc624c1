"""Tokenizer facade of the port.

Counterpart of ``vltk_tpu/data/tokenizer.py`` (``Tokenizer``,
``build_tokenizer``) on the first-party C++ WordPiece, the only backend the
port has: the special-token ids, the fixed-length encode of questions, the
per-word encode of the OCR chain and ``decode``. ``build_tokenizer`` maps
the JAX package's default ``"BertWordPieceTokenizer"`` (HF ``tokenizers``,
BERT WordPiece) to the native WordPiece over the same vocabulary; other
HF ``tokenizers`` / ``transformers`` backends raise
``NotImplementedError``: neither package is part of the port's
environment.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

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
        self._tok = NativeWordPiece(self._vocab_path, lowercase=lowercase, max_seq_length=self.max_seq_length)
        self.cls_token, self.sep_token = "[CLS]", "[SEP]"
        self.pad_token, self.mask_token, self.unk_token = "[PAD]", "[MASK]", "[UNK]"
        self.cls_id = self._tok.cls_id
        self.sep_id = self._tok.sep_id
        self.pad_id = self._tok.pad_id
        self.mask_id = self._tok.mask_id
        self.unk_id = self._tok.unk_id
        self.vocab_size = self._tok.vocab_size
        self._id_to_token: Optional[List[str]] = None

    @property
    def special_ids(self) -> List[int]:
        return [self.cls_id, self.sep_id, self.pad_id, self.mask_id, self.unk_id]

    def encode(self, text: str) -> Dict[str, np.ndarray]:
        """One sentence -> fixed-length {input_ids, type_ids,
        text_attention_mask} int32 arrays."""
        return self.encode_batch([text])[0]

    def encode_batch(self, texts: Sequence[str]) -> List[Dict[str, np.ndarray]]:
        """Sentences -> one fixed-length dict each, as ``encode``."""
        enc = self._tok.encode_batch(list(texts))
        return [
            {
                V.input_ids: enc["input_ids"][i],
                V.type_ids: enc["type_ids"][i],
                V.text_attention_mask: enc["attention_mask"][i],
            }
            for i in range(len(texts))
        ]

    def encode_words(self, words: Sequence[str]) -> List[List[int]]:
        """Per-word sub-token ids, no special tokens, no padding: the
        AuxTokenize OCR path."""
        return self._tok.encode_words(list(words))

    def decode(self, ids: Sequence[int]) -> str:
        """Ids -> text: special tokens dropped, WordPiece continuations
        joined."""
        if self._id_to_token is None:
            with open(self._vocab_path) as f:
                self._id_to_token = [line.rstrip("\n") for line in f]
        special = set(self.special_ids)
        toks = [self._id_to_token[i] for i in ids if 0 <= i < len(self._id_to_token) and i not in special]
        return " ".join(toks).replace(" ##", "")


def build_tokenizer(lang_config) -> Tokenizer:
    """LangConfig -> Tokenizer. HF's ``"BertWordPieceTokenizer"`` (the
    config's default) is BERT WordPiece over the same vocabulary, so it
    builds the native one."""
    name = lang_config.tokenizer
    return Tokenizer(
        name="NativeWordPiece" if name == "BertWordPieceTokenizer" else name,
        from_transformers=lang_config.from_transformers,
        vocab_path=lang_config.vocab_path,
        lowercase=lang_config.lowercase,
        max_seq_length=lang_config.max_seq_length,
    )
