"""Language side of an entry: counterpart of ``vltk_tpu/data/langdataset.py``.

Tokenize to fixed-length int32 arrays, map answers to ids through the
shared ``answers`` table into fixed (16,) id / score arrays with one label
drawn by its soft score, and run the pretraining corruptions the config
names. Each loader thread draws from its own generator, spawned from one
``SeedSequence`` (a shared ``np.random.Generator`` is not thread-safe).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.data.tokenizer import Tokenizer, build_tokenizer
from vltk_tpu_torch.processing import lang as lang_ops


class LangHandler:
    def __init__(
        self,
        lang_config,
        metadata_ids: Optional[Mapping[str, Mapping[str, int]]] = None,
        lang_processors: Sequence[str] = (),
        seed: int = 0,
    ):
        self.config = lang_config
        self.tokenizer: Tokenizer = build_tokenizer(lang_config)
        self.metadata_ids = dict(metadata_ids or {})
        self.lang_processors = tuple(p.lower() for p in lang_processors)
        self._seed_seq = np.random.SeedSequence(seed)
        self._rng_lock = threading.Lock()
        self._tls = threading.local()
        self.max_labels = 16  # the labels capacity

    @property
    def rng(self) -> np.random.Generator:
        """This thread's generator: the next child of the seed sequence,
        spawned on the thread's first draw."""
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            with self._rng_lock:
                rng = np.random.default_rng(self._seed_seq.spawn(1)[0])
            self._tls.rng = rng
        return rng

    def answer_id(self, label: str) -> int:
        return int(self.metadata_ids.get("answers", {}).get(label, self.config.ignore_id))

    def encode_entry(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        """One text row -> fixed-shape token and label arrays."""
        out = dict(entry)
        out.update(self.tokenizer.encode(str(entry.get(V.text, ""))))
        self._attach_labels(out)
        self._run_processors(out)
        return out

    def encode_batch(self, entries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """All sentences of one image in one tokenizer call (img_first)."""
        encs = self.tokenizer.encode_batch([str(e.get(V.text, "")) for e in entries])
        outs = []
        for e, enc in zip(entries, encs):
            o = dict(e)
            o.update(enc)
            self._attach_labels(o)
            self._run_processors(o)
            outs.append(o)
        return outs

    def _attach_labels(self, out: Dict[str, Any]) -> None:
        """Answer strings and soft scores -> (max_labels,) ids and scores
        (unknown answers dropped, padded with ignore_id and 0) and one
        sampled ``label``."""
        ignore = self.config.ignore_id
        raw_labels = out.pop(V.label, None)
        raw_scores = out.pop(V.score, None)
        if raw_labels is None:
            raw_labels = out.pop(V.labels, None)
            raw_scores = out.pop(V.scores, raw_scores)
        if raw_labels is None:
            return
        if isinstance(raw_labels, str):
            raw_labels = [raw_labels]
        if raw_scores is None:
            raw_scores = [1.0] * len(raw_labels)
        ids = [self.answer_id(l) for l in raw_labels][: self.max_labels]
        scores = [float(s) for s in raw_scores][: self.max_labels]
        pairs = [(i, s) for i, s in zip(ids, scores) if i != ignore]
        ids = [i for i, _ in pairs]
        scores = [s for _, s in pairs]
        pad = self.max_labels - len(ids)
        out[V.labels] = np.asarray(ids + [ignore] * pad, np.int32)
        out[V.scores] = np.asarray(scores + [0.0] * pad, np.float32)
        out[V.label] = np.int32(lang_ops.one_hot_label(ids, scores, self.rng, ignore_id=ignore))

    def _run_processors(self, out: Dict[str, Any]) -> None:
        cfg = self.config
        if "masked_language_modeling" in self.lang_processors:
            out[V.input_ids], out["masked_labels"] = lang_ops.masked_language_modeling(
                out[V.input_ids],
                out[V.text_attention_mask],
                self.rng,
                mask_token_id=self.tokenizer.mask_id,
                vocab_size=self.tokenizer.vocab_size,
                special_ids=self.tokenizer.special_ids,
                mask_rate=cfg.mask_rate,
                mask_token_rate=cfg.mask_token_rate,
                random_token_rate=cfg.random_token_rate,
                ignore_id=cfg.ignore_id,
            )
