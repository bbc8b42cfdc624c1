"""Inference compositions of the port: OCR-document token labelling.

Counterpart of ``vltk_tpu/predict.py:DocTokenClassifier`` and the helpers
it uses. OCR words + pixel boxes -> per-word labels through the OCR chain
(``processing/visn.py`` ``AuxTokenize`` + ``OCRBoxFixed``) and
``LayoutLMForTokenClassification``. Requests are chunked into
``batch_size`` buckets padded to ``max_seq_length``, so every forward has
one shape; at ``max_seq_length >= 1024`` on the card every self-attention
runs the flash kernel K3.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vltk_tpu_torch import DeviceLike, resolve_device
from vltk_tpu_torch import vars as V


def _pad_to(arr: np.ndarray, batch: int) -> np.ndarray:
    """Zero-pad (or cut) the leading dim to the static request bucket."""
    arr = np.asarray(arr)
    if arr.shape[0] >= batch:
        return arr[:batch]
    return np.pad(arr, [(0, batch - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1))


def _prep_ocr_entry(aux, boxfix, doc: Dict[str, Any]) -> Dict[str, Any]:
    """{"words", "boxes", "size"?} -> OCR entry via AuxTokenize + OCRBoxFixed."""
    words = [str(w) for w in doc["words"]]
    boxes = [list(map(float, b)) for b in doc["boxes"]]
    if len(words) != len(boxes):
        raise ValueError(f"{len(words)} words vs {len(boxes)} boxes in document")
    entry: Dict[str, Any] = {V.text: words, V.tokenbox: boxes}
    if doc.get("size") is not None:
        entry[V.rawsize] = tuple(doc["size"])
    return boxfix(aux(entry))


def _load_answer_list(answers: Union[str, Sequence[str]]) -> List[str]:
    """Label vocabulary: a list of strings, or a path to a json list or
    {label: id} map whose ids are exactly 0..n-1 (one per head logit)."""
    if isinstance(answers, str):
        with open(answers) as f:
            data = json.load(f)
        if isinstance(data, dict):
            ids = sorted(int(v) for v in data.values())
            if ids != list(range(len(data))):
                raise ValueError(
                    f"label map ids must be exactly 0..{len(data) - 1} "
                    f"(one per head logit); got {ids[:8]}..."
                )
            out = [None] * len(data)
            for k, v in data.items():
                out[int(v)] = k
            return out
        return list(data)
    return list(answers)


def _check_head_width(state_dict: Mapping[str, torch.Tensor], key: str, n: int, what: str) -> None:
    """A loaded head must be as wide as the label vocabulary."""
    weight = state_dict.get(key)
    if weight is not None and weight.shape[0] != n:
        raise ValueError(
            f"{what} head is {weight.shape[0]}-wide but {n} labels were given; "
            "pass the label vocabulary the checkpoint was trained over"
        )


class DocTokenClassifier:
    """OCR documents (words + boxes) -> per-word labels via LayoutLM.

    Args:
      labels: label vocabulary (list of strings, or a json list /
        {label: id} map path).
      params: a state dict of ``LayoutLMForTokenClassification`` (the port's
        names, HF's; e.g. from ``jax_layoutlm_to_torch``); ``None`` = seeded
        random weights.
      config: ``LayoutLMConfig`` override (default LayoutLM-base, bf16);
        ``num_labels`` is auto-sized and ``max_position_embeddings`` must
        cover ``max_seq_length``.
      batch_size / max_seq_length: static request bucket and sub-token
        budget (documents are truncated).
      device: CUDA unless ``"cpu"`` is asked for.
    """

    def __init__(
        self,
        labels,
        *,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        config=None,
        batch_size: int = 4,
        max_seq_length: int = 512,
        tokenizer=None,
        device: DeviceLike = None,
    ):
        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.models.layoutlm import (
            LayoutLMConfig,
            LayoutLMForTokenClassification,
            init_weights,
        )
        from vltk_tpu_torch.processing.visn import AuxTokenize, OCRBoxFixed

        self.device = resolve_device(device)
        self.labels = _load_answer_list(labels)
        self.batch_size = int(batch_size)
        self.max_seq_length = int(max_seq_length)

        cfg = config or LayoutLMConfig(dtype="bfloat16")
        if cfg.num_labels != len(self.labels):
            cfg = dataclasses.replace(cfg, num_labels=len(self.labels))
        if cfg.max_position_embeddings < self.max_seq_length:
            raise ValueError(
                f"max_seq_length {self.max_seq_length} exceeds the position "
                f"table ({cfg.max_position_embeddings}); raise "
                "max_position_embeddings or lower max_seq_length"
            )
        self.config = cfg
        self.tokenizer = tokenizer or Tokenizer(
            name="NativeWordPiece", max_seq_length=self.max_seq_length
        )
        if self.tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({self.tokenizer.vocab_size}) exceeds "
                f"LayoutLMConfig.vocab_size ({cfg.vocab_size})"
            )
        self._aux = AuxTokenize(tokenizer=self.tokenizer, max_visual_seq_length=self.max_seq_length)
        self._boxfix = OCRBoxFixed(max_visual_seq_length=self.max_seq_length)

        model = LayoutLMForTokenClassification(cfg).eval()
        if params is None:
            init_weights(model, seed=0)
        else:
            _check_head_width(params, "classifier.weight", len(self.labels), "label")
            model.load_state_dict(params)
        self.model = model.to(self.device)

    @classmethod
    def from_pretrained(cls, checkpoint: str, labels, **kwargs) -> "DocTokenClassifier":
        """HF LayoutLM(-ForTokenClassification) state dict file ->
        predictor. The encoder loads by name (the pooler and the
        ``position_ids`` buffer are dropped), and every encoder weight must
        be there: a checkpoint that lacks one raises ``KeyError`` naming
        the missing keys, as the JAX predictor fails on a missing
        parameter. A ``classifier.*`` head is loaded too, else it stays
        random (the caller should fine-tune before trusting outputs)."""
        sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
        sd = sd.get("model", sd)
        self = cls(labels, **kwargs)
        own = self.model.state_dict()
        root = "layoutlm." if any(k.startswith("layoutlm.") for k in sd) else ""
        loaded = set()
        for key, value in sd.items():
            name = key[len(root):] if root and key.startswith(root) else key
            if name.startswith(("embeddings.", "encoder.")):
                name = "layoutlm." + name
            elif not name.startswith("classifier."):
                continue  # pooler, position_ids buffer
            if name in own:
                own[name] = value.float()
                loaded.add(name)
        missing = sorted(k for k in own if k.startswith("layoutlm.") and k not in loaded)
        if missing:
            more = f" and {len(missing) - 5} more" if len(missing) > 5 else ""
            raise KeyError(
                f"{checkpoint} lacks {len(missing)} encoder weights: {', '.join(missing[:5])}{more}"
            )
        _check_head_width(own, "classifier.weight", len(self.labels), "label")
        self.model.load_state_dict(own)
        return self

    def export_bundle(self, path: str, **kwargs) -> str:
        raise NotImplementedError("serving bundles are not ported yet (ROADMAP A.15)")

    @classmethod
    def from_bundle(cls, path: str) -> "DocTokenClassifier":
        raise NotImplementedError("serving bundles are not ported yet (ROADMAP A.15)")

    @torch.inference_mode()
    def step(self, ids: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """One forward of the bucket on the device: (B, L) ids, (B, L, 4)
        boxes, (B, L) mask -> (B, L, num_labels) float32 probabilities."""
        logits = self.model(ids, boxes, mask)
        return torch.softmax(logits.float(), dim=-1)

    def _prep(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        return _prep_ocr_entry(self._aux, self._boxfix, doc)

    def __call__(self, documents: Sequence[Dict[str, Any]]) -> List[List[Dict[str, Any]]]:
        """Each document: ``{"words": [...], "boxes": [[x0,y0,x1,y1]...],
        "size": (h, w)}`` (boxes in raw page pixels; ``size`` defaults to a
        1000x1000 page). Returns, per document, one dict per word that fit
        the token budget: ``{"word", "label", "score"}``, the label read at
        the word's first sub-token."""
        if not documents:
            return []
        entries = [self._prep(doc) for doc in documents]
        ids = np.stack([e[V.text] for e in entries]).astype(np.int64)
        boxes = np.stack([e[V.tokenbox] for e in entries]).astype(np.int64)
        mask = np.stack([e[V.visual_attention_mask] for e in entries]).astype(np.float32)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(_pad_to(a, self.batch_size)).to(self.device)

        results: List[List[Dict[str, Any]]] = []
        n = len(documents)
        for lo in range(0, n, self.batch_size):
            hi = min(lo + self.batch_size, n)
            probs = self.step(put(ids[lo:hi]), put(boxes[lo:hi]), put(mask[lo:hi])).cpu().numpy()
            for j in range(hi - lo):
                tokenmap = np.asarray(entries[lo + j][V.tokenmap])
                counts = tokenmap[tokenmap > 0]
                starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
                words = [str(w) for w in documents[lo + j]["words"]]
                per_word = []
                budget = self.max_seq_length - 1  # last slot is [SEP]
                for word, start in zip(words, starts):
                    if start >= budget:
                        break  # truncated past the token budget
                    p = probs[j, int(start)]
                    lab = int(np.argmax(p))
                    per_word.append({"word": word, "label": self.labels[lab], "score": float(p[lab])})
                results.append(per_word)
        return results
