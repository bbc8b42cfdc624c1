"""Inference compositions of the port: composed VQA, OCR-document token
labelling and document span QA.

Counterpart of ``vltk_tpu/predict.py:VQAPredictor``, ``DocTokenClassifier``
and ``DocSpanQA`` and the helpers they use.

``VQAPredictor``: images + questions -> ranked answers. Each bucket of
``batch_size`` (image, question) pairs runs preprocess -> FRCNN -> box
normalisation -> ``LxmertForVQA`` -> sigmoid on the device (on the card the
FRCNN runs the RoIPool kernel K1 once and the greedy-NMS kernel K2 twice a
bucket); questions are tokenized, images decoded and padded onto the raw
canvas, and answers ranked on the host.

``DocTokenClassifier``: OCR words + pixel boxes -> per-word labels through
the OCR chain (``processing/visn.py`` ``AuxTokenize`` + ``OCRBoxFixed``) and
``LayoutLMForTokenClassification``. Requests are chunked into
``batch_size`` buckets padded to ``max_seq_length``, so every forward has
one shape; at ``max_seq_length >= 1024`` on the card every self-attention
runs the flash kernel K3.

``DocSpanQA``: a document and a question -> the answer span, read back as
words. One LayoutLM stream of ``[question sub-tokens | OCR sub-tokens]``
(the layout ``experiments/docvqa_span.py`` trains on), so the question's
pad sits in the middle of the stream; at ``question_len + doc_len >= 1024``
on the card every self-attention runs K3 on that mask. The span decode
(``_best_span``) is host numpy over the float32 log-probabilities.

Serving bundles (``export_bundle`` / ``from_bundle``, ``aot.py``): the
predictor's step traced with ``torch.export``, the weights (and an int8
preset's calibrated scales) its state, the kernels registered ops; a
bundled predictor keeps the host side and runs the loaded program as its
step, on the device it was exported on.

int8 presets (an int8 ``FRCNNConfig``, ``LxmertConfig(int8=True)``,
``LayoutLMConfig(int8=True)``): each predictor calibrates its static int8
scales once, under a lock, on the first request, as the JAX predictors do
(``VQAPredictor.calibrate_int8``, ``_maybe_calibrate_doc_int8``), keeps them in
``frcnn_scales`` / ``lxmert_scales`` / ``int8_scales`` and reuses them for
every later request.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vltk_tpu_torch import DeviceLike, resolve_device
from vltk_tpu_torch import vars as V
from vltk_tpu_torch.models.pretrained import _load_by_name, _materialise, load_state_dict, resolve_checkpoint

ImageLike = Union[str, np.ndarray]


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


def _tokenizer_bundle_parts(tok):
    """(meta dict, vocab bytes) of a tokenizer, for a serving bundle."""
    with open(tok._vocab_path, "rb") as f:
        vocab = f.read()
    meta = {"name": tok.name, "lowercase": bool(tok.lowercase), "max_seq_length": int(tok.max_seq_length)}
    return meta, vocab


def _tokenizer_from_bundle(meta: Dict[str, Any], vocab: bytes):
    """-> (Tokenizer, TemporaryDirectory) from a bundle's tokenizer meta and
    vocab. Keep the directory alive as long as the tokenizer: it reads the
    vocab file again to decode."""
    import tempfile

    from vltk_tpu_torch.data.tokenizer import Tokenizer

    tmpdir = tempfile.TemporaryDirectory(prefix="vltk_aot_")
    path = os.path.join(tmpdir.name, "vocab.txt")
    with open(path, "wb") as f:
        f.write(vocab)
    tok = Tokenizer(
        name=meta["name"], vocab_path=path, lowercase=bool(meta.get("lowercase", True)),
        max_seq_length=int(meta["max_seq_length"]),
    )
    return tok, tmpdir


def _check_bundle_kind(path: str, meta: Dict[str, Any], want: str) -> None:
    if meta.get("kind") != want:
        raise ValueError(f"{path}: bundle kind {meta.get('kind')!r} is not a {want} export")


def _export_step_bundle(obj, path: str, *, kind: str, example_args, extra_meta: Dict[str, Any], platforms) -> str:
    """The two document predictors' export: ``obj._step`` traced with
    ``obj.model`` held (its weights and any calibrated int8 scales are the
    program's state), bundled with the tokenizer vocab and the geometry."""
    from vltk_tpu_torch.aot import export_step, save_bundle

    step = export_step(obj._step, example_args, modules={"model": obj.model}, platforms=platforms)
    tmeta, vocab = _tokenizer_bundle_parts(obj.tokenizer)
    meta = {"kind": kind, "batch_size": obj.batch_size, "tokenizer": tmeta, **extra_meta}
    return save_bundle(path, {"step": step}, meta=meta, files={"vocab.txt": vocab})


def _load_step_bundle(obj, path: str, kind: str, device: DeviceLike) -> Dict[str, Any]:
    """The two document predictors' restore: the tokenizer from the shipped
    vocab, the loaded program standing in for ``_step`` (the weights are
    its state). Returns the manifest meta for the class's geometry."""
    from vltk_tpu_torch.aot import bundle_manifest, load_bundle

    _check_bundle_kind(path, bundle_manifest(path)["meta"], kind)
    obj.device = resolve_device(device)
    bundle = load_bundle(path, obj.device)
    obj.batch_size = int(bundle.meta["batch_size"])
    obj.tokenizer, obj._vocab_dir = _tokenizer_from_bundle(bundle.meta["tokenizer"], bundle.files["vocab.txt"])
    obj.model = None  # the weights are the program's state
    obj.config = None
    obj.int8_scales = None  # any int8 scales are too
    obj._step = bundle.fns["step"]
    obj.platforms = bundle.platforms
    return bundle.meta


def _check_head_width(state_dict: Mapping[str, torch.Tensor], key: str, n: int, what: str) -> None:
    """A loaded head must be as wide as the label vocabulary."""
    weight = state_dict.get(key)
    if weight is not None and weight.shape[0] != n:
        raise ValueError(
            f"{what} head is {weight.shape[0]}-wide but {n} labels were given; "
            "pass the label vocabulary the checkpoint was trained over"
        )


def _layoutlm_params(make, checkpoint: str, head: str, init_weights) -> Dict[str, torch.Tensor]:
    """An HF LayoutLM(-For...) state dict file -> ``make()``'s state dict:
    the encoder by name (the pooler and the ``position_ids`` buffer
    dropped), every encoder weight required (the C.4 rule); the task head
    ``head`` loaded when the file has it, else seeded (``init_weights``,
    seed 0)."""
    sd = load_state_dict(resolve_checkpoint(checkpoint))
    root = "layoutlm." if any(k.startswith("layoutlm.") for k in sd) else ""

    def rename(key: str) -> str:
        name = key[len(root):] if root and key.startswith(root) else key
        return "layoutlm." + name if name.startswith(("embeddings.", "encoder.")) else name

    params = _load_by_name(make, sd, rename, "layoutlm.", checkpoint, "encoder")
    if not all(f"{head}.{leaf}" in params for leaf in ("weight", "bias")):
        params = {**init_weights(make(), seed=0).state_dict(), **params}
    return params


def _doc_config(config, num_labels: int):
    """LayoutLM-base in bf16 unless given, its head sized to the labels."""
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig

    cfg = config or LayoutLMConfig(dtype="bfloat16")
    return cfg if cfg.num_labels == num_labels else dataclasses.replace(cfg, num_labels=num_labels)


def _vqa_configs(frcnn_config, lxmert_config, num_answers: int):
    """The VG parity FRCNN and LXMERT-base in bf16 unless given; the answer
    head is sized to the answers and ``visual_feat_dim`` to the FRCNN's
    ``res2_out_channels * 8``."""
    from vltk_tpu_torch.models.frcnn import FRCNNConfig
    from vltk_tpu_torch.models.lxmert import LxmertConfig

    fcfg = frcnn_config or FRCNNConfig.vg_extraction()
    lcfg = lxmert_config or LxmertConfig(dtype="bfloat16")
    if lcfg.num_answers != num_answers:
        lcfg = dataclasses.replace(lcfg, num_answers=num_answers)
    if lcfg.visual_feat_dim != fcfg.res2_out_channels * 8:
        lcfg = dataclasses.replace(lcfg, visual_feat_dim=fcfg.res2_out_channels * 8)
    return fcfg, lcfg


def _maybe_calibrate_doc_int8(obj, ids: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor) -> None:
    """LayoutLM int8 (``config.int8``): static scales of the encoder's
    ``Int8Linear`` layers from the first at most 4 documents of the first
    (padded) bucket, once, under the predictor's lock (JAX's
    ``_maybe_calibrate_doc_int8``). A loaded bundle (no config) carries its
    scales in its program."""
    if obj.config is None or not obj.config.int8 or obj.int8_scales is not None:
        return
    from vltk_tpu_torch.models.layers import calibrate_int8_scales

    with obj._calib_lock:
        if obj.int8_scales is None:
            obj.int8_scales = calibrate_int8_scales(obj.model, [(ids[:4], boxes[:4], mask[:4])])


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
        from vltk_tpu_torch.models.layoutlm import LayoutLMForTokenClassification, init_weights
        from vltk_tpu_torch.processing.visn import AuxTokenize, OCRBoxFixed

        self.device = resolve_device(device)
        self.labels = _load_answer_list(labels)
        self.batch_size = int(batch_size)
        self.max_seq_length = int(max_seq_length)

        cfg = _doc_config(config, len(self.labels))
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

        if params is not None:
            _check_head_width(params, "classifier.weight", len(self.labels), "label")
        self.model = _materialise(lambda: LayoutLMForTokenClassification(cfg), params, init_weights, 0, self.device)
        self.int8_scales = None  # int8: set on the first request
        self._calib_lock = threading.Lock()

    @classmethod
    def from_pretrained(cls, checkpoint: str, labels, **kwargs) -> "DocTokenClassifier":
        """HF LayoutLM(-ForTokenClassification) state dict file ->
        predictor. The encoder loads by name (the pooler and the
        ``position_ids`` buffer are dropped), and every encoder weight must
        be there: a checkpoint that lacks one raises ``KeyError`` naming
        the missing keys, as the JAX predictor fails on a missing
        parameter. A ``classifier.*`` head is loaded too, else it stays
        random (the caller should fine-tune before trusting outputs)."""
        from vltk_tpu_torch.models.layoutlm import LayoutLMForTokenClassification, init_weights

        cfg = _doc_config(kwargs.get("config"), len(_load_answer_list(labels)))
        params = _layoutlm_params(lambda: LayoutLMForTokenClassification(cfg), checkpoint, "classifier", init_weights)
        return cls(labels, params=params, **kwargs)

    def export_bundle(self, path: str, *, platforms: Optional[Sequence[str]] = None) -> str:
        """One serving file: the step traced with the weights (and, after a
        request, the int8 preset's calibrated scales) as its state, plus
        the vocab, the labels and the geometry (``aot.py``)."""
        b, seq = self.batch_size, self.max_seq_length
        dev = self.device
        return _export_step_bundle(
            self, path, kind="doc_token_classifier",
            example_args=(torch.zeros((b, seq), dtype=torch.int64, device=dev),
                          torch.zeros((b, seq, 4), dtype=torch.int64, device=dev),
                          torch.zeros((b, seq), device=dev)),
            extra_meta={"labels": list(self.labels), "max_seq_length": seq}, platforms=platforms,
        )

    @classmethod
    def from_bundle(cls, path: str, device: DeviceLike = None) -> "DocTokenClassifier":
        """Serve from an ``export_bundle`` file on ``device`` (CUDA unless
        "cpu" is asked for; it must be the device the bundle was exported
        on): no model is built, the loaded program is the step."""
        return _BundledDocTokenClassifier(path, device)

    def _step(self, ids: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        logits = self.model(ids, boxes, mask)
        return torch.softmax(logits.float(), dim=-1)

    @torch.inference_mode()
    def step(self, ids: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """One forward of the bucket on the device: (B, L) ids, (B, L, 4)
        boxes, (B, L) mask -> (B, L, num_labels) float32 probabilities."""
        return self._step(ids, boxes, mask)

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
            chunk = (put(ids[lo:hi]), put(boxes[lo:hi]), put(mask[lo:hi]))
            _maybe_calibrate_doc_int8(self, *chunk)
            probs = self.step(*chunk).cpu().numpy()
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


def _best_span(start_scores: np.ndarray, end_scores: np.ndarray, lo: int, hi: int, max_span: int = 32):
    """The highest-scoring pair start <= end < start + max_span within
    [lo, hi): (start, end, start + end score). Host numpy, as in the JAX
    package: the same pair matrix and ``np.argmax``, so a tie goes to the
    first pair in row-major order."""
    s = np.asarray(start_scores[lo:hi], np.float32)
    e = np.asarray(end_scores[lo:hi], np.float32)
    n = s.shape[0]
    if n == 0:
        return lo, lo, 0.0
    pair = s[:, None] + e[None, :]
    keep = np.triu(np.ones((n, n), bool)) & ~np.triu(np.ones((n, n), bool), k=max_span)
    pair = np.where(keep, pair, -np.inf)
    idx = int(np.argmax(pair))
    si, ei = divmod(idx, n)
    return lo + si, lo + ei, float(pair[si, ei])


def _subtoken_word_index(tokenmap: np.ndarray, budget: int) -> np.ndarray:
    """(budget,) int32: the word index of each sub-token position, -1 past
    the real tokens, from AuxTokenize's per-word sub-token counts."""
    counts = tokenmap[tokenmap > 0]
    out = np.full((budget,), -1, np.int32)
    pos = 0
    for w, c in enumerate(counts):
        for _ in range(int(c)):
            if pos >= budget:
                return out
            out[pos] = w
            pos += 1
    return out


def _span_config(config, seq: int):
    """LayoutLM-base in bf16 unless given; its position table must cover
    ``seq``."""
    from vltk_tpu_torch.models.layoutlm import LayoutLMConfig

    cfg = config or LayoutLMConfig(dtype="bfloat16")
    if cfg.max_position_embeddings < seq:
        raise ValueError(f"question_len + doc_len = {seq} exceeds the position table ({cfg.max_position_embeddings})")
    return cfg


class DocSpanQA:
    """DocVQA extractive QA: document (words + boxes) + question -> the
    answer span, read back as words.

    Args:
      params: a state dict of ``LayoutLMForSpanQA`` (HF names, e.g. from
        ``jax_layoutlm_to_torch``); ``None`` = seeded random weights.
      config: ``LayoutLMConfig`` override (default LayoutLM-base, bf16);
        ``max_position_embeddings`` must cover ``question_len + doc_len``.
      batch_size: static request bucket; inputs are padded up to it.
      question_len / doc_len: static sub-token budgets of the question
        (the tokenizer's ``max_seq_length`` must equal it) and of the
        document (truncated; its last slot is [SEP]).
      max_span: the longest answer, in sub-tokens.
      device: CUDA unless ``"cpu"`` is asked for.
    """

    def __init__(
        self,
        *,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        config=None,
        batch_size: int = 4,
        question_len: int = 20,
        doc_len: int = 128,
        max_span: int = 32,
        tokenizer=None,
        device: DeviceLike = None,
    ):
        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.models.layoutlm import LayoutLMForSpanQA, init_weights
        from vltk_tpu_torch.processing.visn import AuxTokenize, OCRBoxFixed

        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.q_len = int(question_len)
        self.doc_len = int(doc_len)
        self.max_span = int(max_span)
        cfg = _span_config(config, self.q_len + self.doc_len)
        self.config = cfg
        self.tokenizer = tokenizer or Tokenizer(name="NativeWordPiece", max_seq_length=self.q_len)
        if self.tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({self.tokenizer.vocab_size}) exceeds "
                f"LayoutLMConfig.vocab_size ({cfg.vocab_size})"
            )
        if self.tokenizer.max_seq_length != self.q_len:
            raise ValueError(
                f"tokenizer.max_seq_length ({self.tokenizer.max_seq_length}) must equal question_len ({self.q_len})"
            )
        self._aux = AuxTokenize(tokenizer=self.tokenizer, max_visual_seq_length=self.doc_len)
        self._boxfix = OCRBoxFixed(max_visual_seq_length=self.doc_len)
        self.model = _materialise(lambda: LayoutLMForSpanQA(cfg), params, init_weights, 0, self.device)
        self.int8_scales = None  # int8: set on the first request
        self._calib_lock = threading.Lock()

    @classmethod
    def from_pretrained(cls, checkpoint: str, **kwargs) -> "DocSpanQA":
        """HF LayoutLM(-ForQuestionAnswering) state dict file -> predictor.
        The encoder loads by name (the pooler and the ``position_ids``
        buffer are dropped), and every encoder weight must be there: a
        checkpoint that lacks one raises ``KeyError`` naming the missing
        keys, as the JAX predictor fails on a missing parameter. A
        ``qa_outputs.*`` span head is loaded too, else it stays random
        (fine-tune before trusting outputs)."""
        from vltk_tpu_torch.models.layoutlm import LayoutLMForSpanQA, init_weights

        seq = int(kwargs.get("question_len", 20)) + int(kwargs.get("doc_len", 128))
        cfg = _span_config(kwargs.get("config"), seq)
        params = _layoutlm_params(lambda: LayoutLMForSpanQA(cfg), checkpoint, "qa_outputs", init_weights)
        return cls(params=params, **kwargs)

    def export_bundle(self, path: str, *, platforms: Optional[Sequence[str]] = None) -> str:
        """One serving file: the span step traced with the weights (and,
        after a request, the int8 preset's calibrated scales) as its
        state, plus the vocab and the stream's geometry (``aot.py``)."""
        b, seq = self.batch_size, self.q_len + self.doc_len
        dev = self.device
        return _export_step_bundle(
            self, path, kind="doc_span_qa",
            example_args=(torch.zeros((b, seq), dtype=torch.int64, device=dev),
                          torch.zeros((b, seq, 4), dtype=torch.int64, device=dev),
                          torch.zeros((b, seq), device=dev)),
            extra_meta={"question_len": self.q_len, "doc_len": self.doc_len, "max_span": self.max_span},
            platforms=platforms,
        )

    @classmethod
    def from_bundle(cls, path: str, device: DeviceLike = None) -> "DocSpanQA":
        """Serve from an ``export_bundle`` file on ``device`` (CUDA unless
        "cpu" is asked for; the bundle's own device)."""
        return _BundledDocSpanQA(path, device)

    def _step(self, ids: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor):
        start, end = self.model(ids, boxes, mask)
        return torch.log_softmax(start.float(), dim=-1), torch.log_softmax(end.float(), dim=-1)

    @torch.inference_mode()
    def step(self, ids: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor):
        """One forward of the bucket on the device: (B, L) ids, (B, L, 4)
        boxes, (B, L) mask -> float32 log-softmax of the start and end
        logits, (B, L) each."""
        return self._step(ids, boxes, mask)

    def prepare(self, documents: Sequence[Dict[str, Any]], questions: Sequence[str]):
        """Host prep of every pair: (ids, boxes, mask) of the concatenated
        stream (n, question_len + doc_len), the OCR mask, and per pair the
        sub-token -> word map and the words."""
        n = len(documents)
        budget = self.doc_len - 1  # AuxTokenize keeps the last slot for [SEP]
        entries = [_prep_ocr_entry(self._aux, self._boxfix, doc) for doc in documents]
        word_maps = [_subtoken_word_index(np.asarray(e[V.tokenmap]), budget) for e in entries]
        word_lists = [[str(w) for w in doc["words"]] for doc in documents]

        q_enc = self.tokenizer.encode_batch([str(q) for q in questions])
        q_ids = np.stack([e[V.input_ids] for e in q_enc]).astype(np.int64)
        q_mask = np.stack([e[V.text_attention_mask] for e in q_enc]).astype(np.int32)
        d_ids = np.stack([e[V.text] for e in entries]).astype(np.int64)
        d_boxes = np.stack([e[V.tokenbox] for e in entries])
        d_mask = np.stack([e[V.visual_attention_mask] for e in entries]).astype(np.int32)

        ids = np.concatenate([q_ids, d_ids], axis=1)
        q_boxes = np.zeros((n, self.q_len, 4), np.float32)
        q_boxes[..., 2:] = 1000.0  # the full-page box, the training convention
        boxes = np.concatenate([q_boxes, d_boxes], axis=1).astype(np.int32).astype(np.int64)
        mask = np.concatenate([q_mask, d_mask], axis=1).astype(np.float32)
        return (ids, boxes, mask), d_mask, word_maps, word_lists

    def __call__(self, documents: Sequence[Dict[str, Any]], questions: Sequence[str]) -> List[Dict[str, Any]]:
        """Each document as in :class:`DocTokenClassifier`, one question
        each. Returns per pair: ``answer`` (the span's words joined),
        ``start_word`` / ``end_word`` (word indices into the input) and
        ``score`` (the joint log-probability of the span's ends)."""
        if len(documents) != len(questions):
            raise ValueError(f"{len(documents)} documents vs {len(questions)} questions")
        if not documents:
            return []
        (ids, boxes, mask), d_mask, word_maps, word_lists = self.prepare(documents, questions)
        budget = self.doc_len - 1

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(_pad_to(a, self.batch_size)).to(self.device)

        results: List[Dict[str, Any]] = []
        n = len(documents)
        for lo in range(0, n, self.batch_size):
            hi = min(lo + self.batch_size, n)
            chunk = (put(ids[lo:hi]), put(boxes[lo:hi]), put(mask[lo:hi]))
            _maybe_calibrate_doc_int8(self, *chunk)
            s_lp, e_lp = self.step(*chunk)
            s_lp, e_lp = s_lp.cpu().numpy(), e_lp.cpu().numpy()
            for j in range(hi - lo):
                k = lo + j
                n_real = int(d_mask[k].sum())
                region_hi = self.q_len + max(min(n_real, budget), 1)
                si, ei, score = _best_span(s_lp[j], e_lp[j], self.q_len, region_hi, self.max_span)
                sw = int(word_maps[k][si - self.q_len])
                ew = int(word_maps[k][ei - self.q_len])
                if sw < 0:
                    sw = ew = 0
                elif ew < sw:
                    ew = sw
                words = word_lists[k]
                results.append({
                    "answer": " ".join(words[sw:ew + 1]),
                    "start_word": sw,
                    "end_word": ew,
                    "score": score,
                })
        return results


def visual_inputs(det: Dict[str, torch.Tensor], raw_sizes: torch.Tensor):
    """FRCNN output -> LXMERT's (features, [0, 1] boxes, mask), float32.
    Boxes are scaled by each row's raw (h, w) extent. Invalid slots are
    zeroed with ``where``, not a multiply: the pad rows of a bucket (raw
    size 0 x 0) come out of the FRCNN with NaN boxes and features, and
    NaN * 0 is NaN."""
    vmask = det["mask"].float()
    wh = raw_sizes.float()[:, [1, 0, 1, 0]].clamp(min=1.0)
    valid = vmask[..., None] > 0
    zero = torch.zeros((), device=vmask.device)
    norm = torch.where(valid, (det["boxes"].float() / wh[:, None, :]).clamp(0.0, 1.0), zero)
    feats = torch.where(valid, det["roi_features"].float(), zero)
    return feats, norm, vmask


class VQAPredictor:
    """images + questions -> ranked answer strings, fixed shapes end to end.

    Args:
      answers: the answer vocabulary the LXMERT head was trained over (a
        list of strings, or a json list / {answer: id} map path).
      frcnn_params / lxmert_params: state dicts of the port's ``FRCNN``
        (reference names) and ``LxmertForVQA`` (HF names), e.g. from
        ``jax_frcnn_to_torch`` / ``jax_lxmert_to_torch``; ``None`` = seeded
        random weights (smoke runs and shape checks only).
      frcnn_config / lxmert_config: architecture overrides (default the VG
        parity geometry ``FRCNNConfig.vg_extraction()`` and LXMERT-base in
        bf16); the answer head is auto-sized to ``len(answers)`` and
        ``visual_feat_dim`` to the FRCNN's ``res2_out_channels * 8``.
      batch_size: static request bucket; inputs are padded up to it.
      max_seq_length: static question budget (default: the tokenizer's, else
        20; giving both requires them to agree).
      raw_canvas / resized_canvas / short / maximum: detector input
        geometry; default to the extraction adapter's.
      device: CUDA unless ``"cpu"`` is asked for.
    """

    def __init__(
        self,
        answers: Union[str, Sequence[str]],
        *,
        frcnn_params: Optional[Mapping[str, torch.Tensor]] = None,
        lxmert_params: Optional[Mapping[str, torch.Tensor]] = None,
        frcnn_config=None,
        lxmert_config=None,
        batch_size: int = 8,
        max_seq_length: Optional[int] = None,
        tokenizer=None,
        raw_canvas=None,
        resized_canvas=None,
        short: Optional[float] = None,
        maximum: Optional[float] = None,
        device: DeviceLike = None,
    ):
        from vltk_tpu_torch.adapters import frcnn as adapter
        from vltk_tpu_torch.data.tokenizer import Tokenizer
        from vltk_tpu_torch.models.frcnn import FRCNN
        from vltk_tpu_torch.models.frcnn import init_weights as init_frcnn
        from vltk_tpu_torch.models.lxmert import LxmertForVQA, init_weights

        self.device = resolve_device(device)
        self.answers = _load_answer_list(answers)
        self.batch_size = int(batch_size)
        self.raw_canvas = tuple(raw_canvas or adapter.RAW_CANVAS)
        self._resized_canvas = tuple(resized_canvas or adapter.RESIZED_CANVAS)
        self._short = float(short if short is not None else adapter.SHORT)
        self._maximum = float(maximum if maximum is not None else adapter.MAXIMUM)

        fcfg, lcfg = _vqa_configs(frcnn_config, lxmert_config, len(self.answers))
        self.frcnn_config, self.lxmert_config = fcfg, lcfg
        if tokenizer is None:
            tokenizer = Tokenizer(name="NativeWordPiece", max_seq_length=20 if max_seq_length is None else max_seq_length)
        elif max_seq_length is not None and tokenizer.max_seq_length != max_seq_length:
            raise ValueError(
                f"tokenizer.max_seq_length ({tokenizer.max_seq_length}) "
                f"must equal max_seq_length ({max_seq_length})"
            )
        self.tokenizer = tokenizer
        if tokenizer.vocab_size > lcfg.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({tokenizer.vocab_size}) exceeds "
                f"LxmertConfig.vocab_size ({lcfg.vocab_size})"
            )

        if lxmert_params is not None:
            _check_head_width(lxmert_params, "answer_head.logit_fc.3.weight", len(self.answers), "answer")
        self.frcnn = _materialise(lambda: FRCNN(fcfg), frcnn_params, init_frcnn, 0, self.device)
        self.lxmert = _materialise(lambda: LxmertForVQA(lcfg), lxmert_params, init_weights, 1, self.device)
        # int8: static scales, set on the first request
        self.frcnn_scales: Optional[Dict[str, torch.Tensor]] = None
        self.lxmert_scales: Optional[Dict[str, torch.Tensor]] = None
        self._calib_lock = threading.Lock()

    @classmethod
    def from_pretrained(
        cls,
        frcnn_checkpoint: str,
        lxmert_checkpoint: str,
        answers: Union[str, Sequence[str]],
        **kwargs,
    ) -> "VQAPredictor":
        """Checkpoints -> predictor: a reference-named FRCNN (a torch file
        or a detectron ``.pkl``, as extraction loads it) and an HF
        ``LxmertForQuestionAnswering`` loaded by name. Every weight of
        ``LxmertForVQA``, the answer head included, must be there: a
        checkpoint that lacks one (a bare ``LxmertModel`` lacks the head)
        raises ``KeyError`` naming the missing keys, as the JAX predictor
        fails on a missing parameter. Keys the model does not have (the
        pretraining heads ``cls.*`` and ``obj_predict_head.*``, buffers)
        are skipped."""
        from vltk_tpu_torch.models.lxmert import LxmertForVQA
        from vltk_tpu_torch.models.pretrained import pretrained_state_dict

        fcfg, lcfg = _vqa_configs(kwargs.get("frcnn_config"), kwargs.get("lxmert_config"),
                                  len(_load_answer_list(answers)))
        _, frcnn = pretrained_state_dict("frcnn", frcnn_checkpoint, config=fcfg)
        lxmert = _load_by_name(
            lambda: LxmertForVQA(lcfg), load_state_dict(resolve_checkpoint(lxmert_checkpoint)), str, "",
            lxmert_checkpoint, "LxmertForVQA",
        )
        return cls(answers, frcnn_params=frcnn, lxmert_params=lxmert, **kwargs)

    def export_bundle(self, path: str, *, platforms: Optional[Sequence[str]] = None) -> str:
        """One serving file: the composed step (preprocess, FRCNN with K1 and
        K2 as registered ops, LXMERT, sigmoid) traced with both models'
        weights (and, after a request, an int8 preset's calibrated scales)
        as its state, plus the vocab, the answers and the geometry
        (``aot.py``)."""
        from vltk_tpu_torch.aot import export_step, save_bundle

        b, (ch, cw), seq = self.batch_size, self.raw_canvas, self.tokenizer.max_seq_length
        dev = self.device
        step = export_step(
            self._step,
            (torch.zeros((b, ch, cw, 3), dtype=torch.uint8, device=dev), torch.zeros((b, 2), device=dev),
             torch.zeros((b, seq), dtype=torch.int32, device=dev), torch.zeros((b, seq), device=dev)),
            modules={"frcnn": self.frcnn, "lxmert": self.lxmert}, platforms=platforms,
        )
        tmeta, vocab = _tokenizer_bundle_parts(self.tokenizer)
        meta = {
            "kind": "vqa_predictor",
            "answers": list(self.answers),
            "batch_size": b,
            "raw_canvas": [ch, cw],
            "tokenizer": tmeta,
        }
        return save_bundle(path, {"vqa": step}, meta=meta, files={"vocab.txt": vocab})

    @classmethod
    def from_bundle(cls, path: str, device: DeviceLike = None) -> "VQAPredictor":
        """Serve from an ``export_bundle`` file on ``device`` (CUDA unless
        "cpu" is asked for; the bundle's own device): no model is built,
        the loaded program is the step and the host side comes from the
        manifest."""
        return _BundledVQAPredictor(path, device)

    # ------------------------------------------------------------ device

    def _preprocess(self, raw_images: torch.Tensor, raw_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        from vltk_tpu_torch.ops.image_ops import preprocess_batch

        return preprocess_batch(
            raw_images, raw_sizes, canvas_hw=self._resized_canvas, short=self._short, maximum=self._maximum,
        )

    def _detect(self, raw_images: torch.Tensor, raw_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        pre = self._preprocess(raw_images, raw_sizes)
        return self.frcnn(pre["img"], pre["sizes"], scales_yx=pre["scales_yx"])

    @torch.inference_mode()
    def detect(self, raw_images: torch.Tensor, raw_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Preprocess and FRCNN: (B, Hr, Wr, 3) uint8 raw pixels and (B, 2)
        raw (h, w) -> the FRCNN output dict, boxes in raw pixels."""
        return self._detect(raw_images, raw_sizes)

    @torch.inference_mode()
    def calibrate_int8(self, raw_images: torch.Tensor, raw_sizes: torch.Tensor, ids: torch.Tensor,
                       tmask: torch.Tensor) -> None:
        """int8: static scales from the first at most 4 rows of a (padded)
        bucket, once, under a lock (JAX's ``_maybe_calibrate_int8``). An
        int8 FRCNN calibrates first; an int8 LXMERT then calibrates on that
        FRCNN's own features and normalised boxes of the same rows, pad
        rows zeroed with ``where``. ``__call__`` calls it before each
        bucket; it does nothing once the scales are set."""
        from vltk_tpu_torch.models.frcnn import calibrate_int8
        from vltk_tpu_torch.models.layers import calibrate_int8_scales

        want_f = self.frcnn_config.int8 and self.frcnn_scales is None
        want_l = self.lxmert_config.int8 and self.lxmert_scales is None
        if not (want_f or want_l):
            return
        with self._calib_lock:
            raw, sizes = raw_images[:4], raw_sizes[:4]
            pre = None
            if self.frcnn_config.int8 and self.frcnn_scales is None:
                pre = self._preprocess(raw, sizes)
                self.frcnn_scales = calibrate_int8(self.frcnn, [(pre["img"], pre["sizes"], pre["scales_yx"])])
            if self.lxmert_config.int8 and self.lxmert_scales is None:
                if pre is None:
                    pre = self._preprocess(raw, sizes)
                det = self.frcnn(pre["img"], pre["sizes"], scales_yx=pre["scales_yx"])
                feats, norm, vmask = visual_inputs(det, sizes)
                nb = vmask.shape[0]
                self.lxmert_scales = calibrate_int8_scales(
                    self.lxmert, [(ids[:nb], feats, norm, tmask[:nb], vmask)]
                )

    @torch.inference_mode()
    def answer(self, det: Dict[str, torch.Tensor], raw_sizes: torch.Tensor, ids: torch.Tensor,
               tmask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Box normalisation, LXMERT and sigmoid on ``detect``'s output."""
        return self._answer(det, raw_sizes, ids, tmask)

    def _answer(self, det: Dict[str, torch.Tensor], raw_sizes: torch.Tensor, ids: torch.Tensor,
                tmask: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats, norm, vmask = visual_inputs(det, raw_sizes)
        logits = self.lxmert(ids, feats, norm, tmask, vmask)
        return {
            "scores": torch.sigmoid(logits.float()),
            "boxes": det["boxes"].float(),
            "mask": vmask,
            "obj_ids": det["obj_ids"],
            "obj_probs": det["obj_probs"].float(),
        }

    @torch.inference_mode()
    def step(self, raw_images: torch.Tensor, raw_sizes: torch.Tensor, ids: torch.Tensor,
             tmask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One bucket on the device: (B, Hr, Wr, 3) uint8 raw images, (B, 2)
        raw sizes, (B, L) int32 question ids and (B, L) float32 mask ->
        ``scores`` (B, num_answers), ``boxes`` (B, D, 4) raw-pixel xyxy,
        ``mask`` (B, D), ``obj_ids`` and ``obj_probs`` (B, D)."""
        return self._step(raw_images, raw_sizes, ids, tmask)

    def _step(self, raw_images: torch.Tensor, raw_sizes: torch.Tensor, ids: torch.Tensor,
              tmask: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._answer(self._detect(raw_images, raw_sizes), raw_sizes, ids, tmask)

    def warmup(self) -> None:
        """One step on a zero bucket, ahead of the first request (the
        kernels' builds and the allocator's first blocks)."""
        b, (ch, cw), seq = self.batch_size, self.raw_canvas, self.tokenizer.max_seq_length
        dev = self.device
        self.step(
            torch.zeros((b, ch, cw, 3), dtype=torch.uint8, device=dev),
            torch.full((b, 2), 32.0, device=dev),
            torch.zeros((b, seq), dtype=torch.int32, device=dev),
            torch.zeros((b, seq), device=dev),
        )

    # -------------------------------------------------------------- host

    def _entries(self, images: Sequence[ImageLike], offset: int = 0) -> List[Dict[str, Any]]:
        from PIL import Image

        entries = []
        for i, img in enumerate(images):
            if isinstance(img, str):
                arr = np.asarray(Image.open(img).convert("RGB"))
            else:
                arr = np.asarray(img)
                if arr.ndim != 3 or arr.shape[-1] != 3:
                    raise ValueError(f"image {offset + i}: expected (H, W, 3) RGB, got {arr.shape}")
            entries.append({V.img: arr, V.imgid: str(offset + i)})
        return entries

    def _pad_chunk(self, arr: np.ndarray) -> np.ndarray:
        return _pad_to(arr, self.batch_size)

    def __call__(self, images: Sequence[ImageLike], questions: Sequence[str], top_k: int = 5) -> List[Dict[str, Any]]:
        """Returns one dict per (image, question) pair: ``answer`` (top-1
        string), ``score`` (its sigmoid score), ``topk`` ([(answer, score)]
        ranked), ``boxes`` ((D, 4) xyxy in the caller's pixels),
        ``objects`` ((D,) VG class ids), ``object_probs``, ``num_boxes``."""
        from vltk_tpu_torch.adapters.frcnn import collate

        if len(images) != len(questions):
            raise ValueError(f"{len(images)} images vs {len(questions)} questions")
        n = len(images)
        if n == 0:
            return []
        top_k = max(1, min(int(top_k), len(self.answers)))
        enc = self.tokenizer.encode_batch([str(q) for q in questions])
        ids = np.stack([e[V.input_ids] for e in enc]).astype(np.int32)
        tmask = np.stack([e[V.text_attention_mask] for e in enc]).astype(np.float32)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(self._pad_chunk(a)).to(self.device)

        results: List[Dict[str, Any]] = []
        for lo in range(0, n, self.batch_size):
            hi = min(lo + self.batch_size, n)
            entries = self._entries(images[lo:hi], offset=lo)
            orig_hw = np.array([e[V.img].shape[:2] for e in entries], np.float32)
            collated = collate(entries, self.raw_canvas)
            # collate shrinks raws larger than the canvas; this maps boxes
            # back into the caller's pixel frame (1 where nothing shrank)
            unshrink = (orig_hw[:, [1, 0, 1, 0]] / np.maximum(collated[V.rawsize][:, [1, 0, 1, 0]], 1.0))[:, None, :]
            bucket = (put(collated[V.img]), put(collated[V.rawsize].astype(np.float32)),
                      put(ids[lo:hi]), put(tmask[lo:hi]))
            self.calibrate_int8(*bucket)
            out = self.step(*bucket)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            for j in range(hi - lo):
                order = np.argsort(-out["scores"][j])[:top_k]
                ranked = [(self.answers[a], float(out["scores"][j, a])) for a in order]
                results.append({
                    "answer": ranked[0][0],
                    "score": ranked[0][1],
                    "topk": ranked,
                    "boxes": out["boxes"][j] * unshrink[j],
                    "objects": out["obj_ids"][j],
                    "object_probs": out["obj_probs"][j],
                    "num_boxes": int(out["mask"][j].sum()),
                })
        return results


class _BundledVQAPredictor(VQAPredictor):
    """``VQAPredictor`` serving a bundle: the host side (decode, collate,
    tokenize, rank) is inherited, the step is the loaded program; no model
    is built and no weights are read (``aot.py``)."""

    def __init__(self, path: str, device: DeviceLike = None):  # deliberately not super().__init__
        from vltk_tpu_torch.aot import bundle_manifest, load_bundle

        _check_bundle_kind(path, bundle_manifest(path)["meta"], "vqa_predictor")
        self.device = resolve_device(device)
        bundle = load_bundle(path, self.device)
        meta = bundle.meta
        self.answers = list(meta["answers"])
        self.batch_size = int(meta["batch_size"])
        self.raw_canvas = tuple(meta["raw_canvas"])
        self.tokenizer, self._vocab_dir = _tokenizer_from_bundle(meta["tokenizer"], bundle.files["vocab.txt"])
        self.frcnn = self.lxmert = None  # the weights are the program's state
        self.frcnn_config = self.lxmert_config = None
        self.frcnn_scales = self.lxmert_scales = None  # any int8 scales are too
        self._step = bundle.fns["vqa"]
        self.platforms = bundle.platforms

    def calibrate_int8(self, *bucket) -> None:
        """Nothing to calibrate: an int8 bundle carries its scales."""


class _BundledDocTokenClassifier(DocTokenClassifier):
    """``DocTokenClassifier`` serving a bundle: the OCR chain rebuilt from
    the manifest, the step from the program; no model is built."""

    def __init__(self, path: str, device: DeviceLike = None):  # deliberately not super().__init__
        from vltk_tpu_torch.processing.visn import AuxTokenize, OCRBoxFixed

        meta = _load_step_bundle(self, path, "doc_token_classifier", device)
        self.labels = list(meta["labels"])
        self.max_seq_length = int(meta["max_seq_length"])
        self._aux = AuxTokenize(tokenizer=self.tokenizer, max_visual_seq_length=self.max_seq_length)
        self._boxfix = OCRBoxFixed(max_visual_seq_length=self.max_seq_length)
        self._calib_lock = threading.Lock()


class _BundledDocSpanQA(DocSpanQA):
    """``DocSpanQA`` serving a bundle: the stream's host prep rebuilt from
    the manifest, the span step from the program; no model is built."""

    def __init__(self, path: str, device: DeviceLike = None):  # deliberately not super().__init__
        from vltk_tpu_torch.processing.visn import AuxTokenize, OCRBoxFixed

        meta = _load_step_bundle(self, path, "doc_span_qa", device)
        self.q_len = int(meta["question_len"])
        self.doc_len = int(meta["doc_len"])
        self.max_span = int(meta["max_span"])
        self._aux = AuxTokenize(tokenizer=self.tokenizer, max_visual_seq_length=self.doc_len)
        self._boxfix = OCRBoxFixed(max_visual_seq_length=self.doc_len)
        self._calib_lock = threading.Lock()
