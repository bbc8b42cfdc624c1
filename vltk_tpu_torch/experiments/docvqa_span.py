"""DocVQA span-QA experiment: question + OCR tokens -> the answer span.

Counterpart of ``vltk_tpu/experiments/docvqa_span.py``: one LayoutLM
stream of ``[question tokens | OCR sub-tokens]``, the question positions
carrying the full-page box (the LayoutLM convention), span labels shifted
by the question length so they index the concatenated stream; start / end
cross entropy (``span_qa_loss``) and ``span_acc``. The question's pad sits
in the middle of the stream, so on the card K3-K5 see a mask with a hole
(segment ids come from the mask, not from a length).

Batch keys: ``input_ids`` / ``text_attention_mask`` (the question, padded
to ``lang.max_seq_length``), ``vtext`` (OCR sub-token ids, VLOVERLAP-renamed,
or ``text``), ``tokenbox`` (0-1000 xyxy), ``visual_attention_mask`` and
``span_start`` / ``span_end`` (OCR positions, ``ignore_id`` where unanswerable).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.experiments.layoutlm_base import LayoutLMExperimentBase
from vltk_tpu_torch.models.layoutlm import LayoutLMConfig, LayoutLMForSpanQA, span_qa_loss
from vltk_tpu_torch.models.lxmert import masked_denominator


class DocVQASpanExperiment(LayoutLMExperimentBase):
    name = "docvqa_span"

    model_config: LayoutLMConfig = LayoutLMConfig()
    model_cls = LayoutLMForSpanQA

    def _seq_length(self) -> int:
        lang = self.config.data.lang
        return lang.max_seq_length + lang.max_visual_seq_length

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        lang = self.config.data.lang
        q_len = lang.max_seq_length
        ocr_ids = self._ocr_ids(batch)
        q_ids = np.asarray(batch[V.input_ids], np.int32)
        q_mask = np.asarray(batch.get(V.text_attention_mask, np.ones_like(q_ids)), np.int32)
        n = q_ids.shape[0]

        ids = np.concatenate([q_ids, np.asarray(ocr_ids, np.int32)], axis=1)
        q_boxes = np.zeros((n, q_len, 4), np.float32)
        q_boxes[..., 2:] = 1000.0
        boxes = np.concatenate([q_boxes, np.asarray(batch[V.tokenbox], np.float32)], axis=1)
        ocr_mask = np.asarray(batch[V.visual_attention_mask], np.int32)
        mask = np.concatenate([q_mask, ocr_mask], axis=1)

        ignore = lang.ignore_id

        def shift(s):
            s = np.asarray(s)
            return np.where(s == ignore, ignore, s + q_len).astype(np.int32)

        return {
            V.text: ids,
            V.tokenbox: boxes,
            V.visual_attention_mask: mask,
            "span_start": shift(batch["span_start"]),
            "span_end": shift(batch["span_end"]),
        }

    def _span_accuracy(self, start_logits, end_logits, batch) -> torch.Tensor:
        valid = batch["span_start"] != self.config.data.lang.ignore_id
        hit = (
            (start_logits.argmax(-1) == batch["span_start"])
            & (end_logits.argmax(-1) == batch["span_end"])
            & valid
        )
        return hit.sum() / masked_denominator(valid.sum())

    def loss_fn(self, model, batch):
        start, end = self._logits(model, batch)
        loss = span_qa_loss(start, end, batch["span_start"], batch["span_end"], self.config.data.lang.ignore_id)
        return loss, {"span_acc": self._span_accuracy(start, end, batch)}

    def eval_metrics(self, model, batch):
        start, end = self._logits(model, batch)
        return {"span_acc": self._span_accuracy(start, end, batch)}
