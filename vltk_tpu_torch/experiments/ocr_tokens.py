"""OCR token-classification experiment (FUNSD form understanding).

Counterpart of ``vltk_tpu/experiments/ocr_tokens.py``: LayoutLM encoder,
per-token cross entropy over the form labels, ``token_acc``. Batch keys
(the OCR chain's outputs): ``vtext`` (sub-token ids, VLOVERLAP-renamed),
``tokenbox`` (0-1000 xyxy), ``tokenlabels`` (``ignore_id`` on pad and
continuation positions), ``visual_attention_mask``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.experiments.layoutlm_base import LayoutLMExperimentBase
from vltk_tpu_torch.models.layoutlm import (
    LayoutLMConfig,
    LayoutLMForTokenClassification,
    token_classification_loss,
)
from vltk_tpu_torch.models.lxmert import masked_denominator


def _token_accuracy(logits: torch.Tensor, labels: torch.Tensor, ignore_id: int) -> torch.Tensor:
    """Correct over valid positions of the global batch (under a mesh the
    valid count is the ``data`` axis', as the loss's)."""
    valid = labels != ignore_id
    correct = (logits.argmax(-1) == labels) & valid
    return correct.sum() / masked_denominator(valid.sum())


class OCRTokenExperiment(LayoutLMExperimentBase):
    name = "ocr_tokens"

    model_config: LayoutLMConfig = LayoutLMConfig()
    model_cls = LayoutLMForTokenClassification

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        ids = self._ocr_ids(batch)
        if ids is not None:
            out[V.text] = ids
        for key in (V.tokenbox, V.tokenlabels, V.visual_attention_mask):
            if key in batch and hasattr(batch[key], "dtype"):
                out[key] = batch[key]
        return out

    def loss_fn(self, model, batch):
        logits = self._logits(model, batch)
        ignore = self.config.data.lang.ignore_id
        labels = batch[V.tokenlabels]
        loss = token_classification_loss(logits, labels, ignore)
        return loss, {"token_acc": _token_accuracy(logits, labels, ignore)}

    def eval_metrics(self, model, batch):
        logits = self._logits(model, batch)
        return {"token_acc": _token_accuracy(logits, batch[V.tokenlabels], self.config.data.lang.ignore_id)}
