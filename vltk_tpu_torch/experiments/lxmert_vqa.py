"""LXMERT VQA fine-tuning experiment.

Counterpart of ``vltk_tpu/experiments/lxmert_vqa.py``: ``LxmertForVQA`` over
precomputed FRCNN region features, the sigmoid soft-score loss
(``vqa_soft_loss``) and ``vqa_score``. Batch keys: ``input_ids``,
``text_attention_mask``, ``features`` (N, D, 2048), ``boxes`` (N, D, 4;
raw-pixel xyxy, normalised to [0, 1] here when the row carries its
``rawsize``, as ``predict.VQAPredictor`` serves), ``boxes_mask`` or
``visual_attention_mask``, and the answers as dense ``scores`` (N,
num_answers) or as sparse ``labels`` (ids padded with ``ignore_id``) with
their ``scores``, densified here. No kernel runs on this path: the
20-token question stream is below the flash gate and cross-attention
never takes flash.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
from torch import nn

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.models.lxmert import LxmertConfig, LxmertForVQA, init_weights, vqa_soft_loss
from vltk_tpu_torch.train import SimpleExperiment, vqa_score
from vltk_tpu_torch.utils.adapters import normalize_boxes_xyxy


def densify_scores(label_ids, scores, n_answers: int) -> np.ndarray:
    """(N, L) sparse answer ids and their soft scores (None = 1) -> (N,
    n_answers) float32; ids outside [0, n_answers) are dropped."""
    label_ids = np.asarray(label_ids)
    scores = np.ones_like(label_ids, np.float32) if scores is None else np.asarray(scores, np.float32)
    dense = np.zeros((label_ids.shape[0], n_answers), np.float32)
    valid = (label_ids >= 0) & (label_ids < n_answers)
    rows = np.broadcast_to(np.arange(label_ids.shape[0])[:, None], label_ids.shape)
    dense[rows[valid], label_ids[valid]] = scores[valid]
    return dense


class LxmertVQAExperiment(SimpleExperiment):
    name = "lxmert_vqa"

    #: override (or subclass) to change the architecture
    model_config: LxmertConfig = LxmertConfig()

    def build_model(self) -> nn.Module:
        """Seeded random weights (``init_weights``, seed 0). The answer head
        is sized to the train loader's answer vocabulary
        (``metadata_ids["answers"]``) where it has one."""
        cfg = self.model_config
        answers = getattr(self.train_loader, "metadata_ids", {}).get("answers")
        if answers and len(answers) != cfg.num_answers:
            cfg = dataclasses.replace(cfg, num_answers=len(answers))
            self.model_config = cfg
        return init_weights(LxmertForVQA(cfg), seed=0)

    # -- batch plumbing ------------------------------------------------------

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        wanted = (
            V.input_ids, V.text_attention_mask, V.features, V.boxes, V.boxes_mask,
            V.visual_attention_mask, V.scores, V.labels,
        )
        out = {key: batch[key] for key in wanted if key in batch and hasattr(batch[key], "dtype")}
        if V.boxes in out and V.rawsize in batch and hasattr(batch[V.rawsize], "dtype"):
            out[V.boxes] = normalize_boxes_xyxy(out[V.boxes], batch[V.rawsize])
        if V.labels in out:
            out[V.scores] = self._densify_scores(out.pop(V.labels), out.get(V.scores))
        return out

    def _densify_scores(self, label_ids, scores) -> np.ndarray:
        """(N, L) sparse answer ids + scores -> (N, num_answers) dense; a
        (N,) vector is one sampled label a row."""
        label_ids = np.asarray(label_ids)
        if label_ids.ndim == 1:
            label_ids = label_ids[:, None]
            scores = None if scores is None else np.asarray(scores)[:, None]
        return densify_scores(label_ids, scores, self.model_config.num_answers)

    @staticmethod
    def _visual_mask(batch):
        for key in (V.boxes_mask, V.visual_attention_mask):
            if key in batch:
                return batch[key]
        return None

    def _logits(self, model, batch):
        return model(batch[V.input_ids], batch[V.features], batch[V.boxes],
                     batch.get(V.text_attention_mask), self._visual_mask(batch))

    # -- objective -----------------------------------------------------------

    def loss_fn(self, model, batch):
        logits = self._logits(model, batch)
        return vqa_soft_loss(logits, batch[V.scores]), {"vqa_score": vqa_score(logits, batch[V.scores])}

    def eval_metrics(self, model, batch):
        return {"vqa_score": vqa_score(self._logits(model, batch), batch[V.scores])}
