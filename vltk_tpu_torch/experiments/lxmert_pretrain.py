"""LXMERT pretraining experiment: the task toggles of the train config.

Counterpart of ``vltk_tpu/experiments/lxmert_pretrain.py``.
``prepare_batch`` applies the host-side corruptions with the experiment's
numpy generator (seeded from ``config.train.seed`` before anything else
draws), in the JAX package's order: masked LM 80/10/10
(``task_mask_lm``), region-feature masking (``task_obj_predict``), the
batch-level sentence swap with the MLM labels of swapped rows cleared
(``task_matched``), then the dense VQA scores (``task_qa``). ``loss_fn``
sums the toggled objectives over ``LxmertForPretraining``'s heads. No
kernel runs on this path (see ``lxmert_vqa.py``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
from torch import nn

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.experiments.lxmert_vqa import densify_scores
from vltk_tpu_torch.models.lxmert import (
    LxmertConfig,
    LxmertForPretraining,
    init_weights,
    masked_lm_loss,
    matched_loss,
    visual_feat_loss,
    vqa_soft_loss,
)
from vltk_tpu_torch.processing.lang import masked_feature_modeling, masked_language_modeling
from vltk_tpu_torch.train import SimpleExperiment
from vltk_tpu_torch.utils.adapters import normalize_boxes_xyxy


class LxmertPretrainExperiment(SimpleExperiment):
    name = "lxmert_pretrain"

    model_config: LxmertConfig = LxmertConfig()
    mask_token_id: int = 103  # [MASK] in the BERT vocabulary
    special_ids = (0, 100, 101, 102, 103)

    def __init__(self, config, loaders=None, mesh=None, rules=None, device=None):
        self._np_rng = np.random.default_rng(config.train.seed)
        super().__init__(config, loaders=loaders, mesh=mesh, rules=rules, device=device)

    def build_model(self) -> nn.Module:
        """Seeded random weights (``init_weights``, seed 0)."""
        return init_weights(LxmertForPretraining(self.model_config), seed=0)

    # -- host-side corruptions -----------------------------------------------

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        t = self.config.train
        lang = self.config.data.lang
        n_answers = self.model_config.num_answers
        out: Dict[str, Any] = {}
        ids = np.asarray(batch[V.input_ids])
        mask = np.asarray(batch.get(V.text_attention_mask, np.ones_like(ids)))
        feats = np.asarray(batch[V.features], np.float32)
        out[V.boxes] = np.asarray(batch[V.boxes], np.float32)
        if V.rawsize in batch and hasattr(batch[V.rawsize], "dtype"):
            out[V.boxes] = normalize_boxes_xyxy(out[V.boxes], batch[V.rawsize])
        out[V.text_attention_mask] = mask
        vmask = batch.get(V.boxes_mask)
        if vmask is not None:
            out[V.boxes_mask] = np.asarray(vmask, np.float32)

        if t.task_mask_lm:
            out[V.input_ids], out["masked_labels"] = masked_language_modeling(
                ids, mask, self._np_rng,
                mask_token_id=self.mask_token_id, vocab_size=self.model_config.vocab_size,
                special_ids=self.special_ids, mask_rate=lang.mask_rate,
                mask_token_rate=lang.mask_token_rate, random_token_rate=lang.random_token_rate,
                ignore_id=lang.ignore_id,
            )
        else:
            out[V.input_ids] = ids

        if t.task_obj_predict:
            out["feat_target"] = feats
            masked, chosen = masked_feature_modeling(
                feats.reshape(-1, feats.shape[-1]),
                None if vmask is None else np.asarray(vmask).reshape(-1) > 0,
                self._np_rng, feature_mask_rate=lang.feature_mask_rate,
            )
            out[V.features] = masked.reshape(feats.shape)
            out["feat_mask"] = chosen.reshape(feats.shape[:2]).astype(np.float32)
        else:
            out[V.features] = feats

        if t.task_matched:
            # the text of a random half of the rows swapped for the previous row's
            swap = self._np_rng.random(ids.shape[0]) < lang.sentence_match_rate
            out[V.input_ids] = np.where(swap[:, None], np.roll(out[V.input_ids], 1, axis=0), out[V.input_ids])
            out[V.text_attention_mask] = np.where(swap[:, None], np.roll(mask, 1, axis=0), mask)
            out["is_matched"] = (~swap).astype(np.int32)
            if "masked_labels" in out:
                out["masked_labels"] = np.where(swap[:, None], lang.ignore_id, out["masked_labels"])

        if t.task_qa and V.scores in batch:
            scores = np.asarray(batch[V.scores], np.float32)
            if scores.ndim == 2 and scores.shape[1] != n_answers:
                scores = densify_scores(np.asarray(batch.get(V.labels)), scores, n_answers)
            out[V.scores] = scores
        return out

    # -- objective -------------------------------------------------------------

    def loss_fn(self, model, batch):
        t = self.config.train
        heads = model(batch[V.input_ids], batch[V.features], batch[V.boxes],
                      batch.get(V.text_attention_mask), batch.get(V.boxes_mask))
        aux = {}
        if t.task_mask_lm and "masked_labels" in batch:
            aux["mlm_loss"] = masked_lm_loss(heads["mlm_logits"], batch["masked_labels"],
                                             self.config.data.lang.ignore_id)
        if t.task_matched and "is_matched" in batch:
            aux["matched_loss"] = matched_loss(heads["matched_logits"], batch["is_matched"])
        if t.task_obj_predict and "feat_mask" in batch:
            aux["feat_loss"] = visual_feat_loss(heads["feat_pred"], batch["feat_target"], batch["feat_mask"])
        if t.task_qa and V.scores in batch:
            aux["qa_loss"] = vqa_soft_loss(heads["qa_logits"], batch[V.scores])
        # no task on: a zero autograd can differentiate (JAX differentiates 0.0)
        total = sum(aux.values()) if aux else heads["pooled"].sum() * 0.0
        return total, aux
