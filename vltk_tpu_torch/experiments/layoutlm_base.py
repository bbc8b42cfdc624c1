"""Shared plumbing of the LayoutLM experiments: model construction over the
document token stream, the VLOVERLAP-aware id key, one logits entry point.
Counterpart of ``vltk_tpu/experiments/layoutlm_base.py``."""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.models.layoutlm import init_weights
from vltk_tpu_torch.train import SimpleExperiment


class LayoutLMExperimentBase(SimpleExperiment):
    """Subclasses set ``model_config``, ``model_cls`` and the objective."""

    model_cls = None  # LayoutLMFor... module class

    def _seq_length(self) -> int:
        """The length of the stream the model sees (subclasses add leading
        tokens, e.g. the question)."""
        return self.config.data.lang.max_visual_seq_length

    def build_model(self) -> nn.Module:
        """Seeded random weights (``init_weights``, seed 0); override to
        load trained ones. The stream must fit the position table, as the
        JAX package's ``init`` at ``_seq_length()`` requires."""
        length, table = self._seq_length(), self.model_config.max_position_embeddings
        if length > table:
            raise ValueError(
                f"sequence length {length} exceeds max_position_embeddings={table}; raise it in the config"
            )
        return init_weights(self.model_cls(self.model_config), seed=0)

    @staticmethod
    def _ocr_ids(batch: Dict[str, Any]):
        """OCR sub-token ids: the vision side renames text -> vtext
        (VLOVERLAP) so they never clash with VL question tokens."""
        key = V.VLOVERLAP[V.text]
        if key not in batch:
            key = V.text
        value = batch.get(key)
        return value if value is not None and hasattr(value, "dtype") else None

    def _logits(self, model: nn.Module, batch: Dict[str, Any]):
        return model(batch[V.text], batch[V.tokenbox], batch.get(V.visual_attention_mask))
