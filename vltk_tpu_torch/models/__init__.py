"""Models of the port: the Faster R-CNN extraction path, and the LayoutLM
document encoder and LXMERT on the shared transformer blocks."""

from vltk_tpu_torch.models.convert import jax_frcnn_to_torch, jax_layoutlm_to_torch, jax_lxmert_to_torch
from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, init_weights
from vltk_tpu_torch.models.layoutlm import (
    LayoutLM,
    LayoutLMConfig,
    LayoutLMForSpanQA,
    LayoutLMForTokenClassification,
)
from vltk_tpu_torch.models.lxmert import Lxmert, LxmertConfig, LxmertForPretraining, LxmertForVQA

__all__ = [
    "FRCNN",
    "FRCNNConfig",
    "LayoutLM",
    "LayoutLMConfig",
    "LayoutLMForSpanQA",
    "LayoutLMForTokenClassification",
    "Lxmert",
    "LxmertConfig",
    "LxmertForPretraining",
    "LxmertForVQA",
    "init_weights",
    "jax_frcnn_to_torch",
    "jax_layoutlm_to_torch",
    "jax_lxmert_to_torch",
]
