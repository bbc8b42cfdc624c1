"""Models of the port: the Faster R-CNN extraction path, and the LayoutLM
document encoder and LXMERT on the shared transformer blocks."""

from vltk_tpu_torch.models.convert import (
    jax_frcnn_to_torch,
    jax_layoutlm_to_torch,
    jax_lxmert_to_torch,
    jax_quant_to_torch,
)
from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, calibrate_int8, init_weights
from vltk_tpu_torch.models.layoutlm import (
    LayoutLM,
    LayoutLMConfig,
    LayoutLMForSpanQA,
    LayoutLMForTokenClassification,
)
from vltk_tpu_torch.models.layers import calibrate_int8_scales, int8_scales, load_int8_scales
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
    "calibrate_int8",
    "calibrate_int8_scales",
    "init_weights",
    "int8_scales",
    "jax_frcnn_to_torch",
    "jax_layoutlm_to_torch",
    "jax_lxmert_to_torch",
    "jax_quant_to_torch",
    "load_int8_scales",
]
