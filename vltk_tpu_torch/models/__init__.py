"""Models of the port: the Faster R-CNN extraction path, the LayoutLM
document encoder, LXMERT and VisualBERT on the shared transformer blocks
(with the MoE feed-forward in their place under ``moe_experts > 0``), and
the ViT image encoder."""

from vltk_tpu_torch.models.convert import (
    jax_frcnn_to_torch,
    jax_layoutlm_to_torch,
    jax_lxmert_to_torch,
    jax_quant_to_torch,
    jax_visualbert_to_torch,
    jax_vit_to_torch,
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
from vltk_tpu_torch.models.moe import MoEFeedForward, moe_aux_losses, moe_capacity, top_k_routing
from vltk_tpu_torch.models.visualbert import (
    VisualBert,
    VisualBertConfig,
    VisualBertEmbeddings,
    VisualBertForClassification,
    classification_loss,
)
from vltk_tpu_torch.models.vit import ViT, ViTConfig, init_vit_weights

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
    "MoEFeedForward",
    "ViT",
    "ViTConfig",
    "VisualBert",
    "VisualBertConfig",
    "VisualBertEmbeddings",
    "VisualBertForClassification",
    "calibrate_int8",
    "calibrate_int8_scales",
    "classification_loss",
    "init_vit_weights",
    "init_weights",
    "int8_scales",
    "jax_frcnn_to_torch",
    "jax_layoutlm_to_torch",
    "jax_lxmert_to_torch",
    "jax_quant_to_torch",
    "jax_visualbert_to_torch",
    "jax_vit_to_torch",
    "load_int8_scales",
    "moe_aux_losses",
    "moe_capacity",
    "top_k_routing",
]
