"""Models of the port: the Faster R-CNN extraction path."""

from vltk_tpu_torch.models.convert import jax_frcnn_to_torch
from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, init_weights

__all__ = ["FRCNN", "FRCNNConfig", "init_weights", "jax_frcnn_to_torch"]
