"""Tensor ops of the port: box algebra, preprocessing, and the ops with
hand-written CUDA kernels (RoIPool, greedy NMS, flash attention forward
and backward, the RoIPool ablation variants), each beside its plain
PyTorch version."""

from vltk_tpu_torch.ops.flash_attention_kernel import (
    flash_attention_auto,
    flash_attention_dkv_cuda,
    flash_attention_dq_cuda,
)
from vltk_tpu_torch.ops.nms_kernel import nms_fixed_auto
from vltk_tpu_torch.ops.roi_pool_ablation_kernel import (
    pool_auto,
    pool_contig_auto,
    pool_grouped_auto,
    pool_grouped_v3_auto,
)
from vltk_tpu_torch.ops.roi_pool_kernel import roi_pool_auto

#: the dispatchers whose ``launches`` counters show the kernels ran
KERNEL_WRAPPERS = {
    "roi_pool": roi_pool_auto,
    "nms": nms_fixed_auto,
    "flash_attention": flash_attention_auto,
    "flash_attention_dkv": flash_attention_dkv_cuda,
    "flash_attention_dq": flash_attention_dq_cuda,
    "pool": pool_auto,
    "pool_contig": pool_contig_auto,
    "pool_grouped": pool_grouped_auto,
    "pool_grouped_v3": pool_grouped_v3_auto,
}

__all__ = [
    "KERNEL_WRAPPERS", "flash_attention_auto", "flash_attention_dkv_cuda",
    "flash_attention_dq_cuda", "nms_fixed_auto", "pool_auto", "pool_contig_auto",
    "pool_grouped_auto", "pool_grouped_v3_auto", "roi_pool_auto",
]
