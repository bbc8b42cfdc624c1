"""Greedy NMS dispatcher: the CUDA kernel ``csrc/nms.cu`` for tensors on
the card, the plain version (``ops/nms.py:nms_fixed``) for tensors on the
CPU. Same contract either way: (R, max_out) int32 keep indices in greedy
order, -1 padded, plus a validity mask.

The wrapper does the part that is no kernel's business: it masks invalid
candidates, sorts each row by score with a stable descending sort (equal
scores keep the lower index first, the order argmax-greedy visits them)
and allocates the outputs and the IoU bit-mask scratch.
``nms_fixed_auto.launches`` counts kernel launches (CPU calls do not).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops.nms import NEG_INF, nms_fixed, row_thresholds


def _lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    fn = lib.nms_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def nms_fixed_cuda(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: Union[float, torch.Tensor],
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on (R, K, 4) boxes and (R, K) scores on one CUDA
    device (or (K, 4) and (K,) for one row)."""
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(
            f"nms: want boxes (R,K,4) and scores (R,K), got "
            f"{tuple(boxes.shape)} and {tuple(scores.shape)}"
        )
    dev = boxes.device
    if dev.type != "cuda" or scores.device != dev:
        raise ValueError("nms kernel: boxes and scores must share a CUDA device")
    r, k = scores.shape
    live = scores.to(torch.float32)
    if valid is not None:
        live = torch.where(valid.to(dev), live, torch.full_like(live, NEG_INF))
    sorted_live, order = torch.sort(live, dim=1, descending=True, stable=True)
    n_cand = (sorted_live > NEG_INF / 2).sum(dim=1, dtype=torch.int32)
    sboxes = torch.gather(
        boxes.to(torch.float32), 1, order[..., None].expand(r, k, 4)
    ).contiguous()
    order = order.contiguous()
    thr = row_thresholds(iou_threshold, r, dev)
    nwords = -(-k // 64)
    mask = torch.empty((r, k, nwords), dtype=torch.int64, device=dev)
    keep = torch.empty((r, max_out), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().nms_forward(
            sboxes.data_ptr(), order.data_ptr(), n_cand.data_ptr(),
            thr.data_ptr(), mask.data_ptr(), keep.data_ptr(),
            r, k, max_out, stream,
        )
    _build.check(err, "nms_forward launch")
    nms_fixed_auto.launches += 1
    if single:
        keep = keep[0]
    return keep, keep >= 0


def nms_fixed_auto(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: Union[float, torch.Tensor],
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fixed-budget greedy NMS: the kernel on CUDA tensors (or an
    error), the plain version on CPU ones."""
    if boxes.device.type == "cpu":
        return nms_fixed(boxes, scores, iou_threshold, max_out, valid)
    return nms_fixed_cuda(boxes, scores, iou_threshold, max_out, valid)


nms_fixed_auto.launches = 0
