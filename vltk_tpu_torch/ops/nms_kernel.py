"""Greedy NMS dispatcher: the CUDA kernel ``csrc/nms.cu`` for tensors on
the card, the plain version (``ops/nms.py:nms_fixed``) for tensors on the
CPU. Same contract either way: (R, max_out) int32 keep indices in greedy
order, -1 padded, plus a validity mask.

The kernel masks, sorts and gathers the rows itself and needs no scratch:
the wrapper checks its inputs, picks the cluster size (CTAs a row) and
allocates the output, so a call is one launch. The kernel sorts a row in
one CTA's shared memory, which caps it at ``MAX_CANDIDATES`` (6144)
candidates a row (every configuration's ``pre_nms_topk`` is at most 6000);
a longer row raises ``ValueError`` on the card.
``nms_fixed_auto`` calls both through the registered op
``torch.ops.vltk_tpu_torch.nms_fixed`` (``nms_op``), which ``torch.export``
keeps in a serving bundle's program.
``nms_fixed_auto.launches`` counts kernel launches (CPU calls do not).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from vltk_tpu_torch.ops import _build
from vltk_tpu_torch.ops.nms import nms_fixed, row_thresholds

#: cluster sizes the kernel takes (up to the portable maximum, 8)
CLUSTERS = (1, 2, 4, 8)
# CTAs a row the wrapper picks for rows above SPLIT_ABOVE candidates: the
# pull of a word against the keeps so far splits over them. On the card
# (tools.bench_nms --clusters) 4 was the fastest for the RPN's 6000-candidate
# rows and 1 for the detection rows' 300
SPLIT_CLUSTER, SPLIT_ABOVE = 4, 1024
#: the most candidates a row the kernel takes: its block radix sort holds
#: 12 keys in each of 512 threads (``csrc/nms.cu:kMaxK``)
MAX_CANDIDATES = 6144


def _lib() -> ctypes.CDLL:
    return bind(_build.load("nms"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C entry points' argument types on a loaded library of
    ``csrc/nms.cu`` (or of an edited copy)."""
    lib.nms_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 2 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.nms_forward.restype = ctypes.c_int
    lib.nms_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.nms_smem_bytes.restype = ctypes.c_longlong
    return lib


def plan(k: int, max_out: int, cluster: Optional[int] = None, lib: Optional[ctypes.CDLL] = None):
    """(cluster size, dynamic shared memory a CTA) of a launch over rows of
    ``k`` candidates with a budget of ``max_out``: the given cluster size,
    else ``SPLIT_CLUSTER`` CTAs a row above ``SPLIT_ABOVE`` candidates and
    one below. Every row the kernel takes fits one CTA (``csrc/nms.cu``
    asserts it when it is built)."""
    cl = cluster or (SPLIT_CLUSTER if k > SPLIT_ABOVE else 1)
    return cl, (lib or _lib()).nms_smem_bytes(k, max_out, cl)


def prepare(boxes, scores, iou_threshold, valid=None):
    """What the wrapper hands the kernel, on (R, K, 4) boxes and (R, K)
    scores on one CUDA device: float32 boxes and scores, the validity mask
    (or None), and the threshold as a per-row tensor or a number. It copies
    only what is not float32 and contiguous already (the RPN's scores are a
    slice of its sorted logits) and sends no number to the card."""
    dev = boxes.device
    if valid is not None:
        valid = valid.to(dev, torch.bool).contiguous()
    if torch.is_tensor(iou_threshold):
        thr, value = row_thresholds(iou_threshold.to(dev), scores.shape[0], dev), 0.0
    else:
        thr, value = None, float(iou_threshold)
    return (boxes.to(torch.float32).contiguous(), scores.to(torch.float32).contiguous(),
            valid, thr, value)


def launch(prep, max_out: int, cluster: Optional[int] = None, lib: Optional[ctypes.CDLL] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on prepared inputs, one launch: (R, max_out) int32 keep
    and its (R, max_out) bool validity.
    ``cluster`` overrides the cluster size the wrapper picks; ``lib`` is
    another build of the kernel (``bind``; ``tools.bench_nms``)."""
    boxes, scores, valid, thr, value = prep
    dev = boxes.device
    r, k = scores.shape
    if k > MAX_CANDIDATES:
        raise ValueError(f"nms kernel: {k} candidates a row, it takes at most {MAX_CANDIDATES}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"nms kernel: cluster size {cluster}, want one of {CLUSTERS}")
    keep = torch.empty((r, max_out), dtype=torch.int32, device=dev)
    kept = torch.empty((r, max_out), dtype=torch.bool, device=dev)
    if r == 0 or max_out == 0:
        return keep, kept
    lib = lib or _lib()
    cl, _ = plan(k, max_out, cluster, lib)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nms_forward(
            boxes.data_ptr(), scores.data_ptr(), None if valid is None else valid.data_ptr(),
            None if thr is None else thr.data_ptr(), value, keep.data_ptr(), kept.data_ptr(),
            r, k, max_out, cl, stream,
        )
    _build.check(err, "nms_forward launch")
    nms_fixed_auto.launches += 1
    return keep, kept


def nms_fixed_cuda(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: Union[float, torch.Tensor],
    max_out: int,
    valid: Optional[torch.Tensor] = None,
    *,
    _cluster: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on (R, K, 4) boxes and (R, K) scores on one CUDA
    device (or (K, 4) and (K,) for one row), K at most ``MAX_CANDIDATES``.
    ``_cluster`` (tests only) overrides the cluster size."""
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(
            f"nms: want boxes (R,K,4) and scores (R,K), got "
            f"{tuple(boxes.shape)} and {tuple(scores.shape)}"
        )
    if valid is not None and valid.shape != scores.shape:
        raise ValueError(f"nms: valid {tuple(valid.shape)} != scores {tuple(scores.shape)}")
    dev = boxes.device
    if dev.type != "cuda" or scores.device != dev:
        raise ValueError("nms kernel: boxes and scores must share a CUDA device")
    keep, kept = launch(prepare(boxes, scores, iou_threshold, valid), max_out, _cluster)
    if single:
        return keep[0], kept[0]
    return keep, kept


@torch.library.custom_op("vltk_tpu_torch::nms_fixed", mutates_args=(), device_types="cuda")
def nms_op(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    thresholds: Optional[torch.Tensor],
    iou_threshold: float,
    max_out: int,
    valid: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 as a registered op (``torch.ops.vltk_tpu_torch.nms_fixed``), so a
    program that ``torch.export`` traces keeps the kernel: on CUDA tensors
    ``nms_fixed_cuda`` (same launch and counter), on CPU ones the plain
    version. The threshold is the per-row ``thresholds`` tensor where it
    is given, else the number ``iou_threshold``."""
    return nms_fixed_cuda(boxes, scores, iou_threshold if thresholds is None else thresholds, max_out, valid)


@nms_op.register_kernel("cpu")
def _nms_op_cpu(boxes, scores, thresholds, iou_threshold, max_out, valid):
    return nms_fixed(boxes, scores, iou_threshold if thresholds is None else thresholds, max_out, valid)


@nms_op.register_fake
def _nms_op_fake(boxes, scores, thresholds, iou_threshold, max_out, valid):
    shape = (max_out,) if boxes.dim() == 2 else (boxes.shape[0], max_out)
    return scores.new_empty(shape, dtype=torch.int32), scores.new_empty(shape, dtype=torch.bool)


def nms_fixed_auto(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: Union[float, torch.Tensor],
    max_out: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fixed-budget greedy NMS: the kernel on CUDA tensors (or an
    error), the plain version on CPU ones. The keep-set is integer: inputs
    that carry a gradient (the RPN's proposals in training) are detached,
    so nothing is recorded for a backward through it."""
    boxes, scores = boxes.detach(), scores.detach()
    if torch.is_tensor(iou_threshold):
        return nms_op(boxes, scores, iou_threshold.detach(), 0.0, max_out, valid)
    return nms_op(boxes, scores, None, float(iou_threshold), max_out, valid)


nms_fixed_auto.launches = 0
