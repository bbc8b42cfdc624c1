"""Metrics. Counterpart of ``vltk_tpu/train/metrics.py``: ``accuracy``,
``vqa_score`` and ``detection_map``."""

from __future__ import annotations

import numpy as np
import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax hits."""
    return (logits.argmax(-1) == labels).float().mean()


def vqa_score(logits: torch.Tensor, target_scores: torch.Tensor) -> torch.Tensor:
    """VQA accuracy: the soft score (0.3 / 0.6 / 0.9 / 1.0) of the
    predicted answer, averaged over the batch."""
    pred = logits.argmax(-1)
    return target_scores.gather(1, pred[:, None]).mean()


def _host(x, dtype=None) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def detection_map(
    pred_boxes,
    pred_scores,
    pred_classes,
    pred_valid,
    gt_boxes,
    gt_classes,
    gt_valid,
    iou_thresh: float = 0.5,
) -> float:
    """Mean average precision at one IoU threshold, on the host (numpy),
    line for line as JAX's: per class with ground truth, every prediction
    of the class over the batch in descending score (Python's stable sort),
    each judged against its max-IoU ground truth of its image (the VOC
    rule: a ground truth already claimed makes it a false positive, with no
    fallback to a lower-IoU unclaimed one), all-point interpolated AP; the
    mean over those classes (0 without ground truth).

    Args (fixed-shape batches, tensors or arrays): pred_boxes (N, D, 4)
    xyxy, pred_scores (N, D), pred_classes (N, D), pred_valid (N, D) bool;
    gt_boxes (N, G, 4), gt_classes (N, G), gt_valid (N, G) bool.
    """
    pred_boxes = _host(pred_boxes, np.float32)
    pred_scores = _host(pred_scores, np.float32)
    pred_classes = _host(pred_classes)
    pred_valid = _host(pred_valid).astype(bool)
    gt_boxes = _host(gt_boxes, np.float32)
    gt_classes = _host(gt_classes)
    gt_valid = _host(gt_valid).astype(bool)

    def iou(a, b):
        lt = np.maximum(a[:2], b[:2])
        rb = np.minimum(a[2:], b[2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[0] * wh[1]
        ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
        ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
        union = ua + ub - inter
        return inter / union if union > 0 else 0.0

    classes = np.unique(gt_classes[gt_valid])
    if classes.size == 0:
        return 0.0
    aps = []
    for c in classes:
        n_gt = int((gt_valid & (gt_classes == c)).sum())
        entries = []  # (score, image, box)
        for n in range(pred_boxes.shape[0]):
            sel = pred_valid[n] & (pred_classes[n] == c)
            for d in np.flatnonzero(sel):
                entries.append((pred_scores[n, d], n, pred_boxes[n, d]))
        entries.sort(key=lambda e: -e[0])
        matched = [set() for _ in range(gt_boxes.shape[0])]
        tp = np.zeros(len(entries))
        for i, (_, n, box) in enumerate(entries):
            best, best_g = 0.0, -1
            for g in np.flatnonzero(gt_valid[n] & (gt_classes[n] == c)):
                v = iou(box, gt_boxes[n, g])
                if v > best:
                    best, best_g = v, g
            if best >= iou_thresh and best_g >= 0 and best_g not in matched[n]:
                tp[i] = 1.0
                matched[n].add(best_g)
        cum_tp = np.cumsum(tp)
        recall = cum_tp / n_gt
        precision = cum_tp / np.arange(1, len(entries) + 1)
        ap = 0.0
        prev_r = 0.0
        for r, p in zip(recall, np.maximum.accumulate(precision[::-1])[::-1]):
            ap += (r - prev_r) * p
            prev_r = r
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0
