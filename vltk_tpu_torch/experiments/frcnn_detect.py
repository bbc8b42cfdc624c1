"""FRCNN detection fine-tuning: COCO-style boxes through the vision loader
into the detection losses.

Counterpart of ``vltk_tpu/experiments/frcnn_detect.py``. Batches from the
vision loader (host-processed RGB images on the canvas, fixed-shape
``gt_boxes`` / ``gt_boxes_mask`` and ``vlabels`` from the annotation
adapter) train the RPN and RoI-head objectives (``models.detection_loss``)
through the whole FRCNN: on the card the RoIPool forward is K1 and its
backward K10, and the step's two NMS calls are K2.

Data conventions handled in ``prepare_batch``, as in JAX: boxes arrive as
(X, Y, W, H) in raw-image coordinates and become XYXY in the resized
image's; images arrive RGB and become BGR minus the caffe means with the
pad beyond each image's content zeroed. The losses' sampling priorities are
drawn from the experiment's torch RNG on its device, which checkpoints
save, so a resumed run draws the uninterrupted run's samples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from vltk_tpu_torch import vars as V
from vltk_tpu_torch.models.detection_loss import fast_rcnn_losses, rpn_losses
from vltk_tpu_torch.models.frcnn import FRCNN, FRCNNConfig, init_weights
from vltk_tpu_torch.ops.image_ops import CAFFE_BGR_MEAN
from vltk_tpu_torch.train import SimpleExperiment, detection_map


class FRCNNDetectExperiment(SimpleExperiment):
    name = "frcnn_detect"

    #: override for other architectures or tiny test configs
    model_config: FRCNNConfig = FRCNNConfig()
    rpn_batch_per_image: int = 256
    roi_batch_per_image: int = 128

    def build_model(self) -> nn.Module:
        """Seeded random weights (``init_weights``, seed 0), the class head
        sized to the train loader's label table where it has one."""
        cfg = self.model_config
        table = getattr(self.train_loader, "metadata_ids", {}) or {}
        labels = table.get(V.labels) or table.get(V.objects)
        if labels and len(labels) != cfg.num_classes:
            cfg = dataclasses.replace(cfg, num_classes=len(labels))
            self.model_config = cfg
        return init_weights(FRCNN(cfg), seed=0)

    # -- batch plumbing ------------------------------------------------------

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        img = np.asarray(batch[V.img], np.float32)  # (B, Hc, Wc, 3) RGB
        sizes = np.asarray(batch[V.size], np.float32)  # (B, 2) resized (h, w)
        rawsizes = np.asarray(batch[V.rawsize], np.float32)

        # RGB -> BGR, caffe means, the pad beyond each image's content zeroed
        img = img[..., ::-1] - np.asarray(CAFFE_BGR_MEAN, np.float32)
        rows = np.arange(img.shape[1])[None, :, None]
        cols = np.arange(img.shape[2])[None, None, :]
        inside = (rows < sizes[:, 0][:, None, None]) & (cols < sizes[:, 1][:, None, None])
        img = np.where(inside[..., None], img, 0.0)

        # gt: XYWH raw coordinates -> XYXY resized coordinates
        xywh = np.asarray(batch["gt_" + V.boxes], np.float32)  # (B, D, 4)
        gtv = np.asarray(batch["gt_" + V.boxes_mask]).astype(bool)
        sw = (sizes[:, 1] / np.maximum(rawsizes[:, 1], 1.0))[:, None]
        sh = (sizes[:, 0] / np.maximum(rawsizes[:, 0], 1.0))[:, None]
        gt = np.stack(
            [
                xywh[..., 0] * sw,
                xywh[..., 1] * sh,
                (xywh[..., 0] + xywh[..., 2]) * sw,
                (xywh[..., 1] + xywh[..., 3]) * sh,
            ],
            axis=-1,
        )
        # annotation label ids: the loader renames "labels" to "vlabels"
        classes = np.asarray(batch.get("vlabels", batch.get(V.labels)), np.int32)
        classes = np.clip(classes, 0, self.model_config.num_classes - 1)
        return {
            "images": img.astype(np.float32),
            "sizes": sizes,
            "gt_boxes": gt.astype(np.float32),
            "gt_valid": gtv & (gt[..., 2] > gt[..., 0]) & (gt[..., 3] > gt[..., 1]),
            "gt_classes": classes,
        }

    # -- objective -----------------------------------------------------------

    def _rpn_losses(self, raw, batch, generator=None):
        return rpn_losses(
            raw["anchors"], raw["rpn_logits"], raw["rpn_deltas"], batch["gt_boxes"], batch["gt_valid"],
            generator=generator, batch_size_per_image=self.rpn_batch_per_image,
        )

    def loss_fn(self, model, batch):
        raw = model(batch["images"], batch["sizes"], return_raw=True)["raw"]
        obj, loc = self._rpn_losses(raw, batch)
        # fast_rcnn_losses detaches the proposals: the RPN trains on its own
        # losses only
        cls, box = fast_rcnn_losses(
            raw["proposals"], raw["prop_valid"], raw["obj_logits"], raw["box_deltas"],
            batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
            batch_size_per_image=self.roi_batch_per_image,
        )
        return obj + loc + cls + box, {"rpn_obj": obj, "rpn_loc": loc, "roi_cls": cls, "roi_box": box}

    def eval_metrics(self, model, batch):
        """The RPN losses on priorities drawn from a fixed seed (JAX: a
        fixed key)."""
        raw = model(batch["images"], batch["sizes"], return_raw=True)["raw"]
        gen = torch.Generator(device=batch["images"].device).manual_seed(0)
        obj, loc = self._rpn_losses(raw, batch, generator=gen)
        return {"rpn_obj": obj, "rpn_loc": loc}

    def eval_loop(self) -> Dict[str, float]:
        """The loss metrics, then mAP@0.5 of the model's detections (host
        numpy, ``detection_map``), boxes in the prepared ground truth's
        resized coordinates."""
        totals = super().eval_loop()
        if self.eval_loader is None:
            return totals
        map_sum, count = 0.0, 0
        self.model.eval()
        for batch in self._device_batches(self.eval_loader):
            with torch.no_grad():
                out = self.model(batch["images"], batch["sizes"])
            map_sum += detection_map(
                out["boxes"], out["obj_probs"], out["obj_ids"], out["mask"],
                batch["gt_boxes"], batch["gt_classes"], batch["gt_valid"],
            )
            count += 1
            if self.config.test_run:
                break
        totals["map50"] = map_sum / max(count, 1)
        return totals
