"""FRCNN feature-extraction adapter: the 36-box / 2048-d extraction step.

Port of ``vltk_tpu/adapters/frcnn.py``. ``setup`` builds the model on the
chosen device and returns a step that runs preprocess -> FRCNN -> the
packed (B, D, 2048+4+1+1) float32 output the reference step returns
(features, raw-coordinate boxes, object ids, attribute ids). ``collate``
is the host side that feeds such a step: decoded images padded onto the
static raw canvas as uint8. The ``FRCNN`` adapter runs them under the
extraction pipeline (``VisnExtraction.extract``): K1 (RoIPool) once and K2
(greedy NMS) twice a batch on the card, and one Arrow row an image
(``schema``: features, boxes rounded to whole raw pixels, object and
attribute ids, the raw size).

Weights come from a reference-named checkpoint (``checkpoint=``: a torch
file, a detectron ``.pkl`` or a directory, read by
``models.pretrained``), or are seeded random without one. Every preset of
``FRCNNConfig.PRESETS`` is taken; an int8 one (``production`` is
``int8_300``) is calibrated once, on the first at most 4 images of the
step's first batch, before that step runs, as the JAX adapter does, and
its scales are kept in ``bundle["int8_scales"]``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from vltk_tpu_torch import DeviceLike, resolve_device
from vltk_tpu_torch import vars as V
from vltk_tpu_torch.adapters.extraction import VisnExtraction
from vltk_tpu_torch.config import VisionConfig
from vltk_tpu_torch.features import Features
from vltk_tpu_torch.models.frcnn import FRCNN as FRCNNModel, FRCNNConfig, calibrate_int8, init_weights
from vltk_tpu_torch.models.pretrained import pretrained_state_dict
from vltk_tpu_torch.ops.image_ops import preprocess_batch

# static canvases and the shortest-edge targets of the reference adapter
RAW_CANVAS: Tuple[int, int] = (1344, 1344)
RESIZED_CANVAS: Tuple[int, int] = (1344, 1344)
SHORT = 800.0
MAXIMUM = 1333.0


def _resolve_config(preset, dtype, config_overrides) -> FRCNNConfig:
    """Preset -> FRCNNConfig: the preset supplies the base fields, an
    explicit ``dtype`` wins over it, explicit overrides win over both.
    Keys that are no config field are left to the caller."""
    fields = {f.name for f in dataclasses.fields(FRCNNConfig)}
    base = dataclasses.asdict(FRCNNConfig.named_preset(preset)) if preset else {}
    if dtype is not None:
        base["dtype"] = dtype
    base.update({k: v for k, v in config_overrides.items() if k in fields})
    return FRCNNConfig(**{k: v for k, v in base.items() if k in fields})


def tame_random_weights(model: FRCNNModel) -> FRCNNModel:
    """Scale seeded random weights so a full-depth forward stays finite:
    random R-101 explodes to NaN and NaN boxes mask every detection out.
    Conv kernels are halved and the box-delta heads scaled by 1e-3 (the
    JAX package's bench.py ``_tame_params``, on the torch names). For
    benchmarks and smoke runs without a checkpoint."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("anchor_deltas.weight", "bbox_pred.weight")):
                p.mul_(1e-3)
            elif name.endswith("weight") and p.dim() == 4:
                p.mul_(0.5)
    return model


def collate(entries: List[Dict[str, Any]], raw_canvas: Tuple[int, int] = RAW_CANVAS) -> Dict[str, Any]:
    """Pad decoded raw images (``{V.img: (h, w, 3), V.imgid: ...}``) onto
    the static raw canvas and stack them as uint8, with their (n, 2) int32
    raw (h, w) and their ids. An image larger than the canvas is shrunk on
    the host first (PIL, to ``int(h * scale)`` x ``int(w * scale)``; the
    interpolated pixels rounded and clipped before the uint8 cast), and its
    raw size is the shrunk one."""
    ch, cw = raw_canvas
    n = len(entries)
    images = np.zeros((n, ch, cw, 3), np.uint8)
    raw_sizes = np.zeros((n, 2), np.int32)
    imgids = []
    for i, e in enumerate(entries):
        img = e[V.img]
        h, w = img.shape[0], img.shape[1]
        if h > ch or w > cw:
            from PIL import Image

            scale = min(ch / h, cw / w)
            h, w = int(h * scale), int(w * scale)
            img = np.asarray(Image.fromarray(img.astype(np.uint8)).resize((w, h)), np.float32)
        if img.dtype == np.uint8:
            images[i, :h, :w] = img
        else:
            images[i, :h, :w] = np.clip(np.rint(img), 0, 255).astype(np.uint8)
        raw_sizes[i] = (h, w)
        imgids.append(e[V.imgid])
    return {V.img: images, V.rawsize: raw_sizes, V.imgid: imgids}


def setup(
    checkpoint: Optional[str] = None,
    batch_size: Optional[int] = None,
    dtype: Optional[str] = None,
    preset: Optional[str] = None,
    device: DeviceLike = None,
    **overrides,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Build the extraction step on ``device`` (CUDA unless "cpu" is asked
    for; raises without a card).

    ``overrides`` may hold FRCNNConfig fields and the adapter geometry
    (``resized_canvas``, ``short``, ``maximum``, ``seed`` of the random
    weights). Returns (bundle, model_config); ``bundle["step"](raw_uint8,
    raw_sizes)`` maps (B, Hr, Wr, 3) raw pixels and (B, 2) raw sizes to the
    packed (B, D, 2048+4+1+1) float32 output. With an int8 preset the first
    call calibrates (``bundle["int8_scales"]``, None until then).
    """
    dev = resolve_device(device)
    cfg = _resolve_config(preset, dtype, overrides)
    canvas = tuple(overrides.get("resized_canvas", RESIZED_CANVAS))
    short = float(overrides.get("short", SHORT))
    maximum = float(overrides.get("maximum", MAXIMUM))

    model = FRCNNModel(cfg).eval()
    if checkpoint is not None:
        model.load_state_dict(pretrained_state_dict("frcnn", checkpoint, config=cfg)[1])
    else:
        init_weights(model, seed=int(overrides.get("seed", 0)))
    model.to(dev)

    def pre_fn(raw_images: torch.Tensor, raw_sizes: torch.Tensor):
        return preprocess_batch(
            raw_images.to(dev), raw_sizes.to(dev), canvas_hw=canvas,
            short=short, maximum=maximum,
        )

    lock = threading.Lock()

    def calibrate_once(raw_images: torch.Tensor, raw_sizes: torch.Tensor) -> None:
        """int8: static scales from the first at most 4 images of the first
        batch; concurrent first calls calibrate once."""
        with lock:
            if bundle["int8_scales"] is None:
                pre = pre_fn(raw_images[:4], raw_sizes[:4])
                bundle["int8_scales"] = calibrate_int8(model, [(pre["img"], pre["sizes"], pre["scales_yx"])])

    @torch.inference_mode()
    def forward(raw_images: torch.Tensor, raw_sizes: torch.Tensor):
        if cfg.int8 and bundle["int8_scales"] is None:
            calibrate_once(raw_images, raw_sizes)
        pre = pre_fn(raw_images, raw_sizes)
        return model(pre["img"], pre["sizes"], scales_yx=pre["scales_yx"])

    @torch.inference_mode()
    def step(raw_images: torch.Tensor, raw_sizes: torch.Tensor) -> torch.Tensor:
        out = forward(raw_images, raw_sizes)
        return torch.cat(
            [
                out["roi_features"].to(torch.float32),
                out["boxes"].to(torch.float32),
                out["obj_ids"].to(torch.float32)[..., None],
                out["attr_ids"].to(torch.float32)[..., None],
            ],
            dim=-1,
        )

    bundle = {
        "step": step,
        "forward": forward,
        "pre_fn": pre_fn,
        "model": model,
        "cfg": cfg,
        "device": dev,
        "batch_size": batch_size,
        "int8_scales": None,
    }
    model_config = {
        "model": "frcnn-resnet101-c4-vg",
        "checkpoint": checkpoint,
        "max_detections": cfg.max_detections,
        "visual_dim": cfg.res2_out_channels * 8,
        "dtype": cfg.dtype or "float32",
        "preset": preset,
    }
    return bundle, model_config


class FRCNN(VisnExtraction):
    """The 36-box R-101-C4 VG feature extractor as an extraction adapter.
    Subclass it to change the batch size or the canvases."""

    _name = "frcnn"
    model_batch_size = 8
    # the host only decodes, to uint8; resize and normalise run on the device
    default_processor = VisionConfig(transforms=("fromfile",), device_fused=True, decode_dtype="uint8")
    raw_canvas: Tuple[int, int] = RAW_CANVAS
    resized_canvas: Tuple[int, int] = RESIZED_CANVAS
    short: float = SHORT
    maximum: float = MAXIMUM

    @classmethod
    def setup(cls, checkpoint: Optional[str] = None, batch_size: Optional[int] = None, dtype: Optional[str] = None,
              preset: Optional[str] = None, device: DeviceLike = None, **config_overrides):
        """``setup`` at this class's canvases and resize targets."""
        geometry = dict(resized_canvas=cls.resized_canvas, short=cls.short, maximum=cls.maximum)
        config_overrides = {k: v for k, v in config_overrides.items() if k not in geometry}
        return setup(checkpoint, batch_size, dtype, preset, device, **geometry, **config_overrides)

    @staticmethod
    def schema(max_detections: int = 36, visual_dim: int = 2048):
        return {
            "attr_ids": Features.Ids(),
            "object_ids": Features.Ids(),
            V.features: Features.FeaturesMatrix(max_detections, visual_dim),
            V.boxes: Features.Boxtensor(max_detections),
            # raw (h, w): the boxes are raw-pixel coordinates
            V.rawsize: Features.IntList(),
        }

    @classmethod
    def collate(cls, entries: List[Dict[str, Any]]) -> Dict[str, Any]:
        return collate(entries, cls.raw_canvas)

    @classmethod
    def forward_dispatch(cls, model, batch: Mapping[str, Any], **kwargs):
        """Copy the batch to the device (pinned, asynchronous on CUDA) and
        queue the step; nothing waits for the device here."""
        dev = model["device"]
        images, sizes = torch.from_numpy(batch[V.img]), torch.from_numpy(batch[V.rawsize])
        if dev.type == "cuda":
            images, sizes = images.pin_memory(), sizes.pin_memory()
        packed = model["step"](images.to(dev, non_blocking=True), sizes.to(dev, non_blocking=True))
        return packed, list(batch[V.imgid]), np.asarray(batch[V.rawsize])

    @classmethod
    def forward_collect(cls, model, state) -> List[Dict[str, Any]]:
        """Fetch one dispatched step: one entry an image."""
        packed, imgids, raw_sizes = state
        packed = packed.cpu().numpy()
        return unpack(packed, imgids, raw_sizes)

    @classmethod
    def forward(cls, model, batch: Mapping[str, Any], **kwargs):
        return cls.forward_collect(model, cls.forward_dispatch(model, batch, **kwargs))


def unpack(packed: np.ndarray, imgids: List[str], raw_sizes: np.ndarray) -> List[Dict[str, Any]]:
    """The packed (B, D, dim + 6) step output -> one Arrow entry an image:
    features, boxes rounded to whole raw pixels, object and attribute ids,
    the raw (h, w)."""
    dim = packed.shape[-1] - 6
    obj_ids = packed[..., dim + 4].astype(np.int64)
    attr_ids = packed[..., dim + 5].astype(np.int64)
    return [
        {
            V.imgid: imgid,
            "object_ids": obj_ids[i].tolist(),
            "attr_ids": attr_ids[i].tolist(),
            V.features: packed[i, :, :dim],
            V.boxes: np.round(packed[i, :, dim : dim + 4]).tolist(),
            V.rawsize: [int(x) for x in raw_sizes[i]],
        }
        for i, imgid in enumerate(imgids)
    ]
