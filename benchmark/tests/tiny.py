"""Tiny overrides of the benchmark's cells, for runs on the CPU: the same
code paths at sizes a test can hold (the cells themselves keep the
published widths)."""

import json
import os
import time

import torch

from benchmark import harness

LAYOUTLM = {
    "config": {"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
               "max_position_embeddings": 64},
    "traffic": {"seq": 64, "batch": 4, "lengths": [24, 64], "pool_batches": 3, "total_steps": 20,
                "trace_seconds": 0.3},
}


def frcnn():
    with open(os.path.join(harness.BENCH_DIR, "configs", "vg_frcnn_lxmert_base.json")) as f:
        d = json.load(f)["frcnn"]
    d.update(depth=50, stem_out_channels=8, res2_out_channels=16, width_per_group=4, rpn_hidden_channels=16,
             num_classes=10, num_attrs=6, pre_nms_topk=200, post_nms_topk=20, min_detections=5, max_detections=5,
             canvas=[64, 96], short=48.0, maximum=80.0)
    return {"config": {"frcnn": d},
            "traffic": {"raw_canvas": [40, 56], "heights": [24, 40], "widths": [32, 56], "pool_images": 8,
                        "batch": 4, "trace_seconds": 0.3}}


def overrides(cell: str):
    return frcnn() if cell.startswith("extract.") else LAYOUTLM


def run(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0, trace: bool = False, variant=None):
    """One tiny run of ``cell`` on the CPU through the harness: (result,
    context)."""
    ctx = harness.cell_context(cell, seed, seconds, trace, overrides=overrides(cell))
    ctx.device, ctx.variant, ctx.t_start = torch.device("cpu"), variant, time.time()
    return harness.run(ctx), ctx
