"""RoIPool's share of its roofline: the least time of the pooling of every
batch dispatched in the traced window (the res4 map read once, the boxes
read once, the pooled bins written once, over the memory rate; its max
comparisons are no FLOPs) over the device time under the op
``vltk_tpu_torch::roi_pool``, in percent. Counted from the shapes that the
configuration and the traffic give (the canvas over the feature stride,
``post_nms_topk`` boxes an image, 1024 channels), whatever kernel runs it."""

from benchmark.flops import bound_s

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(ctx, window, trace):
    if trace is None or not window.get("traced_work"):
        return None
    d = ctx.config["frcnn"]
    device = sum(trace.ops(lambda name: name == "vltk_tpu_torch::roi_pool"))
    if device <= 0:
        return None
    item, s, p = ITEMSIZE[d["dtype"]], d["pooler_resolution"], d["post_nms_topk"]
    h, w = (-(-x // d["feature_stride"]) for x in d["canvas"])
    c = d["res2_out_channels"] * 4
    bound = sum(bound_s(w_["images"] * (h * w * c * item + p * 4 * 4 + p * s * s * c * item), 0.0)
                for w_ in window["traced_work"])
    return 100.0 * bound / device
