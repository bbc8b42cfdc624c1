"""The flash attention forward's share of its roofline: for every call of
the op ``vltk_tpu_torch::flash_attention`` in the traced window, the least
time of the work its inputs need (the FLOPs of the real query-key pairs
of each row over the bf16 peak, or q, k, v and o each once over the memory
rate) over the device time under the op, in percent."""

from benchmark.flops import attention_forward_flops, bound_s


def read(ctx, window, trace):
    if trace is None or not window.get("traced_work"):
        return None
    cfg, t = ctx.config, ctx.traffic
    ops = trace.ops(lambda name: name == "vltk_tpu_torch::flash_attention")
    layers, heads = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    if not ops or len(ops) != layers * len(window["traced_work"]):
        return None
    nbytes = 4 * t["batch"] * t["seq"] * cfg["hidden_size"] * 2
    bound = layers * sum(bound_s(nbytes, attention_forward_flops(w["pairs"], heads, cfg["hidden_size"] // heads))
                         for w in window["traced_work"])
    device = sum(ops)
    return 100.0 * bound / device if device > 0 else None
