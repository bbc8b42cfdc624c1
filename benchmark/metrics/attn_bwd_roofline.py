"""The flash attention backward's share of its roofline: for every backward
of ``FlashAttentionFunction`` in the traced window, the least time of the
work its inputs need (five products over the real query-key pairs of each
row over the bf16 peak, or q, k, v, o and the output gradient read once and
the three input gradients written once over the memory rate) over the
device time under the autograd node, in percent."""

from benchmark.flops import attention_backward_flops, bound_s


def read(ctx, window, trace):
    if trace is None or not window.get("traced_work"):
        return None
    cfg, t = ctx.config, ctx.traffic
    ops = trace.ops(lambda name: name.startswith("autograd::engine::evaluate_function: FlashAttentionFunctionBackward"))
    layers, heads = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    if not ops or len(ops) != layers * len(window["traced_work"]):
        return None
    nbytes = 8 * t["batch"] * t["seq"] * cfg["hidden_size"] * 2
    bound = layers * sum(bound_s(nbytes, attention_backward_flops(w["pairs"], heads, cfg["hidden_size"] // heads))
                         for w in window["traced_work"])
    device = sum(ops)
    return 100.0 * bound / device if device > 0 else None
