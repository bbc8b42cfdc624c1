"""``idle_share.<cells>``: the share of the measured window in which no
operation ran on the device, in percent: one less the device's busy seconds
an item, from the profiler's intervals over the traced steps, over the
seconds an item of the window's untraced part on the host clock. The
profiler's own host cost slows the traced steps; this leaves it out."""


def read(ctx, window, trace):
    if trace is None or not window.get("traced_items") or not window.get("untraced_items"):
        return None
    busy = trace.summary()["busy_s"] / window["traced_items"]
    wall = window["untraced_s"] / window["untraced_items"]
    return 100.0 * (1.0 - busy / wall) if busy > 0 and wall > 0 else None
