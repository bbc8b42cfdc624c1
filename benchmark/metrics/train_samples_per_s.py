"""Training throughput: every sample stepped in the window over the whole
window, which ends with a synchronise."""


def read(ctx, window, trace):
    if window.get("kind") != "train" or window["seconds"] <= 0:
        return None
    return window["samples"] / window["seconds"]
