"""Offline inference throughput: every item collected in the window over
the whole window (a document in labelling)."""


def read(ctx, window, trace):
    if window.get("kind") != "infer" or window["seconds"] <= 0:
        return None
    return window["items"] / window["seconds"]
