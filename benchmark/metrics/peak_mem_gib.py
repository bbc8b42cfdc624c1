"""``peak_mem_gib.<cells>``: the device memory peak of the window
(allocated, reset at the window's start), in GiB."""


def read(ctx, window, trace):
    if not window["peak_bytes"]:
        return None
    return window["peak_bytes"] / 2 ** 30
