"""Set-up: process start to the first measured item (loading, weights,
warm-up, and in a checkout's first run the kernel builds)."""


def read(ctx, window, trace):
    return ctx.notes.get("setup_s")
