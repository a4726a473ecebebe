"""Serving throughput: the images of every request answered in the
window, over the window's host seconds."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    return ctx.images / ctx.window_s
