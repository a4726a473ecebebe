"""Training throughput: every image of every step in the window, over the
window's host seconds from a synchronize before its first step to one
after its last."""


def read(ctx):
    if ctx.kind != "train":
        return None
    return ctx.images / ctx.window_s
