"""Set-up: the seconds from the process's start to the window's first
step or request (imports, the pool's renders, building the model or the
session, loading the kernels, compiling them on a first run, warm-up)."""


def read(ctx):
    return ctx.setup_s
