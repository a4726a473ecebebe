"""The 95th percentile (numpy's linear interpolation) of a request's
service in the window: host clock, from the start of its call to its
numpy answer, its wait in the queue left out (above the knee the queue
grows all through the window, so the latency from arrival swings)."""
import numpy as np


def read(ctx):
    if ctx.kind != "serve" or not ctx.service_s:
        return None
    return 1e3 * float(np.percentile(ctx.service_s, 95))
