"""A request's share of the H100's float32 peak while it is served: the
forward operations of its images (``harness.counts.forward_flops``) over
the seconds from its start to its answer, summed over the window's
requests (the wait for an arrival and in the queue left out)."""
from port_bench.harness import counts


def read(ctx):
    if ctx.kind != "serve" or not ctx.service_s:
        return None
    flops = counts.forward_flops(ctx.config["model"]) * ctx.images
    return 100.0 * flops / sum(ctx.service_s) / counts.FP32_FLOP_PER_S
