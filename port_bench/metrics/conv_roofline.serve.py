"""The convolutions' share of their roofline in serving: the forward
convolutions' operations of the traced requests' images over the float32
peak, against the device time of the convolution kernels by name."""
from port_bench.harness import counts
from port_bench.harness.trace import CONV_KERNELS


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    seconds, n = ctx.trace.seconds(CONV_KERNELS)
    if n == 0:
        return None
    flops = sum(l["flops"] for l in counts.conv_layers(ctx.config["model"]))
    need = flops * ctx.rows * ctx.traced_requests / counts.FP32_FLOP_PER_S
    return 100.0 * need / seconds
