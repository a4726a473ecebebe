"""The convolutions' share of their roofline in training: their
operations in the traced steps (forward, weight and input gradients,
``harness.counts.train_conv_flops``) over the float32 peak, against the
device time of the convolution kernels by name (cuDNN's fprop, dgrad and
wgrad engines and the layout transposes around them)."""
from port_bench.harness import counts
from port_bench.harness.trace import CONV_KERNELS


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    seconds, n = ctx.trace.seconds(CONV_KERNELS)
    if n == 0:
        return None
    flops = counts.train_conv_flops(
        ctx.config["model"], ctx.config["train"]["equivariance"] is not None)
    need = flops * ctx.rows * ctx.traced_steps / counts.FP32_FLOP_PER_S
    return 100.0 * need / seconds
