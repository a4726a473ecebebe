"""The whole training step's share of the H100's float32 peak (67
TFLOP/s, outside the tensor cores: the port runs IEEE float32): the
operations an image's forward and backward passes need, counted from the
model's shapes (``harness.counts.train_flops``: the encoder's again for
the equivariance loss's rotated images), times the window's images/s."""
from port_bench.harness import counts


def read(ctx):
    if ctx.kind != "train":
        return None
    flops = counts.train_flops(ctx.config["model"],
                               ctx.config["train"]["equivariance"]
                               is not None)
    return 100.0 * flops * ctx.images / ctx.window_s \
        / counts.FP32_FLOP_PER_S
