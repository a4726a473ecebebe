"""K3/K4's share of their roofline: the least time of the wrapped
density's KL and of its backward over the step's samples
(``harness.counts.density_bound``), a step's worth for every traced
step, against the device time of ``so3_density_kl``/``_bwd`` kernels."""
from port_bench.harness import counts


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    seconds, n = ctx.trace.seconds(r"so3_density_(kl|bwd)_kernel")
    if n == 0:
        return None
    k = ctx.config["model"]["density_k"]
    rows = ctx.rows * ctx.config["train"]["elbo_samples"]
    need = (counts.density_bound(rows, ctx.rows, k, False)
            + counts.density_bound(rows, ctx.rows, k, True)) \
        * ctx.traced_steps
    return 100.0 * need / seconds
