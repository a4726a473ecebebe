"""K2's share of its roofline: the least time of the Wigner chain with
residuals and of its backward at the step's batch
(``harness.counts.chain_res_bound`` + ``chain_bwd_bound``: bytes or
operations, whichever bounds), a step's worth for every traced step,
against the device time of ``wigner_chain_*`` kernels."""
from port_bench.harness import counts


def read(ctx):
    if ctx.kind != "train" or ctx.trace is None:
        return None
    seconds, n = ctx.trace.seconds(r"wigner_chain_(fwd|bwd|sum)_kernel")
    if n == 0:
        return None
    m = ctx.config["model"]
    args = (ctx.rows, m["degrees"], m["rep_copies"], True)
    need = (counts.chain_res_bound(*args) + counts.chain_bwd_bound(*args)) \
        * ctx.traced_steps
    return 100.0 * need / seconds
