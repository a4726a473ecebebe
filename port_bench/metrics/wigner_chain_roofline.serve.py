"""K1's share of its roofline: the least time of the Wigner chain at the
request's batch (``harness.counts.chain_bound``), one a traced request,
against the device time of ``wigner_chain_fwd`` kernels."""
from port_bench.harness import counts


def read(ctx):
    if ctx.kind != "serve" or ctx.trace is None:
        return None
    seconds, n = ctx.trace.seconds(r"wigner_chain_fwd_kernel")
    if n == 0:
        return None
    m = ctx.config["model"]
    need = counts.chain_bound(ctx.rows, m["degrees"], m["rep_copies"],
                              True) * ctx.traced_requests
    return 100.0 * need / seconds
