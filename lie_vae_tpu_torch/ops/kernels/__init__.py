"""Hand-written CUDA kernels for the Lie-group hot path and the
decoder's transposed-conv weight gradient, with wrappers that take the
plain PyTorch version for CPU tensors."""
from lie_vae_tpu_torch.ops.kernels.deconv_wgrad import (  # noqa: F401
    deconv_wgrad)
from lie_vae_tpu_torch.ops.kernels.so3_density import (  # noqa: F401
    so3_wrapped_kl_fused, so3_wrapped_log_density_fused)
from lie_vae_tpu_torch.ops.kernels.wigner_fused import (  # noqa: F401
    block_wigner_matrix_multiply_fused)
from lie_vae_tpu_torch.ops.kernels.wigner_block import (  # noqa: F401
    block_wigner_matrix_multiply_pallas)

KERNEL_COUNTERS = ("launches", "launches_residuals", "launches_backward",
                   "density_launches", "density_launches_backward",
                   "block_launches", "block_launches_backward",
                   "deconv_launches")


def kernel_counts():
    """The wrappers' launch counts (K1-K7), by the names of
    ``KERNEL_COUNTERS``."""
    wrappers = (("", block_wigner_matrix_multiply_fused),
                ("density_", so3_wrapped_log_density_fused),
                ("block_", block_wigner_matrix_multiply_pallas),
                ("deconv_", deconv_wgrad))
    return {prefix + attr: getattr(fn, attr) for prefix, fn in wrappers
            for attr in ("launches", "launches_residuals",
                         "launches_backward") if hasattr(fn, attr)}
