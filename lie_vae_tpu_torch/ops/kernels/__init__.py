"""Hand-written CUDA kernels for the Lie-group hot path, with wrappers
that take the plain PyTorch version for CPU tensors."""
from lie_vae_tpu_torch.ops.kernels.so3_density import (  # noqa: F401
    so3_wrapped_log_density_fused)
from lie_vae_tpu_torch.ops.kernels.wigner_fused import (  # noqa: F401
    block_wigner_matrix_multiply_fused)
from lie_vae_tpu_torch.ops.kernels.wigner_block import (  # noqa: F401
    block_wigner_matrix_multiply_pallas)
