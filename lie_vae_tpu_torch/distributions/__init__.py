"""Latent distributions: explicit stats structs and reparameterised
samplers that take their noise as an argument."""
from lie_vae_tpu_torch.distributions.normal import (  # noqa: F401
    GaussianStats, ZeroMeanGaussianStats, sample_zero_mean_gaussian)
from lie_vae_tpu_torch.distributions.so3 import (  # noqa: F401
    LOG_HAAR_UNIFORM, SO3Stats, sample_so3, so3_wrapped_log_density,
    so3_wrapped_log_density_plain)
