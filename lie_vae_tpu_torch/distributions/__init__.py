"""Latent distributions: explicit stats structs and reparameterised
samplers that take their noise as an argument."""
from lie_vae_tpu_torch.distributions.normal import (  # noqa: F401
    GaussianStats, ZeroMeanGaussianStats, sample_zero_mean_gaussian)
from lie_vae_tpu_torch.distributions.so3 import (  # noqa: F401
    SO3Stats, sample_so3)
