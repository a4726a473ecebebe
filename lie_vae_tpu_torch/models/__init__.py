"""PyTorch networks, the SO(3) reparameterizer, the action decoder and the
VAE assembly."""
from lie_vae_tpu_torch.models.nets import ConvEncoder, DeconvNet  # noqa: F401
from lie_vae_tpu_torch.models.reparameterize import (  # noqa: F401
    AlgebraMean, QuaternionMean, S2S2Mean, MEAN_MODULES, SO3Reparameterize)
from lie_vae_tpu_torch.models.decoders import ActionDecoder  # noqa: F401
from lie_vae_tpu_torch.models.vae import LieVAE, flagship_model  # noqa: F401
