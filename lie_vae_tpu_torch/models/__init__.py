"""PyTorch networks, the latent reparameterizers, the decoders and the VAE
assembly."""
from lie_vae_tpu_torch.models.nets import (  # noqa: F401
    ACTIVATIONS, MLP, ConvEncoder, DeconvNet)
from lie_vae_tpu_torch.models.reparameterize import (  # noqa: F401
    AlgebraMean, QuaternionMean, S2S1Mean, S2S2Mean, MEAN_MODULES,
    N0Reparameterize, NormalReparameterize, SO3Reparameterize,
    VmfReparameterize)
from lie_vae_tpu_torch.models.decoders import (  # noqa: F401
    ActionDecoder, MLPDecoder)
from lie_vae_tpu_torch.models.vae import (  # noqa: F401
    LieVAE, bench_model, flagship_model)
