"""Regularizer losses: the SO(2)-subgroup equivariance loss and the encoder
continuity loss on consecutive-pose pairs."""
from lie_vae_tpu_torch.losses.continuity import (  # noqa: F401
    encoder_continuity_loss)
from lie_vae_tpu_torch.losses.equivariance import (  # noqa: F401
    ROTATE_IMPLS, equivariance_loss, rotate_images, rotate_images_shear)
