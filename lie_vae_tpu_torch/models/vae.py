"""The Lie-group VAE: conv encoder -> SO(3) latent -> action decoder.

Counterpart of ``LieVAE`` in the JAX package's ``models/vae.py``, for the
configuration the serving slice runs: ``latent_mode='so3'``,
``decoder_mode='action'``, ``encode_mode='conv'``, ``deconv_mode='deconv'``.
Other modes raise ``NotImplementedError``.

``kernel_impl`` picks the implementation of the two Lie-group hot ops, the
Wigner action of the decoder and the SO(3) posterior density, as the JAX
model's knob does. The port's default is ``'fused'``: on CUDA tensors the
Wigner chain kernels (K1, K2) and the density kernels (K3, K4).
``'pallas'`` takes the synthesise-then-apply Wigner kernels (K5, K6) and
the density kernels; ``'auto'`` routes as ``'fused'``. ``'xla'``, the JAX
model's default, is the plain PyTorch ops on any device, and runs only when
a caller names it. CPU tensors take the plain ops whatever the knob says.

Images are NHWC at the public methods, as in the JAX package, and permuted
to NCHW once inside. Train or eval mode is the module's (``model.train()``
/ ``model.eval()``): it decides whether BatchNorm normalises with batch
statistics and updates its running ones.
"""
import math

import torch
from torch import nn

from lie_vae_tpu_torch import ops
from lie_vae_tpu_torch.models.decoders import ActionDecoder
from lie_vae_tpu_torch.models.nets import ConvEncoder, DeconvNet
from lie_vae_tpu_torch.models.reparameterize import SO3Reparameterize

_PORTED = {"latent_mode": "so3", "decoder_mode": "action",
           "encode_mode": "conv", "deconv_mode": "deconv"}


class LieVAE(nn.Module):
    """Homeomorphic VAE with an SO(3) latent and the group-action decoder.

    Submodule names and ``nn.Sequential`` indices are the original PyTorch
    reference's, so its ``state_dict`` loads once the duplicate
    ``rep_group.*`` keys are dropped (``compat.load_torch``).
    The model is built on ``device`` (default ``"cuda"``).
    """

    def __init__(self, latent_mode="so3", decoder_mode="action",
                 encode_mode="conv", deconv_mode="deconv", mean_mode="alg",
                 degrees=6, rep_copies=10, deconv_hidden=50, conv_hidden=50,
                 batch_norm=True, rgb=False, group_reparam_in_dims=10,
                 wigner_transpose=False, sigma_clamp=None, density_k=10,
                 kernel_impl="fused", device="cuda"):
        super().__init__()
        if kernel_impl not in ("fused", "pallas", "auto", "xla"):
            raise ValueError(f"unknown kernel_impl {kernel_impl!r} (expected "
                             "'fused', 'pallas', 'auto' or 'xla')")
        requested = {"latent_mode": latent_mode, "decoder_mode": decoder_mode,
                     "encode_mode": encode_mode, "deconv_mode": deconv_mode}
        for field, value in requested.items():
            ported = _PORTED[field]
            if value != ported:
                raise NotImplementedError(
                    f"{field}={value!r} is not ported yet; the port serves "
                    f"{field}={ported!r} (ROADMAP.md, Queue A)")
        self.latent_mode = latent_mode
        self.mean_mode = mean_mode
        self.degrees = degrees
        self.rep_copies = rep_copies
        self.rgb = rgb
        self.density_k = density_k
        self.kernel_impl = kernel_impl
        in_dims = group_reparam_in_dims
        self.encoder = ConvEncoder(in_dims, hidden_dims=conv_hidden, rgb=rgb,
                                   batch_norm=batch_norm)
        self.reparameterize = nn.ModuleList([SO3Reparameterize(
            in_dims, mean_mode=mean_mode, sigma_clamp=sigma_clamp,
            k=density_k, density_impl=kernel_impl)])
        matrix_dims = (degrees + 1) ** 2
        self.decoder = ActionDecoder(
            degrees, DeconvNet(matrix_dims * rep_copies, deconv_hidden,
                               rgb=rgb),
            rep_copies=rep_copies, transpose=wigner_transpose,
            wigner_impl=kernel_impl)
        self.to(device)

    @property
    def out_shape(self):
        return (64, 64, 3 if self.rgb else 1)

    def encode(self, x, n=1, eps=None, generator=None):
        """NHWC images (B, 64, 64, C) -> list of one :class:`SO3Stats`
        with n samples. ``eps`` (n, B, 3) fixes the noise; otherwise it is
        drawn from ``generator``."""
        h = self.encoder(x.permute(0, 3, 1, 2))
        return [r(h, n, eps=eps, generator=generator)
                for r in self.reparameterize]

    def decode(self, z_pose):
        """(n, B, 3, 3) rotations -> (n, B, 64, 64, C) NHWC images."""
        n, b = z_pose.shape[:2]
        angles = ops.group_matrix_to_eazyz(z_pose.reshape(-1, 3, 3))
        x = self.decoder(angles).permute(0, 2, 3, 1)
        return x.reshape((n, b) + self.out_shape)

    def forward(self, x, n=1, eps=None, generator=None):
        """encode, sample, decode: returns (x_recon (n, B, ...), stats)."""
        stats = self.encode(x, n=n, eps=eps, generator=generator)
        return self.decode(stats[0].z), stats

    @staticmethod
    def recon_loss(x_recon, x):
        """Sum-of-squares reconstruction error over the image dims, (n, B)."""
        sq = (x_recon - x.expand_as(x_recon)) ** 2
        return torch.sum(sq, dim=tuple(range(2, sq.dim())))

    @staticmethod
    def kl(stats):
        """Per-reparameterizer KLs, each (B,)."""
        return [s.kl() for s in stats]

    def elbo(self, x, n=1, eps=None, generator=None):
        """Returns (recon_loss (n, B), kl_summed (B,), kls, stats)."""
        x_recon, stats = self(x, n=n, eps=eps, generator=generator)
        kls = self.kl(stats)
        recon = self.recon_loss(x_recon, x)
        return recon, sum(kls), kls, stats

    def log_weights(self, x, n=1, eps=None, generator=None):
        """Per-sample importance log-weights log p(x|z) + log p(z) -
        log q(z|x), (n, B): the inner term of the IWAE estimator. Runs in the
        module's mode (the harness evaluates in ``eval()``)."""
        x_recon, stats = self(x, n=n, eps=eps, generator=generator)
        log_p_z = sum(s.log_prior() for s in stats)
        log_q_z_x = sum(s.log_posterior() for s in stats)
        return -self.recon_loss(x_recon, x) + log_p_z - log_q_z_x

    def log_likelihood(self, x, n=1, eps=None, generator=None):
        """IWAE importance-sampled log-likelihood estimate, the mean over
        the batch of logsumexp_n(log_weights) - log n; a 0-dim tensor."""
        w = self.log_weights(x, n=n, eps=eps, generator=generator)
        return torch.mean(torch.logsumexp(w, dim=0) - math.log(float(n)))


def flagship_model(device="cuda", sigma_clamp=None, kernel_impl="fused"):
    """The flagship configuration (the JAX package's
    ``__graft_entry__._flagship_model``): SO(3) latent with the S2xS2 mean,
    L = 6 with 10 copies, conv width 50, deconv width 200, RGB, BatchNorm;
    ``sigma_clamp`` an upper clamp on the posterior's algebra sigma
    (``bench.py`` trains with pi * 10 / 2); ``kernel_impl`` as
    :class:`LieVAE`'s."""
    return LieVAE(latent_mode="so3", decoder_mode="action", mean_mode="s2s2",
                  encode_mode="conv", deconv_mode="deconv", degrees=6,
                  rep_copies=10, deconv_hidden=200, conv_hidden=50, rgb=True,
                  batch_norm=True, sigma_clamp=sigma_clamp,
                  kernel_impl=kernel_impl, device=device)
