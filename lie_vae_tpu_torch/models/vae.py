"""The Lie-group VAE: encoder -> latent -> decoder, from config strings.

Counterpart of ``LieVAE`` in the JAX package's ``models/vae.py``, with its
config strings:

- ``latent_mode``: ``'so3'`` | ``'normal'`` | ``'vmf'`` | ``'vmfq'`` (the
  von Mises-Fisher latent on S^3; ``'vmf'`` decodes the unit 4-vector
  through the MLP decoder, ``'vmfq'`` reads it as a quaternion and decodes
  its Euler angles through the action decoder);
- ``decoder_mode``: ``'action'`` | ``'mlp'``;
- ``encode_mode``: ``'conv'`` | ``'toy'`` (an ``MLP(in, 100, 2)`` on the
  flattened spectrum);
- ``deconv_mode``: ``'deconv'`` | ``'toy'`` (no deconv head: the decoder's
  spectrum (B, (L+1)^2, C) is the reconstruction);
- ``mean_mode``: ``'alg'`` | ``'q'`` | ``'s2s1'`` | ``'s2s2'``.

``kernel_impl`` picks the implementation of the two Lie-group hot ops, the
Wigner action of the decoder and the SO(3) posterior density, as the JAX
model's knob does. The port's default is ``'fused'``: on CUDA tensors the
Wigner chain kernels (K1, K2) and the density kernels (K3, K4).
``'pallas'`` takes the synthesise-then-apply Wigner kernels (K5, K6) and
the density kernels; ``'auto'`` routes as ``'fused'``. ``'xla'``, the JAX
model's default, is the plain PyTorch ops on any device, and runs only when
a caller names it. CPU tensors take the plain ops whatever the knob says.

``compute_dtype`` (``'bfloat16'`` for the tensor cores; None: float32) is
the compute dtype of the conv, transpose-conv and MLP stacks, with the
per-stack overrides ``encoder_dtype``, ``decoder_dtype`` and
``deconv_head_dtype`` (the image head alone), each a dtype name or
``'unset'`` (follow ``compute_dtype``; the head follows the decoder). The
parameters, the Lie-group math, the densities and the losses stay float32,
so the kernels K1-K6 run in float32 whatever the stacks do.

Images are NHWC at the public methods, as in the JAX package, and permuted
to NCHW once inside. Train or eval mode is the module's (``model.train()``
/ ``model.eval()``): it decides whether BatchNorm normalises with batch
statistics and updates its running ones.
"""
import math

import torch
from torch import nn

from lie_vae_tpu_torch import ops
from lie_vae_tpu_torch.models.decoders import ActionDecoder, MLPDecoder
from lie_vae_tpu_torch.models.nets import MLP, ConvEncoder, DeconvNet
from lie_vae_tpu_torch.models.reparameterize import (NormalReparameterize,
                                                     SO3Reparameterize,
                                                     VmfReparameterize)

# bench.py's sigma clamp: the k = 10 wrapped density's validity bound
BENCH_SIGMA_CLAMP = math.pi * 10 / 2


def _dtype(name):
    """A dtype name ('bfloat16', 'float32', ...) as a torch dtype; None or
    'none' as None."""
    if name is None or name == "none":
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


class LieVAE(nn.Module):
    """Homeomorphic VAE with a Lie-group, Gaussian or vMF latent.

    Submodule names and ``nn.Sequential`` indices are the original PyTorch
    reference's, so its ``state_dict`` loads once the duplicate
    ``rep_group.*`` keys are dropped (``compat.load_torch``).
    ``fixed_item_rep`` ((L+1)^2, C) is the action decoder's constant
    spectrum; ``r_callback`` a tuple of callables, one per reparameterizer,
    applied to the encoder's features before it. The model is built on
    ``device`` (default ``"cuda"``).
    """

    def __init__(self, latent_mode="so3", decoder_mode="action",
                 encode_mode="conv", deconv_mode="deconv", mean_mode="alg",
                 degrees=6, rep_copies=10, deconv_hidden=50, conv_hidden=50,
                 batch_norm=True, rgb=False, group_reparam_in_dims=10,
                 normal_dims=3, deterministic=False, fixed_item_rep=None,
                 wigner_transpose=False, mlp_layers=3, mlp_hidden=50,
                 mlp_activation="relu", fixed_sigma=None, sigma_clamp=None,
                 compute_dtype=None, encoder_dtype="unset",
                 decoder_dtype="unset", deconv_head_dtype="unset",
                 density_k=10, r_callback=None, kernel_impl="fused",
                 device="cuda"):
        super().__init__()
        if kernel_impl not in ("fused", "pallas", "auto", "xla"):
            raise ValueError(f"unknown kernel_impl {kernel_impl!r} (expected "
                             "'fused', 'pallas', 'auto' or 'xla')")
        self.latent_mode = latent_mode
        self.decoder_mode = decoder_mode
        self.encode_mode = encode_mode
        self.deconv_mode = deconv_mode
        self.mean_mode = mean_mode
        self.degrees = degrees
        self.rep_copies = rep_copies
        self.rgb = rgb
        self.normal_dims = normal_dims
        self.deterministic = deterministic
        self.density_k = density_k
        self.kernel_impl = kernel_impl
        self.r_callback = r_callback
        in_dims = self._in_dims(group_reparam_in_dims)

        def follow(override):
            return (_dtype(compute_dtype) if override == "unset"
                    else _dtype(override))

        cdt_enc, cdt_dec = follow(encoder_dtype), follow(decoder_dtype)
        hdt = (cdt_dec if deconv_head_dtype == "unset"
               else _dtype(deconv_head_dtype))

        if encode_mode == "conv":
            self.encoder = ConvEncoder(in_dims, hidden_dims=conv_hidden,
                                       rgb=rgb, batch_norm=batch_norm,
                                       dtype=cdt_enc)
        elif encode_mode == "toy":
            # the reference's Sequential(Flatten, MLP): keys encoder.1.*
            self.encoder = nn.Sequential(
                nn.Flatten(),
                MLP((degrees + 1) ** 2 * rep_copies, in_dims, 100, 2,
                    mlp_activation, dtype=cdt_enc))
        else:
            raise ValueError("Wrong encode mode")

        if latent_mode == "so3":
            rep = SO3Reparameterize(
                in_dims, mean_mode=mean_mode, sigma_clamp=sigma_clamp,
                k=density_k, density_impl=kernel_impl,
                fixed_sigma=fixed_sigma, deterministic=deterministic)
        elif latent_mode == "normal":
            rep = NormalReparameterize(in_dims, normal_dims,
                                       deterministic=deterministic)
        elif latent_mode in ("vmf", "vmfq"):
            rep = VmfReparameterize(in_dims, 4, deterministic=deterministic)
        else:
            raise ValueError("Wrong latent mode")
        self.reparameterize = nn.ModuleList([rep])

        matrix_dims = (degrees + 1) ** 2
        if deconv_mode == "deconv":
            deconv = DeconvNet(matrix_dims * rep_copies, deconv_hidden,
                               rgb=rgb, dtype=cdt_dec, head_dtype=hdt)
        elif deconv_mode == "toy":
            deconv = None
        else:
            raise ValueError("Wrong deconv mode")

        if decoder_mode == "action":
            self.decoder = ActionDecoder(
                degrees, deconv, rep_copies=rep_copies,
                transpose=wigner_transpose, wigner_impl=kernel_impl,
                fixed_item_rep=fixed_item_rep)
        elif decoder_mode == "mlp":
            self.decoder = MLPDecoder(
                degrees, deconv, in_dims=self.group_dims,
                rep_copies=rep_copies, layers=mlp_layers,
                hidden_dims=mlp_hidden, activation=mlp_activation,
                dtype=cdt_dec)
        else:
            raise ValueError("Wrong decoder mode")
        self.to(device)

    def _in_dims(self, in_dims):
        # the reference avoids a bottleneck for Gaussian latents
        if self.latent_mode == "normal":
            if self.decoder_mode != "mlp" and self.normal_dims != 3:
                raise ValueError("Normal Action must be 3 dim")
            in_dims = max(in_dims, self.normal_dims)
        if self.latent_mode == "vmf" and self.decoder_mode == "action":
            # the 4-dim S^3 latent has no Euler chart ('vmfq' is the
            # quaternion chart meant for the action decoder)
            raise ValueError(
                "latent_mode='vmf' has no Euler chart for the action "
                "decoder; use decoder_mode='mlp' or latent_mode='vmfq'")
        return in_dims

    @property
    def out_shape(self):
        if self.deconv_mode == "toy":
            return ((self.degrees + 1) ** 2, self.rep_copies)
        return (64, 64, 3 if self.rgb else 1)

    @property
    def group_dims(self):
        """Width of a flattened latent sample: 9 (a rotation matrix),
        ``normal_dims``, or 4 (a unit 4-vector for ``vmf``/``vmfq``)."""
        return {"so3": 9, "normal": self.normal_dims, "vmf": 4,
                "vmfq": 4}[self.latent_mode]

    @property
    def is_vmf(self):
        """Whether the latent is von Mises-Fisher, whose noise is a pair."""
        return self.latent_mode in ("vmf", "vmfq")

    @property
    def noise_dims(self):
        """Width of the standard-normal noise one posterior sample takes:
        3 (the so(3) algebra), ``normal_dims``, or for vMF 4, the width of
        the tangent normal beside the accepted Beta draw; None when
        ``deterministic`` (no noise is drawn)."""
        if self.deterministic:
            return None
        return {"so3": 3, "normal": self.normal_dims, "vmf": 4,
                "vmfq": 4}[self.latent_mode]

    def encode(self, x, n=1, eps=None, generator=None):
        """Inputs (B, *out_shape): NHWC images, or toy spectra (B, S, C) ->
        a list of one stats struct with n samples (:class:`SO3Stats`,
        :class:`GaussianStats` or :class:`VonMisesFisherStats`). ``eps``
        fixes the noise: a standard normal (n, B, noise_dims), or for vMF
        the pair (accepted Beta draw (n, B), tangent normal (n, B, 4));
        otherwise it is drawn from ``generator`` (for vMF the accept/reject
        runs on the device, against the detached kappa)."""
        if self.encode_mode == "toy":
            h = self.encoder(x.reshape(x.shape[0], -1))
        else:
            h = self.encoder(x.permute(0, 3, 1, 2))
        feats = ([f(h) for f in self.r_callback]
                 if self.r_callback is not None
                 else [h] * len(self.reparameterize))
        return [r(f, n, eps=eps, generator=generator)
                for r, f in zip(self.reparameterize, feats)]

    def decode(self, z_pose):
        """(n, B, ...) latent samples ((3, 3) rotations, ``normal_dims``
        vectors or unit 4-vectors) -> (n, B, *out_shape); ``vmfq`` reads
        its samples as quaternions."""
        n, b = z_pose.shape[:2]
        z = z_pose.reshape((n * b,) + tuple(z_pose.shape[2:]))
        if self.decoder_mode == "action":
            if self.latent_mode == "so3":
                angles = ops.group_matrix_to_eazyz(z)
            elif self.latent_mode == "vmfq":
                angles = ops.quaternions_to_eazyz(z)
            else:
                angles = ops.vector_to_eazyz(z)
            x = self.decoder(angles)
        else:
            x = self.decoder(z)
        if self.deconv_mode == "deconv":
            x = x.permute(0, 2, 3, 1)
        return x.reshape((n, b) + self.out_shape)

    def forward(self, x, n=1, eps=None, generator=None):
        """encode, sample, decode: returns (x_recon (n, B, ...), stats);
        ``eps`` and ``generator`` as :meth:`encode`'s."""
        stats = self.encode(x, n=n, eps=eps, generator=generator)
        return self.decode(stats[0].z), stats

    @staticmethod
    def recon_loss(x_recon, x):
        """Sum-of-squares reconstruction error over the output dims, (n, B)."""
        sq = (x_recon - x.expand_as(x_recon)) ** 2
        return torch.sum(sq, dim=tuple(range(2, sq.dim())))

    @staticmethod
    def kl(stats):
        """Per-reparameterizer KLs, each (B,)."""
        return [s.kl() for s in stats]

    def elbo(self, x, n=1, eps=None, generator=None):
        """Returns (recon_loss (n, B), kl_summed (B,), kls, stats); ``eps``
        and ``generator`` as :meth:`encode`'s."""
        x_recon, stats = self(x, n=n, eps=eps, generator=generator)
        kls = self.kl(stats)
        recon = self.recon_loss(x_recon, x)
        return recon, sum(kls), kls, stats

    def log_weights(self, x, n=1, eps=None, generator=None):
        """Per-sample importance log-weights log p(x|z) + log p(z) -
        log q(z|x), (n, B): the inner term of the IWAE estimator, with each
        latent's ``log_prior`` and ``log_posterior`` (the uniform on S^3 and
        the vMF density for vMF). Runs in the module's mode (the harness
        evaluates in ``eval()``); ``eps`` and ``generator`` as
        :meth:`encode`'s."""
        x_recon, stats = self(x, n=n, eps=eps, generator=generator)
        log_p_z = sum(s.log_prior() for s in stats)
        log_q_z_x = sum(s.log_posterior() for s in stats)
        return -self.recon_loss(x_recon, x) + log_p_z - log_q_z_x

    def log_likelihood(self, x, n=1, eps=None, generator=None):
        """IWAE importance-sampled log-likelihood estimate, the mean over
        the batch of logsumexp_n(log_weights) - log n; a 0-dim tensor;
        ``eps`` and ``generator`` as :meth:`encode`'s."""
        w = self.log_weights(x, n=n, eps=eps, generator=generator)
        return torch.mean(torch.logsumexp(w, dim=0) - math.log(float(n)))


def flagship_model(device="cuda", sigma_clamp=None, kernel_impl="fused",
                   compute_dtype=None, encoder_dtype="unset",
                   decoder_dtype="unset", deconv_head_dtype="unset"):
    """The flagship configuration (the JAX package's
    ``__graft_entry__._flagship_model``): SO(3) latent with the S2xS2 mean,
    L = 6 with 10 copies, conv width 50, deconv width 200, RGB, BatchNorm;
    ``sigma_clamp`` an upper clamp on the posterior's algebra sigma;
    ``kernel_impl`` and the dtypes as :class:`LieVAE`'s."""
    return LieVAE(latent_mode="so3", decoder_mode="action", mean_mode="s2s2",
                  encode_mode="conv", deconv_mode="deconv", degrees=6,
                  rep_copies=10, deconv_hidden=200, conv_hidden=50, rgb=True,
                  batch_norm=True, sigma_clamp=sigma_clamp,
                  compute_dtype=compute_dtype, encoder_dtype=encoder_dtype,
                  decoder_dtype=decoder_dtype,
                  deconv_head_dtype=deconv_head_dtype,
                  kernel_impl=kernel_impl, device=device)


def bench_model(device="cuda", kernel_impl="fused"):
    """The flagship as ``bench.py:128-133`` trains it, the JAX package's
    production recipe: bfloat16 conv and transpose-conv stacks, a float32
    image head, and the sigma clamp pi * 10 / 2. Its state_dict is the
    flagship's."""
    return flagship_model(device, sigma_clamp=BENCH_SIGMA_CLAMP,
                          kernel_impl=kernel_impl, compute_dtype="bfloat16",
                          deconv_head_dtype="float32")
