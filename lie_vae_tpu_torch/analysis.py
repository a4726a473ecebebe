"""Analysis tools: latent-space trajectories, the encoder-discontinuity
metric and PCA, the programmatic equivalent of the reference's results
notebook (toy_results.ipynb: the 'circle' and 'random_walk' trajectory
generators and the ``discontinuities`` per-step encoding-jump metric,
cells 3, 11-14).

Counterpart of the JAX package's ``analysis.py``, with two translations:

- noise is an input: :func:`random_walk_trajectory` takes its standard
  normal increments ``eps`` (n, 3) or draws them from a ``torch.Generator``
  (JAX: a PRNG key);
- a flax model is cloned with ``deterministic=True`` (or another
  ``density_k``); a PyTorch model is changed in place and put back:
  :func:`evaluating` sets eval mode, the ``deterministic`` flags and the
  SO(3) density's shell count for a block and restores each module's
  mode, flags and ``k`` afterwards, on an exception too.
  :func:`encode_dataset` and :func:`reconstruction_error` run the
  posterior-mean path inside it.

The model runs on its own device in IEEE float32 (``precision``);
encodings and errors come back as numpy. ``cli/analyze_spherecube.py``
shows the whole flow on sphere-cube renders.
"""
import contextlib

import numpy as np
import torch

from lie_vae_tpu_torch import ops
from lie_vae_tpu_torch.models.reparameterize import SO3Reparameterize
from lie_vae_tpu_torch.precision import ieee_float32


def _tensor(x, dtype=None):
    """``x`` as a tensor (a copy of an array: JAX's are read-only)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.tensor(np.asarray(x), dtype=dtype)


def circle_trajectory(n, axis=(0.0, 0.0, 1.0), start=None):
    """n rotations sweeping a full turn about ``axis``, starting at
    ``start`` (identity by default), float32 (n, 3, 3).

    Notebook equivalent: the 'circle' trajectory (toy_results.ipynb cell 3).
    """
    axis = np.asarray(axis, dtype=np.float32)
    axis = axis / np.linalg.norm(axis)
    angles = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False,
                         dtype=np.float32)
    g = ops.expmap(torch.as_tensor(angles[:, None] * axis[None, :]))
    if start is not None:
        g = _tensor(start, g.dtype) @ g
    return g


def random_walk_trajectory(n, step=0.1, start=None, eps=None,
                           generator=None):
    """Random walk on SO(3): g_{t+1} = g_t exp(step * eps_t), eps_t standard
    normal (n, 3): ``eps`` as given (its dtype kept), else float32 drawn
    from ``generator``. Returns (n, 3, 3), the first step already taken.

    Notebook equivalent: the 'random_walk' trajectory (cell 3).
    """
    if eps is None:
        eps = torch.randn((n, 3), generator=generator)
    eps = _tensor(eps)
    if eps.shape != (n, 3):
        raise ValueError(f"eps {tuple(eps.shape)}, expected ({n}, 3)")
    increments = ops.expmap(eps * step)
    g = (torch.eye(3, dtype=eps.dtype) if start is None
         else _tensor(start, eps.dtype))
    traj = []
    for inc in increments:
        g = g @ inc
        traj.append(g)
    return torch.stack(traj)


def toy_inputs_for_trajectory(traj, harmonics, degrees, impl="fused"):
    """Toy observations x = W(g) @ harmonics along a trajectory, (n, S, C),
    on the trajectory's device. ``impl`` as
    ``ops.block_wigner_matrix_multiply``'s: on CUDA tensors 'fused' is the
    Wigner chain kernel K1 and 'pallas' the synthesise-then-apply kernel
    K5."""
    traj = _tensor(traj)
    angles = ops.group_matrix_to_eazyz(traj)
    spectrum = torch.as_tensor(harmonics, dtype=traj.dtype,
                               device=traj.device)
    return ops.block_wigner_matrix_multiply(angles, spectrum, degrees,
                                            impl=impl)


@contextlib.contextmanager
def evaluating(model, deterministic=False, density_k=None):
    """A block in which ``model`` is in eval mode, with every
    ``deterministic`` flag set when ``deterministic`` (the posterior mean,
    no noise) and the SO(3) density's shell count ``density_k`` when given;
    every module's mode, flags and ``k`` are restored on the way out."""
    modules = list(model.modules())
    modes = [m.training for m in modules]
    flags = [(m, m.deterministic) for m in modules
             if hasattr(m, "deterministic")]
    shells = [(m, m.k) for m in modules if isinstance(m, SO3Reparameterize)]
    model_k = getattr(model, "density_k", None)
    try:
        model.eval()
        if deterministic:
            for m, _ in flags:
                m.deterministic = True
        if density_k is not None:
            for m, _ in shells:
                m.k = density_k
            model.density_k = density_k
        yield model
    finally:
        for m, mode in zip(modules, modes):
            m.training = mode
        for m, flag in flags:
            m.deterministic = flag
        for m, k in shells:
            m.k = k
        if density_k is not None:
            model.density_k = model_k


def model_inputs(model, x):
    """A batch on the model's device in its dtype, uint8 scaled to [0, 1]."""
    p = next(model.parameters())
    x = torch.as_tensor(np.asarray(x), device=p.device)
    return x.to(p.dtype) / 255.0 if x.dtype == torch.uint8 else x.to(p.dtype)


@torch.no_grad()
@ieee_float32()
def encode_dataset(model, xs, batch_size=256):
    """Mean-path encodings (first reparameterizer) of the inputs ``xs``
    (images or toy spectra, a batch axis first): flattened (N, D) numpy in
    the model's dtype. The posterior mean (:func:`evaluating` with
    ``deterministic``), so sampling noise does not pollute the
    discontinuity statistics."""
    outs = []
    with evaluating(model, deterministic=True):
        for i in range(0, len(xs), batch_size):
            z = model.encode(model_inputs(model, xs[i:i + batch_size]),
                             n=1)[0].z[0]
            outs.append(z.reshape(z.shape[0], -1).cpu().numpy())
    return np.concatenate(outs, 0)


def discontinuity_score(encodings):
    """Per-step squared encoding jumps along a trajectory: the notebook's
    ``discontinuities`` metric (cells 3 + 14). Returns (jumps, summary dict).
    """
    e = np.asarray(encodings)
    e = e.reshape(e.shape[0], -1)
    jumps = np.sum((e[1:] - e[:-1]) ** 2, axis=-1)
    return jumps, {
        "mean": float(jumps.mean()),
        "max": float(jumps.max()),
        # a discontinuity shows up as a jump orders of magnitude above the
        # median step; count >10x-median outliers
        "num_outliers": int((jumps > 10.0 * np.median(jumps)).sum()),
    }


def encodings_to_group_matrices(encodings, latent_mode):
    """Flattened mean-path encodings as rotation matrices (N, 3, 3), per
    latent mode, in the encodings' dtype: 'so3' encodings are matrices;
    'vmfq' S^3 encodings map through the quaternion chart; 3-dim 'normal'
    encodings through the tanh-squashed ZYZ Euler chart the action decoder
    uses (notebook cell 13). 'vmf' raises: that mode's S^3 latent never
    passes through the quaternion chart in the model (it is MLP-decoded),
    so a quaternion reading would render poses the decoder never sees."""
    e = _tensor(encodings)
    if latent_mode == "so3":
        return e.reshape(-1, 3, 3)
    if latent_mode == "vmfq":
        return ops.quaternions_to_group_matrix(e.reshape(-1, 4))
    if latent_mode == "normal":
        if e.shape[-1] != 3:
            raise ValueError(
                "only 3-dim normal latents have a rotation interpretation")
        return ops.eazyz_to_group_matrix(ops.vector_to_eazyz(e))
    if latent_mode == "vmf":
        raise ValueError(
            "latent_mode='vmf' encodings have no rotation interpretation "
            "(the model MLP-decodes the S^3 latent directly); use 'vmfq'")
    raise ValueError(f"unknown latent_mode {latent_mode!r}")


def render_encoded_poses(rotations, size=64, align_to=None, style="v1"):
    """Render the sphere-cube at the poses an encoder assigns along a
    trajectory, the in-repo renderer in place of the notebook's Blender
    ``render_axes`` strips (cell 13). ``align_to`` (a (3, 3) rotation)
    left-aligns the strip so its first pose equals ``align_to``, as the
    notebook aligns every model's strip to a common base pose. Returns
    float32 (N, size, size, 3)."""
    from lie_vae_tpu_torch.data.render import render_spherecube

    R = np.asarray(rotations, dtype=np.float32).reshape(-1, 3, 3)
    if align_to is not None:
        d = np.asarray(align_to, dtype=np.float32) @ R[0].T
        R = d[None] @ R
    return render_spherecube(R, size=size, style=style)


def pca(x, n_components=2):
    """SVD-based PCA; returns (projections (N, k), components (k, D))."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean(0, keepdims=True)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    return (u[:, :n_components] * s[:n_components],
            vt[:n_components])


@torch.no_grad()
@ieee_float32()
def reconstruction_error(model, xs, batch_size=256):
    """Mean per-example reconstruction loss on the posterior-mean path
    (:func:`evaluating` with ``deterministic``)."""
    errs = []
    with evaluating(model, deterministic=True):
        for i in range(0, len(xs), batch_size):
            x = model_inputs(model, xs[i:i + batch_size])
            x_recon, _ = model(x, n=1)
            errs.append(model.recon_loss(x_recon, x).reshape(-1).cpu())
    return float(torch.cat(errs).double().mean())
