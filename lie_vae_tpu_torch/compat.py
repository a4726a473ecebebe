"""Carry weights into the port: from the JAX package's parameters, from its
``.npz`` deployment artifacts, and from the original PyTorch reference's
checkpoints.

The port's module tree has the reference's names and indices, so a
reference ``state_dict`` loads as it is once its duplicate ``rep_group.*``
keys (the reference registers its reparameterizer twice) are dropped. JAX
parameters arrive flat, under ``'/'``-joined paths as the JAX package's
``serve.export_npz`` writes them (``params/encoder/Conv_0/kernel``,
``batch_stats/encoder/BatchNorm_0/mean``, ...), and change layout on the
way:

- flax ``Dense`` kernel (in, out)            -> ``Linear`` weight (out, in)
- flax ``Conv`` kernel HWIO                  -> ``Conv2d`` weight OIHW
- flax ``ConvTranspose`` kernel (kh, kw, I, O) -> ``ConvTranspose2d``
  weight (I, O, kh, kw), spatially flipped
- BatchNorm scale / bias / mean / var        -> weight / bias / running stats
- a flax ``MLP``'s ``Dense_i``              -> ``Linear`` at Sequential
  index 2 i (the toy encoder at ``encoder.1``, the MLP decoder at
  ``decoder.mlp``)
"""
import numpy as np
import torch


def _identity(a):
    return a


def _linear(a):
    return np.transpose(a, (1, 0))


def _conv(a):
    return np.transpose(a, (3, 2, 0, 1))


def _deconv(a):
    return np.ascontiguousarray(
        np.transpose(a, (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _mlp_entries(port_prefix, jax_prefix, mlp):
    """An :class:`~lie_vae_tpu_torch.models.MLP`'s Linears (at Sequential
    indices 0, 2, ...) -> the flax MLP's ``Dense_i``."""
    m = {}
    linears = [i for i, mod in enumerate(mlp)
               if isinstance(mod, torch.nn.Linear)]
    for j, t in enumerate(linears):
        p = f"{jax_prefix}/Dense_{j}/"
        m[f"{port_prefix}.{t}.weight"] = (p + "kernel", _linear)
        m[f"{port_prefix}.{t}.bias"] = (p + "bias", _identity)
    return m


def _jax_key_mapping(model):
    """Port state_dict key -> (flat JAX path, transform) for a
    :class:`~lie_vae_tpu_torch.models.LieVAE`, and the set of the port's
    keys JAX has no parameter for (constants the port keeps as they are)."""
    m, own = {}, set()
    enc = model.encoder
    if model.encode_mode == "toy":
        m.update(_mlp_entries("encoder.1", "params/encoder", enc[1]))
    convs = [i for i, mod in enumerate(enc)
             if isinstance(mod, torch.nn.Conv2d)]
    bns = [i for i, mod in enumerate(enc)
           if isinstance(mod, torch.nn.BatchNorm2d)]
    for j, t in enumerate(convs):
        p = f"params/encoder/Conv_{j}/"
        m[f"encoder.{t}.weight"] = (p + "kernel", _conv)
        m[f"encoder.{t}.bias"] = (p + "bias", _identity)
    for j, t in enumerate(bns):
        p = f"params/encoder/BatchNorm_{j}/"
        s = f"batch_stats/encoder/BatchNorm_{j}/"
        m[f"encoder.{t}.weight"] = (p + "scale", _identity)
        m[f"encoder.{t}.bias"] = (p + "bias", _identity)
        m[f"encoder.{t}.running_mean"] = (s + "mean", _identity)
        m[f"encoder.{t}.running_var"] = (s + "var", _identity)

    rg = "params/rep_group/"
    rep = "reparameterize.0"
    if model.latent_mode == "so3":
        heads = ((("s2_map", "s2"), ("s1_map", "s1"))
                 if model.mean_mode == "s2s1" else (("map", "Dense_0"),))
        for name, path in heads:
            p = f"{rep}.mean_module.{name}."
            m[p + "weight"] = (f"{rg}mean/{path}/kernel", _linear)
            m[p + "bias"] = (f"{rg}mean/{path}/bias", _identity)
        inner = f"{rep}.reparameterize."
        if model.reparameterize[0].reparameterize.fixed_sigma_value is None:
            m[inner + "sigma_linear.weight"] = (rg + "sigma/kernel", _linear)
            m[inner + "sigma_linear.bias"] = (rg + "sigma/bias", _identity)
        else:
            # the reference keeps an unused sigma head beside its
            # fixed_sigma buffer; JAX has neither
            own |= {inner + "sigma_linear.weight",
                    inner + "sigma_linear.bias", inner + "fixed_sigma"}
    else:
        for name, path in (("mu_linear", "mu/"), ("sigma_linear", "sigma/")):
            m[f"{rep}.{name}.weight"] = (rg + path + "kernel", _linear)
            m[f"{rep}.{name}.bias"] = (rg + path + "bias", _identity)

    dec = model.decoder
    if model.decoder_mode == "mlp":
        m.update(_mlp_entries("decoder.mlp", "params/decoder/MLP_0",
                              dec.mlp))
    elif isinstance(dec.item_rep, torch.nn.Parameter):
        m["decoder.item_rep"] = ("params/decoder/item_rep", _identity)
    else:
        own.add("decoder.item_rep")          # fixed_item_rep, a buffer
    if dec.deconv is not None:
        deconvs = [i for i, mod in enumerate(dec.deconv)
                   if isinstance(mod, torch.nn.ConvTranspose2d)]
        for j, t in enumerate(deconvs):
            p = f"params/decoder/deconv/ConvTranspose_{j}/"
            m[f"decoder.deconv.{t}.weight"] = (p + "kernel", _deconv)
            m[f"decoder.deconv.{t}.bias"] = (p + "bias", _identity)
    return m, own


def state_dict_from_jax(flat, model):
    """The port's ``state_dict`` for ``model`` from JAX parameters and batch
    statistics given as numpy arrays under flat ``'/'`` paths.

    Strict: an unknown or missing JAX path, or a shape that does not fit,
    raises ``ValueError``. What JAX keeps no parameter for keeps the
    model's own value: BatchNorm ``num_batches_tracked``, a
    ``fixed_item_rep`` and, with ``fixed_sigma``, its buffer and the
    reference's unused sigma head.
    """
    mapping, kept = _jax_key_mapping(model)
    own = model.state_dict()
    flat = {k: v for k, v in flat.items() if k != "__step__"}
    used = {path for path, _ in mapping.values()}
    unknown = sorted(set(flat) - used)
    missing = sorted(path for path in used if path not in flat)
    kept |= {k for k in own if k.endswith("num_batches_tracked")}
    unmapped = sorted(k for k in own if k not in mapping and k not in kept)
    bad = []
    out = {}
    for key, (path, transform) in mapping.items():
        if path not in flat or key not in own:
            continue
        value = torch.from_numpy(np.array(transform(np.asarray(flat[path])),
                                          dtype=np.float32))
        if value.shape != own[key].shape:
            bad.append(f"{path} -> {key}: {tuple(value.shape)} vs "
                       f"{tuple(own[key].shape)}")
        out[key] = value
    if unknown or missing or unmapped or bad:
        raise ValueError(
            "JAX parameters do not match the model config: unknown "
            f"{unknown}, missing {missing}, unmapped {unmapped}, "
            f"shape mismatches {bad}")
    for key in kept:
        out[key] = own[key].detach().cpu().clone()
    return out


def load_torch(path):
    """Read a reference checkpoint (a ``torch.save``'d state_dict) as a
    state_dict of the port: the duplicate ``rep_group.*`` registration of
    the reparameterizer is dropped. ``weights_only``: never unpickle code."""
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v for k, v in state_dict.items()
            if not k.startswith("rep_group.")}


def load_npz(path):
    """Read a JAX deployment artifact (``serve.export_npz``) with numpy:
    returns the flat ``'/'``-path dict, without the step counter."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__step__"}
