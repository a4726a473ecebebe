"""Checkpoints: the model's state_dict, the optimizer's state and the step
in one ``torch.save`` file.

Counterpart of the JAX package's ``train/checkpoint.py`` (orbax: params,
batch_stats, optimizer state and step), so a resumed run continues the
optimizer's trajectory. ``serve.InferenceSession.from_checkpoint`` serves
the model of such a file. Files are read with ``weights_only=True``: they
hold tensors, numbers and lists, never code.

A checkpoint always holds full tensors. Over a process mesh
(``parallel.shard_state``) every rank calls :func:`save_state`, which
gathers the tensors split over ``model``, and rank 0 writes the file in
the single-process format; :func:`apply_state` cuts a full checkpoint's
split tensors to the rank's blocks.
"""
import os

import torch
import torch.distributed as dist


def _full(t, param):
    """``t`` (a parameter, or an optimizer moment of ``param``) whole: a
    block of a split parameter gathered over its ``model`` group."""
    split = getattr(param, "model_split", None)
    if split is not None:
        t = split.mesh.all_gather(t.detach(), "model", split.dim)
    return t.detach().cpu()


def full_state_dict(model):
    """The model's state_dict on the CPU, split parameters gathered."""
    params = dict(model.named_parameters())
    return {k: _full(v, params.get(k)) for k, v in model.state_dict().items()}


def save_state(path, model, optimizer):
    """Write ``model`` and ``optimizer`` (``train.make_optimizer``'s) to
    ``path``, atomically; the step is the optimizer's update count. Over a
    process mesh every rank calls it and rank 0 writes."""
    payload = {"step": optimizer.count,
               "model": full_state_dict(model),
               "optimizer": {"count": optimizer.count,
                             "mu": [_full(m, p) for m, p in
                                    zip(optimizer.mu, optimizer.params)],
                             "nu": [_full(n, p) for n, p in
                                    zip(optimizer.nu, optimizer.params)]}}
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _block(t, param):
    """A full checkpoint tensor cut to ``param``'s block when ``param`` is
    split over ``model``; else ``t``."""
    split = getattr(param, "model_split", None)
    if split is None:
        return t
    parts = split.mesh.shape["model"]
    size = t.shape[split.dim] // parts
    return t.narrow(split.dim, split.mesh.model_index * size, size)


def load_checkpoint(path):
    """The checkpoint's dict (``step``, ``model``, ``optimizer``), on the
    CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(path, model, optimizer):
    """Load a :func:`save_state` file into ``model`` and ``optimizer`` in
    place; returns the step."""
    return apply_state(load_checkpoint(path), model, optimizer)


def load_model_state(model, state_dict):
    """``model.load_state_dict(state_dict, strict=True)`` of full tensors,
    each split parameter's cut to the rank's block."""
    params = dict(model.named_parameters())
    model.load_state_dict({k: _block(v, params.get(k))
                           for k, v in state_dict.items()}, strict=True)


def apply_state(ckpt, model, optimizer):
    """Load a :func:`load_checkpoint` dict into ``model`` and ``optimizer``
    in place; returns the step."""
    load_model_state(model, ckpt["model"])
    opt = ckpt["optimizer"]
    if len(opt["mu"]) != len(optimizer.mu):
        raise ValueError(f"the checkpoint holds optimizer state for "
                         f"{len(opt['mu'])} parameters, the optimizer has "
                         f"{len(optimizer.mu)}")
    with torch.no_grad():
        for dst, src, p in zip(optimizer.mu + optimizer.nu,
                               opt["mu"] + opt["nu"], optimizer.params * 2):
            dst.copy_(_block(src, p))
    optimizer.count = int(opt["count"])
    return int(ckpt["step"])
