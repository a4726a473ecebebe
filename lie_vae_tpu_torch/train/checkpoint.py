"""Checkpoints: the model's state_dict, the optimizer's state and the step
in one ``torch.save`` file.

Counterpart of the JAX package's ``train/checkpoint.py`` (orbax: params,
batch_stats, optimizer state and step), so a resumed run continues the
optimizer's trajectory. ``serve.InferenceSession.from_checkpoint`` serves
the model of such a file. Files are read with ``weights_only=True``: they
hold tensors, numbers and lists, never code.
"""
import os

import torch


def save_state(path, model, optimizer):
    """Write ``model`` and ``optimizer`` (``train.make_optimizer``'s) to
    ``path``, atomically; the step is the optimizer's update count."""
    payload = {"step": optimizer.count,
               "model": {k: v.detach().cpu()
                         for k, v in model.state_dict().items()},
               "optimizer": {"count": optimizer.count,
                             "mu": [m.detach().cpu() for m in optimizer.mu],
                             "nu": [n.detach().cpu() for n in optimizer.nu]}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path):
    """The checkpoint's dict (``step``, ``model``, ``optimizer``), on the
    CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(path, model, optimizer):
    """Load a :func:`save_state` file into ``model`` and ``optimizer`` in
    place; returns the step."""
    return apply_state(load_checkpoint(path), model, optimizer)


def apply_state(ckpt, model, optimizer):
    """Load a :func:`load_checkpoint` dict into ``model`` and ``optimizer``
    in place; returns the step."""
    model.load_state_dict(ckpt["model"], strict=True)
    opt = ckpt["optimizer"]
    if len(opt["mu"]) != len(optimizer.mu):
        raise ValueError(f"the checkpoint holds optimizer state for "
                         f"{len(opt['mu'])} parameters, the optimizer has "
                         f"{len(optimizer.mu)}")
    with torch.no_grad():
        for dst, src in zip(optimizer.mu + optimizer.nu,
                            opt["mu"] + opt["nu"]):
            dst.copy_(src)
    optimizer.count = int(opt["count"])
    return int(ckpt["step"])
