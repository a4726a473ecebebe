"""Small helpers: the JAX package's ``utils.py`` but its XLA compilation
cache (reference: lie_vae/utils.py, lie_vae/experiments/utils.py)."""
import torch


def logsumexp(x, axis=None, keepdims=False):
    """Numerically stable log-sum-exp over ``axis`` (all elements when
    None; reference: lie_vae/utils.py:4-26)."""
    x = torch.as_tensor(x)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.logsumexp(x, dim=axis, keepdim=keepdims)


def expand_dim(x, n, axis=0):
    """Insert a broadcast axis of size n at ``axis`` (reference:
    experiments/utils.py:82-85)."""
    x = torch.as_tensor(x)
    axis = axis % (x.dim() + 1)
    return x.unsqueeze(axis).expand(x.shape[:axis] + (n,) + x.shape[axis:])


def cycle(iterable):
    """Cycle an iterable without caching items (reference:
    experiments/utils.py:75-79)."""
    while True:
        for x in iterable:
            yield x
