"""Small helpers: the JAX package's ``utils.py`` but its XLA compilation
cache (reference: lie_vae/utils.py, lie_vae/experiments/utils.py), and
:func:`onto`, the host-to-card copy that does not wait."""
import torch


def onto(t, device, dtype=None):
    """``t`` on ``device`` (in ``dtype`` when given; the tensor itself when
    it is there already). From the CPU to a card the copy goes through
    pinned memory and does not wait: a copy from pageable memory blocks the
    host until every kernel queued before it has run, so the card runs dry
    while the host launches what follows. The pinned block comes from
    PyTorch's caching host allocator, which hands it out again only once the
    copy's recorded event has completed."""
    device = torch.device(device)
    if t.device.type == "cpu" and device.type == "cuda":
        return t.to(dtype=dtype).pin_memory().to(device, non_blocking=True)
    return t.to(device, dtype)


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
