"""The optimizer of the train step, as the JAX package's optax chain.

Counterpart of ``make_optimizer`` in the JAX package's ``train/state.py``:
gradients are global-norm clipped FIRST (default clip 1e-5), optionally
only over the encoder and reparameterizer parameters (the selective clip),
then torch-style coupled L2 weight decay is added to the clipped gradient,
then Adam (b1 0.9, b2 0.999, eps 1e-8) with optax's arithmetic:

    clip:   g <- g                      if |g| < max_norm
            g <- (g / |g|) * max_norm   otherwise  (|g| the global norm)
    L2:     g <- g + weight_decay * p
    Adam:   mu <- (1 - b1) g + b1 mu,   nu <- (1 - b2) g^2 + b2 nu,
            p  <- p - lr * mu_hat / (sqrt(nu_hat) + eps),
            mu_hat = mu / (1 - b1^t), nu_hat = nu / (1 - b2^t).

``torch.nn.utils.clip_grad_norm_`` would scale by max_norm / (norm + 1e-6)
at every norm, a 10% change near the default clip of 1e-5, so the clip is
written out. ``step`` leaves ``p.grad`` as the backward pass left it.

Over a process mesh the gradients come in averaged over the ``data`` group
(``train_step``); a parameter split over ``model``
(``parallel.shard_state``) enters the global norm once per block, and
Adam, elementwise, runs on each block as it is.
"""
import torch

# the selective clip's targets: the JAX package's 'encoder' and 'rep_group'
SELECTIVE_PREFIXES = ("encoder.", "reparameterize.")
B1, B2, EPS = 0.9, 0.999, 1e-8          # torch.optim.Adam's defaults


class Optimizer:
    """Clip, then coupled L2, then Adam over named parameters."""

    def __init__(self, named_params, lr=1e-3, weight_decay=0.0,
                 clip_grads=1e-5, selective_clip=False):
        named = list(named_params.items() if isinstance(named_params, dict)
                     else named_params)
        self.names = [name for name, _ in named]
        self.params = [p for _, p in named]
        self.lr, self.weight_decay = lr, weight_decay
        self.clip_grads = clip_grads
        if clip_grads and selective_clip:
            self.clip_mask = [n.startswith(SELECTIVE_PREFIXES)
                              for n in self.names]
            if not any(self.clip_mask):
                raise ValueError(
                    "selective clip selected zero parameters: expected "
                    f"names under {SELECTIVE_PREFIXES}, got {self.names}")
        else:
            self.clip_mask = [True] * len(self.params)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _clip(self, grads):
        picked = [(g, getattr(p, "model_split", None))
                  for g, p, m in zip(grads, self.params, self.clip_mask) if m]
        split = [s for _, s in picked if s is not None]
        if not split:
            norm = torch.sqrt(sum(torch.sum(g * g) for g, _ in picked))
        else:
            # a split tensor's blocks are counted once each (summed over
            # 'model'), a replicated tensor once
            sq = sum(torch.sum(g * g) for g, s in picked if s is None)
            sq_split = sum(torch.sum(g * g) for g, s in picked
                           if s is not None)
            norm = torch.sqrt(sq + split[0].mesh.all_reduce_(
                sq_split.reshape(1), "model")[0])
        keep = norm < self.clip_grads
        one = torch.ones_like(norm)
        denom = torch.where(keep, one, norm)
        numer = torch.where(keep, one, torch.full_like(norm, self.clip_grads))
        return [g / denom * numer if m else g
                for g, m in zip(grads, self.clip_mask)]

    @torch.no_grad()
    def step(self):
        """One update from the parameters' ``.grad`` (a missing gradient
        counts as zeros, as in optax)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clip_grads:
            grads = self._clip(grads)
        if self.weight_decay:
            grads = [g + self.weight_decay * p
                     for g, p in zip(grads, self.params)]
        self.count += 1
        c1 = 1.0 - B1 ** self.count
        c2 = 1.0 - B2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).add_(g * g, alpha=1.0 - B2)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + EPS))


def make_optimizer(params, lr=1e-3, weight_decay=0.0, clip_grads=1e-5,
                   selective_clip=False):
    """The train step's optimizer over ``params``, ``(name, parameter)``
    pairs (``model.named_parameters()``) or a dict of them. A falsy
    ``clip_grads`` turns the clip off; ``selective_clip`` clips only the
    ``encoder.*`` and ``reparameterize.*`` parameters, over their own norm."""
    return Optimizer(params, lr=lr, weight_decay=weight_decay,
                     clip_grads=clip_grads, selective_clip=selective_clip)
