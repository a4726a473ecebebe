"""One train step of the ELBO.

Counterpart of ``UnsupervisedExperiment._build_train_step`` in the JAX
package's ``train/loop.py`` (and of ``bench.py``'s step): uint8 images are
scaled to [0, 1] on the device; the model runs in train mode (BatchNorm on
batch statistics, running statistics updated); the loss is the mean
reconstruction error plus beta times the mean KL, or one of the ``control``
forms; the optimizer (``train/state.py``) applies the gradients. At
beta == 0 the KL is not computed at all, as the reference's Python branch
skips it: a zero weight on a NaN KL would still put NaN into the shared
gradients. The equivariance and continuity regularizers are not ported
yet. Epochs, evaluation, the importance-weighted log-likelihood and
checkpoints are the harness's (ROADMAP.md, Queue A, A3).
"""
import torch


def _normalize(x):
    return x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x


def train_step(model, optimizer, x, beta, eps=None, generator=None,
               elbo_samples=1, control=None, control_p=1,
               monitor_sigma=False, equivariance_lamb=None,
               encoder_continuity_lamb=None):
    """One optimizer step on the batch ``x`` (NHWC, uint8 or float, moved
    to the model's device). ``eps`` (elbo_samples, B, 3) fixes the
    posterior noise; otherwise ``generator`` draws it. ``beta`` is a Python
    number. Returns the metrics as detached 0-dim tensors: ``recon``,
    ``kl``, ``kls`` (a list, one per latent), ``loss`` and, with
    ``monitor_sigma``, ``sigma_max``. After the step each parameter's
    ``.grad`` holds its gradient of the loss, unclipped."""
    if equivariance_lamb is not None or encoder_continuity_lamb is not None:
        raise NotImplementedError(
            "the equivariance and encoder-continuity losses are not ported "
            "yet (ROADMAP.md, Queue A, A6)")
    if control is not None and control_p not in (1, 2):
        raise ValueError("Wrong control p")
    device = next(model.parameters()).device
    x = _normalize(torch.as_tensor(x, device=device))
    model.train()
    optimizer.zero_grad()
    x_recon, stats = model(x, n=elbo_samples, eps=eps, generator=generator)
    mean_recon = torch.mean(model.recon_loss(x_recon, x))
    if beta != 0.0:
        kls = model.kl(stats)
        kl_sum = sum(kls)
        if control is None:
            loss = mean_recon + beta * torch.mean(kl_sum)
        elif control_p == 1:
            loss = mean_recon + control * torch.mean(torch.abs(beta - kl_sum))
        else:
            loss = mean_recon + control * torch.mean((beta - kl_sum) ** 2)
        mean_kl = torch.mean(kl_sum).detach()
        kls_mean = [torch.mean(k).detach() for k in kls]
    else:
        loss = mean_recon
        mean_kl = torch.zeros((), device=device)
        kls_mean = [mean_kl for _ in stats]
    loss.backward()
    optimizer.step()
    metrics = {"recon": mean_recon.detach(), "kl": mean_kl, "kls": kls_mean,
               "loss": loss.detach()}
    if monitor_sigma:
        metrics["sigma_max"] = torch.max(stats[0].inner.sigma).detach()
    return metrics
