"""Evaluate a saved checkpoint's importance-sampled test LL.

    python -m lie_vae_tpu_torch.cli.eval_checkpoint [--density_k K ...] \\
        [--ll_n N] [--max_items M] [--checkpoint PATH] <cli.main flags>

Counterpart of the JAX package's ``scripts/eval_checkpoint.py``. Two jobs
the in-training evaluation cannot do (``cli.main`` computes the final LL
on the final state, as the reference does, main.py:134-143):

1. evaluate the BEST checkpoint (``cli.main`` saves on validation
   improvement only, so ``<save_dir>/checkpoint.pt`` is the best state);
2. vary the wrapped density's shell count (``--density_k``) to find the
   shell-truncation bias: when late-training sigma grows, the k = 10
   truncated log q underestimates the posterior density, which inflates
   the IW-LL. An honest LL is stable in k.

Pass the training run's model flags (those of ``cli.main``). The
checkpoint is ``--checkpoint``, else ``<save_dir>/checkpoint.pt`` (with
``--name``, ``outputs/<name>``), or with ``--torch_checkpoint`` a reference
state_dict. The test split is ``cli.main``'s; every shell count sees the
same items in the same order and the same noise (the LL stream restarted),
so the difference between two counts is the density's alone. The LL runs
through ``UnsupervisedExperiment.log_likelihood``, in eval mode with the
model's shell count set for it (``analysis.evaluating``), the model's
state restored after each count. Also printed: the posterior sigma's
mean, median and max over up to 256 test items (SO(3) latent only).

Example (the card; ``--device cpu`` on the CPU):
  python -m lie_vae_tpu_torch.cli.eval_checkpoint --density_k 10 30 \\
      --dataset spherecube --data_dir data/spherecube --save_dir out
"""
import argparse
import os

import numpy as np
import torch

from lie_vae_tpu_torch.analysis import evaluating, model_inputs
from lie_vae_tpu_torch.cli import main as cli
from lie_vae_tpu_torch.data import random_split
from lie_vae_tpu_torch.precision import ieee_float32
from lie_vae_tpu_torch.train import ConstantSchedule, UnsupervisedExperiment
from lie_vae_tpu_torch.train.checkpoint import restore_state


@torch.no_grad()
@ieee_float32()
def sigma_stats(model, dataset, n=256):
    """Mean, median and max of the SO(3) posterior's sigma over the first
    ``n`` items of ``dataset``, in eval mode."""
    rows = np.arange(min(n, len(dataset)))
    x = model_inputs(model, dataset.prep_batch(dataset.gather(rows))[-1])
    with evaluating(model):
        stats = model.encode(x, n=1, generator=torch.Generator())
    sig = stats[0].inner.sigma.double()
    return {"mean": float(sig.mean()), "median": float(sig.median()),
            "max": float(sig.max()), "items": int(x.shape[0])}


def log_likelihoods(experiment, dataset, density_k=(10,), ll_n=500,
                    max_items=None, batch_size=1, n_chunk=None):
    """The IW-LL of ``dataset`` at each shell count: {k: {"ll", "items",
    "mean_log_weights"}}. Each count restarts the LL stream, so all see
    the same items and noise."""
    gen = experiment._gens["ll"]
    start = gen.get_state()
    out = {}
    for k in density_k:
        gen.set_state(start)
        with evaluating(experiment.model, density_k=k):
            ll = experiment.log_likelihood(dataset, n=ll_n,
                                           max_items=max_items,
                                           batch_size=batch_size,
                                           n_chunk=n_chunk)
        items = experiment.last_ll or {"items": np.zeros(0),
                                       "mean_log_weights": np.zeros(0)}
        out[k] = {"ll": ll, "items": items["items"].tolist(),
                  "mean_log_weights": items["mean_log_weights"].tolist()}
        print(f"IW-LL (n={ll_n}, density_k={k}): {ll:.2f}")
    return out


def evaluate(args, density_k=(10,), ll_n=500, max_items=None,
             checkpoint=None):
    """The checkpoint's evaluation for the parsed ``cli.main`` flags
    ``args``: {"step", "sigma" (or None), "ll": {k: ...}} (see
    :func:`log_likelihoods`)."""
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available (pass "
                         "--device cpu to run on the CPU)")
    dataset, batch_size, item_rep = cli.build_dataset(args)
    model = cli.build_model(args, dataset, item_rep)
    num_valid = min(25000, int(0.2 * len(dataset)))
    num_test = min(25000, int(0.2 * len(dataset)))
    split = [num_valid, num_test, len(dataset) - num_valid - num_test]
    valid_dataset, test_dataset, train_dataset = random_split(dataset, split)
    experiment = UnsupervisedExperiment(
        model=model, train_dataset=train_dataset, test_dataset=valid_dataset,
        beta_schedule=ConstantSchedule(args.beta), batch_size=batch_size,
        seed=args.seed)
    if args.torch_checkpoint:
        from lie_vae_tpu_torch.compat import load_torch
        model.load_state_dict(load_torch(args.torch_checkpoint), strict=True)
        step = None
    else:
        if checkpoint is None:
            save_dir = (os.path.join("outputs", args.name) if args.name
                        else args.save_dir)
            if not save_dir:
                raise SystemExit("name the checkpoint: --checkpoint, "
                                 "--save_dir, --name or --torch_checkpoint")
            checkpoint = os.path.join(save_dir, cli.CHECKPOINT)
        step = restore_state(checkpoint, model, experiment.optimizer)
    out = {"step": step, "sigma": None}
    if args.latent_mode == "so3":
        out["sigma"] = sigma_stats(model, test_dataset)
        s = out["sigma"]
        print(f"posterior sigma on {s['items']} test items: mean "
              f"{s['mean']:.4f}  median {s['median']:.4f}  max "
              f"{s['max']:.4f}")
    out["ll"] = log_likelihoods(experiment, test_dataset, density_k, ll_n,
                                max_items, args.ll_batch, args.ll_chunk)
    return out


def main(argv=None):
    outer = argparse.ArgumentParser("eval_checkpoint")
    outer.add_argument("--density_k", type=int, nargs="+", default=[10])
    outer.add_argument("--ll_n", type=int, default=500)
    outer.add_argument("--max_items", type=int, default=None)
    outer.add_argument("--checkpoint", default=None,
                       help="the checkpoint.pt to evaluate (default "
                            "<save_dir>/checkpoint.pt)")
    outer_args, rest = outer.parse_known_args(argv)
    args = cli.parse_args(rest)
    return evaluate(args, density_k=outer_args.density_k,
                    ll_n=outer_args.ll_n, max_items=outer_args.max_items,
                    checkpoint=outer_args.checkpoint)


if __name__ == "__main__":
    main()
