"""Toy dataset generator.

    python -m lie_vae_tpu_torch.cli.toy_generate NUM DEGREES COPIES
        [--path data/toy.npz] [--seed 0] [--device cuda]

Counterpart of the JAX package's ``cli/toy_generate.py`` (reference:
``lie_vae/experiments/toy_generate.py``), with its arguments; ``--device``
is where the spectra are rotated (the Wigner chain kernel on the card).
"""
import argparse

from lie_vae_tpu_torch.data import ToyDataset


def main(argv=None):
    parser = argparse.ArgumentParser("Toy data generator")
    parser.add_argument("num", type=int)
    parser.add_argument("degrees", type=int)
    parser.add_argument("rep_copies", type=int)
    parser.add_argument("--path", default="data/toy.npz")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device that rotates the spectra (cuda, "
                             "cuda:N, cpu)")
    args = parser.parse_args(argv)
    ToyDataset.generate(n=args.num, degrees=args.degrees,
                        rep_copies=args.rep_copies, seed=args.seed,
                        device=args.device).save(args.path)
    print("Dataset generated")


if __name__ == "__main__":
    main()
