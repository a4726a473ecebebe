"""Experiment CLI: ``python -m lie_vae_tpu_torch.cli.main``.

Counterpart of the JAX package's ``cli/main.py`` (reference:
``lie_vae/experiments/main.py``): the same flags and defaults, ``--config a
b c`` merging YAML presets (``cli/config/``) into the parser's defaults
with the command line still overriding, the dataset split, the epoch loop
with best-checkpoint saving and early stop (main.py:117-131), and the final
importance-sampled LL (main.py:134-143), appended to ``ll.txt``.

The defaults are the JAX CLI's: the toy experiment (``--dataset toy``:
1000 Haar poses of one random spectrum at L = 6 with 10 copies, generated
into ``--toy_path`` when the file is missing, the Wigner chain kernel
rotating it on the card; the toy encoder, the SO(3) latent with the S2xS2
mean, the action decoder without a deconv head). ``--dataset spherecube
--data_dir DIR`` trains the flagship shape (conv width 50, deconv width
200, BatchNorm) on RGB sphere-cube renders (rendered by
``python -m lie_vae_tpu_torch.cli.gen_spherecube --singles``); ``--dataset
sc-pairs`` on their consecutive-pose pairs (the generator's default, 32
pairs = 64 images a batch), which the paper's regularizers take:
``--equivariance`` and ``--encoder_continuity`` (each a ``LinearSchedule``
from 0 at step 1000 to its value at ``--*_end_it``), ``--equivariance_rotate
shear|gather``, and the presets ``--config scpairs reg`` (the paper's
regularized configuration), ``contreg``. Every model mode and
compute dtype of the JAX CLI is passed on to ``LieVAE``. Port flags:
``--device`` (default ``cuda``); ``--kernel_impl`` defaults to ``fused``
(the Wigner chain kernels and the density kernels on the card; ``pallas``
takes the synthesise-then-apply Wigner kernels instead; ``xla`` the plain
ops). ``--profile_dir`` writes a ``torch.profiler`` trace. The checkpoint is
``<save_dir>/checkpoint.pt`` (``train.checkpoint``), which
``serve.InferenceSession.from_checkpoint`` serves. The run's device work
is IEEE float32 (``precision.ieee_float32``: no TF32).

``--mesh_data D --mesh_model M`` train data- and model-parallel over
D x M processes (``parallel``): run under ``python -m
torch.distributed.run --nproc_per_node D*M`` (or any launcher that sets
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``); with
another world size the command raises and names the size it needs. The
batch is the global one; each rank trains on its rows, on its own card
over NCCL, on a shared card or the CPU (``--device cpu``) over gloo. Only
rank 0 logs, prints the epoch lines, writes the checkpoint and ``ll.txt``.
"""
import argparse
import math
import os

import torch

from lie_vae_tpu_torch.data import (ScPairsDataset, SphereCubeDataset,
                                    ToyDataset, random_split)
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.precision import ieee_float32
from lie_vae_tpu_torch.train import (
    LinearSchedule, MetricWriter, UnsupervisedExperiment, get_beta_schedule)
from lie_vae_tpu_torch.train.checkpoint import restore_state, save_state

CHECKPOINT = "checkpoint.pt"


def make_run_mesh(args):
    """The process mesh of ``--mesh_data``/``--mesh_model`` (None for
    1 x 1): joins the launcher's process group, whose world size must be
    their product, and points ``args.device`` at this rank's device."""
    need = args.mesh_data * args.mesh_model
    if need == 1:
        return None
    world = int(os.environ.get("WORLD_SIZE") or 1)
    if world != need:
        raise SystemExit(
            f"--mesh_data {args.mesh_data} --mesh_model {args.mesh_model} "
            f"needs a world size of {need} processes, this one has {world}: "
            f"run it under python -m torch.distributed.run --standalone "
            f"--nproc_per_node {need} -m lie_vae_tpu_torch.cli.main ...")
    from lie_vae_tpu_torch.parallel import initialize_distributed, make_mesh
    args.device = str(initialize_distributed(device=args.device))
    return make_mesh(args.mesh_data, args.mesh_model)


def build_dataset(args):
    """The dataset, the CLI's batch size (64 items, 32 for sc-pairs, whose
    items are pairs) and, with ``--fixed_spectrum``, the toy spectrum the
    decoder keeps fixed."""
    item_rep = None
    batch_size = 64
    directory = {"directory": args.data_dir} if args.data_dir else {}
    if args.dataset == "spherecube":
        dataset = SphereCubeDataset(subsample=args.subsample, **directory)
    elif args.dataset == "sc-pairs":
        dataset = ScPairsDataset(subsample=args.subsample, **directory)
        batch_size = 32
    elif args.dataset == "toy":
        if not os.path.exists(args.toy_path):
            print(f"Generating toy dataset at {args.toy_path} ...")
            ToyDataset.generate(n=1000, degrees=args.degrees,
                                rep_copies=args.rep_copies,
                                device=args.device).save(args.toy_path)
        dataset = ToyDataset(path=args.toy_path)
        expected = ((args.degrees + 1) ** 2, args.rep_copies)
        if dataset.harmonics.shape != expected:
            raise ValueError(
                f"{args.toy_path} was generated with spectrum shape "
                f"{dataset.harmonics.shape}, but --degrees/--rep_copies "
                f"request {expected}; regenerate it or pass a different "
                f"--toy_path")
        if args.fixed_spectrum:
            item_rep = dataset.harmonics
    else:
        raise ValueError("Wrong dataset")
    if len(dataset) == 0:
        raise RuntimeError("Dataset empty")
    return dataset, batch_size, item_rep


def sigma_clamp_value(args):
    """--sigma_clamp: float upper bound on the SO(3) posterior sigma, or
    'auto' = pi*density_k/2, the k-shell wrapped density's validity bound."""
    raw = args.sigma_clamp
    if raw is None:
        return None
    if str(raw).lower() == "auto":
        return math.pi * args.density_k / 2.0
    return float(raw)


def build_model(args, dataset, item_rep):
    toy = args.dataset == "toy"
    return LieVAE(
        latent_mode=args.latent_mode,
        mean_mode=args.mean_mode,
        decoder_mode=args.decoder_mode,
        encode_mode="toy" if toy else "conv",
        deconv_mode="toy" if toy else args.deconv_mode,
        rep_copies=args.rep_copies,
        degrees=args.degrees,
        deconv_hidden=args.deconv_hidden,
        conv_hidden=args.conv_hidden,
        batch_norm=bool(args.batch_norm),
        rgb=dataset.rgb,
        normal_dims=args.normal_dims,
        deterministic=args.deterministic,
        fixed_item_rep=item_rep,
        wigner_transpose=args.wigner_transpose,
        mlp_layers=args.mlp_layers,
        mlp_hidden=args.mlp_hidden,
        mlp_activation=args.mlp_activation,
        fixed_sigma=args.fixed_sigma,
        compute_dtype=args.compute_dtype,
        encoder_dtype=args.encoder_dtype,
        decoder_dtype=args.decoder_dtype,
        deconv_head_dtype=args.deconv_head_dtype,
        sigma_clamp=sigma_clamp_value(args),
        density_k=args.density_k,
        kernel_impl=args.kernel_impl,
        device=args.device,
    )


@ieee_float32()
def main(argv=None):
    args = parse_args(argv)
    if args.name is not None:
        args.log_dir = "runs/" + args.name
        args.save_dir = "outputs/" + args.name
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available (pass "
                         "--device cpu to run on the CPU)")
    mesh = make_run_mesh(args)
    main_rank = mesh is None or mesh.is_main
    say = print if main_rank else (lambda *a, **k: None)
    say({k: v for k, v in sorted(vars(args).items())})
    torch.manual_seed(args.seed)

    if mesh is not None and args.dataset == "toy":
        # rank 0 generates a missing toy set; the others wait for it
        if main_rank:
            build_dataset(args)
        mesh.barrier()
    dataset, batch_size, item_rep = build_dataset(args)
    model = build_model(args, dataset, item_rep)

    num_valid = min(25000, int(0.2 * len(dataset)))
    num_test = min(25000, int(0.2 * len(dataset)))
    split = [num_valid, num_test, len(dataset) - num_valid - num_test]
    valid_dataset, test_dataset, train_dataset = random_split(dataset, split)
    say("Dataset splits: train={}, valid={}, test={}".format(
        len(train_dataset), len(valid_dataset), len(test_dataset)))

    equivariance = (LinearSchedule(0, args.equivariance, 1000,
                                   args.equivariance_end_it)
                    if args.equivariance is not None else None)
    encoder_continuity = (LinearSchedule(0, args.encoder_continuity, 1000,
                                         args.encoder_continuity_end_it)
                          if args.encoder_continuity is not None else None)
    experiment = UnsupervisedExperiment(
        model=model,
        train_dataset=train_dataset,
        test_dataset=valid_dataset,
        beta_schedule=get_beta_schedule(args.beta_schedule, args.beta),
        lr=args.lr,
        weight_decay=args.weight_decay,
        elbo_samples=args.elbo_samples,
        report_freq=args.report_freq,
        clip_grads=args.clip_grads,
        selective_clip=args.selective_clip,
        batch_size=batch_size,
        equivariance_lamb=equivariance,
        encoder_continuity_lamb=encoder_continuity,
        control=args.control,
        control_p=args.control_p,
        log=MetricWriter(args.log_dir if main_rank else None),
        log_histograms=args.log_histograms,
        steps_per_call=args.steps_per_call,
        device_data=args.device_data,
        seed=args.seed,
        equivariance_rotate=args.equivariance_rotate,
        mesh=mesh,
    )

    if args.torch_checkpoint:
        # a reference run's torch.save'd state_dict (its model.pickle,
        # main.py:122-127); the optimizer starts fresh, as the reference
        # never saved its state
        if args.continue_epoch > 0:
            raise SystemExit("--torch_checkpoint initializes a fresh run; "
                             "it cannot be combined with --continue_epoch "
                             "(resume from the run's own checkpoint)")
        from lie_vae_tpu_torch.compat import load_torch
        from lie_vae_tpu_torch.train.checkpoint import load_model_state
        say(f"Importing torch checkpoint {args.torch_checkpoint} ..")
        load_model_state(model, load_torch(args.torch_checkpoint))

    checkpoint = (os.path.join(args.save_dir, CHECKPOINT)
                  if args.save_dir else None)
    if args.continue_epoch > 0 and checkpoint:
        say("Loading..")
        restore_state(checkpoint, model, experiment.optimizer)

    if args.profile_dir:
        experiment.profile(args.profile_dir)

    early_stop_counter = 0
    for epoch in range(args.continue_epoch, args.epochs):
        previous_best = experiment.best_value
        experiment.train(epoch)

        if checkpoint:
            improved = previous_best != experiment.best_value
            if args.max_early_stop is None or improved:
                save_state(checkpoint, model, experiment.optimizer)
                early_stop_counter = 0
            elif early_stop_counter < args.max_early_stop:
                early_stop_counter += 1
            else:
                say(f"Early stop at epoch {epoch}")
                break
    experiment.log.close()

    if args.beta != 0:
        say("Computing LL..")
        ll = experiment.log_likelihood(test_dataset, n=args.ll_samples,
                                       max_items=args.ll_max_items,
                                       batch_size=args.ll_batch,
                                       n_chunk=args.ll_chunk)
        say("LL: {:.2f}".format(ll))
        if main_rank:
            with open("ll.txt", "a") as f:
                f.write("{} : {:4f}\n".format(args.name, ll))
    return experiment


def parse_args(argv=None):
    # the JAX CLI's flag surface (same names and defaults, reference
    # main.py:146-210), but --device, and --kernel_impl's default
    parser = argparse.ArgumentParser("VAE experiment")
    parser.add_argument("--dataset", default="toy",
                        help="[toy, spherecube, sc-pairs]")
    parser.add_argument("--decoder_mode", default="action",
                        help="[action, mlp]")
    parser.add_argument("--latent_mode", default="so3",
                        help="[so3, normal, vmf, vmfq]")
    parser.add_argument("--mean_mode", default="s2s2",
                        help="For SO(3). Choose [q, alg, s2s2, s2s1]")
    parser.add_argument("--deconv_mode", default="deconv")
    parser.add_argument("--batch_norm", type=int, default=1)
    parser.add_argument("--beta", type=float, default=1.0)
    parser.add_argument("--beta_schedule", type=str)
    parser.add_argument("--control", type=float,
                        help="KL-controlled VAE gamma. Beta is KL target.")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--report_freq", type=int, default=2500)
    parser.add_argument("--degrees", type=int, default=6)
    parser.add_argument("--deconv_hidden", type=int, default=200)
    parser.add_argument("--conv_hidden", type=int, default=50)
    parser.add_argument("--rep_copies", type=int, default=10)
    parser.add_argument("--clip_grads", type=float, default=1e-5)
    parser.add_argument("--selective_clip", action="store_true")
    parser.add_argument("--elbo_samples", type=int, default=1)
    parser.add_argument("--log_dir")
    parser.add_argument("--save_dir")
    parser.add_argument("--name")
    parser.add_argument("--continue_epoch", type=int, default=0)
    parser.add_argument("--equivariance", type=float)
    parser.add_argument("--equivariance_end_it", type=int, default=20000)
    parser.add_argument("--encoder_continuity", type=float)
    parser.add_argument("--encoder_continuity_end_it", type=int,
                        default=20000)
    parser.add_argument("--max_early_stop", type=int, default=50)
    parser.add_argument("--subsample", type=float, default=1.0)
    parser.add_argument("--data_dir", default=None,
                        help="the rendered dataset's directory (default "
                             "data/spherecube)")
    parser.add_argument("--normal_dims", type=int, default=3)
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--wigner_transpose", action="store_true")
    parser.add_argument("--fixed_spectrum", action="store_true")
    parser.add_argument("--mlp_hidden", type=int, default=50)
    parser.add_argument("--mlp_layers", type=int, default=3)
    parser.add_argument("--mlp_activation", default="relu")
    parser.add_argument("--fixed_sigma", type=float)
    parser.add_argument("--equivariance_rotate", default="shear",
                        choices=["shear", "gather"])
    parser.add_argument("--sigma_clamp", default=None,
                        help="upper clamp on the SO(3) posterior's learned "
                             "algebra sigma: a float, or 'auto' = "
                             "pi*density_k/2")
    parser.add_argument("--control_p", type=int, default=2)
    parser.add_argument("--weight_decay", type=float, default=0.0)
    parser.add_argument("--lr", type=float, default=1.0e-3)
    parser.add_argument("--config", nargs="*")
    parser.add_argument("--mesh_data", type=int, default=1,
                        help="data-parallel mesh axis size (processes)")
    parser.add_argument("--mesh_model", type=int, default=1,
                        help="model-parallel mesh axis size (processes)")
    parser.add_argument("--toy_path", default="data/toy.npz")
    parser.add_argument("--log_histograms", action="store_true")
    parser.add_argument("--seed", type=int, default=0,
                        help="training seed (weights, posterior noise, "
                             "shuffle); the data split stays the "
                             "reference's np-seed-0")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="steps per report group (the JAX harness's "
                             "scan length; here they run one at a time)")
    parser.add_argument("--device_data", action="store_true",
                        help="keep the uint8 dataset on the device and "
                             "gather batches there")
    parser.add_argument("--compute_dtype", default=None,
                        help="conv/MLP compute dtype, e.g. bfloat16 "
                             "(parameters and Lie math stay float32)")
    parser.add_argument("--encoder_dtype", default="unset",
                        help="override compute_dtype for the encoder stack")
    parser.add_argument("--decoder_dtype", default="unset",
                        help="override compute_dtype for the decoder stack")
    parser.add_argument("--deconv_head_dtype", default="unset",
                        help="override the dtype of the image head alone")
    parser.add_argument("--kernel_impl", default="fused",
                        choices=["fused", "pallas", "auto", "xla"],
                        help="Lie-group ops: 'fused' (Wigner chain kernels "
                             "+ density kernels), 'pallas' "
                             "(synthesise-then-apply Wigner kernels + "
                             "density kernels), 'auto' (as fused), 'xla' "
                             "(plain PyTorch ops)")
    parser.add_argument("--density_k", type=int, default=10)
    parser.add_argument("--ll_samples", type=int, default=500)
    parser.add_argument("--ll_max_items", type=int, default=None)
    parser.add_argument("--ll_batch", type=int, default=1)
    parser.add_argument("--ll_chunk", type=int, default=None)
    parser.add_argument("--torch_checkpoint", default=None,
                        help="initialize the weights from a PyTorch "
                             "reference checkpoint (torch.save'd "
                             "state_dict)")
    parser.add_argument("--profile_dir", default=None,
                        help="write a torch.profiler trace of a few "
                             "training steps before the run")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (cuda, cuda:N, cpu)")

    conf = {}
    pkg_config = os.path.join(os.path.dirname(__file__), "config")
    names = parser.parse_args(argv).config or []
    if names:
        import yaml
    for name in names:
        for base in ("config", pkg_config):
            path = os.path.join(base, name + ".yaml")
            if os.path.exists(path):
                with open(path) as f:
                    conf = {**conf, **yaml.safe_load(f)}
                break
        else:
            raise FileNotFoundError(f"config preset '{name}' not found")
    parser.set_defaults(**conf)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
