"""Serving CLI: ``python -m lie_vae_tpu_torch.cli.serve <command> ...``.

Counterpart of the JAX package's ``cli/serve.py`` over the port's
:mod:`lie_vae_tpu_torch.serve`. Every command takes the training run's
model flags (``cli.main``'s, ``--device`` among them: ``cuda`` by default,
which fails without a card; ``--device cpu`` asks for the CPU) after its
own options, since a checkpoint holds a state_dict, not the model's
configuration. Device work runs in IEEE float32 (no TF32).

  export      the port's checkpoint.pt, or a reference state_dict
              (--torch), -> one .npz artifact in the JAX package's format
              (which its serve.load_npz reads); or the checkpoint ->
              a reference state_dict (--to_torch); with --aot
              [--aot_batch N] an ahead-of-time artifact that also holds
              the model's configuration (serve.export_aot)
  sample      decode n poses of the prior -> .npz (and a .png grid when
              PIL is there)
  trajectory  decode a latent geodesic between two encoded images or two
              seeded random poses
  bench       ms per request of the session (host clock) and the device ms
              of its encode and reconstruct (CUDA events), as JSON
  http        the HTTP front end (``serve_http``) over the session

A session comes from ``--artifact`` (an .npz of either package),
``--torch`` (a reference state_dict), ``--checkpoint`` (the port's
checkpoint.pt) or ``--name`` (``outputs/<name>/checkpoint.pt``); or, with
no model flags (``--device`` alone), from ``--aot`` (an ``export --aot``
artifact of the port, served by ``serve.AotSession``: on the card each
fixed-batch surface replays one CUDA graph). Examples::

  python -m lie_vae_tpu_torch.cli.serve export \\
      --checkpoint out/checkpoint.pt --dataset spherecube --out artifact.npz
  python -m lie_vae_tpu_torch.cli.serve http --artifact artifact.npz \\
      --dataset spherecube --port 8310
  python -m lie_vae_tpu_torch.cli.serve export --aot \\
      --checkpoint out/checkpoint.pt --dataset spherecube
  python -m lie_vae_tpu_torch.cli.serve http --aot out/artifact_aot.npz

``--data_devices N`` serves over N devices (``parallel.make_mesh``: each
chunk split into N contiguous shards, one replica of the weights per
device; the batch must be a multiple of N): the first N cards, or with
``--device cpu`` N CPU replicas; on a machine with fewer cards the command
raises with both counts. ``export --aot --aot_data_devices N`` records N in
the artifact, which ``--aot`` then serves over N devices (``--data_devices``
beside it must agree).
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from lie_vae_tpu_torch.precision import ieee_float32


def _build_model(args, device=None):
    """The LieVAE of the training flags ``args`` without loading an image
    dataset: ``rgb`` and the toy/conv switch follow ``--dataset``; a
    ``--fixed_spectrum`` toy run's spectrum is read from ``--toy_path``."""
    from lie_vae_tpu_torch.cli import main as cli
    from lie_vae_tpu_torch.models import LieVAE

    is_toy = args.dataset == "toy"
    item_rep = None
    if args.fixed_spectrum:
        if not is_toy:
            raise SystemExit("--fixed_spectrum is a toy-dataset flag")
        from lie_vae_tpu_torch.data import ToyDataset
        item_rep = ToyDataset(path=args.toy_path).harmonics
    return LieVAE(
        fixed_item_rep=item_rep, latent_mode=args.latent_mode,
        mean_mode=args.mean_mode, decoder_mode=args.decoder_mode,
        encode_mode="toy" if is_toy else "conv",
        deconv_mode="toy" if is_toy else args.deconv_mode,
        rep_copies=args.rep_copies, degrees=args.degrees,
        deconv_hidden=args.deconv_hidden, conv_hidden=args.conv_hidden,
        batch_norm=bool(args.batch_norm), rgb=not is_toy,
        normal_dims=args.normal_dims, deterministic=args.deterministic,
        wigner_transpose=args.wigner_transpose, mlp_layers=args.mlp_layers,
        mlp_hidden=args.mlp_hidden, mlp_activation=args.mlp_activation,
        fixed_sigma=args.fixed_sigma, compute_dtype=args.compute_dtype,
        encoder_dtype=args.encoder_dtype, decoder_dtype=args.decoder_dtype,
        deconv_head_dtype=args.deconv_head_dtype,
        sigma_clamp=cli.sigma_clamp_value(args), density_k=args.density_k,
        kernel_impl=args.kernel_impl, device=device or args.device)


def _model_args(rest):
    from lie_vae_tpu_torch.cli import main as cli
    return cli.parse_args(rest)


def _session(opts, rest):
    """An InferenceSession from --artifact / --torch / --checkpoint /
    --name and the model flags ``rest``, or an AotSession from --aot and
    nothing but ``--device``."""
    from lie_vae_tpu_torch.parallel import make_mesh
    from lie_vae_tpu_torch.serve import (AotSession, InferenceSession,
                                         serving_devices)

    if opts.aot:
        p = argparse.ArgumentParser("--aot", allow_abbrev=False)
        p.add_argument("--device", default="cuda")
        dev, extra = p.parse_known_args(rest)
        if extra:
            raise SystemExit(f"--aot takes no model flags (the artifact "
                             f"holds the model): {extra}")
        _check_device(dev.device)
        with np.load(opts.aot) as z:
            meta = (json.loads(bytes(z["__aot_meta__"]).decode())
                    if "__aot_meta__" in z.files else {})
        recorded = int(meta.get("data_devices", 1))
        if opts.data_devices and opts.data_devices != recorded:
            raise SystemExit(
                f"--data_devices {opts.data_devices} does not match the AOT "
                f"artifact (exported for {recorded} device(s) on the 'data' "
                f"axis); re-export with --aot_data_devices "
                f"{opts.data_devices}")
        return AotSession(opts.aot, seed=opts.seed, device=dev.device,
                          devices=serving_devices(recorded, dev.device))
    args = _model_args(rest)
    _check_device(args.device)
    kw = dict(batch_size=opts.batch_size, seed=opts.seed, device=args.device)
    if opts.data_devices:
        kw["mesh"] = make_mesh(opts.data_devices, devices=serving_devices(
            opts.data_devices, args.device))
    model = _build_model(args)
    if opts.artifact:
        return InferenceSession.from_npz(opts.artifact, model, **kw)
    if opts.torch:
        return InferenceSession.from_torch(opts.torch, model, **kw)
    path = opts.checkpoint or (args.name and os.path.join(
        "outputs", args.name, "checkpoint.pt"))
    if not path:
        raise SystemExit("pass --artifact, --torch, --checkpoint or --name")
    return InferenceSession.from_checkpoint(path, model, **kw)


def _check_device(device):
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available (pass "
                         "--device cpu to run on the CPU)")


def _add_session_flags(p):
    p.add_argument("--artifact", help=".npz deployment artifact (export, "
                                      "or the JAX package's)")
    p.add_argument("--aot", help="the port's ahead-of-time artifact (export "
                                 "--aot): served with no model flags, each "
                                 "surface a CUDA graph on the card")
    p.add_argument("--checkpoint", help="the port's checkpoint.pt")
    p.add_argument("--torch", help="reference PyTorch checkpoint "
                                   "(state_dict) to serve")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", help="output .npz path")
    p.add_argument("--data_devices", type=int, default=0,
                   help="serve over this many devices ('data' mesh axis; "
                        "the batch must divide evenly): the first N cards, "
                        "or N CPU replicas with --device cpu. 0 = one "
                        "device")


def _save_png_grid(images, path):
    """A PNG contact sheet of NHWC images next to the .npz, when PIL is
    installed (an output format: None without it, and for toy spectra)."""
    try:
        from PIL import Image
    except ImportError:
        return None
    imgs = np.asarray(images)
    if imgs.ndim != 4:
        return None
    n, h, w, c = imgs.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), np.float32)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    grid = np.clip(grid * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(grid[..., 0] if c == 1 else grid).save(path)
    return path


def cmd_export(argv):
    from lie_vae_tpu_torch import compat
    from lie_vae_tpu_torch.serve import (export_aot, export_aot_from_torch,
                                         export_npz,
                                         export_npz_from_torch)
    from lie_vae_tpu_torch.train.checkpoint import load_checkpoint

    p = argparse.ArgumentParser("serve export", allow_abbrev=False)
    p.add_argument("--name", help="run name under outputs/")
    p.add_argument("--checkpoint", help="the port's checkpoint.pt")
    p.add_argument("--torch", help="reference PyTorch checkpoint "
                                   "(state_dict) to convert")
    p.add_argument("--to_torch", metavar="PICKLE",
                   help="write the checkpoint's model as a reference "
                        "state_dict instead (loadable by the reference "
                        "with strict=True)")
    p.add_argument("--aot", action="store_true",
                   help="an ahead-of-time artifact: the weights and the "
                        "model's configuration, served by --aot with no "
                        "model flags")
    p.add_argument("--aot_batch", type=int, default=64,
                   help="the fixed batch of the AOT session's graphs")
    p.add_argument("--aot_data_devices", type=int, default=0,
                   help="record this many devices on the 'data' axis: the "
                        "artifact is then served over as many, each chunk "
                        "split evenly (the batch must divide). 0 = one")
    p.add_argument("--out", help="output .npz (default <run>/artifact.npz, "
                                 "or artifact_aot.npz with --aot)")
    opts, rest = p.parse_known_args(argv)
    if opts.aot_data_devices and not opts.aot:
        raise SystemExit("--aot_data_devices is an --aot flag")
    # the model only names the JAX paths: no device work
    model = _build_model(_model_args(rest), device="cpu")
    mesh = None
    if opts.aot_data_devices:
        from lie_vae_tpu_torch.parallel import make_mesh
        n = opts.aot_data_devices
        mesh = make_mesh(n, devices=["cpu"] * n)
    if opts.aot:
        src = opts.torch or opts.checkpoint or (opts.name and os.path.join(
            "outputs", opts.name, "checkpoint.pt"))
        if not src:
            raise SystemExit("pass --name, --checkpoint or --torch")
        out = opts.out or os.path.join(os.path.dirname(src),
                                       "artifact_aot.npz")
        export = export_aot_from_torch if opts.torch else export_aot
        export(src, model, out, batch_size=opts.aot_batch, mesh=mesh)
    elif opts.torch:
        out = opts.out or os.path.splitext(opts.torch)[0] + ".npz"
        export_npz_from_torch(opts.torch, model, out)
    else:
        ckpt = opts.checkpoint or (opts.name and os.path.join(
            "outputs", opts.name, "checkpoint.pt"))
        if not ckpt:
            raise SystemExit("pass --name, --checkpoint or --torch")
        if opts.to_torch:
            out = opts.to_torch
            compat.save_torch(out, load_checkpoint(ckpt)["model"])
        else:
            out = opts.out or os.path.join(os.path.dirname(ckpt),
                                           "artifact.npz")
            export_npz(ckpt, out, model)
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return out


def cmd_sample(argv):
    p = argparse.ArgumentParser("serve sample", allow_abbrev=False)
    _add_session_flags(p)
    p.add_argument("-n", type=int, default=16, help="number of samples")
    opts, rest = p.parse_known_args(argv)
    sess = _session(opts, rest)
    imgs = sess.sample(opts.n, seed=opts.seed)
    out = opts.out or "samples.npz"
    np.savez(out, images=imgs)
    png = _save_png_grid(imgs, os.path.splitext(out)[0] + ".png")
    print(f"wrote {out}" + (f" and {png}" if png else ""))
    return out


def _random_poses(model, seed):
    """Two poses of the prior from a torch generator seeded with ``seed``:
    Haar rotations (so3), Haar unit quaternions (vmf, vmfq), N(0, I)."""
    from lie_vae_tpu_torch import ops
    gen = torch.Generator().manual_seed(seed)
    if model.latent_mode == "so3":
        z = ops.random_group_matrices(2, generator=gen, device="cpu")
    elif model.is_vmf:
        z = ops.random_quaternions(2, generator=gen, device="cpu")
    else:
        z = torch.randn((2, model.normal_dims), generator=gen)
    return z.numpy()


def cmd_trajectory(argv):
    p = argparse.ArgumentParser("serve trajectory", allow_abbrev=False)
    _add_session_flags(p)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--images", nargs=2, metavar="PNG",
                   help="two image files to encode as the endpoints "
                        "(default: two seeded random prior poses)")
    opts, rest = p.parse_known_args(argv)
    sess = _session(opts, rest)
    if opts.images:
        from PIL import Image
        if len(sess.model.out_shape) != 3:
            raise SystemExit("--images requires an image model "
                             f"(out_shape {sess.model.out_shape})")
        h, w, c = sess.model.out_shape
        mode = "RGB" if c == 3 else "L"
        x = np.stack([np.asarray(Image.open(f).convert(mode).resize((w, h)),
                                 np.float32) / 255.0 for f in opts.images])
        if c == 1:
            x = x[..., None]
        a, b = sess.encode(x)["pose"][:2]
    else:
        a, b = _random_poses(sess.model, opts.seed)
    frames = sess.geodesic(a, b, steps=opts.steps)
    out = opts.out or "trajectory.npz"
    np.savez(out, frames=frames, pose_a=a, pose_b=b)
    png = _save_png_grid(frames, os.path.splitext(out)[0] + ".png")
    print(f"wrote {out}" + (f" and {png}" if png else ""))
    return out


def _device_calls(sess, x):
    """The session's encode and reconstruct as calls over inputs already
    on the device: a reconstruct of the batch ``x`` leaves it in every
    replica's input buffer, and the last encode's noise stays in the noise
    buffers. Each call runs the surface on every replica there (on the card
    an AotSession's graph replays), no host work between calls, and
    returns the replicas' outputs."""
    sess.reconstruct(x)
    replicas = sess._replicas
    return {name: lambda name=name: [r.run(name) for r in replicas]
            for name in ("encode", "reconstruct")}


def _device_ms(calls, iters):
    """Device ms per call of each of ``calls``, by CUDA events around
    ``iters`` calls after a first one."""
    out = {}
    with torch.inference_mode(), ieee_float32():
        for name, fn in calls.items():
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            out[name] = start.elapsed_time(end) / iters
    return out


def cmd_bench(argv):
    p = argparse.ArgumentParser("serve bench", allow_abbrev=False)
    _add_session_flags(p)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--stream_chunks", type=int, default=32,
                   help="chunks per streamed request in the throughput "
                        "measurement (0 disables it)")
    p.add_argument("--device_iters", type=int, default=30,
                   help="calls per CUDA-event device-time measurement (0 "
                        "disables it; only on a card)")
    opts, rest = p.parse_known_args(argv)
    sess = _session(opts, rest)
    b = sess.batch_size
    shape = (b,) + tuple(sess.model.out_shape)
    x = np.random.default_rng(0).random(shape, np.float32)
    sess.warmup()
    result = {"batch_size": b, "iters": opts.iters,
              "device": str(sess.device)}
    for name, fn in (("encode", lambda: sess.encode(x)),
                     ("reconstruct", lambda: sess.reconstruct(x))):
        fn()
        # numpy in and out: the host clock spans the whole round trip
        t0 = time.perf_counter()
        for _ in range(opts.iters):
            fn()
        dt = (time.perf_counter() - t0) / opts.iters
        result[name] = {"ms_per_batch": round(dt * 1e3, 3),
                        "items_per_s": round(b / dt, 1)}
    if opts.stream_chunks:
        n = b * opts.stream_chunks
        xs = np.random.default_rng(1).random(
            (n,) + tuple(sess.model.out_shape), np.float32)
        sess.encode(xs)
        t0 = time.perf_counter()
        sess.encode(xs)
        dt = time.perf_counter() - t0
        result["encode_stream"] = {"items": n,
                                   "items_per_s": round(n / dt, 1)}
    if opts.device_iters and sess.device.type == "cuda":
        calls = _device_calls(sess, x)
        for name, ms in _device_ms(calls, opts.device_iters).items():
            result[name]["device_ms_per_batch"] = round(ms, 4)
            result[name]["device_items_per_s"] = round(b / ms * 1e3, 1)
    print(json.dumps(result))
    return result


def cmd_http(argv):
    """The HTTP front end over the session (``serve_http``: .npz and JSON
    bodies, /v1/encode|decode|reconstruct|sample|geodesic, GET
    /healthz)."""
    from lie_vae_tpu_torch import serve_http

    p = argparse.ArgumentParser("serve http", allow_abbrev=False)
    _add_session_flags(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8310)
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running every path once at startup")
    opts, rest = p.parse_known_args(argv)
    sess = _session(opts, rest)
    return serve_http.serve(sess, host=opts.host, port=opts.port,
                            warmup=not opts.no_warmup)


COMMANDS = {"export": cmd_export, "sample": cmd_sample,
            "trajectory": cmd_trajectory, "bench": cmd_bench,
            "http": cmd_http}


@ieee_float32()
def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit(f"usage: python -m lie_vae_tpu_torch.cli.serve "
                         f"{{{','.join(COMMANDS)}}} ...")
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
