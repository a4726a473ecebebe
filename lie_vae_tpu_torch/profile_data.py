"""Time the data path at the scale of a pose manifest, on the host.

    python -m lie_vae_tpu_torch.profile_data [--poses PATH] [--num N] \\
        [--out DIR] [--device cuda|cpu]

Renders the first ``--num`` poses of ``--poses`` (default the tracked
32768-pose manifest ``data_poses/spherecube-v2-32k.npz``, all of it) into
a PNG directory as ``cli.gen_spherecube`` does, and times each stage of
what a training run then does with it (host clock, seconds):

- ``render``: the native renderer over all poses (batches of 256), and the
  numpy ray-caster over 256 of them, both scaled to 1024 images;
- ``png_filters``: one thread encoding the first 2048 images (filtering
  and ``zlib``, no file) with each of PNG's five filters, and with the
  per-row choice of libpng's heuristic, the alternative to the writer's
  one fixed filter: ms and bytes per image;
- ``write``: PNG encoding and writing (``gen_spherecube.write_pngs``), and
  the bytes on disk;
- the decode of 1024 files taken apart: reading the bytes, parsing and
  ``zlib`` (``png._parse``), the native unfilter; and the plain unfilter
  on 16 files;
- ``cold``: a fresh ``SphereCubeDataset`` gathering every item (one thread;
  ms per image), and one threaded ``BatchLoader`` epoch of 64 over another
  fresh open (its default 5 threads);
- ``warm_cache``: decoding everything and writing the disk cache, then an
  open that reads it back;
- ``to_device``: the uint8 images copied to ``--device`` in one transfer,
  as ``--device_data`` does.

The last line of its output is one JSON object of the figures, beside the
card's name and power limit (``nvidia-smi``) and the host's CPU count: the
figures are the host's, the card only receives the copy.
"""
import argparse
import json
import os
import shutil
import subprocess
import time
import zlib

import numpy as np
import torch

from lie_vae_tpu_torch.cli import gen_spherecube
from lie_vae_tpu_torch.data import (BatchLoader, SphereCubeDataset, _native,
                                    png, render_spherecube)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no card"


FILTER_NAMES = ("none", "sub", "up", "average", "paeth")


def _per_row_choice(raw, bpp):
    """The scanlines of the (H, row_bytes) rows with libpng's heuristic:
    per row the filter whose bytes, read as signed, have the least
    absolute sum."""
    cand = np.stack([png.filter_rows(raw, bpp, k) for k in range(5)])
    cost = np.abs(cand[:, :, 1:].view(np.int8).astype(np.int32)).sum(-1)
    return cand[np.argmin(cost, axis=0), np.arange(raw.shape[0])]


def png_filters(images):
    """ms and bytes per image of the compressed scanlines of ``images``
    (N, H, W, C) with each fixed filter and with the per-row choice."""
    n, h, w, c = images.shape
    raws = images.reshape(n, h, w * c)
    variants = {name: (lambda raw, k=k: png.filter_rows(raw, c, k))
                for k, name in enumerate(FILTER_NAMES)}
    variants["per_row"] = lambda raw: _per_row_choice(raw, c)
    out = {}
    for name, rows in variants.items():
        t, blobs = _timed(lambda: [zlib.compress(
            rows(raw).tobytes(), png.COMPRESS_LEVEL) for raw in raws])
        out[name] = {"ms_per_image": 1e3 * t / n,
                     "bytes_per_image": sum(map(len, blobs)) / n}
    return out


def profile(poses_path, num, out_dir, device):
    with np.load(poses_path) as f:
        r, q = f["r"][:num], f["q"][:num]
        style = f["style"].item().decode() if "style" in f.files else "v1"
    flat_r = r.reshape(-1, 3, 3)
    n = len(flat_r)
    names = [gen_spherecube.pose_name(i, j, q[i, j]) for i in range(len(r))
             for j in range(r.shape[1])]
    res = {"images": n, "style": style, "card": _card(),
           "cpus": os.cpu_count()}
    render_spherecube(flat_r[:8], style=style)             # build, warm up
    t, images = _timed(lambda: gen_spherecube.render_images(flat_r,
                                                            style=style))
    res["render_native_s"] = t
    res["render_native_s_per_1024"] = t * 1024 / n
    t, _ = _timed(lambda: render_spherecube(flat_r[:256], style=style,
                                            backend="numpy"))
    res["render_numpy_s_per_1024"] = t * 1024 / 256
    res["png_filters"] = png_filters(images[:2048])
    res["png_filter"] = FILTER_NAMES[png.FILTER]
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    res["write_s"], _ = _timed(lambda: gen_spherecube.write_pngs(
        images, names, out_dir))
    files = [os.path.join(out_dir, nm) for nm in names]
    res["png_bytes"] = sum(os.path.getsize(p) for p in files)

    sample = files[:1024]

    def read_all():
        out = []
        for p in sample:
            with open(p, "rb") as f:
                out.append(f.read())
        return out

    res["decode_1024"] = {}
    t, blobs = _timed(read_all)
    res["decode_1024"]["read_s"] = t
    t, parsed = _timed(lambda: [png._parse(b) for b in blobs])
    res["decode_1024"]["parse_zlib_s"] = t
    t, rows = _timed(lambda: [_native.png_unfilter(raw, h, w * c, c)
                              for w, h, c, raw in parsed])
    res["decode_1024"]["unfilter_native_s"] = t
    t, plain = _timed(lambda: [png.unfilter_plain(raw, h, w * c, c)
                               for w, h, c, raw in parsed[:16]])
    res["decode_1024"]["unfilter_plain_ms_per_image"] = 1e3 * t / 16
    if not all(np.array_equal(a, b) for a, b in zip(rows, plain)):
        raise AssertionError("the native unfilter differs from the plain")

    everything = np.arange(n)
    t, cold = _timed(lambda: SphereCubeDataset(out_dir).gather(everything))
    res["cold_s"] = t
    res["cold_ms_per_image"] = 1e3 * t / n
    if not np.array_equal(cold[2], images):
        raise AssertionError("the decoded images differ from the renders")
    loader = BatchLoader(SphereCubeDataset(out_dir), 64, seed=0)
    res["threaded_epoch_s"], _ = _timed(lambda: sum(1 for _ in loader))
    res["threaded_threads"] = loader.num_threads
    res["warm_cache_s"], _ = _timed(
        lambda: SphereCubeDataset(out_dir).warm_cache())
    res["cache_bytes"] = os.path.getsize(
        os.path.join(out_dir, SphereCubeDataset._DISK_CACHE_NAME))
    warm = SphereCubeDataset(out_dir)
    res["cache_read_s"], _ = _timed(warm.warm_cache)
    torch.zeros(1, device=device)                 # the context, outside

    def copy():
        x = torch.as_tensor(cold[2], device=device)
        if x.is_cuda:
            torch.cuda.synchronize()
        return x

    res["to_device_s"], x = _timed(copy)
    res["to_device"] = str(x.device)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser("profile_data")
    parser.add_argument("--poses", default=os.path.join(
        ROOT, "data_poses", "spherecube-v2-32k.npz"))
    parser.add_argument("--num", type=int, default=None,
                        help="poses (items) to take; default all")
    parser.add_argument("--out", default=os.path.join(
        ROOT, "build", "profile_data"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is available (pass "
                         "--device cpu)")
    res = profile(args.poses, args.num, args.out, args.device)
    shutil.rmtree(args.out, ignore_errors=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
