"""What a run feeds the program, made from ``--seed`` by the benchmark
itself: the pool of uint8 renders, the starting weights, the posterior
noise, and the in-memory dataset the training harness reads.

Every stream is its own ``numpy.random.SeedSequence([seed, tag])``, so a
seed gives the same inputs on every machine and the streams do not
overlap.
"""
import multiprocessing
import os

import numpy as np
import torch

from port_bench.harness import render

POSES, WEIGHTS, NOISE, REQUESTS, SAMPLE = range(5)
RENDER_CHUNK = 64
# the training harness's noise streams
STREAMS = ("train", "eval", "ll")


def stream(seed, tag):
    """A numpy Generator of the run's ``seed`` and the stream ``tag``."""
    return np.random.default_rng(np.random.SeedSequence([seed, tag]))


def stream_seed(seed, tag):
    """A 64-bit seed for a torch Generator of that stream."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(
        2, np.uint64)[0])


def render_pool(seed, items, per_item, size=64, style="v1", workers=None):
    """Poses (items, per_item, 3, 3) from the seed and their uint8 renders
    (items, per_item, size, size, 3), rendered in chunks over a pool of
    worker processes (one per CPU, 8 at most; each imports numpy alone)."""
    poses = render.sample_poses(items, per_item, stream(seed, POSES))
    flat = poses.reshape(-1, 3, 3)
    chunks = [(flat[i:i + RENDER_CHUNK], size, style)
              for i in range(0, len(flat), RENDER_CHUNK)]
    workers = workers or min(8, os.cpu_count() or 1)
    if workers > 1 and len(chunks) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(chunks))) as pool:
            parts = pool.map(render.render_chunk, chunks)
            pool.close()
            pool.join()
    else:
        parts = [render.render_chunk(c) for c in chunks]
    images = np.concatenate(parts).reshape(
        (items, per_item, size, size, 3))
    return poses, images


def _fan_in(shape):
    return int(np.prod(shape[1:])) if len(shape) > 1 else None


def make_weights(shapes, seed, device):
    """Starting weights for the state_dict ``shapes`` (name -> (shape,
    dtype)), drawn on ``device`` by one seeded torch Generator in two
    calls: BatchNorm scale 1 and shift 0, running mean 0 and variance 1;
    the decoder's spectrum ``item_rep`` standard normal; the S2xS2 mean
    head uniform in (-10, 10) as the reference initialises it; every other
    weight and bias uniform in +-1/sqrt(fan_in) of its layer's weight, as
    torch's layers start."""
    names = list(shapes)
    fan = {}
    for name in names:
        shape, _ = shapes[name]
        if name.endswith(".weight") and len(shape) > 1:
            fan[name[:-len(".weight")]] = _fan_in(shape)
    uniform, normal = [], []
    for name in names:
        shape, dtype = shapes[name]
        if not dtype.is_floating_point or name.endswith(
                ("running_mean", "running_var")):
            continue
        layer = name.rsplit(".", 1)[0]
        if name.endswith("item_rep"):
            normal.append(name)
        elif layer in fan or "mean_module" in name:
            uniform.append(name)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, WEIGHTS))
    n_u = sum(int(np.prod(shapes[n][0])) for n in uniform)
    n_n = sum(int(np.prod(shapes[n][0])) for n in normal)
    u = torch.rand(n_u, generator=gen, device=device) * 2 - 1
    z = torch.randn(n_n, generator=gen, device=device)
    out, iu, iz = {}, 0, 0
    for name in names:
        shape, dtype = shapes[name]
        size = int(np.prod(shape))
        if name in uniform:
            layer = name.rsplit(".", 1)[0]
            bound = 10.0 if "mean_module" in name else fan[layer] ** -0.5
            t = u[iu:iu + size] * bound
            iu += size
        elif name in normal:
            t = z[iz:iz + size]
            iz += size
        elif name.endswith(("running_var", ".weight")):
            t = torch.ones(size, device=device)
        else:
            t = torch.zeros(size, device=device)
        out[name] = t.reshape(shape).to(dtype).contiguous()
    return out


class Noise:
    """The posterior noise the training harness asks for, ``(stream,
    shape)`` -> standard normals on the CPU in float32, each stream its own
    torch Generator of the run's seed. While ``keep`` is true the training
    stream's draws are kept, in order, for the reference."""

    def __init__(self, seed):
        self.seed = seed
        self.gens = {}
        self.keep = True
        self.kept = []

    def __call__(self, stream_name, shape):
        gen = self.gens.get(stream_name)
        if gen is None:
            gen = torch.Generator().manual_seed(stream_seed(
                self.seed, NOISE * 100 + STREAMS.index(stream_name)))
            self.gens[stream_name] = gen
        x = torch.randn(shape, generator=gen, dtype=torch.float32)
        if self.keep and stream_name == "train":
            self.kept.append(x.clone())
        return x


class PoolDataset:
    """The pool as the training harness reads a dataset of renders:
    ``gather`` gives (indices, poses, uint8 images) of items, and
    ``prep_batch`` flattens an item's images into the batch (pairs on rows
    2i and 2i + 1), as ``data.shapes``' datasets do."""

    rgb = True
    num_workers = 0

    def __init__(self, poses, images):
        self.poses, self.images = poses, images
        self.per_item = images.shape[1]

    def __len__(self):
        return len(self.images)

    def gather(self, indices):
        idx = np.asarray(indices)
        if self.per_item == 1:
            return idx, self.poses[idx, 0], self.images[idx, 0]
        return idx, self.poses[idx], self.images[idx]

    def prep_batch(self, batch):
        if self.per_item == 1:
            return batch
        return [np.asarray(t).reshape((-1,) + np.shape(t)[2:])
                for t in batch]
