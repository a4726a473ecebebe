"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark's
files (the same cells, each configuration cut to a width the CPU runs in
seconds), and the card, looked for inside a fixture."""
import json
import os
import shutil

import pytest
import torch

from port_bench.harness.spec import BENCH_DIR, ROOT

TINY_MODEL = {"degrees": 2, "rep_copies": 2, "conv_hidden": 4,
              "deconv_hidden": 8}
TINY_TRAIN = {"kind": "train", "images_per_step": 8, "pool_images": 32,
              "setup_steps": 3, "trace_steps": 2}
TINY_SERVE = {"images_per_request": 8, "artifact_batch": 8,
              "pool_images": 32, "distinct_requests": 4,
              "sample_requests": 3, "trace_requests": 3}


def make_tiny_root(path):
    """A checkout-like directory: BENCHMARK.json and the data files of
    ``port_bench/`` with tiny configurations and traffic, and a tiny
    served checkpoint (seeded random weights, running statistics moved
    off 0 and 1)."""
    bench = os.path.join(path, "port_bench")
    for d in ("configs", "traffic", "limits", "metrics", "reference"):
        shutil.copytree(os.path.join(BENCH_DIR, d), os.path.join(bench, d))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    for name in os.listdir(os.path.join(bench, "configs")):
        f = os.path.join(bench, "configs", name)
        with open(f) as fh:
            cfg = json.load(fh)
        cfg["model"].update(TINY_MODEL)
        with open(f, "w") as fh:
            json.dump(cfg, fh)
    with open(os.path.join(bench, "traffic", "train.json"), "w") as fh:
        json.dump(TINY_TRAIN, fh)
    for name in os.listdir(os.path.join(bench, "traffic")):
        f = os.path.join(bench, "traffic", name)
        with open(f) as fh:
            traffic = json.load(fh)
        if traffic["kind"] == "serve":
            traffic.update(TINY_SERVE)
            with open(f, "w") as fh:
                json.dump(traffic, fh)
    from lie_vae_tpu_torch.models import LieVAE
    with open(os.path.join(bench, "configs", "flagship.json")) as fh:
        cfg = json.load(fh)
    torch.manual_seed(0)
    sd = LieVAE(**cfg["model"], device="cpu").state_dict()
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = torch.rand_like(sd[k]) + 0.5
        elif k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn_like(sd[k])
    target = os.path.join(path, cfg["serve_weights"])
    os.makedirs(os.path.dirname(target), exist_ok=True)
    torch.save(sd, target)
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


@pytest.fixture
def float64():
    """torch's default dtype float64 for the test: the program and the
    reference then agree to rounding of float64."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")
