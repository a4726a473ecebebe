"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases, each timed:

1. card: name and power limit (nvidia-smi), torch, CUDA and nvcc versions;
2. build: the Wigner chain kernel (csrc/wigner_chain.cu) with nvcc;
3. kernel against its plain PyTorch version on the card, over
   L in {0, 1, 3, 6, 10}, C in {1, 10, 16}, B in {1, 64, 4103}, shared and
   per-sample spectra, transpose on and off; then both timed with CUDA
   events at the serving shape (B = 64) and at B = 4096;
4. serving: the flagship model with the converged reference weights
   (converged_state/torch_clean/best.pt), batch 64, on the card: warmup,
   sample, encode, reconstruct, geodesic and a ragged decode, checked for
   shape, finiteness, rotations and one kernel launch per decode chunk,
   then held against the same requests served on the CPU, and timed.

The last lines are a JSON record of the kernels, the card line, and
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; it does so too without a CUDA card.
"""
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "converged_state", "torch_clean",
                          "best.pt")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
# kernel vs plain chain: both float32, sums in another order
KERNEL_TOL = 1e-5
# GPU vs CPU serving, float32 with TF32 off: ten conv layers whose sums run
# in other orders (cuDNN's algorithms against the CPU's)
IMAGE_TOL = 1e-3
POSE_TOL = 1e-3


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, trials=20, per_trial=10):
    """Median over ``trials`` of the ms per call of ``fn``, each trial
    ``per_trial`` calls between two CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_trial):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_trial)
    return statistics.median(times)


def host_ms(fn, reps=20, warm=2):
    """Median host ms of ``fn``, which returns numpy (so it has synced)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def chain_bound(B, L, C, shared):
    """Least time for the chain on an H100 SXM, in ms, and what bounds it:
    each input read once and the output written once, against the float32
    operations (two J products of sum_l (2l+1)^2 C MACs and three
    z-rotations of 3 S C operations per sample)."""
    S = (L + 1) ** 2
    n_j = (L + 1) * (4 * (L + 1) ** 2 - 1) // 3
    spec = S * C * (1 if shared else B)
    nbytes = 4 * (3 * B + spec + n_j + B * S * C)
    flops = B * (2 * 2 * n_j * C + 3 * 3 * S * C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def check_rotations(R, what):
    R = np.asarray(R, np.float64).reshape(-1, 3, 3)
    orth = np.abs(np.swapaxes(R, -1, -2) @ R - np.eye(3)).max()
    det = np.linalg.det(R).min()
    print(f"   {what}: max|R^T R - I| {orth:.2e}, min det {det:.6f}")
    if not (orth < 1e-4 and det > 0):
        raise AssertionError(f"{what} are not rotations")


def check_images(x, shape, what):
    if x.shape != shape or not np.isfinite(x).all():
        raise AssertionError(f"{what}: shape {x.shape} (expected {shape}), "
                             f"finite {np.isfinite(x).all()}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() "
                 "is False")
    from lie_vae_tpu_torch.models import flagship_model
    from lie_vae_tpu_torch.ops import (group_matrix_to_eazyz,
                                       random_group_matrices)
    from lie_vae_tpu_torch.ops.kernels import _build
    from lie_vae_tpu_torch.ops.kernels import wigner_fused
    from lie_vae_tpu_torch.ops.wigner import block_wigner_apply_zjz
    from lie_vae_tpu_torch.serve import InferenceSession

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fused = wigner_fused.block_wigner_matrix_multiply_fused
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    t0 = phase("card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    print(f"   {card}")
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"device(s); {nvcc[-1]}; ninja: {shutil.which('ninja')}")
    done(t0)

    t0 = phase("build")
    lib = _build.library_path("wigner_chain")
    cached = os.path.exists(lib)
    tb = time.perf_counter()
    _build.build("wigner_chain")
    build_s = time.perf_counter() - tb
    print(f"   wigner_chain: {build_s:.2f} s "
          f"({'already built' if cached else 'nvcc'}) -> {lib}")
    done(t0)

    t0 = phase("Wigner chain kernel vs plain chain on the card")
    gen = torch.Generator(device="cpu").manual_seed(0)
    worst = 0.0
    for L in (0, 1, 3, 6, 10):
        S = (L + 1) ** 2
        worst_l, n = 0.0, 0
        for C in (1, 10, 16):
            for B in (1, 64, 4103):
                angles = group_matrix_to_eazyz(random_group_matrices(
                    B, gen, device="cpu").to(dev)).contiguous()
                for shared in (True, False):
                    shape = (S, C) if shared else (B, S, C)
                    x = torch.randn(shape, generator=gen).to(dev)
                    for tr in (False, True):
                        got = fused(angles, x, L, transpose=tr)
                        ref = block_wigner_apply_zjz(angles, x, L,
                                                     transpose=tr)
                        torch.cuda.synchronize()
                        err = (got - ref).abs().max().item()
                        tol = KERNEL_TOL * max(1.0, x.abs().max().item())
                        if not err <= tol:
                            raise AssertionError(
                                f"kernel != plain: L={L} C={C} B={B} "
                                f"shared={shared} transpose={tr}: "
                                f"{err:.3e} > {tol:.3e}")
                        worst_l = max(worst_l, err)
                        n += 1
        worst = max(worst, worst_l)
        print(f"   L={L:2d}: {n} cases, max |kernel - plain| {worst_l:.3e}")

    item_rep = torch.randn((49, 10), generator=gen).to(dev)
    timing = {}
    for B in (64, 4096):
        angles = group_matrix_to_eazyz(
            random_group_matrices(B, gen, device="cpu").to(dev)).contiguous()
        with torch.inference_mode():
            k_ms = cuda_ms(lambda: fused(angles, item_rep, 6))
            p_ms = cuda_ms(lambda: block_wigner_apply_zjz(angles, item_rep,
                                                          6))
        bound, bound_by = chain_bound(B, 6, 10, shared=True)
        timing[B] = (k_ms, p_ms, bound, bound_by)
        print(f"   B={B} L=6 C=10 shared: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {bound:.6f} ms ({bound_by})")
    done(t0)

    t0 = phase("serving: flagship, converged weights, batch 64, on the card")
    sess = InferenceSession.from_torch(CHECKPOINT, flagship_model(),
                                       batch_size=64, seed=0)
    fused.launches = 0
    steps = []

    def run(name, fn, chunks):
        before = fused.launches
        out = fn()
        steps.append((name, fused.launches - before, chunks))
        return out

    run("warmup", sess.warmup, 2)
    imgs = run("sample(64)", lambda: sess.sample(64), 1)
    enc = run("encode(64)", lambda: sess.encode(imgs), 0)
    rec = run("reconstruct(64)", lambda: sess.reconstruct(imgs), 1)
    pa, pb = enc["pose"][0], enc["pose"][1]
    geo = run("geodesic(16)", lambda: sess.geodesic(pa, pb, steps=16), 1)
    geo_poses = sess.geodesic(pa, pb, steps=16, decode=False)
    poses100 = np.concatenate([enc["pose"], enc["sample"][:36]])
    dec = run("decode(100)", lambda: sess.decode(poses100), 2)
    launches = fused.launches
    for name, got, want in steps:
        print(f"   {name}: {got} kernel launch(es), {want} decode chunk(s)")
        if got != want:
            raise AssertionError(f"{name}: {got} Wigner kernel launches, "
                                 f"expected one per decode chunk ({want})")
    if launches == 0:
        raise AssertionError("the serving path never launched the kernel")

    img = (64, 64, 3)
    check_images(imgs, (64,) + img, "sample")
    check_images(rec, (64,) + img, "reconstruct")
    check_images(geo, (16,) + img, "geodesic")
    check_images(dec, (100,) + img, "decode")
    if enc["sigma"].shape != (64, 3) or not np.isfinite(enc["sigma"]).all():
        raise AssertionError(f"encode sigma {enc['sigma'].shape}")
    check_rotations(enc["pose"], "encode poses")
    check_rotations(enc["sample"], "encode samples")
    check_rotations(geo_poses, "geodesic poses")

    cpu = InferenceSession.from_torch(CHECKPOINT, flagship_model("cpu"),
                                      batch_size=64, seed=0, device="cpu")
    cpu.warmup()
    c_imgs = cpu.sample(64)
    c_enc = cpu.encode(imgs)
    c_rec = cpu.reconstruct(imgs)
    c_geo = cpu.geodesic(pa, pb, steps=16)
    c_dec = cpu.decode(poses100)
    d_img = max(np.abs(a - b).max() for a, b in (
        (imgs, c_imgs), (rec, c_rec), (geo, c_geo), (dec, c_dec)))
    d_pose = max(np.abs(enc[k] - c_enc[k]).max()
                 for k in ("pose", "sigma", "sample"))
    print(f"   GPU vs CPU session: max |image diff| {d_img:.3e} (tol "
          f"{IMAGE_TOL}), max |pose/sigma diff| {d_pose:.3e} (tol "
          f"{POSE_TOL})")
    if not (d_img <= IMAGE_TOL and d_pose <= POSE_TOL):
        raise AssertionError("GPU serving disagrees with CPU serving")

    req = {"encode": lambda: sess.encode(imgs),
           "decode": lambda: sess.decode(enc["pose"]),
           "reconstruct": lambda: sess.reconstruct(imgs)}
    req_ms = {k: host_ms(fn) for k, fn in req.items()}
    print("   ms per request of 64 (host clock, numpy in and out): "
          + ", ".join(f"{k} {v:.3f}" for k, v in req_ms.items()))
    done(t0)

    k64, p64, b64, by64 = timing[64]
    k4k, p4k, b4k, _ = timing[4096]
    record = {"kernels": [{
        "name": "wigner_chain_fwd", "route": "cuda",
        "source": "lie_vae_tpu_torch/csrc/wigner_chain.cu",
        "replaces": "lie_vae_tpu/ops/kernels/wigner_fused.py:127",
        "launches": launches, "max_abs_err": worst,
        "ms": k64, "plain_ms": p64, "bound_ms": b64, "bound_by": by64,
        "library_ms": None,
        "shape": "B=64 L=6 C=10 shared",
        "ms_b4096": k4k, "plain_ms_b4096": p4k, "bound_ms_b4096": b4k}],
        "build_s": build_s, "request_ms": req_ms,
        "total_s": time.perf_counter() - t_start}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
