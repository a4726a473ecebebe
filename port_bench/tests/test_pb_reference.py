"""The plain reference against float64: the program's own float64 step
and session on the CPU at a tiny size (the same arithmetic, so the two
agree to float64 rounding), the reference in float32 against itself in
float64, and its pieces against independent forms."""
import math

import numpy as np
import pytest
import torch

from port_bench.harness import check, serve, train
from port_bench.harness.spec import Bench


@pytest.mark.parametrize("workload", ["flagship-train", "scpairs_reg-train"])
def test_train_steps_match_the_program_in_float64(tiny_root, workload,
                                                  float64):
    bench = Bench(tiny_root)
    cell = bench.cell(workload)
    _, _, numbers = train.run(bench, cell, 123, 0.1, False, device="cpu",
                              workers=1)
    assert max(numbers.values()) < 1e-9, numbers


def test_reconstruct_matches_the_program_in_float64(tiny_root, float64):
    bench = Bench(tiny_root)
    _, _, numbers = serve.run(bench, bench.cell("flagship-serve_peak"), 9, 0.1,
                              False, device="cpu", workers=1)
    assert numbers["recon_gap"] < 1e-12


def test_float32_reference_near_its_float64(tiny_root):
    bench = Bench(tiny_root)
    cfg = bench.config("scpairs_reg")
    r = train.TrainRun(cfg, bench.traffic("train"), 31, "cpu", workers=1)
    r.first_steps()
    module = bench.reference("lievae")
    batches, steps = r.reference_inputs()
    out32 = module.train_steps(r.init, batches, steps, cfg["model"],
                               cfg["train"])
    w64 = {k: v.double() if v.is_floating_point() else v
           for k, v in r.init.items()}
    steps64 = [{k: v.double() if isinstance(v, torch.Tensor) else v
                for k, v in s.items()} for s in steps]
    out64 = module.train_steps(w64, batches, steps64, cfg["model"],
                               cfg["train"])
    numbers = check.train_numbers(train.readings(out32, r.init),
                                  train.readings(out64, w64))
    assert numbers["loss1_gap"] < 1e-5 and numbers["loss3_gap"] < 1e-3 \
        and numbers["grad_gap"] < 0.1, numbers


def test_rotation_against_the_programs_shear(float64):
    from lie_vae_tpu_torch.losses import rotate_images_shear
    module = Bench().reference("lievae")
    g = torch.Generator().manual_seed(0)
    img = torch.rand((6, 16, 16, 3), generator=g)
    theta = torch.tensor([0.0, 0.3, -2.0, math.pi / 2, 3.0, -0.7])
    got = module.rotate(img, theta)
    assert torch.allclose(got, rotate_images_shear(img, theta), atol=1e-12)
    # a quarter turn is exact, and the identity is the identity
    assert torch.equal(got[0], img[0])
    assert torch.allclose(got[3], torch.rot90(img[3], 1, dims=(0, 1)))


def test_wigner_blocks_are_a_representation(float64):
    """D(R1 R2) = D(R2) D(R1) block by block (the reference's convention
    acts on the right), each D orthogonal: from the reference's own tables
    and its ZYZ angles, a check independent of the program; the angles'
    clamp at acos(1 - 1e-6) limits it to about 1e-6."""
    module = Bench().reference("lievae")
    g = torch.Generator().manual_seed(1)
    v = torch.randn((4, 3), generator=g)
    w = torch.randn((4, 3), generator=g)
    r1, r2 = module.expmap(v), module.expmap(w)
    L = 4
    eye = torch.eye((L + 1) ** 2)

    def dense(R):
        return module.wigner_action(module.zyz(R), eye, L)

    assert torch.allclose(dense(r1 @ r2), dense(r2) @ dense(r1), atol=1e-5)
    d = dense(r1)
    assert torch.allclose(d @ d.transpose(1, 2), eye.expand(4, -1, -1),
                          atol=1e-5)


def test_kl_against_quadrature_free_limit(float64):
    """At a small sigma the wrapped density is the algebra Gaussian times
    the exp-map volume, so the KL is the Gaussian's entropy gap to the
    Haar measure, to within the volume's correction."""
    module = Bench().reference("lievae")
    sigma = torch.full((1, 3), 1e-3)
    v = torch.zeros((1, 1, 3)) + 1e-4
    kl = module.kl(v, sigma, 10)
    gauss = (-0.5 * (1e-4 / 1e-3) ** 2 * 3 - 3 * math.log(1e-3)
             - 1.5 * math.log(2 * math.pi))
    assert float(kl) == pytest.approx(gauss - module.LOG_HAAR, rel=1e-6)
