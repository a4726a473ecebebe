"""The inputs a run makes from its seed: the same seed gives the same
inputs, whatever the number of render workers; the starting weights
follow the stated scheme."""
import numpy as np
import torch

from port_bench.harness import inputs


def test_pool_from_the_seed():
    p1, a = inputs.render_pool(2 ** 31 + 5, 96, 2, workers=2)
    p2, b = inputs.render_pool(2 ** 31 + 5, 96, 2, workers=1)
    assert np.array_equal(a, b) and np.array_equal(p1, p2)
    assert a.shape == (96, 2, 64, 64, 3) and a.dtype == np.uint8
    # a pair's second pose is its first moved by a small rotation
    rel = np.einsum("nji,njk->nik", p1[:, 0], p1[:, 1])
    angle = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2,
                              -1, 1))
    assert angle.max() < 0.6
    _, c = inputs.render_pool(2 ** 31 + 6, 96, 2, workers=1)
    assert not np.array_equal(a, c)


def test_weights_from_the_seed():
    from lie_vae_tpu_torch.models import flagship_model
    sd = flagship_model(device="cpu").state_dict()
    shapes = {k: (v.shape, v.dtype) for k, v in sd.items()}
    w1 = inputs.make_weights(shapes, 3, "cpu")
    w2 = inputs.make_weights(shapes, 3, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert float(w1["encoder.3.weight"].abs().max()) <= (50 * 16) ** -0.5
    assert float(w1["encoder.3.bias"].abs().max()) <= (50 * 16) ** -0.5
    assert float(w1["decoder.deconv.3.weight"].abs().max()) <= \
        (200 * 16) ** -0.5
    m = w1["reparameterize.0.mean_module.map.weight"]
    assert 5 < float(m.abs().max()) <= 10
    assert torch.equal(w1["encoder.1.weight"], torch.ones(50))
    assert torch.equal(w1["encoder.1.running_var"], torch.ones(50))
    assert torch.equal(w1["encoder.1.running_mean"], torch.zeros(50))
    assert abs(float(w1["decoder.item_rep"].std()) - 1) < 0.2
    w3 = inputs.make_weights(shapes, 4, "cpu")
    assert not torch.equal(w1["decoder.item_rep"], w3["decoder.item_rep"])


def test_noise_streams():
    n1, n2 = inputs.Noise(9), inputs.Noise(9)
    a = n1("train", (1, 4, 3))
    n1.keep = False
    n1("train", (1, 4, 3))
    assert torch.equal(a, n2("train", (1, 4, 3)))
    assert len(n1.kept) == 1 and torch.equal(n1.kept[0], a)
    assert not torch.equal(a, n2("eval", (1, 4, 3)))
