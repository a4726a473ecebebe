"""The decoder's transposed convolutions on the port's one path
(``nets.ConvTranspose2d``: on a card in float32 the hidden k4 s2 p1
layers through ``nets.conv_transpose_s2``, the sub-pixel forward and the
weight gradient of ``ops.kernels.deconv_wgrad``; the 1x1 -> 4x4 layer as
a matrix product; the rest through ``F.conv_transpose2d``), one case per
layer shape of the flagship decoder and the grayscale image head. The
card's route runs here too (the ``card_route`` fixture takes it for
every dtype and device; the kernel's plain version gives dw):

- the layer as the CPU runs it and as the card runs it, against
  ``F.conv_transpose2d`` and its autograd in float64 (output, dx, dw, db
  at 1e-12 of the largest entry), at an odd batch, with NCHW and
  channels_last inputs, and the card's route in float32 against the
  float64 reference (within float32 rounding, 1e-5);
- the converged ``best.pt`` loads strict and each layer, on the input a
  decode of real poses hands it, gives what ``F.conv_transpose2d`` gives
  with the same weights, forward and backward, within float32 rounding;
  and the whole decode equals the decode through ``F.conv_transpose2d``;
- split over a ``model`` axis (two ranks in threads; three and one for the
  odd heads) it equals the unsplit layer, in float64 at 1e-12;
- on a card (``cuda``): each layer at 512 images in IEEE float32 against
  ``F.conv_transpose2d`` in float64, with each pass's µs beside its 67
  TFLOP/s floor and the kernel's launches.
"""
import copy
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lie_vae_tpu_torch import compat
from lie_vae_tpu_torch.models import flagship_model, nets
from lie_vae_tpu_torch.ops.kernels import deconv_wgrad as dw_kernel
from lie_vae_tpu_torch.parallel.mesh import ModelSplit, take_shard
from lie_vae_tpu_torch.precision import ieee_float32
from test_torch_port_parallel import _Bus, _in_threads, _ThreadMesh
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "converged_state", "torch_clean", "best.pt")
# name: (C_in, C_out, H_in, stride, padding); head1 is the grayscale head
LAYERS = {"deconv.1": (490, 200, 1, 1, 0), "deconv.3": (200, 200, 4, 2, 1),
          "deconv.5": (200, 200, 8, 2, 1), "deconv.7": (200, 200, 16, 2, 1),
          "deconv.9": (200, 3, 32, 2, 1), "head1": (200, 1, 32, 2, 1)}


def _grads(fn, x, w, b, dy):
    """(y, dx, dw, db) of fn(x, w, b) for the output gradient dy."""
    x, w, b = (t.detach().requires_grad_(True) for t in (x, w, b))
    y = fn(x, w, b)
    return (y.detach(),) + torch.autograd.grad(y, (x, w, b), dy)


def _gap(a, ref):
    return float((a.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def _layer(name, dtype=torch.float32):
    c_in, c_out, _, stride, pad = LAYERS[name]
    return nets.ConvTranspose2d(c_in, c_out, 4, stride, pad).to(dtype)


def _through(layer):
    return lambda x, w, b: torch.func.functional_call(
        layer, {"weight": w, "bias": b}, (x,))


@pytest.fixture
def card_route(monkeypatch):
    """The card's route on the CPU and in any dtype: the hidden k4 s2 p1
    layers through ``nets.conv_transpose_s2``."""
    monkeypatch.setattr(nets, "_card_float32", lambda x: True)


def _reference(layer):
    return lambda x, w, b: F.conv_transpose2d(
        x, w, b, layer.stride, layer.padding)


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_conv_transpose2d(name, layout, monkeypatch):
    c_in, c_out, h, _, _ = LAYERS[name]
    gen = torch.Generator().manual_seed(len(name))
    layer = _layer(name, torch.float64)
    x = torch.randn((3, c_in, h, h), generator=gen, dtype=torch.float64)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(_reference(layer)(x, layer.weight, None).shape,
                     generator=gen, dtype=torch.float64)
    w, b = layer.weight.detach(), layer.bias.detach()
    ref = _grads(_reference(layer), x, w, b, dy)
    for got, want in zip(_grads(_through(layer), x, w, b, dy), ref):
        assert got.shape == want.shape      # the CPU's route
        assert _gap(got, want) <= 1e-12
    monkeypatch.setattr(nets, "_card_float32", lambda x: True)
    for got, want in zip(_grads(_through(layer), x, w, b, dy), ref):
        assert got.shape == want.shape      # the card's
        assert _gap(got, want) <= 1e-12
    # float32 on the card's route (the kernel's plain version here)
    layer32 = copy.deepcopy(layer).float()
    got32 = _grads(_through(layer32), x.float(), w.float(), b.float(),
                   dy.float())
    for got, want in zip(got32, ref):
        assert got.dtype == torch.float32
        assert _gap(got, want) <= 1e-5


@pytest.fixture(scope="module")
def converged():
    """The flagship model from the converged ``best.pt`` (loaded strict)
    and each transposed conv's input in a decode of 3 seeded poses."""
    model = flagship_model("cpu")
    state = compat.load_torch(CHECKPOINT)
    model.load_state_dict(state, strict=True)
    model.eval()
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in state.items()}
    seen = {}

    def keep(name):
        def hook(mod, args, out):
            seen.setdefault(name, args[0].detach())
        return hook

    hooks = [m.register_forward_hook(keep(n))
             for n, m in model.named_modules()
             if isinstance(m, torch.nn.ConvTranspose2d)]
    from lie_vae_tpu_torch.ops import random_group_matrices
    poses = random_group_matrices(
        3, generator=torch.Generator().manual_seed(7), device="cpu")
    with torch.no_grad(), ieee_float32():
        images = model.decode(poses[None])
    for hk in hooks:
        hk.remove()
    return model, seen, poses, images


@pytest.mark.parametrize("name", list(LAYERS))
def test_converged_layer_reconstructs_as_before(converged, name,
                                                card_route):
    model, seen, _, _ = converged
    key = "decoder.deconv." + ("9" if name == "head1" else name[-1])
    src = model.get_submodule(key)
    layer = _layer(name)
    with torch.no_grad():       # the grayscale head: deconv.9's first channel
        layer.weight.copy_(src.weight[:, :layer.out_channels])
        layer.bias.copy_(src.bias[:layer.out_channels])
    x = seen[key]
    w, b = layer.weight.detach(), layer.bias.detach()
    dy = torch.randn(_reference(layer)(x, w, b).shape,
                     generator=torch.Generator().manual_seed(1))
    ref = _grads(_reference(layer), x.double(), w.double(), b.double(),
                 dy.double())
    got = _grads(_through(layer), x, w, b, dy)
    old = _grads(_reference(layer), x, w, b, dy)
    for g, o, r in zip(got, old, ref):
        # as close to float64 as the path it replaced, within rounding
        assert _gap(g, r) <= max(2 * _gap(o, r), 1e-6)


def test_converged_decode_is_unchanged(converged, monkeypatch):
    """The whole decode of best.pt, as the CPU runs it and on the card's
    route, against the same decode with every transposed conv through
    ``F.conv_transpose2d``, in float32."""
    model, _, poses, images = converged
    monkeypatch.setattr(nets, "_card_float32", lambda x: True)
    with torch.no_grad(), ieee_float32():
        card = model.decode(poses[None])

    def through_cudnn(self, x, w, bias=None):
        return F.conv_transpose2d(x, w, bias, self.stride, self.padding)

    monkeypatch.setattr(nets.ConvTranspose2d, "_product", through_cudnn)
    with torch.no_grad(), ieee_float32():
        before = model.decode(poses[None])
    assert images.shape == card.shape == before.shape == (1, 3, 64, 64, 3)
    for got in (images, card):
        np.testing.assert_allclose(got.numpy(), before.numpy(), rtol=0,
                                   atol=2e-6)


class _Mesh(_ThreadMesh):
    def all_reduce_(self, t, axis="data"):
        t.copy_(sum(self.bus.exchange(self.rank, t.clone())))
        return t


@pytest.mark.parametrize("name", list(LAYERS))
def test_model_split_equals_one_process(name, card_route):
    c_in, c_out, h, _, _ = LAYERS[name]
    n = 2 if c_out % 2 == 0 else c_out
    torch.manual_seed(0)
    layer = _layer(name, torch.float64)
    x = torch.randn((3, c_in, h, h), dtype=torch.float64, requires_grad=True)
    y = layer(x)
    dout = torch.randn_like(y)
    (y * dout).sum().backward()
    bus = _Bus(n)

    def rank(r):
        split = ModelSplit(_Mesh(bus, r, "model"), 1)
        part = copy.deepcopy(layer)
        shard = torch.nn.Parameter(take_shard(layer.weight.data, 1, r, n))
        part.weight, part.model_split = shard, split
        xr = x.detach().clone().requires_grad_(True)
        yr = part(xr)
        (yr * dout).sum().backward()
        return yr.detach(), xr.grad, shard.grad, part.bias.grad

    for r, (yr, gx, gw, gb) in enumerate(_in_threads(rank, n)):
        assert _gap(yr, y.detach()) <= 1e-12
        assert _gap(gx, x.grad) <= 1e-12
        assert _gap(gw, take_shard(layer.weight.grad, 1, r, n)) <= 1e-12
        assert _gap(gb, layer.bias.grad) <= 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_on_the_card(cuda_device, name):
    """512 images in IEEE float32 against F.conv_transpose2d in float64 on
    the card (1e-4 of the largest entry); prints each pass's µs (CUDA
    events) beside its floor at 67 TFLOP/s and the kernel's launches."""
    from lie_vae_tpu_torch.profile_train import passes, time_ms
    c_in, c_out, h, stride, _ = LAYERS[name]
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer = _layer(name).cuda()
    x = torch.randn((512, c_in, h, h), device="cuda", generator=gen)
    with ieee_float32():
        w, b = layer.weight.detach(), layer.bias.detach()
        dy = torch.randn(_reference(layer)(x, w, b).shape, device="cuda",
                         generator=gen)
        before = dw_kernel.deconv_wgrad.launches
        got = _grads(_through(layer), x, w, b, dy)
        launches = dw_kernel.deconv_wgrad.launches - before
        ref = _grads(_reference(layer), x.double(), w.double(), b.double(),
                     dy.double())
        flops = 2.0 * c_in * c_out * 16 * h * h * 512
        for p, call in passes(_through(layer), x, w, b).items():
            us = 1e3 * time_ms(call, 3, 3)
            print(f"{name} {p}: {us:.1f} us, floor {flops / 67e6:.1f} us, "
                  f"{launches} launches")
    assert launches == int(stride == 2 and dw_kernel.supports(c_out, h))
    for g, r in zip(got, ref):
        assert _gap(g, r) <= 1e-4
