"""The port's ``parallel`` held against the JAX package's, in one process.

- ``make_mesh`` over local devices: its shapes, and the errors for more
  devices than exist, an empty axis and a card that is not there;
- ``param_shardings`` picks the tensors JAX's rule picks, by path (through
  ``compat``'s key table), on the flagship's shape at small width and on
  the toy model, at two size thresholds, over a (4 x 2) mesh;
- ``BatchLoader(num_shards, shard_index)`` yields the JAX loader's index
  batches bit for bit, over two epochs;
- the column-parallel layers (Linear, Conv2d, ConvTranspose2d split over a
  ``model`` axis of 2) and BatchNorm over a ``data`` axis of 2 against the
  unsplit layer on the whole batch: outputs, input gradients, parameter
  gradients and running statistics, in float64 at 1e-12. The two ranks run
  as two threads of this process whose collectives meet at a barrier (the
  mesh's ``all_gather`` and ``all_reduce_``), so the autograd Functions are
  the ones the process mesh runs;
- ``batch_spec``/``shard_batch`` on a device mesh.

The multi-process runs are ``test_torch_port_distributed.py``'s.
"""
import copy
import threading

import numpy as np
import pytest
import torch

import jax

import test_torch_port_models as models_test
import test_torch_port_modes as modes_test
from lie_vae_tpu.data.loader import BatchLoader as JaxBatchLoader
from lie_vae_tpu.models import LieVAE as JaxLieVAE
from lie_vae_tpu.parallel import make_mesh as jax_make_mesh
from lie_vae_tpu.parallel import param_shardings as jax_param_shardings
from lie_vae_tpu_torch.compat import _jax_key_mapping
from lie_vae_tpu_torch.data import BatchLoader
from lie_vae_tpu_torch.models import LieVAE
from lie_vae_tpu_torch.models import nets
from lie_vae_tpu_torch.parallel import (batch_spec, make_mesh,
                                        param_shardings, shard_batch)
from lie_vae_tpu_torch.parallel.mesh import (ModelSplit, shard_state,
                                             take_shard)
from test_torch_port_train import SMALL
from test_torch_port_models import (  # noqa: F401
    no_persistent_compile_cache)

TOY = dict(latent_mode="so3", decoder_mode="action", encode_mode="toy",
           deconv_mode="toy", mean_mode="s2s2", degrees=2, rep_copies=3)


# ------------------------------------------------------------ the mesh

@pytest.mark.parametrize("n_data,n_model,devices,shape", [
    (2, 1, ["cpu"] * 2, (2, 1)), (2, 2, ["cpu"] * 4, (2, 2)),
    (None, 2, ["cpu"] * 6, (3, 2)), (None, 1, None, (1, 1))])
def test_make_mesh_shapes(n_data, n_model, devices, shape):
    mesh = make_mesh(n_data, n_model, devices=devices)
    assert (mesh.shape["data"], mesh.shape["model"]) == shape
    assert mesh.axis_names == ("data", "model")
    assert len(mesh.devices) == shape[0] * shape[1]
    assert not mesh.distributed


@pytest.mark.parametrize("n_data,n_model,devices,match", [
    (3, 1, ["cpu"] * 2, "needs 3 devices, have 2"),
    (2, 2, ["cpu"] * 3, "needs 4 devices, have 3"),
    (None, 4, ["cpu"] * 2, "needs 0 devices, have 2"),
    (2, 0, ["cpu"] * 2, "at least 1"),
    (1, 1, ["cuda:0"], "card")])
def test_make_mesh_errors(n_data, n_model, devices, match, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match=match):
        make_mesh(n_data, n_model, devices=devices)


# --------------------------------------------------- the sharding rule

@pytest.mark.parametrize("cfg", [SMALL, TOY], ids=["flagship", "toy"])
@pytest.mark.parametrize("min_size", [256, 1 << 13])
def test_param_shardings_pick_jax_rules_tensors(cfg, min_size):
    flat = modes_test._flat_weights(JaxLieVAE(**cfg), seed=0)
    params = models_test._unflatten(flat)["params"]
    jmesh = jax_make_mesh(4, 2)
    specs = jax.tree_util.tree_flatten_with_path(
        jax_param_shardings(params, jmesh, min_size=min_size))[0]
    jax_split = {"params/" + "/".join(k.key for k in path)
                 for path, sh in specs if "model" in tuple(sh.spec)}
    model = LieVAE(device="cpu", **cfg)
    where = param_shardings(model, make_mesh(4, 2, devices=["cpu"] * 8),
                            min_size=min_size)
    table, _ = _jax_key_mapping(model)
    port_split = {table[name][0] for name, dim in where.items()
                  if dim is not None}
    assert port_split == jax_split
    assert where.keys() == dict(model.named_parameters()).keys()
    for name, dim in where.items():
        if dim is not None:        # the output features, in torch's layout
            assert dim == (1 if name.startswith("decoder.deconv") else 0)
    if min_size == 256:
        assert len(port_split) >= 3


# ----------------------------------------------------------- the loader

class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def gather(self, idx):
        return (np.asarray(idx),)


@pytest.mark.parametrize("n,batch,shards,shuffle,drop_last", [
    (70, 32, 2, True, True), (70, 32, 4, False, False),
    (130, 64, 2, True, False), (64, 16, 4, True, True),
    (10, 4, 1, True, False)])
def test_sharded_loader_matches_jax(n, batch, shards, shuffle, drop_last):
    for shard in range(shards):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3,
                  num_shards=shards, shard_index=shard)
        ours, theirs = (BatchLoader(_Items(n), batch, **kw),
                        JaxBatchLoader(_Items(n), batch, **kw))
        assert len(ours) == len(theirs)
        for _ in range(2):
            got = [b[0] for b in ours]
            want = [b[0] for b in theirs]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_sharded_loader_rejects_an_uneven_batch():
    with pytest.raises(ValueError, match="divide evenly"):
        BatchLoader(_Items(10), 5, num_shards=2)


# ------------------------------------- the split layers, two ranks in threads

class _Bus:
    """Where two threads' collectives meet: each puts its tensor in its slot
    and reads everyone's once all have."""

    def __init__(self, n):
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=20)

    def exchange(self, rank, t):
        self.slots[rank] = t
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class _ThreadMesh:
    """A rank of an axis of size 2 whose collectives go through a
    :class:`_Bus` (the mesh's ``all_gather`` and ``all_reduce_``)."""

    def __init__(self, bus, rank, axis):
        self.shape = {"data": 1, "model": 1}
        self.shape[axis] = len(bus.slots)
        self.data_index = rank if axis == "data" else 0
        self.model_index = rank if axis == "model" else 0
        self.bus, self.rank = bus, rank

    def all_gather(self, t, axis="model", dim=0):
        return torch.cat(self.bus.exchange(self.rank, t.contiguous()),
                         dim=dim)

    def all_reduce_(self, t, axis="data"):
        parts = self.bus.exchange(self.rank, t.clone())
        t.copy_(parts[0] + parts[1])
        return t


def _in_threads(fn, n=2):
    out, errors = [None] * n, []

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as e:           # reported in the test
            errors.append(e)

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    return out


_LAYERS = {
    "linear": (lambda: nets.Linear(6, 8), (5, 6), 0, -1),
    "conv": (lambda: nets.Conv2d(3, 4, 4, 2, 1), (2, 3, 8, 8), 0, 1),
    "deconv": (lambda: nets.ConvTranspose2d(4, 6, 4, 2, 1), (2, 4, 4, 4), 1,
               1)}


@pytest.mark.parametrize("kind", list(_LAYERS))
def test_column_parallel_backward_equals_the_unsplit_layer(kind):
    make, shape, wdim, fdim = _LAYERS[kind]
    torch.manual_seed(0)
    layer = make().double()
    x = torch.randn(shape, dtype=torch.float64, requires_grad=True)
    y = layer(x)
    dout = torch.randn_like(y)
    (y * dout).sum().backward()
    bus = _Bus(2)

    def rank(r):
        split = ModelSplit(_ThreadMesh(bus, r, "model"), wdim)
        part = copy.deepcopy(layer)
        shard = torch.nn.Parameter(take_shard(layer.weight.data, wdim, r, 2))
        shard.model_split = split
        part.weight, part.model_split = shard, split
        xr = x.detach().clone().requires_grad_(True)
        yr = part(xr)
        (yr * dout).sum().backward()
        return yr.detach(), xr.grad, shard.grad, part.bias.grad

    outs = _in_threads(rank)
    for r, (yr, gx, gw, gb) in enumerate(outs):
        np.testing.assert_allclose(yr, y.detach(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(gx, x.grad, rtol=0, atol=1e-12)
        np.testing.assert_allclose(gw, take_shard(layer.weight.grad, wdim, r,
                                                  2), rtol=0, atol=1e-12)
        np.testing.assert_allclose(gb, layer.bias.grad, rtol=0, atol=1e-12)
    assert y.shape[fdim] == 2 * outs[0][2].shape[wdim]


class _StateMesh(_ThreadMesh):
    """A rank of :class:`_ThreadMesh` as ``shard_state`` takes it: a
    process mesh whose replicas start equal (the broadcast a no-op)."""
    distributed = True

    def broadcast_(self, t):
        return t


def test_shard_state_splits_the_ports_linear_and_conv_layers():
    """``shard_state`` splits a port ``Linear`` (as the MLP decoder's
    Linear(50, 490)) and a ``ConvTranspose2d`` over two ``model`` ranks, and
    the split model equals the whole one, forward and backward."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        nets.Linear(50, 490), torch.nn.ReLU(),
        torch.nn.Unflatten(1, (490, 1, 1)),
        nets.ConvTranspose2d(490, 8, 4, 1, 0)).double()
    x = torch.randn((3, 50), dtype=torch.float64)
    y = model(x)
    dout = torch.randn_like(y)
    (y * dout).sum().backward()
    bus = _Bus(2)

    def rank(r):
        part = copy.deepcopy(model)
        for p in part.parameters():
            p.grad = None
        where = shard_state(part, _StateMesh(bus, r, "model"))
        yr = part(x)
        (yr * dout).sum().backward()
        return where, yr.detach(), {n: p.grad
                                    for n, p in part.named_parameters()}

    for r, (where, yr, grads) in enumerate(_in_threads(rank)):
        assert where == {"0.weight": 0, "0.bias": None, "3.weight": 1,
                         "3.bias": None}
        np.testing.assert_allclose(yr, y.detach(), rtol=0, atol=1e-12)
        for n, p in model.named_parameters():
            want = (p.grad if where[n] is None
                    else take_shard(p.grad, where[n], r, 2))
            assert grads[n].shape == want.shape
            np.testing.assert_allclose(grads[n], want, rtol=0, atol=1e-12)


def test_batchnorm_takes_the_global_batch_statistics():
    torch.manual_seed(1)
    bn = nets.BatchNorm2d(3, eps=1e-5, momentum=0.1).double()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 2.0)
        bn.bias.uniform_(-1.0, 1.0)
    x = 3.0 + 2.0 * torch.randn((8, 3, 5, 5), dtype=torch.float64)
    x.requires_grad_(True)
    dout = torch.randn((8, 3, 5, 5), dtype=torch.float64)
    whole = copy.deepcopy(bn)
    y = whole(x)
    (y * dout).sum().backward()
    bus = _Bus(2)

    def rank(r):
        part = copy.deepcopy(bn)
        part.data_mesh = _ThreadMesh(bus, r, "data")
        rows = slice(4 * r, 4 * r + 4)
        xr = x.detach()[rows].clone().requires_grad_(True)
        yr = part(xr)
        (yr * dout[rows]).sum().backward()
        return yr.detach(), xr.grad, part

    outs = _in_threads(rank)
    np.testing.assert_allclose(torch.cat([o[0] for o in outs]), y.detach(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(torch.cat([o[1] for o in outs]), x.grad,
                               rtol=0, atol=1e-12)
    for name in ("weight", "bias"):           # the ranks' sum is the whole's
        got = sum(getattr(o[2], name).grad for o in outs)
        np.testing.assert_allclose(got, getattr(whole, name).grad, rtol=0,
                                   atol=1e-12)
    for o in outs:
        for name in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(o[2], name),
                                       getattr(whole, name), rtol=0,
                                       atol=1e-12)
        assert int(o[2].num_batches_tracked) == 1


def test_shard_batch_on_a_device_mesh():
    mesh = make_mesh(2, devices=["cpu", "cpu"])
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    assert batch_spec(mesh, 6) == [slice(0, 3), slice(3, 6)]
    parts = shard_batch(x, mesh)
    np.testing.assert_array_equal(torch.cat(parts), x)
    with pytest.raises(ValueError, match="do not split"):
        batch_spec(mesh, 5)
