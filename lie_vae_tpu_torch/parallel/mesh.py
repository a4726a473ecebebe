"""Process and device meshes, and the sharding rules of the port.

Counterpart of the JAX package's ``parallel/mesh.py``. In JAX a mesh is
one logical program: GSPMD inserts the collectives, so a step over a mesh
computes what the single-device step computes on the global batch. The
port keeps that meaning with one process per mesh position and
``torch.distributed``:

- the ``data`` axis splits every global batch into contiguous row blocks,
  one per data index. Each rank draws the noise of the whole batch and
  keeps its rows; BatchNorm takes its statistics over the global batch (an
  all-reduce over the ``data`` group); the gradients are averaged over it
  (one all-reduce of a flat buffer);
- the ``model`` axis splits the output features of the big layers
  (:func:`param_shardings`, JAX's rule): a split layer computes its slice
  of features, an all-gather restores the replicated activation, and the
  backward takes the rank's own slice of the gradient (every rank computes
  the same gradient downstream of the gather) while the layer's input
  gradient is summed over the ``model`` group.

Ranks form an ``n_data x n_model`` grid, rank = data_index * n_model +
model_index, as JAX lays devices into the mesh. Without a process group a
mesh is a list of local devices (the serving session's, one replica of the
weights on each).

The backend is chosen in the open and printed: NCCL when each rank has a
card of its own, gloo on the CPU and when several ranks share one card
(NCCL refuses two ranks on one device). Only ``all_reduce``,
``all_gather`` and ``broadcast`` are used, which gloo runs on CUDA tensors
(torch 2.11 on the H100 machine does; ``reduce_scatter`` is left out).
"""
import datetime
import os

import torch
import torch.distributed as dist

AXES = ("data", "model")
TIMEOUT_S = 300

# this process's device, as initialize_distributed chose it
_RANK_DEVICE = None


def _env_int(name, default):
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device="cuda", backend=None,
                           timeout_s=TIMEOUT_S):
    """Join the process group once per process; returns this rank's device.

    Without arguments the launcher's environment names the group
    (``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``python -m torch.distributed.run`` sets them);
    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id`` names it explicitly (``tcp://``). ``device`` "cpu" runs
    the rank on the CPU over gloo; "cuda" gives the rank the card of its
    local rank and NCCL when there are as many cards as local ranks, else
    card ``local_rank % cards`` over gloo. ``backend`` overrides the
    choice. Collectives time out after ``timeout_s``."""
    global _RANK_DEVICE
    if coordinator_address is None:
        init_method = "env://"
        rank = _env_int("RANK", 0)
        world = _env_int("WORLD_SIZE", 1)
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    kind = torch.device(device).type
    if kind == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("initialize_distributed(device='cuda'): no "
                               "CUDA card is available (pass device='cpu')")
        own = cards >= local_world
        rank_device = torch.device("cuda", local_rank % cards)
        chosen = backend or ("nccl" if own else "gloo")
        why = ("a card per rank" if own else
               f"{local_world} local ranks share {cards} card(s)")
    else:
        rank_device = torch.device("cpu")
        chosen = backend or "gloo"
        why = "ranks on the CPU"
    if not dist.is_initialized():
        if kind == "cuda":
            torch.cuda.set_device(rank_device)
        dist.init_process_group(
            chosen, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE = rank_device
    print(f"rank {rank}/{world}: backend {dist.get_backend()} on "
          f"{rank_device} ({why})", flush=True)
    return rank_device


class Mesh:
    """An (n_data x n_model) mesh: of processes (``distributed``, this
    rank's position, its ``data`` and ``model`` groups) or of the local
    ``devices`` (one replica of the weights on each)."""

    def __init__(self, n_data, n_model, devices, distributed):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.axis_names = AXES
        self.devices = [torch.device(d) for d in devices]
        self.distributed = distributed
        self.rank, self.world = 0, 1
        self.data_index = self.model_index = 0
        self.data_group = self.model_group = None
        self.backend = None

    @property
    def device(self):
        """This rank's device (a process mesh), or the first device."""
        return self.devices[0]

    @property
    def is_main(self):
        """Whether this is rank 0 (the one that logs and writes)."""
        return self.rank == 0

    def __repr__(self):
        where = (f"rank {self.rank} of {self.world} ({self.backend})"
                 if self.distributed else
                 ", ".join(str(d) for d in self.devices))
        return (f"Mesh(data={self.shape['data']}, "
                f"model={self.shape['model']}; {where})")

    # ---------------------------------------------------------- collectives

    def all_reduce_(self, t, axis="data"):
        """Sum ``t`` in place over the ``axis`` group (a no-op over a group
        of one)."""
        group, n = self._group(axis)
        if n > 1:
            dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t, axis="model", dim=0):
        """The ``axis`` group's tensors of ``t``'s shape, concatenated along
        ``dim`` in group order."""
        group, n = self._group(axis)
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    def broadcast_(self, t, src=0):
        """Overwrite ``t`` with the global rank ``src``'s."""
        if self.world > 1:
            dist.broadcast(t, src=src)
        return t

    def barrier(self):
        """Every rank waits for all the others (an all-reduce of one
        number)."""
        if self.world > 1:
            self.all_reduce_(torch.zeros(1, device=self.device),
                             axis=None)

    def _group(self, axis):
        if not self.distributed:
            return None, 1
        if axis is None:
            return None, self.world
        return ((self.data_group, self.shape["data"]) if axis == "data"
                else (self.model_group, self.shape["model"]))

    # ------------------------------------------------------------- batches

    def rows(self, n):
        """This rank's contiguous slice of ``n`` global rows (over
        ``data``)."""
        k = self.shape["data"]
        if n % k:
            raise ValueError(f"{n} rows do not split over the data axis of "
                             f"size {k}")
        per = n // k
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def average_gradients(self, params):
        """Average the parameters' ``.grad`` over the ``data`` group in one
        all-reduce of a flat buffer (a missing gradient counts as zeros,
        as the optimizer counts it)."""
        n = self.shape["data"]
        if n == 1:
            return
        params = list(params)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        self.all_reduce_(flat, "data")
        flat /= n
        off = 0
        for p, g in zip(params, grads):
            p.grad = flat[off:off + g.numel()].view_as(g)
            off += g.numel()


def make_mesh(n_data=None, n_model=1, devices=None):
    """A ('data', 'model') mesh. With a process group (after
    :func:`initialize_distributed`) the ranks form the grid, and
    ``n_data x n_model`` must equal the world size (``n_data`` defaults to
    world // n_model); this rank's device is ``devices[rank]`` when given,
    else the one :func:`initialize_distributed` chose. Without one it is a
    list of local ``devices`` (default: every card, or the CPU on a host
    without one), ``n_data`` defaulting to all of them; asking for more
    devices than exist raises, naming the counts."""
    if n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"mesh {n_data}x{n_model}: axis sizes must be "
                         "at least 1")
    if dist.is_initialized():
        return _process_mesh(n_data, n_model, devices)
    if devices is None:
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   or ["cpu"])
    devices = list(devices)
    if n_data is None:
        n_data = len(devices) // n_model
    use = n_data * n_model
    if n_data < 1 or use > len(devices):
        raise ValueError(f"mesh {n_data}x{n_model} needs {use} devices, "
                         f"have {len(devices)}")
    for d in devices[:use]:
        d = torch.device(d)
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"mesh {n_data}x{n_model} names {d}, but "
                             f"{torch.cuda.device_count()} card(s) exist")
    return Mesh(n_data, n_model, devices[:use], distributed=False)


def _process_mesh(n_data, n_model, devices):
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs a world of "
                         f"{n_data * n_model} processes, the process group "
                         f"has {world}")
    if devices is not None:
        device = torch.device(list(devices)[rank])
    else:
        device = _RANK_DEVICE or torch.device("cpu")
    mesh = Mesh(n_data, n_model, [device], distributed=True)
    mesh.rank, mesh.world = rank, world
    mesh.data_index, mesh.model_index = divmod(rank, n_model)
    mesh.backend = dist.get_backend()
    # every rank makes every group, in one order (new_group's contract)
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        group = dist.new_group(ranks) if n_data > 1 else None
        if m == mesh.model_index:
            mesh.data_group = group
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        group = dist.new_group(ranks) if n_model > 1 else None
        if d == mesh.data_index:
            mesh.model_group = group
    return mesh


# --------------------------------------------------------------- batches

def batch_spec(mesh, n):
    """The rows of ``n`` global rows this rank holds: a ``slice`` (a
    process mesh), or the list of each device's slice (a device mesh)."""
    if mesh.distributed:
        return mesh.rows(n)
    k = mesh.shape["data"]
    if n % k:
        raise ValueError(f"{n} rows do not split over the data axis of size "
                         f"{k}")
    per = n // k
    return [slice(i * per, (i + 1) * per) for i in range(k)]


def shard_batch(x, mesh, dim=0):
    """``x``'s rows on the mesh: this rank's contiguous block (a process
    mesh, on its device), or one block per data device (a device mesh)."""
    x = torch.as_tensor(x)
    spec = batch_spec(mesh, x.shape[dim])
    if mesh.distributed:
        return x.narrow(dim, spec.start, spec.stop - spec.start).to(
            mesh.device)
    return [x.narrow(dim, s.start, s.stop - s.start).to(d)
            for s, d in zip(spec, mesh.devices)]


# ------------------------------------------------------------ parameters

def _feature_dim(module):
    """The output-feature dimension of a layer's weight in torch's layout:
    0 for Linear and Conv2d, 1 for ConvTranspose2d; None for others."""
    if isinstance(module, torch.nn.ConvTranspose2d):
        return 1
    if isinstance(module, (torch.nn.Linear, torch.nn.Conv2d)):
        return 0
    return None


def param_shardings(params, mesh, min_size=1 << 13):
    """Per-parameter placement, name -> the dimension split over ``model``
    or None (replicated), by the JAX package's rule: a tensor with at least
    2 dimensions and ``min_size`` elements whose output features divide by
    the ``model`` size is split over its output features; everything else
    is replicated. ``params`` is a model (its layers say where the output
    features are: dim 0 of Linear and Conv2d weights, dim 1 of
    ConvTranspose2d's; the last dimension otherwise, as in flax's layout)."""
    n_model = mesh.shape["model"]
    where = {}
    for mod_name, mod in params.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            dim = _feature_dim(mod) if p_name == "weight" else None
            if dim is None:
                dim = p.dim() - 1
            where[name] = (dim if n_model > 1 and p.dim() >= 2
                           and p.numel() >= min_size
                           and p.shape[dim] % n_model == 0 else None)
    return where


class ModelSplit:
    """How a split layer runs on its ``model`` group: its input passes
    through :class:`_CopyToModel` (identity forward, gradient summed over
    the group), its output features are gathered by
    :class:`_GatherFromModel` (the rank's own slice of the gradient
    back)."""

    def __init__(self, mesh, dim):
        self.mesh, self.dim = mesh, dim

    def copy_in(self, x):
        return _CopyToModel.apply(x, self.mesh)

    def gather(self, y, dim):
        return _GatherFromModel.apply(y, self.mesh, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.contiguous().clone(), "model"), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, y.shape[dim]
        return mesh.all_gather(y, "model", dim)

    @staticmethod
    def backward(ctx, grad):
        # downstream of the gather every rank of the group computes the
        # same gradient: the rank's own slice is its output's (a summing
        # all-gather backward would make it n_model times too large)
        lo = ctx.mesh.model_index * ctx.size
        return grad.narrow(ctx.dim, lo, ctx.size).contiguous(), None, None


class AllReduceSum(torch.autograd.Function):
    """Sum over the ``data`` group, whose gradient is the sum over the group
    of the ranks' gradients (BatchNorm's global statistics)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone(), "data")

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.contiguous().clone(), "data"), None


def take_shard(full, dim, index, parts):
    """The ``index``-th of ``parts`` equal blocks of ``full`` along
    ``dim``."""
    size = full.shape[dim] // parts
    return full.narrow(dim, index * size, size).clone()


def shard_state(model, mesh):
    """Place ``model`` on the process mesh, in place, before its optimizer
    is made: every parameter and buffer broadcast from rank 0 (the replicas
    start equal), the parameters :func:`param_shardings` picks cut to this
    rank's block of output features (their layers then gather over
    ``model``), BatchNorm set to take its statistics over the ``data``
    group. Returns :func:`param_shardings`' map."""
    if not mesh.distributed:
        raise ValueError("shard_state places a model on a process mesh; a "
                         "device mesh holds one replica per device")
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            mesh.broadcast_(t.data)
    where = param_shardings(model, mesh)
    index, parts = mesh.model_index, mesh.shape["model"]
    layers = {f"{n}.weight" if n else "weight": mod
              for n, mod in model.named_modules()
              if hasattr(mod, "_product")}
    for name, dim in where.items():
        if dim is not None and name not in layers:
            raise ValueError(f"{name}: only the port's Linear, Conv2d and "
                             "ConvTranspose2d weights split over 'model'")
    for mod in model.modules():
        if isinstance(mod, torch.nn.BatchNorm2d) and mesh.shape["data"] > 1:
            mod.data_mesh = mesh
    for name, mod in layers.items():
        dim = where.get(name)
        if dim is None:
            continue
        split = ModelSplit(mesh, dim)
        shard = torch.nn.Parameter(take_shard(mod.weight.data, dim, index,
                                              parts))
        shard.model_split = split
        mod.weight = shard
        mod.model_split = split
    return where
