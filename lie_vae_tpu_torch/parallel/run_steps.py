"""Training steps of one model over a process mesh, from a spec file, each
rank's results written out: the check that a data- and model-parallel step
computes what the single-process step computes on the global batch.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m lie_vae_tpu_torch.parallel.run_steps SPEC.npz [SPEC.npz ...] OUT_DIR

``SPEC.npz`` holds ``spec``, a JSON blob (uint8) with the model's
``LieVAE`` keywords (``model``), the ``kernel_impls`` to run one after the
other, ``dtype``, ``device`` ("cpu" or "cuda"), ``mesh`` ([n_data,
n_model]), ``batch_size`` (the global batch), ``seed``, ``lr``,
``clip_grads``, ``beta``, ``steps``, ``threads`` (torch's intra-op threads
of a CPU rank), ``timeout_s`` (the collectives' time limit) and
optionally ``test`` (run ``test()`` after the steps),
``ll`` ([n, max_items]: the IW-LL after them), ``device_data`` (the
harness's) and ``checkpoint`` (a path
prefix: ``save_state`` after them, to ``<prefix>_<impl>.pt``); beside it
the full state_dict under ``w/<key>``, the training inputs ``train_x`` and
the evaluation inputs ``test_x`` (items: uint8 NHWC images or toy
spectra), ``fixed_item_rep`` when the model keeps its spectrum fixed, and
optionally the posterior noise to use in place of the harness's streams:
``noise/<stream>/<i>``, the i-th standard normal draw of the ``train``,
``eval`` or ``ll`` stream, each of the shape the harness draws (the
global batch's: a reference that draws its own noise hands it over so).

Each rank runs :func:`run`, which trains through the port's
``UnsupervisedExperiment.train`` (its sharded loader, its noise streams,
``train_step`` over the mesh; no reports), and writes
``OUT_DIR/rank<r>_<s>.npz`` for its s-th spec: per kernel_impl the loss of
each step, the full state (split tensors gathered) after each step, the
host ms of each step (its batch, its noise and the step), the kernels'
launches over the steps, and the results of ``test()`` and the IW-LL.
:func:`run` without a mesh is the single-process twin.
"""
import json
import os
import sys
import time

import numpy as np
import torch

class NoiseQueue:
    """The harness's ``noise`` (``UnsupervisedExperiment(noise=...)``):
    hands out a spec's ``noise/<stream>/<i>`` arrays in order, checking
    their shapes."""

    def __init__(self, arrays):
        self.queues = {}
        for key in sorted((k for k in arrays if k.startswith("noise/")),
                          key=lambda k: int(k.rsplit("/", 1)[1])):
            stream = key.split("/")[1]
            self.queues.setdefault(stream, []).append(arrays[key])

    def __call__(self, stream, shape):
        eps = torch.tensor(self.queues[stream].pop(0))
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(f"noise of the {stream} stream: "
                             f"{tuple(eps.shape)}, the harness draws "
                             f"{tuple(shape)}")
        return eps


class ArrayDataset:
    """Items of one array, as the harness's datasets serve them."""
    num_workers = 0

    def __init__(self, x):
        self.x = np.asarray(x)

    def __len__(self):
        return self.x.shape[0]

    def gather(self, indices):
        return (self.x[np.asarray(indices)],)

    @staticmethod
    def prep_batch(batch):
        return batch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(spec, arrays, mesh=None, device=None):
    """The spec's steps on ``mesh`` (None: one process) on ``device``
    (default the spec's, or the mesh's), through
    ``UnsupervisedExperiment.train``; returns a dict of numpy results
    keyed ``<impl>/...``."""
    from lie_vae_tpu_torch.models import LieVAE
    from lie_vae_tpu_torch.ops.kernels import KERNEL_COUNTERS, kernel_counts
    from lie_vae_tpu_torch.train import (ConstantSchedule,
                                         UnsupervisedExperiment)
    from lie_vae_tpu_torch.train.checkpoint import full_state_dict
    dtype = getattr(torch, spec["dtype"])
    device = torch.device(device or (mesh.device if mesh is not None
                                     else spec["device"]))
    weights = {k[2:]: torch.as_tensor(v) for k, v in arrays.items()
               if k.startswith("w/")}
    fixed = arrays.get("fixed_item_rep")
    train_ds = ArrayDataset(arrays["train_x"])
    test_ds = ArrayDataset(arrays["test_x"])
    given = any(k.startswith("noise/") for k in arrays)
    out = {}
    for impl in spec["kernel_impls"]:
        model = LieVAE(**spec["model"], kernel_impl=impl,
                       fixed_item_rep=fixed, device=device)
        model.load_state_dict(weights, strict=True)
        model.to(dtype)
        exp = UnsupervisedExperiment(
            model=model, train_dataset=train_ds, test_dataset=test_ds,
            beta_schedule=ConstantSchedule(float(spec.get("beta", 1.0))),
            lr=spec.get("lr", 1e-3), clip_grads=spec.get("clip_grads", 1e-5),
            batch_size=spec["batch_size"], seed=spec.get("seed", 0),
            report_freq=None, mesh=mesh,
            device_data=spec.get("device_data", False),
            noise=NoiseQueue(arrays) if given else None)
        losses, times, clock = [], [], [0.0]

        def on_step(metrics):
            _sync(device)
            times.append((time.perf_counter() - clock[0]) * 1e3)
            step = len(losses)
            losses.append(float(metrics["loss"]))
            for k, v in full_state_dict(model).items():
                out[f"{impl}/state{step}/{k}"] = v.numpy().copy()
            clock[0] = time.perf_counter()

        before = kernel_counts() if device.type == "cuda" else None
        epoch = 0
        while len(losses) < spec["steps"]:
            _sync(device)
            clock[0] = time.perf_counter()
            exp.train(epoch, max_steps=spec["steps"] - len(losses),
                      on_step=on_step)
            epoch += 1
        if before is not None:
            after = kernel_counts()
            out[f"{impl}/launches"] = np.asarray(
                [after[k] - before[k] for k in KERNEL_COUNTERS])
        out[f"{impl}/loss"] = np.asarray(losses)
        out[f"{impl}/step_ms"] = np.asarray(times)
        if spec.get("test"):
            out[f"{impl}/test"] = exp.test()
        if spec.get("ll"):
            n, max_items = spec["ll"]
            _, items = exp.log_likelihood(test_ds, n=n, max_items=max_items,
                                          return_items=True)
            out[f"{impl}/ll"] = items
        if spec.get("checkpoint"):
            from lie_vae_tpu_torch.train.checkpoint import save_state
            save_state(f"{spec['checkpoint']}_{impl}.pt", model,
                       exp.optimizer)
    return out


def read_spec(path):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(bytes(arrays.pop("spec")).decode()), arrays


def write_spec(path, spec, arrays):
    np.savez(path, spec=np.frombuffer(json.dumps(spec).encode(), np.uint8),
             **arrays)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: python -m lie_vae_tpu_torch.parallel."
                         "run_steps SPEC.npz [SPEC.npz ...] OUT_DIR (under "
                         "torch.distributed.run)")
    from lie_vae_tpu_torch.parallel import initialize_distributed, make_mesh
    from lie_vae_tpu_torch.parallel.mesh import TIMEOUT_S
    specs = [read_spec(path) for path in argv[:-1]]
    first = specs[0][0]
    if first.get("threads"):
        torch.set_num_threads(int(first["threads"]))
    initialize_distributed(device=first["device"],
                           timeout_s=first.get("timeout_s", TIMEOUT_S))
    os.makedirs(argv[-1], exist_ok=True)
    for i, (spec, arrays) in enumerate(specs):
        mesh = make_mesh(*spec["mesh"])
        out = run(spec, arrays, mesh)
        np.savez(os.path.join(argv[-1], f"rank{mesh.rank}_{i}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
