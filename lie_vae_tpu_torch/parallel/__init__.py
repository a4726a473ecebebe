"""Data and model parallelism over processes (``torch.distributed``), and
the serving session's device mesh (the JAX package's ``parallel``)."""
from lie_vae_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, batch_spec, initialize_distributed, make_mesh, param_shardings,
    shard_batch, shard_state)
