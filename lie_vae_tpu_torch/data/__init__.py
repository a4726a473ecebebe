"""Data pipeline: the sphere-cube renderer, PNG files, the image-folder and
toy datasets, splits and loader (the JAX package's ``data`` exports and the
renderer)."""
from lie_vae_tpu_torch.data.loader import BatchLoader  # noqa: F401
from lie_vae_tpu_torch.data.render import render_spherecube  # noqa: F401
from lie_vae_tpu_torch.data.shapes import (  # noqa: F401
    ScPairsDataset, ShapeDataset, SphereCubeDataset, count_renders,
    filename_to_name, filename_to_quaternion)
from lie_vae_tpu_torch.data.splits import Subset, random_split  # noqa: F401
from lie_vae_tpu_torch.data.toy import ToyDataset  # noqa: F401
