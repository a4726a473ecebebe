"""Data pipeline: the sphere-cube renderer, the sphere-cube and toy
datasets, splits and loader."""
from lie_vae_tpu_torch.data.loader import BatchLoader  # noqa: F401
from lie_vae_tpu_torch.data.render import render_spherecube  # noqa: F401
from lie_vae_tpu_torch.data.shapes import (  # noqa: F401
    ScPairsDataset, ShapeDataset, SphereCubeDataset)
from lie_vae_tpu_torch.data.splits import Subset, random_split  # noqa: F401
from lie_vae_tpu_torch.data.toy import ToyDataset  # noqa: F401
