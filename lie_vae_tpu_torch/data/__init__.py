"""Data pipeline: the sphere-cube renderer, datasets, splits and loader."""
from lie_vae_tpu_torch.data.loader import BatchLoader  # noqa: F401
from lie_vae_tpu_torch.data.render import render_spherecube  # noqa: F401
from lie_vae_tpu_torch.data.shapes import (  # noqa: F401
    ShapeDataset, SphereCubeDataset)
from lie_vae_tpu_torch.data.splits import Subset, random_split  # noqa: F401
