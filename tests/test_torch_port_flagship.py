"""The flagship model at full width, served by both packages from the
converged reference checkpoint ``converged_state/torch_clean/best.pt``.

Both load the checkpoint through their own ``from_torch`` and answer the
same requests on the CPU. Tolerance 1e-3 on images in [0, 1] and on poses:
float32 through ten layers of 50 to 490 channels, summed in another order.
"""
import os

import numpy as np

from __graft_entry__ import _flagship_model
from lie_vae_tpu import serve as jserve
from lie_vae_tpu_torch import serve as tserve
from lie_vae_tpu_torch.models import flagship_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(ROOT, "converged_state", "torch_clean", "best.pt")


def test_full_width_converged_checkpoint_matches_jax():
    jsess = jserve.InferenceSession.from_torch(CHECKPOINT, _flagship_model(),
                                               batch_size=2)
    tsess = tserve.InferenceSession.from_torch(
        CHECKPOINT, flagship_model("cpu"), batch_size=2, device="cpu")
    x = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3),
                                          dtype=np.uint8)
    j_enc, t_enc = jsess.encode(x), tsess.encode(x)
    for k in ("pose", "sigma"):
        np.testing.assert_allclose(t_enc[k], j_enc[k], rtol=0, atol=1e-3)
    poses = j_enc["pose"]
    j_img, t_img = jsess.decode(poses), tsess.decode(poses)
    assert t_img.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=1e-3)
