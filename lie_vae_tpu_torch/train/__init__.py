"""Training: the beta schedules, the optimizer (global-norm clip, coupled
L2, Adam) and one train step of the ELBO."""
from lie_vae_tpu_torch.train.loop import train_step  # noqa: F401
from lie_vae_tpu_torch.train.schedules import (  # noqa: F401
    ConstantSchedule, LinearSchedule, get_beta_schedule)
from lie_vae_tpu_torch.train.state import make_optimizer  # noqa: F401
