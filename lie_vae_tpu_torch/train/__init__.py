"""Training: the beta schedules, the optimizer (global-norm clip, coupled
L2, Adam), one train step of the ELBO, the experiment harness, metric
logging and checkpoints."""
from lie_vae_tpu_torch.train.logging import MetricWriter  # noqa: F401
from lie_vae_tpu_torch.train.loop import (  # noqa: F401
    UnsupervisedExperiment, train_step)
from lie_vae_tpu_torch.train.schedules import (  # noqa: F401
    ConstantSchedule, LinearSchedule, get_beta_schedule)
from lie_vae_tpu_torch.train.state import make_optimizer  # noqa: F401
