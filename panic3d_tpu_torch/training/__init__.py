"""The training path of the port (panic3d_tpu/training): the loss phases,
the train step with lazy-reg Adam and G_ema, the statistics and the
trainer CLI (training/trainer.py)."""

from .loop import (
    Adam,
    GANTrainState,
    TrainConfig,
    build_train_step,
    init_state,
    phases_for_step,
)
from .loss import LossConfig, OrthoCondLoss, mask_view_orthofront
from .stats import Collector, JsonlLogger
