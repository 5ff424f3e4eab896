"""The training path of the port (panic3d_tpu/training): the loss phases,
ADA's augment pipe, the train step with lazy-reg Adam and G_ema, the
statistics and the trainer CLI (training/trainer.py)."""

from .loop import (
    Adam,
    GANTrainState,
    TrainConfig,
    ada_update,
    build_train_step,
    init_state,
    phases_for_step,
)
from .augment import AugmentConfig, augment_pipe
from .loss import LossConfig, OrthoCondLoss, mask_view_orthofront
from .stats import Collector, JsonlLogger
