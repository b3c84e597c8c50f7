"""Training: assignment, loss with its metrics, EMA, optimizers, trainer."""

from .assign import assign_targets_to_scale  # noqa: F401
from .ema import EMA  # noqa: F401
from .loss import METRIC_KEYS, AudioDetectionLoss, compute_ciou, focal_loss_with_logits  # noqa: F401
from .optim import ReduceLROnPlateau, make_lr_scheduler, make_optimizer  # noqa: F401
from .trainer import TrainerPipeline  # noqa: F401
