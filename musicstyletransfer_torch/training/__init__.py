"""Training of the VAE and the GAN on the PyTorch port: loss, metrics, the
optax-style optimizer, one train/eval step, checkpoints and the fit loops
(counterparts of ``musicstyletransfer_tpu/training``)."""

from .checkpoint import (TrainingProgress, get_latest_checkpoint_index, restore_checkpoint,
                         restore_params, save_checkpoint, try_latest)
from .gan_trainer import GANTrainConfig, GANTrainer, make_gan_steps
from .loss import binary_cross_entropy, kl_divergence, masked_cross_entropy, vae_loss
from .metrics import MetricAccumulator, step_metrics
from .optimizer import Optimizer, OptimizerConfig, build_optimizer
from .train_step import (LossConfig, TrainState, create_train_state, make_eval_step,
                         make_train_step)
from .trainer import TrainConfig, Trainer

__all__ = [
    "GANTrainConfig", "GANTrainer", "make_gan_steps", "TrainingProgress",
    "get_latest_checkpoint_index", "restore_checkpoint", "restore_params", "save_checkpoint",
    "try_latest", "binary_cross_entropy", "kl_divergence", "masked_cross_entropy", "vae_loss",
    "MetricAccumulator", "step_metrics", "Optimizer", "OptimizerConfig", "build_optimizer",
    "LossConfig", "TrainState", "create_train_state", "make_eval_step", "make_train_step",
    "TrainConfig", "Trainer",
]
