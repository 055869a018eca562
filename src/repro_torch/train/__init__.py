"""Training of the port: the reference's optimizers, the train step and
checkpoints for the model cells, and the dense scorer's distillation. The
forest trainers are :mod:`repro_torch.forest.gbdt` and
:func:`repro_torch.core.lear.train_lear`."""

from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.distill import DistillResult, distill_dense_scorer, teacher_scores
from repro_torch.train.elastic import remesh
from repro_torch.train.optimizer import (
    Optimizer,
    adafactor,
    adagrad_rowwise,
    adamw,
    get_optimizer,
)
from repro_torch.train.trainer import TrainState, init_state, make_train_step

__all__ = [
    "DistillResult",
    "Optimizer",
    "TrainState",
    "adafactor",
    "adagrad_rowwise",
    "adamw",
    "distill_dense_scorer",
    "get_optimizer",
    "init_state",
    "latest_step",
    "make_train_step",
    "remesh",
    "restore_checkpoint",
    "save_checkpoint",
    "teacher_scores",
]
