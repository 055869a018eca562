"""Training of the port's dense scorer: the reference's AdamW and the
distillation. The forest trainers are :mod:`repro_torch.forest.gbdt` and
:func:`repro_torch.core.lear.train_lear`."""

from repro_torch.train.distill import DistillResult, distill_dense_scorer, teacher_scores
from repro_torch.train.optimizer import Optimizer, adamw

__all__ = ["DistillResult", "Optimizer", "adamw", "distill_dense_scorer", "teacher_scores"]
