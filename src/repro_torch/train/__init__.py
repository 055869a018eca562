"""Training of the port: the reference's AdamW and the dense scorer's
distillation (the forest trainers are a later slice)."""

from repro_torch.train.distill import DistillResult, distill_dense_scorer, teacher_scores
from repro_torch.train.optimizer import Optimizer, adamw

__all__ = ["DistillResult", "Optimizer", "adamw", "distill_dense_scorer", "teacher_scores"]
