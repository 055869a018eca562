"""Binary Continue/Exit classifier metrics (paper Table 2).

The port of :mod:`repro.metrics.classification`.
"""

from __future__ import annotations

import torch


def precision_recall(
    pred_continue: torch.Tensor, true_continue: torch.Tensor, mask: torch.Tensor
) -> dict[str, float]:
    """Per-class precision/recall for the Continue (1) / Exit (0) classes,
    as float32 ratios like the reference's. Returns a dict matching the
    paper's Table 2 layout."""
    pred_continue = pred_continue & mask
    true_continue = true_continue & mask
    pred_exit = (~pred_continue) & mask
    true_exit = (~true_continue) & mask

    def _pr(pred, true):
        tp = (pred & true).sum().float()
        p = tp / torch.clamp_min(pred.sum(), 1).float()
        r = tp / torch.clamp_min(true.sum(), 1).float()
        return float(p), float(r)

    p_c, r_c = _pr(pred_continue, true_continue)
    p_e, r_e = _pr(pred_exit, true_exit)
    return {
        "continue_precision": p_c,
        "continue_recall": r_c,
        "exit_precision": p_e,
        "exit_recall": r_e,
    }
