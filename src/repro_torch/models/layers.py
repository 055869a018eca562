"""Shared neural layers.

The port of :func:`repro.models.layers.rms_norm`, the one layer the RecSys
family needs (BERT4Rec's blocks). The rest of the reference module (RoPE,
blockwise attention, the GLU MLP) comes with the LM family.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale`` over the last axis, in float32,
    cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)
