"""AdamW as a pure transform of parameter dicts.

The port of :func:`repro.train.optimizer.adamw` (the other optimizers of
that module wait for the training slice). It is the reference's formula,
not ``torch.optim.AdamW``, whose decoupled decay is applied before the
step and whose ``eps`` sits elsewhere: the update is
``p − lr·((m/c1)/(sqrt(v/c2)+eps) + wd·p)`` with ``c1 = 1 − b1^count`` and
``c2 = 1 − b2^count`` computed in float32 from an int32 step count, and
moments kept in float32.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (new_params, new_state)


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    """AdamW over ``dict[str, Tensor]`` parameters; ``update`` returns new
    tensors (computed without autograd) and leaves its inputs unchanged."""

    def init(params: dict[str, torch.Tensor]) -> dict:
        first = next(iter(params.values()))
        return {
            "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=first.device),
        }

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        count = state["count"] + 1
        c1 = 1.0 - b1 ** count.float()
        c2 = 1.0 - b2 ** count.float()
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * g * g
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            pf = p.float()
            new_p[k] = (pf - lr * (step + weight_decay * pf)).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v, "count": count}

    return Optimizer(init=init, update=update)
