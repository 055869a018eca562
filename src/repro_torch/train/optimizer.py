"""Optimizers as transforms of flat parameter dicts.

The port of :mod:`repro.train.optimizer`. Each is the reference's formula,
not ``torch.optim``'s (whose AdamW applies its decay before the step and
puts ``eps`` elsewhere), with float32 state and an int32 step count:

- ``adamw`` — ``p − lr·((m/c1)/(sqrt(v/c2)+eps) + wd·p)``, ``c1 = 1 − b1^count``,
  ``c2 = 1 − b2^count``.
- ``adafactor`` — factored second moment, no momentum (Shazeer & Stern):
  state is O(rows + cols) per matrix, decay ``1 − count^-0.8``, updates
  clipped to RMS ≤ ``clip_threshold``.
- ``adagrad_rowwise`` — DLRM-style: a table (2-D, at least
  :data:`ROWWISE_MIN_ROWS` rows) keeps one accumulator scalar per ROW;
  everything else dense Adagrad.

A state mirrors the parameter dict (same keys), so the logical-axis rules
of the parameters apply to it. ``update(grads, state, params)`` returns new
parameters and state and leaves its inputs unchanged, with one exception:
``adagrad_rowwise`` given a table's sparse gradient (a
``torch.sparse_coo_tensor`` of rows × dim, as the embedding lookups give
with ``sparse_grad=True``) updates only the touched rows, in place in the
table and in its accumulator, and returns those same tensors. On an
untouched row the reference adds 0 to the accumulator and steps by
``0/(sqrt(a)+eps) = 0``, so this is its result, and it is the only way a
table of tens of GB trains beside its own dense gradient's worth of free
memory. Any other optimizer, or a parameter below that size, densifies a
sparse gradient first.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (new_params, new_state)


def _dense(g: torch.Tensor) -> torch.Tensor:
    return (g.to_dense() if g.is_sparse else g).float()


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _count(params: dict[str, torch.Tensor]) -> torch.Tensor:
    first = next(iter(params.values()))
    return torch.zeros((), dtype=torch.int32, device=first.device)


def adamw(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    """AdamW over ``dict[str, Tensor]`` parameters."""

    def init(params: dict[str, torch.Tensor]) -> dict:
        return {
            "m": {k: _zeros(p.shape, p) for k, p in params.items()},
            "v": {k: _zeros(p.shape, p) for k, p in params.items()},
            "count": _count(params),
        }

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        count = state["count"] + 1
        c1 = 1.0 - b1 ** count.float()
        c2 = 1.0 - b2 ** count.float()
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = _dense(grads[k])
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * g * g
            step = (m / c1) / (torch.sqrt(v / c2) + eps)
            pf = p.float()
            new_p[k] = (pf - lr * (step + weight_decay * pf)).to(p.dtype)
            new_m[k], new_v[k] = m, v
        return new_p, {"m": new_m, "v": new_v, "count": count}

    return Optimizer(init=init, update=update)


def adafactor(lr: float = 1e-2, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment, no momentum; decay ∝ step^-0.8."""

    def init(params: dict[str, torch.Tensor]) -> dict:
        def leaf(p):
            if p.ndim >= 2:
                return {"vr": _zeros(p.shape[:-1], p), "vc": _zeros(p.shape[:-2] + p.shape[-1:], p)}
            return {"v": _zeros(p.shape, p)}

        return {"f": {k: leaf(p) for k, p in params.items()}, "count": _count(params)}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        count = state["count"] + 1
        decay = 1.0 - count.float() ** -0.8
        new_p, new_f = {}, {}
        for k, p in params.items():
            g = _dense(grads[k])
            s = state["f"][k]
            g2 = g * g + eps
            if p.ndim >= 2:
                vr = decay * s["vr"] + (1 - decay) * g2.mean(dim=-1)
                vc = decay * s["vc"] + (1 - decay) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                u = g / torch.sqrt(
                    (vr / torch.clamp_min(denom, eps))[..., None] * vc[..., None, :] + eps
                )
                new_f[k] = {"vr": vr, "vc": vc}
            else:
                v = decay * s["v"] + (1 - decay) * g2
                u = g / torch.sqrt(v + eps)
                new_f[k] = {"v": v}
            # Update clipping (RMS ≤ clip_threshold).
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            new_p[k] = (p.float() - lr * u).to(p.dtype)
        return new_p, {"f": new_f, "count": count}

    return Optimizer(init=init, update=update)


ROWWISE_MIN_ROWS = 1 << 16


def is_rowwise_table(p: torch.Tensor) -> bool:
    """A parameter ``adagrad_rowwise`` treats as an embedding table."""
    return p.ndim == 2 and p.shape[0] >= ROWWISE_MIN_ROWS


def adagrad_rowwise(lr: float = 0.01, eps: float = 1e-8) -> Optimizer:
    """Row-wise Adagrad for big tables; dense Adagrad elsewhere. ``init``
    picks the tables by :func:`is_rowwise_table` (on the whole parameter);
    ``update`` follows the state it made (one accumulator per row), so a
    table's local shard of fewer rows keeps its row-wise step."""

    def init(params: dict[str, torch.Tensor]) -> dict:
        return {"acc": {
            k: _zeros(p.shape[:1] if is_rowwise_table(p) else p.shape, p)
            for k, p in params.items()
        }}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        new_p, new_a = {}, {}
        for k, p in params.items():
            g, a = grads[k], state["acc"][k]
            rowwise = a.ndim < p.ndim
            if rowwise and g.is_sparse:
                new_p[k], new_a[k] = _rowwise_sparse_(g, a, p, lr, eps)
                continue
            g = _dense(g)
            if rowwise:
                a = a + (g * g).mean(dim=-1)
                step = g / (torch.sqrt(a)[:, None] + eps)
            else:
                a = a + g * g
                step = g / (torch.sqrt(a) + eps)
            new_p[k], new_a[k] = (p.float() - lr * step).to(p.dtype), a
        return new_p, {"acc": new_a}

    return Optimizer(init=init, update=update)


def _rowwise_sparse_(g: torch.Tensor, a: torch.Tensor, p: torch.Tensor,
                     lr: float, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The row-wise step on the rows of a sparse ``[rows, dim]`` gradient,
    written into ``p`` and ``a`` in place (duplicate rows summed first)."""
    if g.sparse_dim() != 1 or g.shape != p.shape:
        raise ValueError(
            f"adagrad_rowwise: a table's sparse gradient must be rows x dim "
            f"{tuple(p.shape)}, got {tuple(g.shape)} with {g.sparse_dim()} sparse dims"
        )
    g = g.coalesce()
    rows = g.indices()[0]                        # int64, unique after coalesce
    vals = g.values().float()                    # [n, dim]
    a_rows = a.index_select(0, rows) + (vals * vals).mean(dim=-1)
    a.index_copy_(0, rows, a_rows)
    step = vals / (torch.sqrt(a_rows)[:, None] + eps)
    p_rows = p.index_select(0, rows).float() - lr * step
    p.index_copy_(0, rows, p_rows.to(p.dtype))
    return p, a


def get_optimizer(name: str, lr: float = 1e-3) -> Optimizer:
    if name == "adamw":
        return adamw(lr)
    if name == "adafactor":
        return adafactor(lr)
    if name == "adagrad_rowwise":
        return adagrad_rowwise(lr)
    raise ValueError(f"unknown optimizer {name!r}")
