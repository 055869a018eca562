"""Mixture-of-Experts FFN: grouped token-choice dispatch with capacity.

The port of :mod:`repro.models.moe`. Tokens are organized into *dispatch
groups* (one group per sequence at prefill; a single group of every
sequence's token at decode). Within each group, each expert takes its
top-``C`` chosen tokens by router probability (token-choice with capacity,
priority = probability), runs the expert FFN as one batched product over
``[G, E, C, D]``, and its outputs are added back to their tokens, weighted
by the renormalized router probabilities.

Capacity: C = ceil(T_group · top_k / E · capacity_factor). Tokens beyond an
expert's capacity are dropped (GShard semantics); the residual connection
carries them unchanged. A Switch-style load-balancing loss is returned.

Two orders are pinned where the reference's are: ``lax.top_k`` breaks ties
by the lowest index, so both top-k selections here are stable descending
sorts (``torch.topk`` promises no order among ties); and the reference's
scatter-add visits the ``[E, C]`` slots expert by expert, so each token
sums its at most ``top_k`` expert outputs in ascending expert order,
rounding after each add in the activations' dtype. No float atomics are
used, so a rerun on the card is bit-equal.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import silu


def _capacity(tokens_per_group: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(tokens_per_group * top_k * cf / n_experts) + 1
    return min(max(4, c), tokens_per_group)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, ties to the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def route(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int, capacity_factor: float
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing decisions of :func:`moe_ffn` for tokens ``x`` [G, T, D]:
    router probabilities ``probs`` [G, T, E], each token's experts
    ``top_idx`` [G, T, k] (descending probability), its renormalized weight
    per expert ``weight`` [G, T, E] (0 where not chosen), and each expert's
    capacity slots ``token_idx`` [G, E, C] (its chosen tokens by weight,
    then padding tokens, which carry weight 0)."""
    G, T, D = x.shape
    E = router_w.shape[1]
    C = _capacity(T, E, top_k, capacity_factor)

    logits = x.float() @ router_w.float()                              # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_idx = _top_k(probs, top_k)                              # [G, T, k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    # Per-token-per-expert routing weight (0 if not chosen).
    weight = torch.zeros_like(probs).scatter_(-1, top_idx, top_p)      # [G, T, E]
    # Token-choice with capacity: each expert takes its top-C tokens by prob.
    priority = torch.where(weight > 0, weight, -1.0)                   # [G, T, E]
    _, token_idx = _top_k(priority.transpose(1, 2), C)                 # [G, E, C]
    return probs, top_idx, weight, token_idx


def moe_ffn(
    x: torch.Tensor,            # [G, T, D] tokens in dispatch groups
    router_w: torch.Tensor,     # [D, E]
    w_gate: torch.Tensor,       # [E, D, F]
    w_up: torch.Tensor,         # [E, D, F]
    w_down: torch.Tensor,       # [E, F, D]
    *,
    top_k: int,
    capacity_factor: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [G, T, D], aux load-balance loss [])."""
    G, T, D = x.shape
    E = router_w.shape[1]
    probs, top_idx, weight, token_idx = route(
        x, router_w, top_k=top_k, capacity_factor=capacity_factor
    )
    C = token_idx.shape[-1]

    # Switch aux loss: E * Σ_e (fraction routed to e) · (mean prob of e).
    frac = (weight > 0).float().mean(dim=1)                            # [G, E]
    mean_p = probs.mean(dim=1)
    aux = (E * (frac * mean_p).sum(dim=-1)).mean()

    groups = torch.arange(G, device=x.device)[:, None, None]
    x_sel = x[groups, token_idx]                                       # [G, E, C, D]
    w_sel = torch.gather(weight.transpose(1, 2), 2, token_idx)
    w_sel = torch.clamp_min(w_sel, 0.0)                                # padding → 0
    x_sel = constrain(x_sel, "groups", "experts", None, None)

    h = silu(torch.einsum("gecd,edf->gecf", x_sel, w_gate)) * torch.einsum(
        "gecd,edf->gecf", x_sel, w_up
    )
    y_sel = torch.einsum("gecf,efd->gecd", h, w_down)                  # [G, E, C, D]
    y_sel = y_sel * w_sel[..., None].to(y_sel.dtype)

    # Back to the tokens: slot[g, e, t] = the capacity slot token t holds in
    # expert e, or -1. Each token gathers the slots of its chosen experts,
    # ascending, and sums them in that order (the reference's scatter order;
    # padding slots carry weight 0 and are left out).
    slot = torch.full((G, E, T), -1, dtype=torch.long, device=x.device)
    slot.scatter_(2, token_idx, torch.arange(C, device=x.device).expand(G, E, C))
    experts = torch.sort(top_idx, dim=-1).values                       # [G, T, k]
    held = torch.gather(slot.transpose(1, 2), 2, experts)              # [G, T, k]
    parts = y_sel.reshape(G, E * C, D)[groups, experts * C + held.clamp_min(0)]
    parts = torch.where(held[..., None] >= 0, parts, 0.0)              # [G, T, k, D]
    y = torch.zeros((G, T, D), dtype=y_sel.dtype, device=x.device)
    for j in range(top_k):
        y = y + parts[:, :, j]
    y = constrain(y, "groups", None, None)
    return y.to(x.dtype), aux
