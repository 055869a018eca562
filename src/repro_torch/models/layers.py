"""Shared neural layers: RMSNorm, RoPE, blockwise attention, GLU MLP.

The port of :mod:`repro.models.layers`. Attention is flash-style, as in
the reference: an online softmax over key/value blocks, so no ``[S, S]``
score matrix is materialized. The reference scans query blocks and, inside
each, key/value blocks; the port runs every query row through one
key/value block at a time. Each row still sees the blocks in the same
order with the same arithmetic (the online softmax is per row), and a
32k-token prefill takes ``S / kv_block`` steps a layer instead of
``(S / q_block) · (S / kv_block)``.

Numerics follow the reference's cast points: RMSNorm, RoPE and attention
compute in float32 and return the input's dtype. Query head ``h`` reads
key/value head ``h // G`` (``G = H / Hkv``): the heads are reshaped to
``[Hkv, G]``, never tiled. The GLU's hidden activations carry the
reference's sharding constraint (:func:`~repro_torch.distributed.constrain`:
the identity on a plain tensor).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.distributed.parallel import LOCAL, ModelAxis
from repro_torch.distributed.sharding import constrain

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · scale`` over the last axis, in float32,
    cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dtype)


def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


@functools.lru_cache(maxsize=None)
def _rope_frequencies_on(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` on ``device``, copied there once per
    (d_head, theta, device): a copy from pageable host memory at every call
    would make the host wait for the card twice a layer. Read-only."""
    return torch.as_tensor(rope_frequencies(d_head, theta), device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh]; positions: [B, S] or [S]. Half-split rotation:
    the first ``Dh/2`` lanes pair with the last ``Dh/2``."""
    d_head = x.shape[-1]
    freqs = _rope_frequencies_on(d_head, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs            # [B, S, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _online_softmax_block(carry, scores, v_blk):
    """One online-softmax update. scores: [..., Q, K]; v_blk: [..., K, Dh]
    in float32."""
    acc, row_max, row_sum = carry
    blk_max = scores.amax(dim=-1)
    new_max = torch.maximum(row_max, blk_max)
    correction = torch.exp(row_max - new_max)
    p = torch.exp(scores - new_max[..., None])
    acc = acc * correction[..., None] + p @ v_blk
    row_sum = row_sum * correction + p.sum(dim=-1)
    return acc, new_max, row_sum


def blockwise_attention(
    q: torch.Tensor,      # [B, Sq, H, Dh]
    k: torch.Tensor,      # [B, Skv, Hkv, Dh]
    v: torch.Tensor,      # [B, Skv, Hkv, Dh]
    *,
    causal: bool = True,
    q_offset: int = 0,          # absolute position of q[0] (chunked prefill)
    q_block: int = 512,
    kv_block: int = 1024,
    causal_skip: bool = False,
) -> torch.Tensor:
    """GQA flash-style attention; returns [B, Sq, H, Dh].

    Key/value blocks are visited in order, each by every query row of the
    reference's scan. ``causal_skip`` gives a key/value block only the
    query blocks at or below the causal diagonal (the reference's
    ``n_kv`` per query block), halving the attention work; without it every
    block is scored and masked, as in the reference.
    """
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    if Sq % q_block or Skv % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) must divide ({Sq}, {Skv})")
    nq, nk = Sq // q_block, Skv // kv_block
    scale = 1.0 / np.sqrt(Dh)

    # Rows (query position, group member) per kv head: query head h is
    # (h // G, h % G), so [B, Sq, H, Dh] → [B, Hkv, Sq·G, Dh].
    qr = q.reshape(B, Sq, Hkv, G, Dh).transpose(1, 2).float().reshape(B, Hkv, Sq * G, Dh)
    kr = k.transpose(1, 2).float().contiguous()                # [B, Hkv, Skv, Dh]
    vr = v.transpose(1, 2).float().contiguous()
    carry = (
        torch.zeros((B, Hkv, Sq * G, Dh), dtype=torch.float32, device=q.device),
        torch.full((B, Hkv, Sq * G), NEG_INF, dtype=torch.float32, device=q.device),
        torch.zeros((B, Hkv, Sq * G), dtype=torch.float32, device=q.device),
    )

    # Per query block, the key/value blocks it scans (the reference's n_kv).
    n_kv = [nk] * nq
    if causal_skip and causal:
        n_kv = [min(nk, -(-(q_offset + (i + 1) * q_block) // kv_block)) for i in range(nq)]
    qpos = (q_offset + torch.arange(Sq, device=q.device)).repeat_interleave(G)
    for j in range(nk):
        r0 = sum(n <= j for n in n_kv) * q_block * G   # first row scanning block j
        if r0 == Sq * G:
            continue
        kv = slice(j * kv_block, (j + 1) * kv_block)
        scores = (qr[:, :, r0:] @ kr[:, :, kv].transpose(-1, -2)) * scale
        if causal:
            kpos = j * kv_block + torch.arange(kv_block, device=q.device)
            scores = torch.where(qpos[r0:, None] >= kpos[None, :], scores, NEG_INF)
        # Out of place, so autograd can differentiate it: rows above r0
        # keep their carries, the rest take the block's update.
        new = _online_softmax_block(tuple(c[:, :, r0:] for c in carry), scores, vr[:, :, kv])
        carry = new if r0 == 0 else tuple(
            torch.cat([c[:, :, :r0], n], dim=2) for c, n in zip(carry, new)
        )
    acc, _, row_sum = carry
    out = acc / torch.clamp_min(row_sum[..., None], 1e-30)
    # [B, Hkv, Sq·G, Dh] → [B, Sq, H, Dh]
    return out.reshape(B, Hkv, Sq, G, Dh).transpose(1, 2).reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention(
    q: torch.Tensor,        # [B, 1, H, Dh] current-token queries
    k_cache: torch.Tensor,  # [B, S_max, Hkv, Dh]
    v_cache: torch.Tensor,
    pos: int | torch.Tensor,  # current length (tokens < pos are valid)
) -> torch.Tensor:
    """One query token against the whole cache, as the reference computes
    it: the cache is upcast to float32 (a transient of twice its bytes per
    call) and positions ``>= pos`` are masked."""
    B, _, H, Dh = q.shape
    _, S, Hkv, _ = k_cache.shape
    G = H // Hkv
    scale = 1.0 / np.sqrt(Dh)
    qf = q.reshape(B, Hkv, G, Dh).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float()) * scale
    valid = torch.arange(S, device=q.device)[None, None, None, :] < pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


class _Silu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        # JAX's: the product rule, the logistic's derivative from its value.
        return g * s + ((g * x) * s) * (1 - s)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · σ(x)`` with σ written ``1 / (1 + exp(-x))``, one op at a time in
    ``x``'s dtype: the expansion XLA gives ``jax.nn.silu``'s logistic. In
    bfloat16 each op rounds, as there, so the port's bfloat16 activations
    equal the reference's on the CPU (``F.silu`` rounds once and differs in
    about a third of them). The backward is JAX's,
    ``g·σ + g·x·σ·(1 − σ)`` from the forward's σ: differentiating the ops
    themselves would give ``0 · inf`` = NaN where ``exp(-x)`` overflows
    (x < −88). Differentiable once."""
    return _Silu.apply(x)


def glu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor, tp: ModelAxis = LOCAL) -> torch.Tensor:
    """``(silu(x @ w_gate) · (x @ w_up)) @ w_down``. With ``"ff"`` on
    ``tp``'s axis, the weights hold this rank's columns of the hidden width
    (rows of ``w_down``): the partial products are summed over the axis."""
    split = tp.on("ff")
    if split:
        x = tp.copy(x)
    h = silu(x @ w_gate) * (x @ w_up)
    h = constrain(h, "batch", None, "ff")
    y = h @ w_down
    return tp.reduce(y) if split else y
