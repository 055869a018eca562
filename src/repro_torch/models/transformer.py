"""Decoder LM: GQA attention, optional QK-norm / QKV bias / MoE FFN.

The port of :mod:`repro.models.transformer`: ``init``, ``prefill``,
``decode_step`` and the training loss ``loss_fn`` (chunked cross-entropy
plus the MoE aux loss, with per-layer remat).

Parameters are one flat ``dict[str, Tensor]`` keyed by the reference's
pytree paths, with the layers stacked on a leading axis as the reference
scans them: ``embed`` ``[V, D]``, ``dense_stack/attn/wq`` ``[L, D, H·Dh]``,
``moe_stack/moe/router`` ``[L, D, E]`` (float32), … MoE archs hold two
stacks: ``n_dense_layers`` leading dense layers (DeepSeek-MoE places a
dense FFN first) and the MoE stack. The port runs the layers in a Python
loop over views of the stacked tensors.

Training (``loss_fn``) runs the same layers without caches. Under
``cfg.remat`` each layer is checkpointed (``torch.utils.checkpoint``,
non-reentrant): ``remat_policy="nothing"`` recomputes the whole layer in the
backward pass; ``"dots"`` keeps the outputs of the plain 2-D matmuls
(``aten.mm``: the projections, the dense FFN, the router) and recomputes
the rest, as the reference's ``dots_with_no_batch_dims_saveable`` keeps
its dot products without batch dimensions. Recomputation repeats the same
ops on the same inputs, so a loss and its gradients are bit-equal with and
without remat. :func:`chunked_cross_entropy` checkpoints each chunk of 512
positions, so the ``[B, S, V]`` logits never exist at once.

KV caches are nested dicts ``{stack: {"k": [L, B, S, Hkv, Dh], "v": …}}``
in the model's dtype, as in the reference. ``decode_step`` writes the new
token's keys and values into the caches *in place* and returns the same
tensors (the reference updates them functionally; at Qwen3-4B, batch 8
and 32,768 tokens the caches are 38.65 GB, and a copy per step would not
fit beside them).

``init`` draws from an explicit ``torch.Generator`` on the target device
with the reference's distributions (normal · fan^-½ in the model's dtype,
the router drawn in that dtype then cast to float32, the embedding normal
· 0.02, norms at one, biases at zero); the numbers differ from
``jax.random``'s. :func:`transformer_params_from_numpy` and
:func:`transformer_params_to_numpy` carry weights across in both
directions, bfloat16 bit for bit. The reference's sharding constraints sit
where its do (:func:`~repro_torch.distributed.constrain`: the identity on a
plain tensor); ``cfg.seq_parallel`` puts the residual stream's sequence
axis on ``"seq_sp"``.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.configs.base import TransformerConfig
from repro_torch.distributed.parallel import LOCAL, ModelAxis
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import (
    apply_rope,
    blockwise_attention,
    decode_attention,
    glu_mlp,
    rms_norm,
)
from repro_torch.models.moe import moe_ffn
from repro_torch.utils import resolve_device, tree_items

Params = dict[str, torch.Tensor]
Caches = dict[str, dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# Parameter table: path → (shape, logical axes, init).
# ---------------------------------------------------------------------------

# An init is ("normal", scale), ("ones",) or ("zeros",); "router" is a
# normal drawn in the model's dtype and kept in float32.


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _attn_table(cfg: TransformerConfig, L: int) -> dict:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    table = {
        "wq": ((L, D, H * Dh), ("layers", "embed", "qkv"), ("normal", D ** -0.5)),
        "wk": ((L, D, Hkv * Dh), ("layers", "embed", "qkv"), ("normal", D ** -0.5)),
        "wv": ((L, D, Hkv * Dh), ("layers", "embed", "qkv"), ("normal", D ** -0.5)),
        "wo": ((L, H * Dh, D), ("layers", "qkv", "embed"), ("normal", (H * Dh) ** -0.5)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * Dh), ("bk", Hkv * Dh), ("bv", Hkv * Dh)):
            table[name] = ((L, width), ("layers", "qkv"), ("zeros",))
    if cfg.qk_norm:
        table["q_norm"] = ((L, Dh), ("layers", None), ("ones",))
        table["k_norm"] = ((L, Dh), ("layers", None), ("ones",))
    return table


def _mlp_table(L: int, D: int, F_: int, ff: str = "ff", experts: int = 0) -> dict:
    lead, lead_lg = ((L, experts), ("layers", "experts")) if experts else ((L,), ("layers",))
    return {
        "w_gate": ((*lead, D, F_), (*lead_lg, "embed", ff), ("normal", D ** -0.5)),
        "w_up": ((*lead, D, F_), (*lead_lg, "embed", ff), ("normal", D ** -0.5)),
        "w_down": ((*lead, F_, D), (*lead_lg, ff, "embed"), ("normal", F_ ** -0.5)),
    }


def _stack_table(cfg: TransformerConfig, L: int, moe: bool) -> dict:
    D = cfg.d_model
    table = {
        "ln1": ((L, D), ("layers", None), ("ones",)),
        "ln2": ((L, D), ("layers", None), ("ones",)),
        **{f"attn/{k}": v for k, v in _attn_table(cfg, L).items()},
    }
    if not moe:
        F_ = cfg.dense_d_ff or cfg.d_ff
        table.update({f"mlp/{k}": v for k, v in _mlp_table(L, D, F_).items()})
        return table
    E, Fe = cfg.n_experts, cfg.d_ff_expert or cfg.d_ff
    table["moe/router"] = ((L, D, E), ("layers", "embed", None), ("router", D ** -0.5))
    table.update({
        f"moe/{k}": v for k, v in _mlp_table(L, D, Fe, "expert_ff", experts=E).items()
    })
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * Fe
        table.update({f"shared/{k}": v for k, v in _mlp_table(L, D, Fs).items()})
    return table


def _stacks(cfg: TransformerConfig) -> list[tuple[str, int, bool]]:
    """(name, n_layers, moe) of each layer stack, in execution order."""
    if not cfg.is_moe:
        return [("dense_stack", cfg.n_layers, False)]
    out = [("dense_stack", cfg.n_dense_layers, False)] if cfg.n_dense_layers else []
    return out + [("moe_stack", cfg.n_moe_layers, True)]


def _table(cfg: TransformerConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    table = {
        "embed": ((V, D), ("vocab", "embed"), ("normal", 0.02)),
        "final_norm": ((D,), (None,), ("ones",)),
        "lm_head": ((D, V), ("embed", "vocab"), ("normal", D ** -0.5)),
    }
    for name, L, moe in _stacks(cfg):
        table.update({f"{name}/{k}": v for k, v in _stack_table(cfg, L, moe).items()})
    return table


def init(cfg: TransformerConfig, seed: int | torch.Generator | None,
         device: str | torch.device | None = None) -> Params:
    """Random parameters on ``device`` (``None`` → the card), drawn from
    ``seed`` (an int or a ``torch.Generator`` on that device); on the
    ``meta`` device only their shapes and dtypes (``seed`` unused)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    dt = _dtype(cfg)
    gen = seed
    if dev.type != "meta" and not isinstance(seed, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    params = {}
    for path, (shape, _, (kind, *scale)) in _table(cfg).items():
        out_dt = torch.float32 if kind == "router" else dt
        if dev.type == "meta":
            params[path] = torch.empty(shape, dtype=out_dt, device=dev)
        elif kind in ("normal", "router"):
            w = torch.randn(shape, dtype=dt, generator=gen, device=dev).mul_(scale[0])
            params[path] = w.to(out_dt)
        else:
            params[path] = torch.full(shape, 1.0 if kind == "ones" else 0.0, dtype=dt, device=dev)
    return params


def param_logical(cfg: TransformerConfig) -> dict[str, tuple]:
    return {path: logical for path, (_, logical, _) in _table(cfg).items()}


def abstract_params(cfg: TransformerConfig) -> Params:
    """The parameters as ``meta`` tensors: shapes and dtypes, no memory."""
    return init(cfg, None, "meta")


# ---------------------------------------------------------------------------
# Layer body (train / prefill / decode).
# ---------------------------------------------------------------------------


def _attention(cfg: TransformerConfig, layer: Mapping[str, torch.Tensor], x, positions,
               pos: int | None, k_cache: torch.Tensor | None, v_cache: torch.Tensor | None,
               tp: ModelAxis):
    """Prefill (``pos`` None): attention over ``x``'s sequence, whose keys
    and values are written to ``k_cache`` / ``v_cache`` ``[B, S, Hkv, Dh]``;
    training passes no caches and writes none. Decode: the token's keys and
    values are written at ``pos`` and it attends the cache up to and
    including them. With ``"qkv"`` on ``tp``'s axis the weights hold this
    rank's columns: where the heads split into whole heads over the ranks,
    each rank attends with its own heads; where they do not (fewer
    key/value heads than ranks), the projections are gathered, every rank
    attends with every head and keeps its columns of the output. Either way
    the output projection's partial sums are summed over the axis."""
    B, S, D = x.shape
    Dh = cfg.d_head
    heads = tp.on("qkv")
    if heads:
        x = tp.copy(x)
    q = x @ layer["attn/wq"]
    k = x @ layer["attn/wk"]
    v = x @ layer["attn/wv"]
    if cfg.qkv_bias:
        q, k, v = q + layer["attn/bq"], k + layer["attn/bk"], v + layer["attn/bv"]
    gathered = heads and bool(cfg.n_heads % tp.size or cfg.n_kv_heads % tp.size)
    if gathered:
        q, k, v = (tp.gather(t, 2, grad="sum") for t in (q, k, v))
    H, Hkv = q.shape[-1] // Dh, k.shape[-1] // Dh
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Hkv, Dh)
    v = v.reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q_norm, k_norm = layer["attn/q_norm"], layer["attn/k_norm"]
        if heads:   # replicated scales: each rank's gradient is a part
            q_norm, k_norm = tp.copy(q_norm), tp.copy(k_norm)
        q = rms_norm(q, q_norm)
        k = rms_norm(k, k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if pos is not None:
        # dynamic_update_slice clamps the start so the update fits.
        at = min(max(pos, 0), k_cache.shape[1] - 1)
        k_cache[:, at] = k[:, 0]
        v_cache[:, at] = v[:, 0]
        out = decode_attention(q, k_cache, v_cache, pos + 1)
    else:
        if k_cache is not None:
            k_cache.copy_(constrain(k, "batch", "kv_seq", None, None))
            v_cache.copy_(constrain(v, "batch", "kv_seq", None, None))
        out = blockwise_attention(
            q, k, v,
            causal=cfg.causal,
            q_block=min(cfg.attn_q_block, S),
            kv_block=min(cfg.attn_kv_block, S),
            causal_skip=cfg.causal_skip,
        )
    out = out.reshape(B, S, H * Dh)
    if gathered:
        n = layer["attn/wo"].shape[-2]
        out = out[..., tp.rank * n:(tp.rank + 1) * n]
    out = out @ layer["attn/wo"]
    return tp.reduce(out) if heads else out


def _layer(cfg: TransformerConfig, layer: Mapping[str, torch.Tensor], x, positions,
           pos: int | None, k_cache, v_cache, moe: bool, tp: ModelAxis
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer; returns (x, the MoE aux loss, 0 for a dense layer)."""
    seq_axis = "seq_sp" if cfg.seq_parallel else None
    x = x + _attention(cfg, layer, rms_norm(x, layer["ln1"]), positions, pos, k_cache, v_cache,
                       tp)
    x = constrain(x, "batch", seq_axis, None)
    h = rms_norm(x, layer["ln2"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not moe:
        h = glu_mlp(h, layer["mlp/w_gate"], layer["mlp/w_up"], layer["mlp/w_down"], tp)
    else:
        B, S, D = h.shape
        # Decode: one dispatch group of every sequence's token; prefill:
        # one group per sequence.
        groups = h.reshape(1, B * S, D) if pos is not None else h
        y, aux = moe_ffn(
            groups, layer["moe/router"], layer["moe/w_gate"], layer["moe/w_up"],
            layer["moe/w_down"], top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            tp=tp,
        )
        y = y.reshape(B, S, D)
        if cfg.n_shared_experts:
            y = y + glu_mlp(h, layer["shared/w_gate"], layer["shared/w_up"],
                            layer["shared/w_down"], tp)
        h = y
    return constrain(x + h, "batch", seq_axis, None), aux


def _save_mm(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``remat_policy="dots"``: keep plain 2-D matmul outputs, recompute
    everything else (batched products included)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig, fn):
    """``fn`` checkpointed per ``cfg.remat_policy``."""
    if cfg.remat_policy not in ("nothing", "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: want 'nothing' or 'dots'")
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _save_mm)
                  if cfg.remat_policy == "dots" else noop_context_fn)
    return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=context_fn)


def _embed_lookup(cfg: TransformerConfig, embed: torch.Tensor, tokens: torch.Tensor,
                  tp: ModelAxis) -> torch.Tensor:
    """Token embedding. ``embed_onehot``: the lookup as a one-hot matmul
    (the reference's layout for a vocab-sharded table; exact, since each
    output sums one product). With ``"vocab"`` on ``tp``'s axis the table
    holds this rank's rows: each rank looks up the tokens it holds, zeros
    elsewhere, and the axis sums them (exact: one term is not zero)."""
    ids = tokens.long()
    inside = None
    if tp.on("vocab"):
        ids = ids - tp.rank * embed.shape[0]
        inside = (ids >= 0) & (ids < embed.shape[0])
        ids = torch.where(inside, ids, 0)
    if not cfg.embed_onehot:
        x = F.embedding(ids, embed)
    else:
        onehot = F.one_hot(ids.reshape(-1), embed.shape[0]).to(embed.dtype)
        x = (onehot @ embed).reshape(*tokens.shape, embed.shape[1])
    if inside is None:
        return x
    return tp.reduce(torch.where(inside[..., None], x, 0.0))


def _forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor, positions,
             caches: Caches | None, pos: int | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The stacks over ``tokens``; ``caches`` are written as
    :func:`_attention` says, or, ``None``, the training mode: no cache, and
    each layer checkpointed under ``cfg.remat`` while autograd records.
    Returns (the final-normed hidden states, the MoE aux loss summed over
    the layers, float32).

    ``DTensor`` parameters (a train step's, placed by
    :func:`~repro_torch.train.elastic.remesh`) are used through
    :meth:`ModelAxis.use` where they are used: a layer's inside its
    checkpoint, so its gathered weights are dropped with its activations."""
    tp = ModelAxis.of(params, functools.partial(param_logical, cfg))
    use = tp.use
    x = _embed_lookup(cfg, use(params["embed"]), tokens, tp).to(_dtype(cfg))
    x = constrain(x, "batch", None, None)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = caches is None and cfg.remat and torch.is_grad_enabled()
    for name, n_layers, moe in _stacks(cfg):
        stack = {k[len(name) + 1:]: v for k, v in params.items() if k.startswith(name + "/")}
        keys = tuple(stack)

        def body(x, *weights, moe=moe, keys=keys):
            return _layer(cfg, {k: use(w) for k, w in zip(keys, weights)}, x, positions,
                          None, None, None, moe, tp)

        body = _remat(cfg, body) if remat else body
        for i in range(n_layers):
            if caches is None:
                x, aux = body(x, *(stack[k][i] for k in keys))
            else:
                x, aux = _layer(cfg, {k: use(v[i]) for k, v in stack.items()}, x, positions, pos,
                                caches[name]["k"][i], caches[name]["v"][i], moe, tp)
            aux_total = aux_total + aux
    return rms_norm(x, use(params["final_norm"])), aux_total


# ---------------------------------------------------------------------------
# Public steps.
# ---------------------------------------------------------------------------


def _ce_chunk(hb: torch.Tensor, lm_head: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    logits = (hb @ lm_head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb.long()[..., None])[..., 0]
    return (logz - gold).sum()


def _ce_chunk_vocab(hb: torch.Tensor, lm_head: torch.Tensor, lb: torch.Tensor,
                    tp: ModelAxis) -> torch.Tensor:
    """:func:`_ce_chunk` over this rank's columns of a vocab-sharded
    ``lm_head``: the logsumexp from the axis's maximum and its sum of
    exponentials, the gold logit from the rank that holds it."""
    logits = (tp.copy(hb) @ lm_head).float()
    top = tp.max(logits.amax(dim=-1))
    logz = top + torch.log(tp.reduce(torch.exp(logits - top[..., None]).sum(dim=-1)))
    ids = lb.long() - tp.rank * lm_head.shape[-1]
    inside = (ids >= 0) & (ids < lm_head.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, ids, 0)[..., None])[..., 0]
    gold = tp.reduce(torch.where(inside, gold, 0.0))
    return (logz - gold).sum()


def chunked_cross_entropy(h: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
                          chunk: int = 512, tp: ModelAxis = LOCAL) -> torch.Tensor:
    """Mean next-token CE without materializing ``[B, S, V]``: per chunk of
    ``chunk`` positions (every sequence's), float32 logits, their
    logsumexp and the gold logit; each chunk is checkpointed (recomputed in
    the backward pass) and the chunk totals are summed in order, then
    divided by ``B·S``. With ``"vocab"`` on ``tp``'s axis, ``lm_head``
    holds this rank's columns (:func:`_ce_chunk_vocab`)."""
    fn = _ce_chunk
    if tp.on("vocab"):
        fn = functools.partial(_ce_chunk_vocab, tp=tp)
    B, S, D = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        if torch.is_grad_enabled():
            part = checkpoint(fn, h[:, sl], lm_head, labels[:, sl], use_reentrant=False)
        else:
            part = fn(h[:, sl], lm_head, labels[:, sl])
        total = total + part
    return total / (B * S)


def loss_fn(cfg: TransformerConfig, params: Params, batch: Mapping[str, torch.Tensor]
            ) -> torch.Tensor:
    """``chunked_cross_entropy + 0.01 · aux`` over ``batch["tokens"]`` and
    ``batch["labels"]`` ``[B, S]``."""
    tokens, labels = batch["tokens"], batch["labels"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, aux = _forward(cfg, params, tokens, positions, None)
    tp = ModelAxis.of(params, functools.partial(param_logical, cfg))
    ce = chunked_cross_entropy(h, tp.use(params["lm_head"]), labels, tp=tp)
    return ce + 0.01 * aux


def _zeros_caches(cfg: TransformerConfig, batch: int, length: int, device) -> Caches:
    def zeros(n_layers):
        shape = (n_layers, batch, length, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
                "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}

    return {name: zeros(n) for name, n, _ in _stacks(cfg)}


@torch.no_grad()
def prefill(cfg: TransformerConfig, params: Params, tokens: torch.Tensor, cache_len: int
            ) -> tuple[torch.Tensor, Caches]:
    """Full-sequence prefill; returns (last-token logits [B, V] float32,
    KV caches padded or cut to ``cache_len``)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    caches = _zeros_caches(cfg, B, S, tokens.device)
    h, _ = _forward(cfg, params, tokens, positions, caches)
    logits = (h[:, -1] @ params["lm_head"]).float()
    return logits, _pad_caches(cfg, caches, cache_len)


def _pad_caches(cfg: TransformerConfig, caches: Caches, cache_len: int) -> Caches:
    def pad(x):
        S = x.shape[2]
        if S >= cache_len:
            return x[:, :, :cache_len]
        return F.pad(x, (0, 0, 0, 0, 0, cache_len - S))

    return {name: {kv: pad(t) for kv, t in c.items()} for name, c in caches.items()}


def make_decode_caches(cfg: TransformerConfig, batch: int, cache_len: int,
                       device: str | torch.device | None = None) -> Caches:
    """Zero caches for ``batch`` sequences of ``cache_len`` tokens on
    ``device`` (``None`` → the card; ``meta`` for shapes only)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    return _zeros_caches(cfg, batch, cache_len, dev)


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params: Params, token: torch.Tensor, caches: Caches,
                pos: int | torch.Tensor) -> tuple[torch.Tensor, Caches]:
    """One token for every sequence. token: [B, 1]; pos: the position it
    takes (an int or a 0-d tensor). Writes its keys and values into
    ``caches`` in place and returns (logits [B, V] float32, ``caches``)."""
    pos = int(pos)
    positions = torch.full((token.shape[0], 1), pos, dtype=torch.int32, device=token.device)
    h, _ = _forward(cfg, params, token, positions, caches, pos=pos)
    logits = (h[:, -1] @ params["lm_head"]).float()
    return logits, caches


# ---------------------------------------------------------------------------
# The weight converter.
# ---------------------------------------------------------------------------


def _leaf_to_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A copy of a numpy leaf as a tensor, bit for bit; bfloat16
    (``ml_dtypes``, which ``torch.from_numpy`` rejects) goes through its
    16-bit pattern."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def transformer_params_from_numpy(cfg: TransformerConfig, tree: Any,
                                  device: str | torch.device | None = None) -> Params:
    """The port's flat parameters on ``device`` (``None`` → the card) from
    the reference's parameter pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``). Paths, shapes and dtypes must be
    exactly those of ``cfg``."""
    dev = resolve_device(device)
    flat = {path: np.asarray(leaf) for path, leaf in tree_items(tree)}
    want = abstract_params(cfg)
    if set(flat) != set(want):
        raise ValueError(
            f"{cfg.name}: parameter paths differ from the reference's: missing "
            f"{sorted(set(want) - set(flat))}, unexpected {sorted(set(flat) - set(want))}"
        )
    out = {}
    for path, leaf in flat.items():
        t = _leaf_to_tensor(leaf, dev)
        if t.shape != want[path].shape or t.dtype != want[path].dtype:
            raise ValueError(f"{cfg.name}: {path} is {t.dtype}{list(t.shape)}, want "
                             f"{want[path].dtype}{list(want[path].shape)}")
        out[path] = t
    return out


def transformer_params_to_numpy(cfg: TransformerConfig, params: Mapping[str, torch.Tensor]
                                ) -> dict:
    """The reference's parameter pytree (nested dicts) with numpy leaves,
    the inverse of :func:`transformer_params_from_numpy`. bfloat16 leaves
    come out as ``ml_dtypes.bfloat16`` arrays (numpy has no bfloat16), so
    this direction needs the ``ml_dtypes`` package for bfloat16 models."""
    nested: dict = {}
    for path, t in params.items():
        node = nested
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            node[last] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            node[last] = t.numpy()
    return nested
