"""RecSys architectures: DLRM, DeepFM, DIN, BERT4Rec.

The port of :mod:`repro.models.recsys`. The hot path is the sparse
embedding lookup: :func:`embedding_bag` gathers rows with
``torch.nn.functional.embedding`` and sums each bag. With
``sparse_grad=True`` the lookups give their tables a sparse COO gradient
(touched rows × dim), which :func:`repro_torch.train.optimizer.adagrad_rowwise`
applies in place: the only way DLRM-RM2's 45.56 GB of tables train on one
card. The reference computes all of this in XLA, outside any Pallas kernel,
so the port has no kernel here either.

``retrieval_cand`` (1 query × 10⁶ candidates) is served by per-family
``score_candidates`` functions that compute the user side once and batch
the candidate side as one dense matmul/interaction sweep — never a loop
(DIN may sweep in chunks of candidates, which are independent).

Parameters are one flat ``dict[str, Tensor]`` keyed by the reference's
pytree path (``tables/t0``, ``bot/0/0`` for the first bottom-MLP weight,
``bot/0/1`` for its bias, ``blocks/wqkv``, …).
:func:`recsys_params_from_numpy` and :func:`recsys_params_to_numpy` carry
them across in both directions. ``init`` draws from an explicit
``torch.Generator`` on the target device with the reference's
distributions and scales (the numbers differ from ``jax.random``'s), so a
table never passes through host memory; on the ``meta`` device it only
shapes. The inputs carry the reference's sharding constraints
(:func:`~repro_torch.distributed.constrain`: the identity on a plain
tensor), and the logical-axis tables are its data.

On several ranks the train step splits the batch over ``"batch"`` and the
parameters stay plain tensors, replicated over ``"model"`` (exact: every
``"model"`` rank computes its share's step whole); their ``rows`` sharding
over ``"model"`` is not run. BERT4Rec's masked loss divides by the whole
batch's masked count (:func:`~repro_torch.distributed.parallel.batch_total`).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecSysConfig
from repro_torch.distributed.parallel import batch_total
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import rms_norm
from repro_torch.utils import resolve_device, tree_items

Params = dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Embedding substrate.
# ---------------------------------------------------------------------------


ROW_PAD = 512  # tables padded to shard boundaries (16 | 32 model ways)


def pad_rows(v: int) -> int:
    return -(-v // ROW_PAD) * ROW_PAD


def _take(table: torch.Tensor, ids: torch.Tensor, sparse_grad: bool = False) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (any shape) → ``[..., D]``. Ids are
    widened to int64: the largest tables hold more than 2³¹ elements."""
    return F.embedding(ids.long(), table, sparse=sparse_grad)


def embedding_bag(
    table: torch.Tensor, ids: torch.Tensor, combine: str = "sum", sparse_grad: bool = False
) -> torch.Tensor:
    """table [V, D]; ids [..., n_per_bag] → [..., D] (sum/mean over the bag)."""
    out = _take(table, ids, sparse_grad).sum(dim=-2)
    if combine == "mean":
        out = out / ids.shape[-1]
    return out


def _mlp(x: torch.Tensor, params: Mapping[str, torch.Tensor], prefix: str,
         final_activation=None) -> torch.Tensor:
    """The MLP of weights ``{prefix}/{i}/0`` and biases ``{prefix}/{i}/1``:
    relu between layers, ``final_activation`` after the last."""
    n = 0
    while f"{prefix}/{n}/0" in params:
        n += 1
    for i in range(n):
        x = x @ params[f"{prefix}/{i}/0"] + params[f"{prefix}/{i}/1"]
        if i < n - 1:
            x = torch.relu(x)
    if final_activation is not None:
        x = final_activation(x)
    return x


def _normal(gen: torch.Generator | None, shape: tuple[int, ...], device, scale: float = 1.0
            ) -> torch.Tensor:
    """N(0, 1) · ``scale`` drawn on ``device`` (scaled in place, so a table
    is allocated once); an empty tensor of the shape on ``meta``."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(scale)


def _const(shape: tuple[int, ...], device, value: float) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=device)


def _mlp_init(gen, prefix: str, dims: tuple[int, ...], device) -> Params:
    out = {}
    for i in range(len(dims) - 1):
        out[f"{prefix}/{i}/0"] = _normal(gen, (dims[i], dims[i + 1]), device, dims[i] ** -0.5)
        out[f"{prefix}/{i}/1"] = _const((dims[i + 1],), device, 0.0)
    return out


def _mlp_logical(prefix: str, dims: tuple[int, ...]) -> dict[str, tuple]:
    # Dense-MLP weights are KB-scale: replicate (sharding 40-wide layers over
    # 16 devices fails divisibility and saves nothing).
    out = {}
    for i in range(len(dims) - 1):
        out[f"{prefix}/{i}/0"] = (None, None)
        out[f"{prefix}/{i}/1"] = (None,)
    return out


# ---------------------------------------------------------------------------
# DLRM (arXiv:1906.00091) — dot interaction.
# ---------------------------------------------------------------------------


def dlrm_init(cfg: RecSysConfig, gen: torch.Generator | None, device) -> Params:
    params = {
        f"tables/t{i}": _normal(gen, (pad_rows(v), cfg.embed_dim), device, v ** -0.25).mul_(0.1)
        for i, v in enumerate(cfg.vocab_sizes)
    }
    n_vec = len(cfg.vocab_sizes) + 1
    n_pairs = n_vec * (n_vec - 1) // 2
    top_in = cfg.bot_mlp[-1] + n_pairs
    params.update(_mlp_init(gen, "bot", (cfg.n_dense, *cfg.bot_mlp), device))
    params.update(_mlp_init(gen, "top", (top_in, *cfg.top_mlp), device))
    return params


def dlrm_logical(cfg: RecSysConfig) -> dict[str, tuple]:
    return {
        **{f"tables/t{i}": ("rows", None) for i in range(len(cfg.vocab_sizes))},
        **_mlp_logical("bot", (cfg.n_dense, *cfg.bot_mlp)),
        **_mlp_logical("top", (cfg.bot_mlp[-1] + 1, *cfg.top_mlp)),
    }


def dot_interact(vecs: torch.Tensor) -> torch.Tensor:
    """``[B, n, d]`` → upper-triangle pairwise dots ``[B, n(n−1)/2]``, in
    ``np.triu_indices(n, k=1)`` order (row by row): the reference's
    ``_dot_interaction``. The rows of the Gram matrix are sliced on the host,
    so no index tensor is sent to the card."""
    n = vecs.shape[1]
    z = torch.bmm(vecs, vecs.transpose(1, 2))
    return torch.cat([z[:, i, i + 1:] for i in range(n - 1)], dim=1)


def dlrm_forward(cfg: RecSysConfig, params: Params, batch, sparse_grad: bool = False
                 ) -> torch.Tensor:
    dense = constrain(batch["dense"], "batch", None)              # [B, 13]
    sparse = constrain(batch["sparse"], "batch", None, None)      # [B, 26, hot]
    bot = _mlp(dense, params, "bot", torch.relu)                  # [B, D]
    embs = [
        embedding_bag(params[f"tables/t{i}"], sparse[:, i], sparse_grad=sparse_grad)
        for i in range(len(cfg.vocab_sizes))
    ]
    vecs = torch.stack([bot, *embs], dim=1)                       # [B, 27, D]
    feats = torch.cat([bot, dot_interact(vecs)], dim=-1)
    return _mlp(feats, params, "top")[..., 0]                     # logits [B]


def dlrm_score_candidates(cfg: RecSysConfig, params: Params, batch) -> torch.Tensor:
    """1 user (dense + 25 fields) × C candidate items (last field)."""
    dense = batch["dense"]                                        # [1, 13]
    sparse = batch["sparse"]                                      # [1, 25, hot]
    cands = constrain(batch["cand_ids"], "cands")                 # [C]
    bot = _mlp(dense, params, "bot", torch.relu)                  # [1, D]
    user_embs = [
        embedding_bag(params[f"tables/t{i}"], sparse[:, i])
        for i in range(len(cfg.vocab_sizes) - 1)
    ]
    user_vecs = torch.cat([bot, *user_embs], dim=0)               # [26, D]
    cand_vec = _take(params[f"tables/t{len(cfg.vocab_sizes) - 1}"], cands)  # [C, D]
    # User-user dots are candidate-independent; compute once.
    uu_flat = dot_interact(user_vecs[None])[0]                    # [n_u(n_u-1)/2]
    uc = cand_vec @ user_vecs.T                                   # [C, n_u]
    C = cands.shape[0]
    feats = torch.cat(
        [bot[0].expand(C, bot.shape[1]), uu_flat.expand(C, uu_flat.shape[0]), uc], dim=-1
    )
    return _mlp(feats, params, "top")[..., 0]                     # [C]


# ---------------------------------------------------------------------------
# DeepFM (arXiv:1703.04247) — FM + deep on one concatenated table.
# ---------------------------------------------------------------------------


def deepfm_init(cfg: RecSysConfig, gen: torch.Generator | None, device) -> Params:
    V = pad_rows(sum(cfg.vocab_sizes))
    deep_in = cfg.n_sparse * cfg.embed_dim
    return {
        "table": _normal(gen, (V, cfg.embed_dim), device, 0.01),
        "first_order": _normal(gen, (V, 1), device, 0.01),
        **_mlp_init(gen, "deep", (deep_in, *cfg.mlp, 1), device),
        "bias": _const((), device, 0.0),
    }


def deepfm_logical(cfg: RecSysConfig) -> dict[str, tuple]:
    return {
        "table": ("rows", None),
        "first_order": ("rows", None),
        **_mlp_logical("deep", (cfg.n_sparse * cfg.embed_dim, *cfg.mlp, 1)),
        "bias": (),
    }


def deepfm_forward(cfg: RecSysConfig, params: Params, batch, sparse_grad: bool = False
                   ) -> torch.Tensor:
    ids = constrain(batch["ids"], "batch", None)                  # [B, 39] global ids
    v = _take(params["table"], ids, sparse_grad)                  # [B, 39, D]
    w = _take(params["first_order"], ids, sparse_grad)[..., 0]    # [B, 39]
    fm1 = w.sum(dim=-1)
    s = v.sum(dim=1)
    fm2 = 0.5 * ((s * s).sum(dim=-1) - (v * v).sum(dim=(1, 2)))
    deep = _mlp(v.reshape(v.shape[0], -1), params, "deep")[..., 0]
    return fm1 + fm2 + deep + params["bias"]


def deepfm_score_candidates(cfg: RecSysConfig, params: Params, batch) -> torch.Tensor:
    """User fields fixed, candidate = last field swept over C ids."""
    ids = batch["ids"]                                            # [1, 38]
    cands = constrain(batch["cand_ids"], "cands")                 # [C]
    vu = _take(params["table"], ids[0])                           # [38, D]
    wu = _take(params["first_order"], ids[0]).sum()
    vc = _take(params["table"], cands)                            # [C, D]
    wc = _take(params["first_order"], cands)[..., 0]              # [C]
    su = vu.sum(dim=0)
    s = su[None] + vc
    fm2 = 0.5 * ((s * s).sum(dim=-1) - ((vu * vu).sum() + (vc * vc).sum(dim=-1)))
    C = cands.shape[0]
    deep_in = torch.cat([vu.reshape(-1).expand(C, vu.numel()), vc], dim=-1)
    deep = _mlp(deep_in, params, "deep")[..., 0]
    return wu + wc + fm2 + deep + params["bias"]


# ---------------------------------------------------------------------------
# DIN (arXiv:1706.06978) — target attention over user history.
# ---------------------------------------------------------------------------


def din_init(cfg: RecSysConfig, gen: torch.Generator | None, device) -> Params:
    D = cfg.embed_dim
    return {
        "item_table": _normal(gen, (pad_rows(cfg.item_vocab), D), device, 0.01),
        **_mlp_init(gen, "attn", (4 * D, *cfg.attn_mlp, 1), device),
        **_mlp_init(gen, "out", (3 * D, *cfg.mlp, 1), device),
    }


def din_logical(cfg: RecSysConfig) -> dict[str, tuple]:
    return {
        "item_table": ("rows", None),
        **_mlp_logical("attn", (4 * cfg.embed_dim, *cfg.attn_mlp, 1)),
        **_mlp_logical("out", (3 * cfg.embed_dim, *cfg.mlp, 1)),
    }


def _din_user_vec(params: Params, hist_vec, target_vec, hist_mask) -> torch.Tensor:
    """hist [B, S, D], target [B, D] → attention-pooled user vec [B, D]."""
    t = target_vec[:, None].expand(hist_vec.shape)
    attn_in = torch.cat([t, hist_vec, t - hist_vec, t * hist_vec], dim=-1)
    scores = _mlp(attn_in, params, "attn")[..., 0]                # [B, S]
    scores = torch.where(hist_mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bs,bsd->bd", w, hist_vec)


def din_forward(cfg: RecSysConfig, params: Params, batch, sparse_grad: bool = False
                ) -> torch.Tensor:
    hist = constrain(batch["hist_ids"], "batch", None)            # [B, S]
    target = constrain(batch["target_id"], "batch")               # [B]
    hist_mask = hist >= 0
    hist_vec = _take(params["item_table"], hist.clamp_min(0), sparse_grad)
    target_vec = _take(params["item_table"], target, sparse_grad)
    user = _din_user_vec(params, hist_vec, target_vec, hist_mask)
    feats = torch.cat([user, target_vec, user * target_vec], dim=-1)
    return _mlp(feats, params, "out")[..., 0]


def din_score_candidates(cfg: RecSysConfig, params: Params, batch,
                         chunk: int | None = None) -> torch.Tensor:
    """One user history × C candidates — candidate-dependent attention.
    ``chunk`` sweeps the candidates that many at a time (each candidate's
    score depends on it alone): the attention input of one sweep is
    ``[C, S, 4·D]``, 28.8 GB at DIN's full width and 10⁶ candidates."""
    hist = batch["hist_ids"][0]                                   # [S]
    cands = constrain(batch["cand_ids"], "cands")                 # [C]
    hist_mask = (hist >= 0)[None]
    hist_vec = _take(params["item_table"], hist.clamp_min(0))     # [S, D]

    def sweep(c: torch.Tensor) -> torch.Tensor:
        cand_vec = _take(params["item_table"], c)                 # [c, D]
        hv = hist_vec[None].expand(c.shape[0], *hist_vec.shape)
        user = _din_user_vec(params, hv, cand_vec, hist_mask)
        feats = torch.cat([user, cand_vec, user * cand_vec], dim=-1)
        return _mlp(feats, params, "out")[..., 0]

    if chunk is None or chunk >= cands.shape[0]:
        return sweep(cands)
    return torch.cat([sweep(c) for c in cands.split(chunk)])


# ---------------------------------------------------------------------------
# BERT4Rec (arXiv:1904.06690) — bidirectional transformer, tied softmax.
# ---------------------------------------------------------------------------


_BLOCK_KEYS = ("ln1", "ln2", "wqkv", "wo", "w1", "b1", "w2", "b2")


def bert4rec_init(cfg: RecSysConfig, gen: torch.Generator | None, device) -> Params:
    D, L = cfg.embed_dim, cfg.n_blocks
    d_ff = 4 * D
    return {
        # +1 row = [MASK]
        "item_embed": _normal(gen, (pad_rows(cfg.item_vocab + 1), D), device, 0.02),
        "pos_embed": _normal(gen, (cfg.seq_len, D), device, 0.02),
        "blocks/ln1": _const((L, D), device, 1.0),
        "blocks/ln2": _const((L, D), device, 1.0),
        "blocks/wqkv": _normal(gen, (L, D, 3 * D), device, D ** -0.5),
        "blocks/wo": _normal(gen, (L, D, D), device, D ** -0.5),
        "blocks/w1": _normal(gen, (L, D, d_ff), device, D ** -0.5),
        "blocks/b1": _const((L, d_ff), device, 0.0),
        "blocks/w2": _normal(gen, (L, d_ff, D), device, d_ff ** -0.5),
        "blocks/b2": _const((L, D), device, 0.0),
        "final_ln": _const((D,), device, 1.0),
    }


def bert4rec_logical(cfg: RecSysConfig) -> dict[str, tuple]:
    return {
        "item_embed": ("rows", None),
        "pos_embed": (None, None),
        "blocks/ln1": ("layers", None),
        "blocks/ln2": ("layers", None),
        "blocks/wqkv": ("layers", None, "qkv"),
        "blocks/wo": ("layers", "qkv", None),
        "blocks/w1": ("layers", None, "ff"),
        "blocks/b1": ("layers", "ff"),
        "blocks/w2": ("layers", "ff", None),
        "blocks/b2": ("layers", None),
        "final_ln": (None,),
    }


def bert4rec_encode(cfg: RecSysConfig, params: Params, ids: torch.Tensor,
                    sparse_grad: bool = False) -> torch.Tensor:
    """ids [B, S] → hidden [B, S, D]; bidirectional (no causal mask)."""
    B, S = ids.shape
    D, H = cfg.embed_dim, cfg.n_heads
    Dh = D // H
    x = _take(params["item_embed"], ids, sparse_grad) + params["pos_embed"][None, :S]
    x = constrain(x, "batch", None, None)
    for layer in range(cfg.n_blocks):
        blk = {k: params[f"blocks/{k}"][layer] for k in _BLOCK_KEYS}
        h = rms_norm(x, blk["ln1"])
        qkv = (h @ blk["wqkv"]).reshape(B, S, 3, H, Dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(Dh)
        attn = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, S, D)
        x = x + o @ blk["wo"]
        h = rms_norm(x, blk["ln2"])
        # jax.nn.gelu defaults to the tanh approximation.
        x = x + F.gelu(h @ blk["w1"] + blk["b1"], approximate="tanh") @ blk["w2"] + blk["b2"]
    return rms_norm(x, params["final_ln"])


def bert4rec_masked_loss(cfg: RecSysConfig, params: Params, batch,
                         sparse_grad: bool = False) -> torch.Tensor:
    """Cloze training: predict items at masked positions (tied softmax)."""
    h = bert4rec_encode(cfg, params, batch["ids"], sparse_grad)   # [B, S, D]
    logits = torch.einsum("bsd,vd->bsv", h, params["item_embed"])
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, batch["labels"].long()[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * batch["mask_pos"]
    count, n = batch_total(batch["mask_pos"].sum())
    if n == 1:
        return nll.sum() / torch.clamp_min(count, 1.0)
    # A rank's share of a batch split over n ranks: the whole batch's
    # masked count, and n times the quotient, so that the step's mean over
    # the ranks is the one-program loss.
    return n * (nll.sum() / torch.clamp_min(count, 1.0))


def bert4rec_forward(cfg: RecSysConfig, params: Params, batch, sparse_grad: bool = False
                     ) -> torch.Tensor:
    """Serve: next-item score for a provided target at the last position."""
    h = bert4rec_encode(cfg, params, batch["ids"], sparse_grad)[:, -1]  # [B, D]
    tgt = _take(params["item_embed"], batch["target_id"], sparse_grad)
    return (h * tgt).sum(dim=-1)


def bert4rec_score_candidates(cfg: RecSysConfig, params: Params, batch) -> torch.Tensor:
    h = bert4rec_encode(cfg, params, batch["ids"])[:, -1]         # [1, D]
    cand_vec = _take(params["item_embed"], constrain(batch["cand_ids"], "cands"))  # [C, D]
    return cand_vec @ h[0]


# ---------------------------------------------------------------------------
# Family dispatch.
# ---------------------------------------------------------------------------

INIT = {"dlrm": dlrm_init, "deepfm": deepfm_init, "din": din_init,
        "bert4rec": bert4rec_init}
LOGICAL = {"dlrm": dlrm_logical, "deepfm": deepfm_logical, "din": din_logical,
           "bert4rec": bert4rec_logical}
FORWARD = {"dlrm": dlrm_forward, "deepfm": deepfm_forward, "din": din_forward,
           "bert4rec": bert4rec_forward}
SCORE_CANDIDATES = {
    "dlrm": dlrm_score_candidates,
    "deepfm": deepfm_score_candidates,
    "din": din_score_candidates,
    "bert4rec": bert4rec_score_candidates,
}


def loss_fn(cfg: RecSysConfig, params: Params, batch, sparse_grad: bool = False
            ) -> torch.Tensor:
    """Mean logistic loss on ``label`` (BERT4Rec: the masked-item loss).
    ``sparse_grad``: the embedding lookups give their tables sparse
    gradients."""
    if cfg.family == "bert4rec":
        return bert4rec_masked_loss(cfg, params, batch, sparse_grad)
    logits = FORWARD[cfg.family](cfg, params, batch, sparse_grad=sparse_grad)
    y = batch["label"].float()
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * y + torch.log1p(torch.exp(-torch.abs(logits)))
    )


# ---------------------------------------------------------------------------
# The weight converter.
# ---------------------------------------------------------------------------


def recsys_params_from_numpy(cfg: RecSysConfig, tree: Any,
                             device: str | torch.device | None = None) -> Params:
    """The port's flat parameters on ``device`` (``None`` → the card) from
    the reference's parameter pytree (nested dicts and lists of ``(w, b)``
    tuples) with numpy leaves (``jax.tree.map(np.asarray, params)``). The
    paths must be exactly those of ``cfg``'s family."""
    dev = resolve_device(device)
    flat = {path: np.asarray(leaf) for path, leaf in tree_items(tree)}
    want = set(INIT[cfg.family](cfg, None, "meta"))
    if set(flat) != want:
        raise ValueError(
            f"{cfg.name}: parameter paths differ from the reference's: missing "
            f"{sorted(want - set(flat))}, unexpected {sorted(set(flat) - want)}"
        )
    return {k: torch.as_tensor(np.array(v, np.float32), device=dev) for k, v in flat.items()}


def recsys_params_to_numpy(cfg: RecSysConfig, params: Mapping[str, torch.Tensor]) -> dict:
    """The reference's parameter pytree (nested dicts; an MLP is a list of
    ``(w, b)`` tuples) with numpy leaves, the inverse of
    :func:`recsys_params_from_numpy`."""
    nested: dict = {}
    for path, t in params.items():
        node = nested
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = t.detach().cpu().numpy()

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            items = [build(node[str(i)]) for i in range(len(node))]
            leaves = not any(isinstance(node[k], dict) for k in node)
            return tuple(items) if leaves else items
        return {k: build(v) for k, v in node.items()}

    return build(nested)
