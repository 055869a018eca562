"""Unified architecture API: one entry point per (arch × shape) cell.

The port of :mod:`repro.models.api`. ``make_cell(cfg, shape)`` returns a
:class:`Cell` bundling everything a launcher needs:

- ``abstract_state()``  — the step's carried state as tensors on the
  ``meta`` device (a :class:`TrainState` for ``train`` shapes; the
  parameters for serving): shapes and dtypes of a full config, no memory.
- ``state_logical()``   — matching logical-axis tree.
- ``input_specs()``     — ``meta`` tensors standing in for one step's inputs,
  in the reference's order (:func:`repro_torch.models.synth.synthesize_inputs`
  draws them in that order).
- ``input_logical()``   — logical axes for those inputs.
- ``step``              — ``(state, inputs) → ...``, eager: a train step
  returns ``(state, metrics)``, a serving step its scores.
- ``init_state(seed, device=None)`` — real init on ``device`` (``None`` →
  the card) from an int seed or a ``torch.Generator`` (the reference takes
  a JAX key).

Parameters are flat ``dict[str, Tensor]`` keyed by the reference's pytree
paths. On several ranks an LM train cell computes on its ``DTensor``
state; a RecSys or NequIP train cell steps a placed state on its local
shards (:func:`~repro_torch.train.trainer.make_train_step`'s
``param_logical``). Every serving cell's step is
:func:`~repro_torch.train.trainer.make_serve_step`: under the rules on a
mesh each rank serves its share of the queries (``"batch"``), of the
candidates (``"cands"``) and of the decode caches' sequence
(``"kv_seq"``); RecSys and the forest on their parameters' local shards,
the LM on its ``DTensor`` parameters; the outputs come back whole.

Every family of the registry has its cells: RecSys
(:mod:`repro_torch.models.recsys`), the LM's ``train``, ``prefill`` and
``decode`` (:mod:`repro_torch.models.transformer`; a train cell
accumulates microbatch gradients in bfloat16 under Adafactor, float32
otherwise, as the reference), NequIP's train cells
(:mod:`repro_torch.models.nequip`; with forces where the shape batches
graphs) and the paper's forest. A decode step writes its token's keys and
values into the input caches in place and returns them.

The forest cell serves the LEAR cascade over a padded ``[Q, D, F]`` block
through the hand-written forest kernel
(:func:`repro_torch.kernels.ops.forest_score_range` over a cached
:func:`~repro_torch.kernels.ops.padded_forest`): head ``[0, sentinel)``,
classifier, tail, one launch each (a second sentinel adds one); on CPU
tensors the same calls run the kernel's plain version. The reference scores
with ``score_bitvector``; the kernel sums the trees in the reference
kernel's order, so the two agree within 1e-5 (``ROADMAP.md`` C2).
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from functools import partial
from typing import Any

import torch

from repro_torch.configs.base import (
    ForestConfig,
    NequIPConfig,
    RecSysConfig,
    ShapeSpec,
    TransformerConfig,
)
from repro_torch.models import nequip as nequip_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tfm
from repro_torch.train.optimizer import get_optimizer, is_rowwise_table
from repro_torch.train.trainer import TrainState, init_state, make_serve_step, make_train_step
from repro_torch.utils import resolve_device

F32 = torch.float32
I32 = torch.int32

# DIN's retrieval sweep takes this many candidates at a time: one chunk's
# attention input [2¹⁷, 100, 72] f32 is 3.8 GB, where the whole 1,000,448
# candidates' would be 28.8 GB beside a 32.0 GB first MLP layer.
DIN_CAND_CHUNK = 1 << 17


@dataclasses.dataclass
class Cell:
    cfg: Any
    shape: ShapeSpec
    step: Callable
    abstract_state: Callable[[], Any]
    state_logical: Callable[[], Any]
    input_specs: Callable[[], Any]
    input_logical: Callable[[], Any]
    init_state: Callable[..., Any]  # (seed | Generator, device=None) -> state


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _generator(seed: int | torch.Generator, device: torch.device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


# ---------------------------------------------------------------------------
# Optimizer-state logical axes.
# ---------------------------------------------------------------------------


def _opt_logical(opt_name: str, abstract_params: dict, param_logical: dict):
    if opt_name == "adamw":
        return {"m": param_logical, "v": param_logical, "count": ()}
    if opt_name == "adafactor":
        def leaf(p, lg):
            lg = tuple(lg)
            if p.ndim >= 2:
                return {"vr": lg[:-1], "vc": lg[:-2] + lg[-1:]}
            return {"v": lg}

        f = {k: leaf(p, param_logical[k]) for k, p in abstract_params.items()}
        return {"f": f, "count": ()}
    if opt_name == "adagrad_rowwise":
        return {"acc": {
            k: tuple(param_logical[k])[:1] if is_rowwise_table(p) else tuple(param_logical[k])
            for k, p in abstract_params.items()
        }}
    raise ValueError(opt_name)


def _train_cell(cfg, shape, loss_fn, abstract_params_fn, param_logical,
                init_fn, inputs_fn, inputs_logical, microbatch=0,
                accum_dtype=F32, local_shards=False) -> Cell:
    opt = get_optimizer(cfg.optimizer)
    # The step splits the inputs whose leading logical axis is "batch"
    # (over the batch ranks) or "edges" (NequIP's, over the edge ranks);
    # ``local_shards``: a placed state steps on its local shards.
    step = partial(make_train_step(loss_fn, opt, microbatch=microbatch, accum_dtype=accum_dtype),
                   input_logical=inputs_logical(),
                   param_logical=param_logical if local_shards else None)

    def abstract_state():
        params = abstract_params_fn()
        return TrainState(params=params, opt_state=opt.init(params), step=_sds((), I32))

    def state_logical():
        return TrainState(
            params=param_logical,
            opt_state=_opt_logical(cfg.optimizer, abstract_params_fn(), param_logical),
            step=(),
        )

    def init(seed, device=None):
        dev = resolve_device(device)
        return init_state(init_fn(_generator(seed, dev), dev), opt)

    return Cell(
        cfg=cfg, shape=shape, step=step,
        abstract_state=abstract_state, state_logical=state_logical,
        input_specs=inputs_fn, input_logical=inputs_logical,
        init_state=init,
    )


def _pad512(n: int) -> int:
    """Graph/candidate axes padded to 512 so every mesh factoring divides
    (data=16, data×model=256, pod×data×model=512). The data pipeline emits
    dummy entries (self-edges on a ghost node / zero-weight rows)."""
    return -(-n // 512) * 512


# ---------------------------------------------------------------------------
# LM transformers.
# ---------------------------------------------------------------------------


def _lm_cell(cfg: TransformerConfig, shape: ShapeSpec) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    plogical = tfm.param_logical(cfg)

    if shape.kind == "train":
        def inputs():
            return {"tokens": _sds((B, S), I32), "labels": _sds((B, S), I32)}

        def inputs_logical():
            return {"tokens": ("batch", None), "labels": ("batch", None)}

        accum = torch.bfloat16 if cfg.optimizer == "adafactor" else F32
        return _train_cell(
            cfg, shape, partial(tfm.loss_fn, cfg),
            lambda: tfm.abstract_params(cfg), plogical,
            lambda gen, dev: tfm.init(cfg, gen, dev),
            inputs, inputs_logical,
            microbatch=shape.microbatch, accum_dtype=accum,
        )

    def init(seed, device=None):
        dev = resolve_device(device)
        return tfm.init(cfg, _generator(seed, dev), dev)

    def cell(step, inputs, inputs_logical):
        return Cell(
            cfg=cfg, shape=shape, step=step,
            abstract_state=lambda: tfm.abstract_params(cfg),
            state_logical=lambda: plogical,
            input_specs=inputs, input_logical=inputs_logical,
            init_state=init,
        )

    cache_lg = {name: {kv: (None, "batch", "kv_seq", None, None) for kv in c}
                for name, c in tfm.make_decode_caches(cfg, B, S, "meta").items()}
    out_logical = (("batch", None), cache_lg)   # logits, caches
    if shape.kind == "prefill":
        def prefill(params, inputs):
            return tfm.prefill(cfg, params, inputs["tokens"], cache_len=S)

        logical = {"tokens": ("batch", None)}
        return cell(make_serve_step(prefill, logical, out_logical, plogical, kv_len=S),
                    lambda: {"tokens": _sds((B, S), I32)}, lambda: logical)

    # decode
    def decode(params, inputs):
        return tfm.decode_step(cfg, params, inputs["token"], inputs["caches"], inputs["pos"])

    def inputs():
        return {"token": _sds((B, 1), I32),
                "caches": tfm.make_decode_caches(cfg, B, S, "meta"),
                "pos": _sds((), I32)}

    logical = {"token": ("batch", None), "caches": cache_lg, "pos": ()}
    return cell(make_serve_step(decode, logical, out_logical, plogical, kv_len=S), inputs,
                lambda: logical)


# ---------------------------------------------------------------------------
# NequIP.
# ---------------------------------------------------------------------------


def _nequip_inputs(shape: ShapeSpec):
    if shape.graph_batch and shape.n_nodes < 10_000:
        # batched-small-graphs: totals = per-graph size × batch
        N = _pad512(shape.n_nodes * shape.graph_batch)
        E = _pad512(shape.n_edges * shape.graph_batch)
    else:
        N, E = _pad512(shape.n_nodes), _pad512(shape.n_edges)
    n_graphs = shape.graph_batch or 1
    specs = {
        "positions": _sds((N, 3), F32),
        "species": _sds((N,), I32),
        "edge_src": _sds((E,), I32),
        "edge_dst": _sds((E,), I32),
        "energy": _sds((n_graphs,), F32),
    }
    logical = {
        "positions": ("nodes", None),
        "species": ("nodes",),
        "edge_src": ("edges",),
        "edge_dst": ("edges",),
        "energy": (None,),
    }
    if shape.graph_batch:
        specs["graph_id"] = _sds((N,), I32)
        logical["graph_id"] = ("nodes",)
        specs["forces"] = _sds((N, 3), F32)
        logical["forces"] = ("nodes", None)
    if shape.d_feat:
        specs["node_feat"] = _sds((N, shape.d_feat), F32)
        logical["node_feat"] = ("nodes", None)
    return specs, logical


def _nequip_cell(cfg: NequIPConfig, shape: ShapeSpec) -> Cell:
    d_feat = shape.d_feat
    specs, logical = _nequip_inputs(shape)
    return _train_cell(
        cfg, shape,
        partial(nequip_mod.loss_fn, cfg, with_forces=bool(shape.graph_batch)),
        lambda: nequip_mod.init(cfg, None, "meta", d_feat),
        nequip_mod.param_logical(cfg, d_feat),
        lambda gen, dev: nequip_mod.init(cfg, gen, dev, d_feat),
        lambda: specs, lambda: logical, local_shards=True,
    )


# ---------------------------------------------------------------------------
# RecSys.
# ---------------------------------------------------------------------------


def _recsys_inputs(cfg: RecSysConfig, shape: ShapeSpec):
    B = shape.batch
    fam = cfg.family
    if shape.n_candidates:
        C = _pad512(shape.n_candidates)
        if fam == "dlrm":
            specs = {
                "dense": _sds((1, cfg.n_dense), F32),
                "sparse": _sds((1, cfg.n_sparse - 1, cfg.multi_hot), I32),
                "cand_ids": _sds((C,), I32),
            }
            logical = {"dense": (None, None), "sparse": (None, None, None),
                       "cand_ids": ("cands",)}
        elif fam == "deepfm":
            specs = {"ids": _sds((1, cfg.n_sparse - 1), I32),
                     "cand_ids": _sds((C,), I32)}
            logical = {"ids": (None, None), "cand_ids": ("cands",)}
        elif fam == "din":
            specs = {"hist_ids": _sds((1, cfg.seq_len), I32),
                     "cand_ids": _sds((C,), I32)}
            logical = {"hist_ids": (None, None), "cand_ids": ("cands",)}
        else:  # bert4rec
            specs = {"ids": _sds((1, cfg.seq_len), I32),
                     "cand_ids": _sds((C,), I32)}
            logical = {"ids": (None, None), "cand_ids": ("cands",)}
        return specs, logical

    if fam == "dlrm":
        specs = {
            "dense": _sds((B, cfg.n_dense), F32),
            "sparse": _sds((B, cfg.n_sparse, cfg.multi_hot), I32),
        }
        logical = {"dense": ("batch", None), "sparse": ("batch", None, None)}
    elif fam == "deepfm":
        specs = {"ids": _sds((B, cfg.n_sparse), I32)}
        logical = {"ids": ("batch", None)}
    elif fam == "din":
        specs = {"hist_ids": _sds((B, cfg.seq_len), I32),
                 "target_id": _sds((B,), I32)}
        logical = {"hist_ids": ("batch", None), "target_id": ("batch",)}
    else:  # bert4rec
        specs = {"ids": _sds((B, cfg.seq_len), I32)}
        logical = {"ids": ("batch", None)}

    if shape.kind == "train":
        if fam == "bert4rec":
            specs.update({"labels": _sds((B, cfg.seq_len), I32),
                          "mask_pos": _sds((B, cfg.seq_len), F32)})
            logical.update({"labels": ("batch", None),
                            "mask_pos": ("batch", None)})
        else:
            specs["label"] = _sds((B,), F32)
            logical["label"] = ("batch",)
    elif fam == "bert4rec" and shape.kind == "serve":
        specs["target_id"] = _sds((B,), I32)
        logical["target_id"] = ("batch",)
    return specs, logical


def _recsys_cell(cfg: RecSysConfig, shape: ShapeSpec) -> Cell:
    fam = cfg.family
    plogical = recsys_mod.LOGICAL[fam](cfg)
    specs, logical = _recsys_inputs(cfg, shape)
    init_fn = partial(recsys_mod.INIT[fam], cfg)
    abstract = partial(recsys_mod.INIT[fam], cfg, None, "meta")

    if shape.kind == "train":
        # Row-wise Adagrad takes the tables' gradients as sparse rows.
        sparse = cfg.optimizer == "adagrad_rowwise"
        return _train_cell(
            cfg, shape, partial(recsys_mod.loss_fn, cfg, sparse_grad=sparse),
            abstract, plogical, init_fn,
            lambda: specs, lambda: logical,
            microbatch=shape.microbatch, local_shards=True,
        )

    if not shape.n_candidates:
        fwd = recsys_mod.FORWARD[fam]
    elif fam == "din":
        fwd = partial(recsys_mod.din_score_candidates, chunk=DIN_CAND_CHUNK)
    else:
        fwd = recsys_mod.SCORE_CANDIDATES[fam]
    # Scores per request, or per candidate.
    step = make_serve_step(partial(fwd, cfg), logical,
                           ("cands",) if shape.n_candidates else ("batch",),
                           param_logical=plogical)

    def init(seed, device=None):
        dev = resolve_device(device)
        return init_fn(_generator(seed, dev), dev)

    return Cell(
        cfg=cfg, shape=shape, step=step,
        abstract_state=abstract, state_logical=lambda: plogical,
        input_specs=lambda: specs, input_logical=lambda: logical,
        init_state=init,
    )


# ---------------------------------------------------------------------------
# Forest (the paper's arch): LEAR cascade serving.
# ---------------------------------------------------------------------------


def _forest_abstract(cfg: ForestConfig) -> dict:
    from repro_torch.forest.ensemble import TreeEnsemble

    n_int = (1 << cfg.depth) - 1
    n_leaf = 1 << cfg.depth

    def ens(T):
        return TreeEnsemble(
            feature=_sds((T, n_int), I32),
            threshold=_sds((T, n_int), F32),
            left=_sds((T, n_int), I32),
            right=_sds((T, n_int), I32),
            mask=_sds((T, n_int), torch.int64),  # the reference's mask_lo | mask_hi << 32
            leaf_value=_sds((T, n_leaf), F32),
            base_score=_sds((), F32),
        )

    return {
        "ranker": ens(cfg.n_trees),
        "classifier": ens(cfg.classifier_trees),
        "threshold": _sds((), F32),
    }


def _forest_real(cfg: ForestConfig, seed: int | torch.Generator, device=None) -> dict:
    """Random ranker and classifier as the reference draws them; an int
    ``seed`` is the reference's derived seed (``api.py:395``), a generator
    draws one."""
    from repro_torch.forest.ensemble import random_ensemble

    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 2**31 - 1, (), generator=seed, device=seed.device))
    return {
        "ranker": random_ensemble(seed, cfg.n_trees, cfg.depth, cfg.n_features, device=dev),
        "classifier": random_ensemble(
            seed + 1, cfg.classifier_trees, cfg.depth, cfg.n_features + 4, device=dev
        ),
        "threshold": torch.tensor(0.5, dtype=F32, device=dev),
    }


def _forest_bounds(cfg: ForestConfig) -> tuple[int, ...]:
    """The ranker's segment ends: [0, sentinel), [sentinel, sentinel2) when
    the compacted path has a second sentinel, then the tail."""
    s2 = cfg.sentinel2 if cfg.capacity_frac > 0 and cfg.sentinel2 > cfg.sentinel else 0
    return (cfg.sentinel, s2, cfg.n_trees) if s2 else (cfg.sentinel, cfg.n_trees)


@torch.no_grad()
def forest_head(cfg: ForestConfig, params: dict, X: torch.Tensor, mask: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forest cell's first stage on a ``[Q, D, F]`` block: the ranker's
    ``[0, sentinel)`` partial scores ``[Q, D]``, the classifier's input
    ``[Q·D, F + 4]`` and its Continue probability ``[Q, D]`` (two kernel
    launches). The step continues a document where the probability reaches
    ``params["threshold"]``."""
    from repro_torch.core.features import augment_features
    from repro_torch.kernels.ops import forest_score_range, padded_forest

    Q, D, F = X.shape
    pf = padded_forest(params["ranker"], boundaries=_forest_bounds(cfg))
    part = forest_score_range(pf, X.reshape(-1, F), 0, 1).reshape(Q, D)
    aug = augment_features(X, part, mask).reshape(Q * D, F + 4)
    logits = forest_score_range(padded_forest(params["classifier"]), aug).reshape(Q, D)
    return part, aug, torch.sigmoid(logits)


def _forest_step(cfg: ForestConfig):
    from repro_torch.kernels.ops import forest_score_range, padded_forest

    bounds = _forest_bounds(cfg)
    s2 = bounds[1] if len(bounds) == 3 else 0

    def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return torch.take_along_dim(x, idx[..., None] if x.ndim == 3 else idx, dim=1)

    def _first(keep: torch.Tensor, n: int) -> torch.Tensor:
        """Per row, the indices of ``keep``'s True entries first, in order
        (a stable partition), cut to ``n``."""
        return torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)[:, :n]

    @torch.no_grad()
    def step(params, inputs):
        """LEAR cascade over a padded [Q, D, F] block.

        capacity_frac == 0 → reference path: every document runs every
        tree, exits applied arithmetically (the paper's *quality*
        semantics, used as the §Perf baseline = "Full" cost).

        capacity_frac > 0 → compacted path: per query, only the top
        ⌈frac·D⌉ survivors (stable-partitioned by the classifier verdict)
        traverse the tail trees. sentinel2 adds a second rank-based cut
        (beyond-paper multi-sentinel cascade).
        """
        X, mask = inputs["X"], inputs["mask"]
        Q, D, F = X.shape
        pf = padded_forest(params["ranker"], boundaries=bounds)

        def score(seg_lo, seg_hi, x):   # [Q, n, F] → [Q, n]
            return forest_score_range(pf, x.reshape(-1, F), seg_lo, seg_hi).reshape(x.shape[:2])

        part, _, prob = forest_head(cfg, params, X, mask)
        cont = mask & (prob >= params["threshold"])

        if cfg.capacity_frac <= 0:
            tail = score(1, 2, X)
            return torch.where(cont, part + tail, part), cont

        C1 = max(1, math.ceil(cfg.capacity_frac * D))
        sel = _first(cont, C1)                                    # [Q, C1]
        x_sel = _gather(X, sel)                                   # [Q, C1, F]
        part_sel = _gather(part, sel)
        valid = _gather(cont, sel)

        if s2:
            mid_sel = score(1, 2, x_sel)
            part2 = part_sel + mid_sel
            C2 = max(1, math.ceil((cfg.capacity2_frac or cfg.capacity_frac / 2) * D))
            C2 = min(C2, C1)
            # Second cut: rank threshold on the refreshed partial scores.
            key = torch.where(valid, -part2, torch.inf)
            rank2 = torch.argsort(torch.argsort(key, dim=1, stable=True), dim=1, stable=True)
            keep2 = valid & (rank2 < C2)
            order2 = _first(keep2, C2)
            x_sel2 = _gather(x_sel, order2)
            valid2 = _gather(keep2, order2)
            tail_sel = score(2, 3, x_sel2)
            delta2 = torch.zeros((Q, C1), dtype=F32, device=X.device).scatter_add(
                1, order2, torch.where(valid2, tail_sel, 0.0)
            )
            deltas = torch.where(valid, mid_sel, 0.0) + delta2
        else:
            tail_sel = score(1, 2, x_sel)
            deltas = torch.where(valid, tail_sel, 0.0)

        scores = part + torch.zeros_like(part).scatter_add(1, sel, deltas)
        return scores, cont

    return step


def _forest_cell(cfg: ForestConfig, shape: ShapeSpec) -> Cell:
    Q, D, F = shape.batch, cfg.max_docs, cfg.n_features

    def inputs():
        return {"X": _sds((Q, D, F), F32), "mask": _sds((Q, D), torch.bool)}

    def logical():
        return {"X": ("batch", None, None), "mask": ("batch", None)}

    def plogical():
        from repro_torch.forest.ensemble import TreeEnsemble

        def ens_lg():
            # Trees replicated (documents are the parallel axis).
            return TreeEnsemble(
                feature=(None, None), threshold=(None, None),
                left=(None, None), right=(None, None), mask=(None, None),
                leaf_value=(None, None), base_score=(),
            )

        return {"ranker": ens_lg(), "classifier": ens_lg(), "threshold": ()}

    # Queries over "batch", trees replicated: each rank's shard of the block
    # runs the cascade on its own device; scores and continue masks gathered.
    step = make_serve_step(_forest_step(cfg), logical(), (("batch", None), ("batch", None)))
    return Cell(
        cfg=cfg, shape=shape, step=step,
        abstract_state=lambda: _forest_abstract(cfg),
        state_logical=plogical,
        input_specs=inputs, input_logical=logical,
        init_state=partial(_forest_real, cfg),
    )


# ---------------------------------------------------------------------------
# Dispatch.
# ---------------------------------------------------------------------------


def make_cell(cfg, shape: ShapeSpec) -> Cell:
    if isinstance(cfg, TransformerConfig):
        return _lm_cell(cfg, shape)
    if isinstance(cfg, NequIPConfig):
        return _nequip_cell(cfg, shape)
    if isinstance(cfg, RecSysConfig):
        return _recsys_cell(cfg, shape)
    if isinstance(cfg, ForestConfig):
        return _forest_cell(cfg, shape)
    raise TypeError(type(cfg))
