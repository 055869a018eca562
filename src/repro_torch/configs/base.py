"""Config dataclasses for every assigned architecture family.

The port's copy of :mod:`repro.configs.base`, field for field. Each
``repro_torch/configs/<arch>.py`` exposes ``config()`` (the exact
published configuration) and ``smoke_config()`` (a reduced same-family
config for CPU smoke tests). Shapes are per-arch (the assignment pairs each
arch with its own shape set); ``kind`` selects which step a shape lowers
(``train_step`` vs ``serve_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

ShapeKind = Literal["train", "prefill", "decode", "serve"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: ShapeKind
    # LM shapes
    seq_len: int = 0
    global_batch: int = 0
    # GNN shapes
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    graph_batch: int = 0
    # RecSys shapes
    batch: int = 0
    n_candidates: int = 0
    # Execution hints
    microbatch: int = 0        # grad-accumulation microbatch (0 = whole batch)
    skip_reason: str = ""      # non-empty → cell is skipped (e.g. long_500k)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    causal: bool = True
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0        # leading dense layers (DeepSeek-MoE style)
    dense_d_ff: int = 0            # FFN width of those dense layers
    capacity_factor: float = 1.25
    # Numerics / perf
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"  # "nothing" | "dots" (§Perf knob)
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    embed_onehot: bool = False     # one-hot-matmul embedding lookup (§Perf)
    causal_skip: bool = False      # unrolled q-blocks skip masked kv blocks
    seq_parallel: bool = False     # Megatron-SP residual stream (AR→RS+AG)
    optimizer: str = "adamw"       # "adamw" | "adafactor"
    shapes: tuple[ShapeSpec, ...] = ()

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers if self.is_moe else 0


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 32             # multiplicity per irrep l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    avg_degree: float = 20.0
    radial_mlp: tuple[int, ...] = (64, 64)
    dtype: str = "float32"         # equivariance is precision-sensitive
    # §Perf: apply the per-path channel mix BEFORE the edge→node
    # segment-sum (legal by linearity) — shrinks the cross-shard
    # all-reduce payload from (Σ_l paths_l·mul·d_l) to (Σ_l mul·d_l)
    # floats per node (3.9× for l_max=2) at the cost of per-edge mixing
    # FLOPs, which the collective-bound cells have abundant headroom for.
    premix_messages: bool = False
    optimizer: str = "adamw"
    shapes: tuple[ShapeSpec, ...] = ()


@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    family: Literal["dlrm", "deepfm", "din", "bert4rec"] = "dlrm"
    embed_dim: int = 64
    n_dense: int = 0
    n_sparse: int = 0
    vocab_sizes: tuple[int, ...] = ()
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    mlp: tuple[int, ...] = ()
    attn_mlp: tuple[int, ...] = ()
    seq_len: int = 0
    n_blocks: int = 0
    n_heads: int = 0
    item_vocab: int = 0
    multi_hot: int = 1             # ids per sparse field (embedding-bag size)
    dtype: str = "float32"
    optimizer: str = "adamw"
    shapes: tuple[ShapeSpec, ...] = ()


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """The paper's own architecture: λ-MART ensemble + LEAR cascade."""

    name: str
    n_trees: int = 1047
    depth: int = 6
    n_features: int = 136
    sentinel: int = 50
    classifier_trees: int = 10
    # The port's own field: the depth of the classifier the LEAR pipeline
    # trains, GBDTParams(n_trees=10, depth=5) as the reference's
    # core.lear.train_lear does (31 internal nodes, 32 leaves). The model
    # cell's random classifier keeps the reference's ``depth``.
    classifier_depth: int = 5
    max_docs: int = 256
    # §Perf knobs: 0 → reference path (score everything, masked combine).
    # capacity_frac > 0 → compacted execution: only the per-query top
    # ⌈frac·D⌉ survivors run the tail trees (the paper's speedup realized
    # structurally). sentinel2 > 0 adds a second (beyond-paper) sentinel.
    capacity_frac: float = 0.0
    sentinel2: int = 0
    capacity2_frac: float = 0.0
    dtype: str = "float32"
    optimizer: str = "none"
    shapes: tuple[ShapeSpec, ...] = ()


ArchConfig = TransformerConfig | NequIPConfig | RecSysConfig | ForestConfig


# Shared LM shape sets (assignment: 4 shapes per LM arch).
def lm_shapes(full_attention: bool = True) -> tuple[ShapeSpec, ...]:
    return (
        ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256,
                  microbatch=32),
        ShapeSpec(name="prefill_32k", kind="prefill", seq_len=32768, global_batch=32),
        ShapeSpec(name="decode_32k", kind="decode", seq_len=32768, global_batch=128),
        ShapeSpec(
            name="long_500k", kind="decode", seq_len=524288, global_batch=1,
            skip_reason=(
                "pure full-attention arch: 500k-token decode requires "
                "sub-quadratic attention (spec: skip and note in DESIGN.md)"
            ) if full_attention else "",
        ),
    )


def recsys_shapes() -> tuple[ShapeSpec, ...]:
    return (
        ShapeSpec(name="train_batch", kind="train", batch=65536),
        ShapeSpec(name="serve_p99", kind="serve", batch=512),
        ShapeSpec(name="serve_bulk", kind="serve", batch=262144),
        ShapeSpec(name="retrieval_cand", kind="serve", batch=1, n_candidates=1_000_000),
    )


def gnn_shapes() -> tuple[ShapeSpec, ...]:
    return (
        ShapeSpec(name="full_graph_sm", kind="train", n_nodes=2708, n_edges=10556,
                  d_feat=1433),
        # minibatch_lg: sampled block from reddit-scale graph (232,965 nodes /
        # 114.6M edges), batch_nodes=1024, fanout 15-10 → block sizes below.
        ShapeSpec(name="minibatch_lg", kind="train", n_nodes=170_000, n_edges=169_000,
                  d_feat=602, graph_batch=1024),
        ShapeSpec(name="ogb_products", kind="train", n_nodes=2_449_029,
                  n_edges=61_859_140, d_feat=100),
        ShapeSpec(name="molecule", kind="train", n_nodes=30, n_edges=64,
                  graph_batch=128),
    )


def forest_shapes() -> tuple[ShapeSpec, ...]:
    return (
        ShapeSpec(name="rank_xl", kind="serve", batch=4096),   # queries per step
        ShapeSpec(name="rank_online", kind="serve", batch=64),
    )
