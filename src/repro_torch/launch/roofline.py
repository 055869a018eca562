"""Roofline terms of a traced step, in NVIDIA H100 SXM terms.

The port of :mod:`repro.launch.roofline` (which holds TPU v5e constants).
Three terms per (arch × shape × mesh), in seconds, per device:

    compute    = Σ_dtype FLOPs_dtype / chips / PEAK[dtype]
    memory     = bytes               / chips / HBM_BW
    collective = collective bytes (per device) / NVLINK_BW

The FLOPs and bytes are :mod:`repro_torch.launch.op_analysis`'s count of
the whole step (global shapes), divided evenly over the chips (ideal
SPMD). Peaks are NVIDIA's data sheet figures for the SXM part at its full
700 W: dense bf16 / fp16 on the tensor cores; float32 outside them (the
port keeps TF32 off, so float32 matmuls run there too); the elementwise
and reduction count at the float32 rate, one operation an element.
``collective`` takes NVLink's rate per direction per card and ignores
contention and overlap, as the reference's term does.

``MODEL_FLOPS`` (6·N·D dense, 6·N_active·D MoE) is computed per arch so
the useful-compute ratio exposes remat and dispatch overheads;
:func:`lm_param_count` and :func:`lm_model_flops` are the reference's.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.op_analysis import OpCost

BF16_FLOPS = 989e12        # dense bf16 / fp16, tensor cores
F32_FLOPS = 67e12          # float32 outside the tensor cores (an FMA counts two)
HBM_BW = 3.35e12           # B/s, HBM3
NVLINK_BW = 450e9          # B/s per direction per card
# One 32-bit compare, logic or integer instruction per lane per cycle: the
# float32 rate without its FMA's second operation.
ALU_OPS = F32_FLOPS / 2

PEAK = {
    "bfloat16": BF16_FLOPS,
    "float16": BF16_FLOPS,
    "float8_e4m3fn": 2 * BF16_FLOPS,
    "float8_e5m2": 2 * BF16_FLOPS,
    "int8": 2 * BF16_FLOPS,
    "float32": F32_FLOPS,
    "elementwise": F32_FLOPS,
}


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: dict[str, int]
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    useful_ratio: float
    flops_by_dtype: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            **dataclasses.asdict(self),
            "dominant": self.dominant,
            "bound_s": self.bound_s,
        }


def roofline(cost: OpCost, chips: int = 1, model_flops: float = 0.0,
             coll_breakdown: dict[str, float] | None = None) -> Roofline:
    """Per-device terms of a step whose whole-step cost is ``cost``.

    ``coll_breakdown``: collective bytes per device by kind, added to the
    trace's own (a dry run traces the step unsharded and reckons them from
    the rules). ``model_flops`` is global and compared with ``flops ×
    chips``.
    """
    per_dtype = {k: v / chips for k, v in cost.flops.items()}
    flops = sum(per_dtype.values())
    coll = {k: v / chips for k, v in cost.coll_breakdown.items()}
    for k, v in (coll_breakdown or {}).items():
        coll[k] = coll.get(k, 0.0) + v
    coll_bytes = sum(coll.values())
    total_flops = flops * chips
    return Roofline(
        flops=flops,
        bytes_accessed=cost.bytes / chips,
        coll_bytes=coll_bytes,
        coll_breakdown={k: int(v) for k, v in coll.items()},
        chips=chips,
        compute_s=sum(v / PEAK.get(k, F32_FLOPS) for k, v in per_dtype.items()),
        memory_s=cost.bytes / chips / HBM_BW,
        collective_s=coll_bytes / NVLINK_BW,
        model_flops=model_flops,
        useful_ratio=(model_flops / total_flops) if total_flops else 0.0,
        flops_by_dtype=per_dtype,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS per arch (6·N·D rule).
# ---------------------------------------------------------------------------


def lm_param_count(cfg, active: bool = False) -> float:
    """Parameter count (total or active-per-token) for a TransformerConfig."""
    D, V = cfg.d_model, cfg.vocab_size
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
    embed = 2 * V * D
    total = embed
    n_dense = cfg.n_dense_layers if cfg.is_moe else cfg.n_layers
    dense_ff = cfg.dense_d_ff or cfg.d_ff
    total += n_dense * (attn + 3 * D * dense_ff)
    if cfg.is_moe:
        Fe = cfg.d_ff_expert or cfg.d_ff
        n_active = cfg.top_k if active else cfg.n_experts
        expert = 3 * D * Fe
        shared = cfg.n_shared_experts * 3 * D * Fe
        total += cfg.n_moe_layers * (attn + n_active * expert + shared
                                     + D * cfg.n_experts)
    return float(total)


def lm_model_flops(cfg, shape) -> float:
    n_tokens = shape.global_batch * shape.seq_len
    if shape.kind == "decode":
        n_tokens = shape.global_batch
    n = lm_param_count(cfg, active=True)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * n_tokens
