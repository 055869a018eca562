"""Llama-4 Maverick 400B-A17B: MoE 128 routed top-1 + 1 shared expert.
[hf:meta-llama/Llama-4-Maverick-17B-128E; unverified]

400B total parameters ⇒ the optimizer is Adafactor (factored second
moment): full AdamW state (12 bytes/param fp32) does not fit 256 × 16 GiB
alongside activations; Adafactor state is ~O(params/d). Noted in
EXPERIMENTS.md §Dry-run.
"""

from repro_torch.configs.base import TransformerConfig, lm_shapes


def config() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-maverick-400b-a17b",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab_size=202048,
        rope_theta=500_000.0,
        n_experts=128,
        n_shared_experts=1,
        top_k=1,
        d_ff_expert=8192,
        optimizer="adafactor",
        shapes=lm_shapes(full_attention=True),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama4-maverick-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=64,
        vocab_size=512,
        n_experts=8,
        n_shared_experts=1,
        top_k=1,
        d_ff_expert=64,
        optimizer="adafactor",
        attn_q_block=16,
        attn_kv_block=16,
        shapes=(),
    )
