"""Minitron-4B: width/depth-pruned Nemotron. [arXiv:2407.14679; hf]"""

from repro_torch.configs.base import TransformerConfig, lm_shapes


def config() -> TransformerConfig:
    return TransformerConfig(
        name="minitron-4b",
        n_layers=32,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_head=128,
        d_ff=9216,
        vocab_size=256000,
        rope_theta=10_000.0,
        shapes=lm_shapes(full_attention=True),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="minitron-4b-smoke",
        n_layers=2,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        d_head=16,
        d_ff=96,
        vocab_size=512,
        attn_q_block=16,
        attn_kv_block=16,
        shapes=(),
    )
