"""DeepSeek-MoE-16B: fine-grained MoE, 2 shared + 64 routed top-6, first
layer dense. [arXiv:2401.06066; hf]"""

from repro_torch.configs.base import TransformerConfig, lm_shapes


def config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-moe-16b",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=1408,
        vocab_size=102400,
        rope_theta=10_000.0,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        d_ff_expert=1408,
        n_dense_layers=1,
        dense_d_ff=10944,
        shapes=lm_shapes(full_attention=True),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-moe-16b-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_head=16,
        d_ff=32,
        vocab_size=512,
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        d_ff_expert=32,
        n_dense_layers=1,
        dense_d_ff=128,
        attn_q_block=16,
        attn_kv_block=16,
        shapes=(),
    )
