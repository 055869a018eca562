"""Qwen2.5-14B: dense GQA decoder with QKV bias. [hf:Qwen/Qwen2.5-14B; hf]"""

from repro_torch.configs.base import TransformerConfig, lm_shapes


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-14b",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        shapes=lm_shapes(full_attention=True),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-14b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        attn_q_block=16,
        attn_kv_block=16,
        shapes=(),
    )
