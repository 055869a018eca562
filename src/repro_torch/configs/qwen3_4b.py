"""Qwen3-4B: dense GQA decoder with QK-norm. [hf:Qwen/Qwen3-4B; hf]"""

from repro_torch.configs.base import TransformerConfig, lm_shapes


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-4b",
        n_layers=36,
        d_model=2560,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=9728,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        shapes=lm_shapes(full_attention=True),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-4b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        qk_norm=True,
        attn_q_block=16,
        attn_kv_block=16,
        shapes=(),
    )
