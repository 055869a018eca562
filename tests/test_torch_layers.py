"""The port's LM layers against the JAX reference, on the CPU.

RoPE, ``blockwise_attention`` over the grid of ``tests/test_layers.py``
(causal and not, GQA, ``q_offset``, ``causal_skip``, ragged block sizes),
``decode_attention`` and ``glu_mlp``: the same numpy inputs through
``repro.models.layers`` and ``repro_torch.models.layers``. float32 is held
at 2e-4 (the reference's own tolerance, ``tests/test_layers.py``); the
largest difference measured here is about 1e-6 (RoPE: XLA's and torch's
``cos`` differ in the last place). bfloat16 outputs are held to one unit
in the last place (``BF16_ULPS``): both packages compute in float32 and
round once, so they differ only where the float32 values straddle a
rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import layers as ref  # noqa: E402
from repro_torch.models import layers as port  # noqa: E402

F32_TOL = 2e-4
BF16_ULPS = 1

_ref_blockwise = jax.jit(ref.blockwise_attention, static_argnames=(
    "causal", "q_offset", "q_block", "kv_block", "causal_skip"))
_ref_decode = jax.jit(ref.decode_attention)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """bfloat16's unit in the last place at ``x`` (7 fraction bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _np(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t, jnp.float32)) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def _close_bf16(got, want):
    got, want = _np(got), _np(want)
    assert np.all(np.abs(got - want) <= BF16_ULPS * _bf16_ulp(want)), np.abs(got - want).max()


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("positions", ["1d", "2d"])
def test_rope_frequencies_and_rotation(theta, positions):
    np.testing.assert_array_equal(port.rope_frequencies(128, theta),
                                  ref.rope_frequencies(128, theta))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, 3, 16)).astype(np.float32)
    pos = (np.arange(24) * 997 if positions == "1d"
           else rng.integers(0, 32768, size=(2, 24))).astype(np.int32)
    want = np.asarray(ref.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = port.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta).numpy()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    # Half-split pairs: lane i rotates with lane i + Dh/2, never i ^ 1.
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    r = port.apply_rope(torch.as_tensor(one), torch.tensor([1]), theta).numpy()[0, 0, 0]
    assert r[8] != 0 and r[1] == 0
    # bfloat16: computed in float32, returned in bfloat16.
    xb = torch.as_tensor(x).bfloat16()
    got_b = port.apply_rope(xb, torch.as_tensor(pos), theta)
    want_b = ref.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), theta)
    assert got_b.dtype == torch.bfloat16
    _close_bf16(got_b, want_b)


GRID = [
    (2, 64, 64, 4, 2, 16, 32),
    (3, 32, 32, 6, 1, 8, 8),     # B != n_blocks
    (1, 128, 128, 2, 2, 128, 16),
    (2, 48, 48, 4, 4, 16, 48),
    (1, 48, 48, 4, 2, 16, 24),   # ragged: q blocks straddle kv blocks
    (2, 32, 32, 8, 2, 32, 8),    # G = 4, one q block
]


@pytest.mark.parametrize("causal_skip", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,q_block,kv_block", GRID)
def test_blockwise_attention_matches_reference(causal, causal_skip, B, Sq, Skv, H, Hkv,
                                               q_block, kv_block):
    rng = np.random.default_rng(B * Sq + H)
    Dh = 16
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, Dh)).astype(np.float32)
    kw = dict(causal=causal, q_block=q_block, kv_block=kv_block, causal_skip=causal_skip)
    want = np.asarray(_ref_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = port.blockwise_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("q_offset", [0, 16, 40])
def test_blockwise_attention_q_offset_and_skip(q_offset):
    """Chunked prefill: queries start at ``q_offset`` into the keys. With
    ``causal_skip`` the skipped blocks are exactly no-ops (a fully masked
    block rescales by exp(0) = 1 and adds 0), so both routes are equal."""
    rng = np.random.default_rng(q_offset)
    B, Sq, Skv, H, Hkv, Dh = 2, 16, 64, 4, 2, 16
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, Dh)).astype(np.float32)
    outs = {}
    for skip in (False, True):
        kw = dict(causal=True, q_offset=q_offset, q_block=8, kv_block=16, causal_skip=skip)
        want = np.asarray(_ref_blockwise(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
        outs[skip] = port.blockwise_attention(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw)
        np.testing.assert_allclose(outs[skip].numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    assert torch.equal(outs[False], outs[True])


def test_blockwise_attention_gqa_maps_head_h_to_kv_head_h_over_g():
    """Query head h reads kv head h // G: only kv head 0 carries values, so
    heads 0..G-1 see them and heads G..H-1 see zeros."""
    B, S, H, Hkv, Dh = 1, 8, 6, 3, 4
    G = H // Hkv
    q = torch.randn(B, S, H, Dh, generator=torch.Generator().manual_seed(0))
    k = torch.zeros(B, S, Hkv, Dh)
    v = torch.zeros(B, S, Hkv, Dh)
    v[:, :, 0] = 1.0
    out = port.blockwise_attention(q, k, v, q_block=4, kv_block=4)
    assert torch.all(out[:, :, :G] == 1.0)
    assert torch.all(out[:, :, G:] == 0.0)


def test_blockwise_attention_bf16_rounds_once():
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    kw = dict(causal=True, q_block=16, kv_block=16)
    want = _ref_blockwise(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
    got = port.blockwise_attention(*(torch.as_tensor(a).bfloat16() for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)


@pytest.mark.parametrize("pos", [1, 20, 32])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (4, 4), (6, 1)])
def test_decode_attention_matches_reference(pos, H, Hkv):
    rng = np.random.default_rng(pos + H)
    B, S, Dh = 2, 32, 16
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    kc = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    vc = rng.normal(size=(B, S, Hkv, Dh)).astype(np.float32)
    want = np.asarray(_ref_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.int32(pos)))
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        got = port.decode_attention(torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc), p)
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    want_b = _ref_decode(*(jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc)), jnp.int32(pos))
    got_b = port.decode_attention(*(torch.as_tensor(a).bfloat16() for a in (q, kc, vc)), pos)
    _close_bf16(got_b, want_b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glu_mlp_matches_reference(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    wg, wu = (rng.normal(size=(64, 96)).astype(np.float32) / 8 for _ in range(2))
    wd = rng.normal(size=(96, 64)).astype(np.float32) / 10
    want = ref.glu_mlp(*(jnp.asarray(a, dtype) for a in (x, wg, wu, wd)))
    got = port.glu_mlp(*(torch.as_tensor(a).to(getattr(torch, dtype)) for a in (x, wg, wu, wd)))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    else:
        # The port's silu rounds where XLA's expansion of the logistic does.
        _close_bf16(got, want)
