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


# ---------------------------------------------------------------------------
# The out-of-place online softmax (training) against the in-place one.
# ---------------------------------------------------------------------------


def _in_place_blockwise_attention(q, k, v, *, causal=True, q_offset=0, q_block=512,
                                  kv_block=1024, causal_skip=False):
    """The blockwise attention as the serving path first ported it: the
    carries written through slice assignment. Kept here as the record the
    out-of-place version must equal bit for bit."""
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    q_block, kv_block = min(q_block, Sq), min(kv_block, Skv)
    nq, nk = Sq // q_block, Skv // kv_block
    scale = 1.0 / np.sqrt(Dh)
    qr = q.reshape(B, Sq, Hkv, G, Dh).transpose(1, 2).float().reshape(B, Hkv, Sq * G, Dh)
    kr = k.transpose(1, 2).float().contiguous()
    vr = v.transpose(1, 2).float().contiguous()
    acc = torch.zeros((B, Hkv, Sq * G, Dh), dtype=torch.float32)
    row_max = torch.full((B, Hkv, Sq * G), port.NEG_INF, dtype=torch.float32)
    row_sum = torch.zeros((B, Hkv, Sq * G), dtype=torch.float32)
    n_kv = [nk] * nq
    if causal_skip and causal:
        n_kv = [min(nk, -(-(q_offset + (i + 1) * q_block) // kv_block)) for i in range(nq)]
    qpos = (q_offset + torch.arange(Sq)).repeat_interleave(G)
    for j in range(nk):
        r0 = sum(n <= j for n in n_kv) * q_block * G
        if r0 == Sq * G:
            continue
        kv = slice(j * kv_block, (j + 1) * kv_block)
        scores = (qr[:, :, r0:] @ kr[:, :, kv].transpose(-1, -2)) * scale
        if causal:
            kpos = j * kv_block + torch.arange(kv_block)
            scores = torch.where(qpos[r0:, None] >= kpos[None, :], scores, port.NEG_INF)
        carry = (acc[:, :, r0:], row_max[:, :, r0:], row_sum[:, :, r0:])
        acc[:, :, r0:], row_max[:, :, r0:], row_sum[:, :, r0:] = port._online_softmax_block(
            carry, scores, vr[:, :, kv])
    out = acc / torch.clamp_min(row_sum[..., None], 1e-30)
    return out.reshape(B, Hkv, Sq, G, Dh).transpose(1, 2).reshape(B, Sq, H, Dh).to(q.dtype)


_IN_PLACE_CASES = (
    [dict(grid=g, causal=c, causal_skip=s, q_offset=0, dtype="float32")
     for g in GRID for c in (True, False) for s in (False, True)]
    + [dict(grid=(2, 16, 64, 4, 2, 8, 16), causal=True, causal_skip=s, q_offset=o, dtype="float32")
       for o in (0, 16, 40) for s in (False, True)]
    + [dict(grid=(2, 32, 32, 4, 2, 16, 16), causal=True, causal_skip=s, q_offset=0,
            dtype="bfloat16") for s in (False, True)]
)


@pytest.mark.parametrize("case", _IN_PLACE_CASES,
                         ids=lambda c: "-".join(str(v) for v in c.values()).replace(" ", ""))
def test_blockwise_attention_equals_the_in_place_carries_bit_for_bit(case):
    """Every case of the tests above (the reference grid, causal or not,
    with and without ``causal_skip``; ``q_offset`` 0, 16 and 40; bfloat16):
    the out-of-place carries give the same bits as slice assignment, so
    serving's results are unchanged by the training rewrite."""
    B, Sq, Skv, H, Hkv, q_block, kv_block = case["grid"]
    rng = np.random.default_rng(B * Sq + H + case["q_offset"])
    dt = getattr(torch, case["dtype"])
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32)).to(dt)
               for s in ((B, Sq, H, 16), (B, Skv, Hkv, 16), (B, Skv, Hkv, 16)))
    kw = dict(causal=case["causal"], q_offset=case["q_offset"], q_block=q_block,
              kv_block=kv_block, causal_skip=case["causal_skip"])
    assert torch.equal(port.blockwise_attention(q, k, v, **kw),
                       _in_place_blockwise_attention(q, k, v, **kw))


@pytest.mark.parametrize("causal_skip", [False, True])
def test_blockwise_attention_gradients_match_reference(causal_skip):
    """Autograd through the out-of-place online softmax, float32, against
    ``jax.grad`` of the reference's scan: every input's gradient within
    2e-4."""
    rng = np.random.default_rng(21)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    up = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    kw = dict(causal=True, q_block=8, kv_block=16, causal_skip=causal_skip)
    want = jax.grad(lambda a, b, c: jnp.sum(ref.blockwise_attention(a, b, c, **kw) * up),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
    out = port.blockwise_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad((out * torch.as_tensor(up)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_is_finite_and_matches_reference(dtype):
    """``silu``'s backward is JAX's (``g·σ + g·x·σ·(1 − σ)``): finite where
    ``exp(-x)`` overflows, and close to ``jax.grad`` elsewhere: float32
    within 2e-4; bfloat16 within 2 units in the last place (measured: 2,
    at 5 of these 128 inputs; XLA may keep a fused expression's
    intermediates wider than bfloat16)."""
    x = np.concatenate([np.linspace(-200, 30, 64), np.random.default_rng(2).normal(size=64) * 4])
    x = x.astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jax.nn.silu(a).astype(jnp.float32)))(
        jnp.asarray(x, jdt)).astype(jnp.float32))
    t = torch.as_tensor(x).to(getattr(torch, dtype)).requires_grad_()
    (got,) = torch.autograd.grad(port.silu(t).float().sum(), t)
    assert torch.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert np.all(np.abs(_np(got) - want) <= 2 * _bf16_ulp(want))
