"""The port's MoE FFN against the JAX reference, on the CPU.

``repro_torch.models.moe.moe_ffn`` and ``repro.models.moe.moe_ffn`` on the
same numpy inputs, in float32 (2e-4, the reference layers' tolerance;
about 1e-6 measured) and bfloat16 (one unit in the last place; equal in
every case measured: the port rounds where XLA's expansion rounds and
sums each token's experts in the reference's scatter order), with the
auxiliary load-balancing loss. Two cases pin the orders that
``torch.topk`` would not: an expert over its capacity must drop exactly
the reference's tokens, and tied router probabilities (and tied
priorities at the capacity boundary) must go to the lowest index, as
``lax.top_k`` sends them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as ref  # noqa: E402
from repro_torch.models import moe as port  # noqa: E402

F32_TOL = 2e-4
BF16_ULPS = 1


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _weights(rng, D, E, F):
    return (
        rng.normal(size=(D, E)).astype(np.float32) * 0.3,
        rng.normal(size=(E, D, F)).astype(np.float32) / np.sqrt(D),
        rng.normal(size=(E, D, F)).astype(np.float32) / np.sqrt(D),
        rng.normal(size=(E, F, D)).astype(np.float32) / np.sqrt(F),
    )


_ref_moe = jax.jit(ref.moe_ffn, static_argnames=("top_k", "capacity_factor"))


def _both(x, router, wg, wu, wd, dtype, **kw):
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want, aux_want = _ref_moe(jnp.asarray(x, jd), jnp.asarray(router),
                              *(jnp.asarray(w, jd) for w in (wg, wu, wd)), **kw)
    got, aux_got = port.moe_ffn(torch.as_tensor(x).to(td), torch.as_tensor(router),
                                *(torch.as_tensor(w).to(td) for w in (wg, wu, wd)), **kw)
    assert got.dtype == td and got.shape == want.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32)), float(aux_got), float(aux_want)


def _ref_route(x, router, top_k, cf):
    """The reference's routing decisions, spelled out from ``repro/models/moe.py``
    (its ``moe_ffn`` does not return them): each token's experts and each
    expert's capacity slots."""
    x = jnp.asarray(x, jnp.float32)
    G, T, _ = x.shape
    E = router.shape[1]
    C = ref._capacity(T, E, top_k, cf)
    probs = jax.nn.softmax(x @ jnp.asarray(router), axis=-1)
    top_p, top_idx = jax.lax.top_k(probs, top_k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    weight = (jax.nn.one_hot(top_idx, E) * top_p[..., None]).sum(axis=2)
    priority = jnp.where(weight > 0, weight, -1.0)
    _, token_idx = jax.lax.top_k(priority.transpose(0, 2, 1), C)
    return np.asarray(top_idx), np.asarray(token_idx)


def _check(got, want, aux_got, aux_want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert np.all(np.abs(got - want) <= BF16_ULPS * _bf16_ulp(want)), np.abs(got - want).max()
    np.testing.assert_allclose(aux_got, aux_want, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,T,E,top_k,cf", [
    (2, 32, 8, 2, 1.25),    # the smoke configs' routing
    (1, 24, 8, 1, 1.25),    # Maverick's top-1
    (3, 16, 16, 6, 1.25),   # DeepSeek's top-6, several groups
    (1, 4, 64, 6, 1.25),    # a decode group: C = T, nothing dropped
])
def test_moe_ffn_matches_reference(dtype, G, T, E, top_k, cf):
    rng = np.random.default_rng(G * 100 + T + E + top_k)
    D, F = 32, 24
    x = rng.normal(size=(G, T, D)).astype(np.float32)
    got, want, aux_got, aux_want = _both(x, *_weights(rng, D, E, F), dtype,
                                         top_k=top_k, capacity_factor=cf)
    _check(got, want, aux_got, aux_want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overflowing_expert_drops_the_references_tokens(dtype):
    """Every token's first choice is expert 0, with distinct priorities, so
    expert 0 keeps its top-C tokens and drops the rest; the dropped ones get
    nothing from it."""
    rng = np.random.default_rng(7)
    G, T, D, E, F, k, cf = 1, 32, 16, 8, 12, 2, 1.0
    router, wg, wu, wd = _weights(rng, D, E, F)
    router[:, 0] = 0.0
    router[0, 0] = 4.0
    x = rng.normal(size=(G, T, D)).astype(np.float32)
    x[..., 0] = 2.0 + np.linspace(0.0, 1.0, T)[rng.permutation(T)]   # distinct margins
    C = ref._capacity(T, E, k, cf)
    top_want, slots_want = _ref_route(x, router, k, cf)
    assert (top_want[..., 0] == 0).all() and C < T
    _, top_idx, _, token_idx = port.route(torch.as_tensor(x), torch.as_tensor(router),
                                          top_k=k, capacity_factor=cf)
    np.testing.assert_array_equal(top_idx.numpy(), top_want)
    np.testing.assert_array_equal(token_idx.numpy(), slots_want)
    dropped = sorted(set(range(T)) - set(slots_want[0, 0].tolist()))
    assert len(dropped) == T - C
    got, want, aux_got, aux_want = _both(x, router, wg, wu, wd, dtype, top_k=k,
                                         capacity_factor=cf)
    _check(got, want, aux_got, aux_want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tied_router_probabilities_go_to_the_lowest_index(dtype):
    """Experts 1, 3 and 5 have one router column: every token ties them, and
    ``lax.top_k`` takes the lowest. Tokens 0..7 repeat one row, so their
    priorities tie at every expert and the capacity keeps the lowest
    indices."""
    rng = np.random.default_rng(9)
    G, T, D, E, F, k, cf = 2, 24, 16, 8, 12, 2, 1.0
    router, wg, wu, wd = _weights(rng, D, E, F)
    router[0, 1] = 2.0                # with x[..., 0] = 3: the tied three lead
    router[:, 3] = router[:, 1]
    router[:, 5] = router[:, 1]
    x = rng.normal(size=(G, T, D)).astype(np.float32)
    x[..., 0] = 3.0
    x[:, :8] = x[:, :1]
    top_want, slots_want = _ref_route(x, router, k, cf)
    _, top_idx, _, token_idx = port.route(torch.as_tensor(x), torch.as_tensor(router),
                                          top_k=k, capacity_factor=cf)
    np.testing.assert_array_equal(top_idx.numpy(), top_want)
    np.testing.assert_array_equal(token_idx.numpy(), slots_want)
    assert (np.sort(top_want, -1) == [1, 3]).all(-1).mean() > 0.5    # the ties did bind
    got, want, aux_got, aux_want = _both(x, router, wg, wu, wd, dtype, top_k=k,
                                         capacity_factor=cf)
    _check(got, want, aux_got, aux_want, dtype)


def test_capacity_matches_reference():
    for T in (1, 2, 4, 64, 512, 32768):
        for E, k in ((8, 2), (64, 6), (128, 1)):
            assert port._capacity(T, E, k, 1.25) == ref._capacity(T, E, k, 1.25)
    assert port._capacity(32768, 64, 6, 1.25) == 3841
