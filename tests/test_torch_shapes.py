"""The runtime-checked lane of the port's kernel wrappers
(``repro_torch.typecheck.shape_checked``), the six cases of
``tests/test_shapes.py`` and the annotation grammar.

``shape_checked`` enforces the ``Tensor["dims", dtype]`` annotations of
``forest_score_kernel`` / ``forest_score_segments_kernel`` at call time,
with dims bound across arguments: the node axis ``n`` of ``feature`` must
be the SAME ``n`` as that of ``threshold`` and ``mask``, and the tree axis
``t`` must agree everywhere. Production call sites stay unwrapped. The
accepted calls are held to the reference's Pallas entry points (interpret
mode) on the same random operands, bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.forest_score import (  # noqa: E402
    forest_score_pallas,
    forest_score_segments_pallas,
)
from repro_torch.kernels.forest_score import (  # noqa: E402
    forest_score_kernel,
    forest_score_segments_kernel,
)
from repro_torch.typecheck import Tensor, shape_checked  # noqa: E402

B, F, T, N, L = 8, 4, 16, 8, 4


def _numpy_operands(seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2**32, size=(T, N), dtype=np.uint64)
    hi = rng.integers(0, 2**32, size=(T, N), dtype=np.uint64)
    return dict(
        x=rng.normal(size=(B, F)).astype(np.float32),
        feature=rng.integers(0, F, size=(T, N)).astype(np.int32),
        threshold=rng.normal(size=(T, N)).astype(np.float32),
        mask_lo=(lo | 1).astype(np.uint32),  # bit 0 set: every mask AND is nonzero
        mask_hi=hi.astype(np.uint32),
        leaf_value=rng.normal(size=(T, L)).astype(np.float32),
    )


def _operands(seed: int = 0) -> dict[str, torch.Tensor]:
    a = _numpy_operands(seed)
    mask = (a["mask_hi"].astype(np.uint64) << np.uint64(32)) | a["mask_lo"].astype(np.uint64)
    return dict(
        x=torch.as_tensor(a["x"]),
        feature=torch.as_tensor(a["feature"]),
        threshold=torch.as_tensor(a["threshold"]),
        mask=torch.as_tensor(mask.view(np.int64)),
        leaf_value=torch.as_tensor(a["leaf_value"]),
    )


def _reference(fn, **kw):
    a = {k: jnp.asarray(v) for k, v in _numpy_operands().items()}
    return np.asarray(fn(**a, block_b=B, block_t=T, **kw))


def test_plain_entry_accepts_declared_shapes():
    checked = shape_checked(forest_score_kernel)
    out = checked(**_operands(), block_t=T)
    assert out.shape == (B,) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), forest_score_kernel(**_operands(), block_t=T).numpy())
    np.testing.assert_array_equal(out.numpy(), _reference(forest_score_pallas))


def test_segments_entry_accepts_and_returns_b_s():
    checked = shape_checked(forest_score_segments_kernel)
    out = checked(**_operands(), seg_block_starts=(0,), n_tree_blocks=1, block_t=T)
    assert out.shape == (B, 1)
    np.testing.assert_array_equal(
        out.numpy(),
        _reference(forest_score_segments_pallas, seg_block_starts=(0,), n_tree_blocks=1),
    )


def test_wrong_dtype_rejected():
    checked = shape_checked(forest_score_kernel)
    ops = _operands()
    ops["feature"] = ops["feature"].float()  # i32 contract
    with pytest.raises(TypeError, match="feature"):
        checked(**ops, block_t=T)


def test_cross_argument_dim_binding_rejected():
    # threshold's node axis disagrees with feature's — same letter `n` in
    # the annotation, so the binding must fail even though each operand is
    # a valid [t, n] float32/int32 on its own.
    checked = shape_checked(forest_score_kernel)
    ops = _operands()
    ops["threshold"] = torch.zeros((T, 2 * N))
    with pytest.raises(TypeError, match="threshold"):
        checked(**ops, block_t=T)


def test_wrong_rank_rejected():
    checked = shape_checked(forest_score_kernel)
    ops = _operands()
    ops["x"] = torch.zeros((B,))
    with pytest.raises(TypeError, match="`x`"):
        checked(**ops, block_t=T)


def test_unwrapped_entry_points_unchanged():
    # the hot path never pays for checking: the public names are the raw
    # wrappers, not shape_checked ones
    assert not hasattr(forest_score_kernel, "__shape_checked__")
    assert shape_checked(forest_score_kernel).__shape_checked__ is True
    out = forest_score_kernel(**_operands(), block_t=T)
    assert out.shape == (B,)


def _f(a: Tensor["b ... f", (torch.float32, torch.float64)],
       b: Tensor["*lead 3"],
       c: Tensor["_ 2", torch.int64]) -> Tensor["b f", torch.float32]:
    return a.reshape(a.shape[0], -1, a.shape[-1])[:, 0].float()


@pytest.mark.parametrize(
    "a, b, c, ok",
    [
        ((2, 5, 4), (7, 3), (9, 2), True),
        ((2, 4), (7, 1, 3), (1, 2), True),          # `...` may be empty
        ((2, 4), (3,), (1, 2), True),                # `*lead` may be empty
        ((2, 4), (7, 4), (1, 2), False),             # fixed size 3
        ((2, 4), (7, 3), (1, 3), False),             # fixed size 2
        ((4,), (7, 3), (1, 2), False),               # rank below `b ... f`
    ],
)
def test_dim_grammar(a, b, c, ok):
    checked = shape_checked(_f)
    args = (torch.zeros(a), torch.zeros(b), torch.zeros(c, dtype=torch.int64))
    if ok:
        assert tuple(checked(*args).shape) == (a[0], a[-1])
    else:
        with pytest.raises(TypeError):
            checked(*args)


def test_dtype_alternatives_and_return_value():
    checked = shape_checked(_f)
    c = torch.zeros((1, 2), dtype=torch.int64)
    assert checked(torch.zeros((2, 4), dtype=torch.float64), torch.zeros(3), c).dtype == torch.float32
    with pytest.raises(TypeError, match="`a`"):
        checked(torch.zeros((2, 4), dtype=torch.float16), torch.zeros(3), c)

    def bad(x: Tensor["n"]) -> Tensor["n"]:
        return x[1:]

    with pytest.raises(TypeError, match="return value"):
        shape_checked(bad)(torch.zeros(4))
    assert repr(Tensor["b f", torch.float32]) == 'Tensor["b f", torch.float32]'
    with pytest.raises(TypeError):
        Tensor["b ... *c"]  # two variadic dims
    assert shape_checked(len) is len  # nothing to check
