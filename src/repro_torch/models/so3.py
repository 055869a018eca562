"""Real spherical harmonics (ℓ ≤ 2) and Clebsch–Gordan coupling tensors.

NequIP's core op is the equivariant tensor product
``(h^{l1} ⊗ Y^{l2}) → l3`` contracted with Clebsch–Gordan coefficients in
the **real** SH basis. Rather than transcribing real-basis CG tables (an
error-prone change of basis from the complex convention), we *solve* for
them numerically once at import:

1. Wigner-D matrices in the real basis are recovered for any rotation R by
   evaluating ``Y_l`` on a set of sample directions and solving
   ``Y_l(R v) = D_l(R) · Y_l(v)`` in the least-squares sense (exact — Y_l
   spans an irreducible subspace).
2. The coupling tensor ``C[m3, m1, m2]`` is the null space of the
   equivariance constraint ``D3(R) C − C (D1(R) ⊗ D2(R))`` stacked over a
   handful of random rotations (the invariant subspace is 1-dimensional for
   each admissible (l1, l2, l3)).

The equivariance property is verified directly in tests (rotate inputs ⇒
outputs rotate with the appropriate Wigner-D).

The port's own numpy copy of :mod:`repro.models.so3`: the same functions,
so the same tables, bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np

L_DIMS = {0: 1, 1: 3, 2: 5}


def real_sph_harm(v: np.ndarray, l: int) -> np.ndarray:
    """Real SH of unit vectors ``v: [..., 3]`` → ``[..., 2l+1]``.

    Component-normalized (e3nn ``normalize=True, normalization='component'``
    convention up to constant factors — constants only rescale channels and
    are absorbed by the learned weights; what matters is the irreducible
    transformation law, which these polynomials satisfy exactly).
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return np.ones_like(x)[..., None]
    if l == 1:
        return np.stack([y, z, x], axis=-1) * np.sqrt(3.0)
    if l == 2:
        r2 = x * x + y * y + z * z
        out = np.stack(
            [
                np.sqrt(15.0) * x * y,
                np.sqrt(15.0) * y * z,
                np.sqrt(5.0) / 2.0 * (3 * z * z - r2),
                np.sqrt(15.0) * x * z,
                np.sqrt(15.0) / 2.0 * (x * x - y * y),
            ],
            axis=-1,
        )
        return out
    raise NotImplementedError(f"l={l}")


def wigner_d(R: np.ndarray, l: int) -> np.ndarray:
    """Real-basis Wigner-D for rotation matrix R (3×3) → [(2l+1), (2l+1)]."""
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(1234)
    v = rng.normal(size=(64, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    Yv = real_sph_harm(v, l)              # [64, d]
    YRv = real_sph_harm(v @ R.T, l)       # [64, d]
    # Y(Rv) = D Y(v)  ⇒  D = argmin ‖Yv Dᵀ − YRv‖.
    D, *_ = np.linalg.lstsq(Yv, YRv, rcond=None)
    return D.T


def _random_rotation(rng) -> np.ndarray:
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


@functools.lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Coupling tensor C: [d3, d1, d2] with D3 C = C (D1 ⊗ D2), ‖C‖=1.

    Raises if (l1, l2, l3) violates the triangle inequality (empty null
    space).
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        raise ValueError(f"triangle violation ({l1},{l2},{l3})")
    d1, d2, d3 = L_DIMS[l1], L_DIMS[l2], L_DIMS[l3]
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(6):
        R = _random_rotation(rng)
        D1, D2, D3 = wigner_d(R, l1), wigner_d(R, l2), wigner_d(R, l3)
        # Constraint on vec(C): (I_{d1 d2} ⊗ D3 − (D1 ⊗ D2)ᵀ ⊗ I_{d3}) vec = 0
        # with C[m3, m1 m2]: D3 C − C (D1 ⊗ D2) = 0.
        K = np.kron(np.eye(d1 * d2), D3) - np.kron(np.kron(D1, D2).T, np.eye(d3))
        rows.append(K)
    K = np.concatenate(rows, axis=0)
    _, s, vh = np.linalg.svd(K)
    # vec ordering: C[m3, m1, m2] flattened with (m1 m2) major, m3 minor.
    c = vh[-1].reshape(d1 * d2, d3).T.reshape(d3, d1, d2)
    resid = s[-1]
    if resid > 1e-8:
        raise RuntimeError(f"no invariant coupling for ({l1},{l2},{l3}): σ={resid}")
    # Deterministic sign: make the largest-|.| entry positive.
    idx = np.unravel_index(np.argmax(np.abs(c)), c.shape)
    c = c * np.sign(c[idx])
    return (c / np.linalg.norm(c)).astype(np.float32)


# Parity-respecting paths for the NequIP irreps set {0e, 1o, 2e} with
# Y-parities (+,−,+): output parity = p(h_l1) · p(Y_l2) must match.
def allowed_paths(l_max: int = 2) -> list[tuple[int, int, int]]:
    parity_h = {0: +1, 1: -1, 2: +1}
    parity_y = {0: +1, 1: -1, 2: +1}
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                if parity_h[l1] * parity_y[l2] == parity_h[l3]:
                    paths.append((l1, l2, l3))
    return paths
