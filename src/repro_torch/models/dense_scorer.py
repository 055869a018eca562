"""Distilled dense stage-0 scorer for the hybrid cascade.

The port of :mod:`repro.models.dense_scorer`. A tiny model (KB-scale
parameters) that stands in for the tree ensemble on the easy majority of
documents: the hybrid engine (:class:`repro_torch.core.stage.DenseStage`)
scores the whole flat ``[Q·D, F]`` candidate block through it, the gate
policy (:func:`repro_torch.core.strategies.dense_keep_fraction`) keeps the
contested head, and only those survivors reach a tree. One projection
lifts each feature vector into ``n_vec`` small vectors, their pairwise
upper-triangle dots (the DLRM interaction,
:func:`repro_torch.models.recsys.dot_interact`) add second-order
interactions, and a two-layer MLP head maps ``[projection ‖ interactions]``
to one score. The products are plain ``torch`` matmuls, as the reference
leaves them to XLA: the dense stage launches no forest kernel.

Sizing knobs, read at import through :func:`repro_torch.kernels.ops.env_int`
as in the reference:

- ``REPRO_DENSE_N_VEC`` (default 4): interaction vectors per document.
- ``REPRO_DENSE_VEC_DIM`` (default 16): dimension of each vector.
- ``REPRO_DENSE_HIDDEN`` (default 32): MLP head width.
- ``REPRO_DENSE_COST_TREES`` (default 4): accounting price of one dense
  evaluation in doc·tree-traversal equivalents (the reference's choice:
  the matmul runs on the matrix units, the trees on the vector units).

Parameters are named as the reference's dict (``proj [F, n_vec, vec_dim]``,
``pb [n_vec, vec_dim]``, ``w1``, ``b1``, ``w2``, ``b2``).
:func:`dense_params_from_numpy` and :meth:`DenseScorer.to_numpy` carry them
across as numpy arrays, the dense counterpart of
:func:`repro_torch.forest.ensemble.from_numpy`. A :class:`DenseScorer` is
itself the ``[B, F] → [B]`` callable a ``DenseStage`` takes; keep one per
trained model, since stages compare their scorers by identity.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.kernels.build import FIRST_TOUCHES
from repro_torch.kernels.ops import env_int
from repro_torch.models.recsys import dot_interact
from repro_torch.utils import resolve_device

DENSE_N_VEC = env_int("REPRO_DENSE_N_VEC", 4, minimum=2)
DENSE_VEC_DIM = env_int("REPRO_DENSE_VEC_DIM", 16)
DENSE_HIDDEN = env_int("REPRO_DENSE_HIDDEN", 32)
DENSE_COST_TREES = env_int("REPRO_DENSE_COST_TREES", 4)

PARAM_NAMES = ("proj", "pb", "w1", "b1", "w2", "b2")


def dense_score(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Score a flat feature block: ``[B, F]`` → ``[B]`` float32, the
    reference's :func:`repro.models.dense_scorer.dense_score`."""
    proj = params["proj"]
    F, n_vec, vec_dim = proj.shape
    vecs = (x @ proj.reshape(F, n_vec * vec_dim)).reshape(-1, n_vec, vec_dim) + params["pb"]
    feats = torch.cat([vecs.reshape(vecs.shape[0], -1), dot_interact(vecs)], dim=-1)
    h = torch.relu(feats @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[..., 0]


class DenseScorer(torch.nn.Module):
    """The dense scorer's parameters as a module; calling it is
    :func:`dense_score`.

    Each call counts a first touch (``first_touches()["dense"]`` of
    :mod:`repro_torch.kernels.forest_score`) the first time it meets a
    (device, stream, row count): the first GEMMs of a shape on a stream
    pay for the BLAS handle, its workspace and the kernel choice, which the
    reference pays while it compiles its step. Warmup serves every bucket,
    so a warmed service adds none.
    """

    def __init__(self, params: Mapping[str, torch.Tensor]) -> None:
        super().__init__()
        for name in PARAM_NAMES:
            self.register_parameter(
                name, torch.nn.Parameter(params[name].detach().float().clone())
            )
        self._touched: set[tuple] = set()

    def params(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The parameters as the reference's dict of numpy arrays."""
        return {k: v.detach().cpu().numpy() for k, v in self.params().items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stream = torch.cuda.current_stream(x.device).cuda_stream if x.is_cuda else 0
        key = (x.device, stream, x.shape[0])
        if key not in self._touched:
            self._touched.add(key)
            FIRST_TOUCHES["dense"] += 1
        return dense_score(self.params(), x)


def dense_params_from_numpy(
    params: Mapping[str, np.ndarray], device: str | torch.device | None = None
) -> DenseScorer:
    """A :class:`DenseScorer` on ``device`` (``None`` → the card) from the
    reference's parameter dict as numpy arrays (a trained or initialised
    pytree, read out with ``np.asarray``)."""
    dev = resolve_device(device)
    tensors = {k: torch.tensor(np.asarray(params[k], np.float32)) for k in PARAM_NAMES}
    return DenseScorer(tensors).to(dev)


def init_dense_scorer(
    generator: torch.Generator,
    n_features: int,
    n_vec: int = DENSE_N_VEC,
    vec_dim: int = DENSE_VEC_DIM,
    hidden: int = DENSE_HIDDEN,
    device: str | torch.device | None = None,
) -> DenseScorer:
    """A fresh scorer for ``n_features``-dim vectors, drawn from
    ``generator`` (a CPU ``torch.Generator``) with the reference's
    distributions: ``proj`` normal · F^-0.5, each head layer normal ·
    fan^-0.5 (``repro.models.recsys._mlp_init``), biases and ``pb`` zero.
    The numbers differ from ``jax.random``'s for the same seed."""
    head_in = n_vec * vec_dim + n_vec * (n_vec - 1) // 2

    def normal(*shape: int) -> torch.Tensor:
        return torch.randn(*shape, generator=generator, dtype=torch.float32) * shape[0] ** -0.5

    params = {
        "proj": normal(n_features, n_vec, vec_dim),
        "pb": torch.zeros(n_vec, vec_dim),
        "w1": normal(head_in, hidden),
        "b1": torch.zeros(hidden),
        "w2": normal(hidden, 1),
        "b2": torch.zeros(1),
    }
    return DenseScorer(params).to(resolve_device(device))
