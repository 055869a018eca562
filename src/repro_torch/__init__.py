"""repro_torch — the LEAR serving path and its training in PyTorch, with CUDA
kernels for Hopper, the model cells of the architecture registry and the
LM serving path.

A port of :mod:`repro` (JAX, Pallas kernels for the TPU), which stays in
the repository unchanged as the reference the port is tested against. The
port imports neither JAX nor anything of ``repro``. Entry points take a
``device``; ``None`` means the CUDA card, and ``device="cpu"`` runs the
plain PyTorch version of every kernel.

Module map (port ↔ reference):

======================================  =====================================
``repro_torch.forest.ensemble``         ``repro.forest.ensemble`` (+ the
                                        ``from_numpy`` weight converter)
``repro_torch.forest.scoring``          ``repro.forest.scoring``
``repro_torch.forest.binning``          ``repro.forest.binning``
``repro_torch.forest.lambdamart``       ``repro.forest.lambdamart``
``repro_torch.forest.gbdt``             ``repro.forest.gbdt``
``repro_torch.forest.reorder``          ``repro.forest.reorder``
``repro_torch.data.synthetic``          ``repro.data.synthetic``
``repro_torch.kernels.forest_score``    ``repro.kernels.forest_score`` —
                                        CUDA source in ``csrc/forest_score.cu``
``repro_torch.kernels.build``           (none: nvcc build + ctypes load)
``repro_torch.kernels.ops``             ``repro.kernels.ops``
``repro_torch.core.compaction``         ``repro.core.compaction``
``repro_torch.core.features``           ``repro.core.features``
``repro_torch.core.strategies``         ``repro.core.strategies`` (ERT, EPT,
                                        query-exit predicate, dense keep
                                        fraction, EE_ideal)
``repro_torch.core.stage``              ``repro.core.stage``
``repro_torch.core.lear``               ``repro.core.lear``
``repro_torch.core.cascade``            ``repro.core.cascade``
``repro_torch.models.dense_scorer``     ``repro.models.dense_scorer`` (+ the
                                        ``dense_params_from_numpy`` converter)
``repro_torch.models.layers``           ``repro.models.layers``
``repro_torch.models.moe``              ``repro.models.moe``
``repro_torch.models.transformer``      ``repro.models.transformer`` (serving
                                        half, + the
                                        ``transformer_params_from_numpy`` /
                                        ``_to_numpy`` converters)
``repro_torch.models.recsys``           ``repro.models.recsys`` (+ the
                                        ``recsys_params_from_numpy`` /
                                        ``_to_numpy`` converters)
``repro_torch.models.api``              ``repro.models.api`` (RecSys, LM
                                        serving and forest cells)
``repro_torch.models.synth``            ``repro.models.synth``
``repro_torch.train.optimizer``         ``repro.train.optimizer``
``repro_torch.train.trainer``           ``repro.train.trainer``
``repro_torch.train.checkpoint``        ``repro.train.checkpoint``
``repro_torch.train.distill``           ``repro.train.distill``
``repro_torch.data.pipeline``           ``repro.data.pipeline``
``repro_torch.metrics.ranking``         ``repro.metrics.ranking``
``repro_torch.metrics.speedup``         ``repro.metrics.speedup``
``repro_torch.metrics.classification``  ``repro.metrics.classification``
``repro_torch.serve.calibration``       ``repro.serve.calibration``
``repro_torch.serve.ranking_service``   ``repro.serve.ranking_service``
``repro_torch.serve.lm_serve``          ``repro.serve.lm_serve``
``repro_torch.configs``                 ``repro.configs`` (the registry,
                                        ``base`` and the eleven configs)
``repro_torch.launch.serve``            ``repro.launch.serve``
``repro_torch.launch.train``            ``repro.launch.train``
``repro_torch.distributed``             ``repro.distributed`` (rules on a
                                        ``DeviceMesh``; ``constrain`` on
                                        ``DTensor``)
``repro_torch.launch.mesh``             ``repro.launch.mesh``
``repro_torch.train.elastic``           ``repro.train.elastic``
``repro_torch.serve.placement``         ``repro.serve.placement``
``repro_torch.launch.op_analysis``      ``repro.launch.hlo_analysis`` (aten
                                        ops of an eager step, not HLO)
``repro_torch.launch.roofline``         ``repro.launch.roofline`` (H100)
``repro_torch.launch.dryrun``           ``repro.launch.dryrun`` (a fake
                                        process group, ``meta`` tensors)
``repro_torch.launch.reanalyze``        ``repro.launch.reanalyze``
``repro_torch.launch.hillclimb``        ``repro.launch.hillclimb``
``repro_torch.utils``                   (none: device resolution, the path
                                        walk of nested states)
``repro_torch.tracing``                 (none: the port's own; spans of the
                                        ranking path for a reader to put
                                        beside the profiler's trace)
======================================  =====================================

What is not ported yet is listed in ``ROADMAP.md``.
"""

from repro_torch.core.cascade import CascadeRanker
from repro_torch.core.lear import LearClassifier
from repro_torch.core.stage import DenseStage, EngineConfig, TreeStage
from repro_torch.core.strategies import dense_keep_fraction
from repro_torch.forest.ensemble import TreeEnsemble, from_numpy, random_ensemble
from repro_torch.kernels.ops import launch_counts, reset_launch_counts
from repro_torch.models.dense_scorer import DenseScorer, dense_params_from_numpy
from repro_torch.serve.ranking_service import RankingService, ServiceConfig
from repro_torch.train.distill import distill_dense_scorer

__all__ = [
    "CascadeRanker",
    "DenseScorer",
    "DenseStage",
    "EngineConfig",
    "LearClassifier",
    "RankingService",
    "ServiceConfig",
    "TreeEnsemble",
    "TreeStage",
    "dense_keep_fraction",
    "dense_params_from_numpy",
    "distill_dense_scorer",
    "from_numpy",
    "launch_counts",
    "random_ensemble",
    "reset_launch_counts",
]
