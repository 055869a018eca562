"""The work a request needs, and the card's peaks: what ``roofline.forest``
and ``step_mfu`` divide by.

The count reads only shapes, the real documents and the survivors of the
reference's own exit decisions (:class:`lear_bench.reference.Result`),
never the program's counters or layout, so it stays the same whatever
scores the trees:

- a document and a tree it passes through count ``depth`` node tests, the
  root-to-leaf path;
- the ranker's head (trees ``[0, s_1)``) and the first classifier count the
  real documents, padding slots left out; the segment after sentinel
  ``s_k`` and the classifier at ``s_{k+1}`` count the survivors of stage
  ``k``;
- bytes: each real document's features read once, each tree's internal
  nodes (a 4-byte feature index and a 4-byte threshold) and leaves (4 bytes)
  read once, one 4-byte score a real document written once.

Peaks (NVIDIA's H100 SXM data sheet, dense rates at the full 700 W):
67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM3. A node test
holds no FMA, so :data:`ALU_OPS` takes one 32-bit instruction per lane per
cycle, half the float32 FLOP rate (which counts an FMA as two); this is an
assumption, the one ``repro_torch.launch.roofline`` states.
:data:`OPS_PER_NODE_TEST` is six: the feature index load, the feature's
load, the compare, the child select, and the step's two 32-bit halves of
the QuickScorer mask AND or, on a root-to-leaf walk, the index arithmetic.
"""

from __future__ import annotations

import dataclasses

F32_FLOPS = 67e12
ALU_OPS = F32_FLOPS / 2
HBM_BW = 3.35e12
OPS_PER_NODE_TEST = 6


@dataclasses.dataclass(frozen=True)
class Work:
    """Node tests and bytes one or more requests need."""

    tests: float = 0.0
    nbytes: float = 0.0

    def __add__(self, other: Work) -> Work:
        return Work(self.tests + other.tests, self.nbytes + other.nbytes)

    def __mul__(self, n: float) -> Work:
        return Work(self.tests * n, self.nbytes * n)

    @property
    def ops(self) -> float:
        return OPS_PER_NODE_TEST * self.tests

    @property
    def least_s(self) -> float:
        """The least time on one card: operations or bytes, whichever bounds."""
        return max(self.ops / ALU_OPS, self.nbytes / HBM_BW)


def request_work(
    real: int, survivors: list[int], sentinels: tuple[int, ...], n_trees: int,
    depth: int, classifier_trees: int, classifier_depth: int, n_features: int,
) -> Work:
    """The forest work of one request: ``real`` documents, ``survivors[k]``
    of them past stage ``k`` by the reference's decisions."""
    ends = (*sentinels, n_trees)
    reach = [real, *survivors]
    tests = real * ends[0] * depth
    for k in range(len(sentinels)):
        tests += reach[k] * classifier_trees * classifier_depth
        tests += reach[k + 1] * (ends[k + 1] - ends[k]) * depth
    tree_bytes = lambda d: ((1 << d) - 1) * 8 + (1 << d) * 4
    tables = n_trees * tree_bytes(depth) + len(sentinels) * classifier_trees * tree_bytes(
        classifier_depth
    )
    nbytes = real * n_features * 4 + tables + real * 4
    return Work(float(tests), float(nbytes))
