"""CSR neighbor sampling for GNN minibatch training (``minibatch_lg`` shape).

JAX has no sparse neighbor-sampling primitive; this host-side sampler is
part of the system (spec: "``minibatch_lg`` needs a real neighbor
sampler"). Uniform sampling with replacement per GraphSAGE, layered
fanouts, output as a padded edge list + node set ready for
``segment_sum`` message passing on device.

The port's own numpy copy of :mod:`repro.data.graph_sampler`: for the same
graph, seeds and ``seed`` it samples the same block, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # [n_nodes + 1]
    indices: np.ndarray  # [n_edges]

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.indices.shape[0]

    @staticmethod
    def random(n_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
        rng = np.random.default_rng(seed)
        deg = rng.poisson(avg_degree, size=n_nodes).clip(1)
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = rng.integers(0, n_nodes, size=int(indptr[-1]), dtype=np.int64)
        return CSRGraph(indptr=indptr, indices=indices)


def sample_neighbors(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Layered uniform neighbor sampling (with replacement).

    Returns a block: ``nodes`` (unique node ids, seeds first), ``edge_src`` /
    ``edge_dst`` (indices *into* ``nodes``), suitable for
    ``segment_sum(messages, edge_dst, num_segments=len(nodes))``.
    """
    rng = np.random.default_rng(seed)
    frontier = np.unique(seeds)
    node_ids = list(frontier)
    node_pos = {int(n): i for i, n in enumerate(frontier)}
    src_list, dst_list = [], []

    for fanout in fanouts:
        next_frontier = []
        for n in frontier:
            lo, hi = graph.indptr[n], graph.indptr[n + 1]
            if hi == lo:
                continue
            nbrs = graph.indices[lo + rng.integers(0, hi - lo, size=fanout)]
            for m in nbrs:
                m = int(m)
                if m not in node_pos:
                    node_pos[m] = len(node_ids)
                    node_ids.append(m)
                    next_frontier.append(m)
                src_list.append(node_pos[m])
                dst_list.append(node_pos[int(n)])
        frontier = np.asarray(next_frontier, dtype=np.int64)
        if frontier.size == 0:
            break

    return {
        "nodes": np.asarray(node_ids, dtype=np.int64),
        "edge_src": np.asarray(src_list, dtype=np.int64),
        "edge_dst": np.asarray(dst_list, dtype=np.int64),
        "n_seeds": np.int64(np.unique(seeds).shape[0]),
    }
