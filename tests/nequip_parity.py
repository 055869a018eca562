"""Batches of small molecules for holding the port's NequIP to the
reference and the card to the CPU.

``synthesize_inputs`` draws a ``molecule`` cell's edges among the first
``n_nodes`` (30) of its 4,096 nodes, so each of those nodes receives ~270
edges: the features grow through the layers, the forces are sums of large
opposite terms, and in float32 the reference itself misses its own
rotation tolerance there (``tests/test_property.py``: 1.7 against forces
of 85 at the full config). :func:`molecule_batch` builds what the shape
describes instead: ``n_graphs`` molecules of ``atoms`` atoms, each with
``edges`` directed edges between two different atoms of the same
molecule, and the padding the data pipeline emits: the nodes past the
molecules are ghosts of the last graph, and the edges past the molecules'
are self-edges on the last ghost node (distance 0).
"""

from __future__ import annotations

import numpy as np


def molecule_batch(n_graphs: int, atoms: int, edges: int, n_nodes: int, n_edges: int,
                   n_species: int, seed: int, d_feat: int = 0) -> dict[str, np.ndarray]:
    """A padded batch with the ``molecule`` cell's inputs: positions
    ~N(0, 1.5²) per atom, random species, energy and force targets."""
    if n_graphs * atoms >= n_nodes or n_graphs * edges > n_edges:
        raise ValueError("the molecules must leave room for a ghost node")
    rng = np.random.default_rng(seed)
    pos = np.zeros((n_nodes, 3), np.float32)
    species = np.zeros(n_nodes, np.int32)
    graph_id = np.full(n_nodes, n_graphs - 1, np.int32)
    src = np.full(n_edges, n_nodes - 1, np.int32)
    dst = np.full(n_edges, n_nodes - 1, np.int32)
    for g in range(n_graphs):
        lo = g * atoms
        pos[lo:lo + atoms] = rng.normal(scale=1.5, size=(atoms, 3))
        species[lo:lo + atoms] = rng.integers(0, n_species, atoms)
        graph_id[lo:lo + atoms] = g
        s = rng.integers(0, atoms, edges)
        d = (s + rng.integers(1, atoms, edges)) % atoms
        src[g * edges:(g + 1) * edges] = lo + s
        dst[g * edges:(g + 1) * edges] = lo + d
    batch = {
        "positions": pos, "species": species, "edge_src": src, "edge_dst": dst,
        "energy": rng.normal(size=n_graphs).astype(np.float32), "graph_id": graph_id,
        "forces": rng.normal(scale=0.1, size=(n_nodes, 3)).astype(np.float32),
    }
    if d_feat:
        batch["node_feat"] = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    return batch
