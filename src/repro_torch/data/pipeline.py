"""Deterministic, resumable data pipelines.

The port's copy of :mod:`repro.data.pipeline` (numpy, host side): the same
seed and cursor give the same batches in both packages.

``TokenPipeline`` — synthetic LM token stream with an explicit integer
cursor; the cursor is part of the training checkpoint so a restarted job
resumes mid-epoch exactly (fault-tolerance requirement). Sharding is by
``(host_index, cursor)`` so every host draws a disjoint stream without
coordination.

``QueryBatcher`` — batches padded LETOR query blocks for the ranking
service, same cursor discipline.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    batch_size: int       # per-host batch
    seq_len: int
    seed: int = 0
    cursor: int = 0
    host_index: int = 0
    num_hosts: int = 1

    def next_batch(self) -> dict[str, np.ndarray]:
        """Markov-ish synthetic tokens: deterministic in (seed, host, cursor)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.host_index) * 2_654_435_761
            + self.cursor
        )
        # Zipf-distributed tokens + short-range repetition → a learnable LM task.
        base = rng.zipf(1.3, size=(self.batch_size, self.seq_len + 1))
        tokens = np.minimum(base, self.vocab_size - 1).astype(np.int32)
        rep = rng.random((self.batch_size, self.seq_len + 1)) < 0.3
        tokens[:, 1:] = np.where(rep[:, 1:], tokens[:, :-1], tokens[:, 1:])
        self.cursor += 1
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def state(self) -> dict:
        return {"cursor": self.cursor, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.cursor = int(state["cursor"])
        self.seed = int(state["seed"])


@dataclasses.dataclass
class QueryBatcher:
    """Yields fixed-size blocks of padded queries; resumable cursor."""

    n_queries: int
    batch_queries: int
    cursor: int = 0

    def next_indices(self) -> np.ndarray:
        idx = (self.cursor + np.arange(self.batch_queries)) % self.n_queries
        self.cursor = (self.cursor + self.batch_queries) % self.n_queries
        return idx

    def state(self) -> dict:
        return {"cursor": self.cursor}

    def restore(self, state: dict) -> None:
        self.cursor = int(state["cursor"])
