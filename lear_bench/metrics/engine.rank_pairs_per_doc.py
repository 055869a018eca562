"""Pairs the sentinel features' rank compare evaluated, over the real
documents ranked, in the traced segment (``ServiceStats.rank_pairs`` over
``docs``, as the segment moved them): each stage ranks its whole ``[Q, D]``
grid, ``D²`` pairs a query, or the tile-padded ``D²`` of the blocked
compare. None without the counters, or where no kernel ran on the device
(the metric is the card's run's; the CPU runs of the harness report only
the service's timings)."""


def read(ctx: dict) -> float | None:
    st, tr = ctx["stats_traced"], ctx["trace"]
    if not st or "rank_pairs" not in st or not st.get("docs") or tr is None or not tr.kernels:
        return None
    return st["rank_pairs"] / st["docs"]
