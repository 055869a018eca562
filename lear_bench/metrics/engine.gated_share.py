"""The share of the compacted forest launches' rows that lay at or past
their launch's survivor count, in the traced segment, in %
(``ServiceStats.rows_gated`` over ``rows_compacted``, as the segment moved
them): compaction padding that the gated CUDA kernel writes as 0 without
tree work. None without the counters, without a compacted launch, or where
no forest kernel ran on the device (the CPU's plain version scores every
row and skips none)."""


def read(ctx: dict) -> float | None:
    st, tr = ctx["stats_traced"], ctx["trace"]
    if not st or not st.get("rows_compacted") or tr is None or tr.forest_s <= 0:
        return None
    return 100.0 * st["rows_gated"] / st["rows_compacted"]
