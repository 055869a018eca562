"""Tail rows launched over tail survivors in the traced segment: the sum of
the picked tail capacities (``ServiceStats.capacities``, the last entry of
each batch's tuple) over the final stage's survivors
(``ServiceStats.docs_continued``), both as the segment moved them. None
without the counters or without survivors."""


def read(ctx: dict) -> float | None:
    st = ctx["stats_traced"]
    if not st or not st.get("docs_continued"):
        return None
    rows = sum(caps[-1] * n for caps, n in st["capacities"].items())
    return rows / st["docs_continued"]
