"""The 95th percentile of every request's time in the measured window, from
the call to ``rank_batch`` to its return (an open loop's from the request's
arrival), in ms (host clock; numpy's linear interpolation). It reads the
host's slow spells as much as the service, so it stands here without a
bound and not among the end-to-end metrics."""

import numpy as np


def read(ctx: dict) -> float:
    return float(np.percentile(np.asarray(ctx["latencies_s"]) * 1e3, 95))
