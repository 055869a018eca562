"""The one traffic generator: a pool of request batches and their arrival
times, made from the seed.

A traffic mix is a data file, ``traffic/<name>.json``, read by
:func:`make_pool` and :func:`arrivals`. Its keys:

- ``queries``, ``slots``: a request is ``queries`` queries, each padded to
  ``slots`` candidate slots (``X [queries, slots, F]``, ``mask [queries, slots]``);
- ``candidates``: the real candidates a query, in the first slots of the
  query, clipped to ``[min, min(max, slots)]``:
  ``{"draw": "poisson", "mean", "min", "max"}`` (the draw of
  ``make_letor_dataset``'s presets) or ``{"draw": "uniform", "min", "max"}``
  (every count in the range alike);
- ``features``: ``{"draw": "normal"}``, N(0, 1) for real documents, 0 in
  padding slots;
- ``pool``: distinct request batches, made once and cycled by the loop (so
  the window measures ranking, not the making of inputs);
- ``inputs``: ``"device"`` (the default: the batches stay on the card, as
  a back end that batches there hands them over) or ``"host"`` (numpy
  arrays in host memory, so every request carries its transfer);
- ``loop``: ``"closed"``, ``clients`` callers each sending its next
  request once its last one returned, or ``"open"``, requests arriving as
  a Poisson process of ``rate`` requests a second and served in arrival
  order by one dispatcher (``clients`` 1): a request's time runs from its
  arrival, so it counts its wait in the queue.

Candidate counts and arrival gaps come from numpy's ``default_rng`` on
``seed``; features from ``torch`` on the device through the run's
generator, so the same seed gives the same inputs on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Pool:
    """The request batches of a run and their real document counts."""

    batches: list[tuple[torch.Tensor | np.ndarray, torch.Tensor | np.ndarray]]
    real_docs: list[int]

    @property
    def device_bytes(self) -> int:
        """What the pool holds on the device (nothing for host inputs)."""
        return sum(
            X.nbytes + m.nbytes for X, m in self.batches if isinstance(X, torch.Tensor)
        )


def candidate_counts(traffic: dict, seed: int) -> np.ndarray:
    """Real candidates of every query of every pool batch, ``[pool, queries]``."""
    cand = traffic["candidates"]
    rng = np.random.default_rng([seed, 0x7EA5])
    size = (traffic["pool"], traffic["queries"])
    slots = traffic["slots"]
    if cand["draw"] == "poisson":
        n = rng.poisson(cand["mean"], size=size)
    elif cand["draw"] == "uniform":
        n = rng.integers(cand["min"], min(cand["max"], slots), size=size, endpoint=True)
    else:
        raise ValueError(f"candidate draw {cand['draw']!r} is not poisson or uniform")
    return np.clip(n, cand["min"], min(cand["max"], slots))


def make_pool(
    traffic: dict, n_features: int, seed: int, generator: torch.Generator,
    device: torch.device,
) -> Pool:
    """The ``traffic["pool"]`` request batches of a run: made on ``device``,
    and kept there or moved to host memory as ``traffic["inputs"]`` says."""
    inputs = traffic.get("inputs", "device")
    if inputs not in ("device", "host"):
        raise ValueError(f"inputs {inputs!r} is not device or host")
    if traffic["features"]["draw"] != "normal":
        raise ValueError(f"feature draw {traffic['features']['draw']!r} is not 'normal'")
    counts = candidate_counts(traffic, seed)
    Q, D = traffic["queries"], traffic["slots"]
    slot = torch.arange(D, device=device)
    batches, real = [], []
    for n in counts:
        mask = slot[None, :] < torch.as_tensor(n, device=device)[:, None]
        X = torch.randn((Q, D, n_features), generator=generator, device=device)
        X.mul_(mask[..., None])
        if inputs == "host":
            X, mask = X.cpu().numpy(), mask.cpu().numpy()
        batches.append((X, mask))
        real.append(int(n.sum()))
    return Pool(batches, real)


def arrivals(traffic: dict, seed: int, seconds: float) -> np.ndarray | None:
    """Arrival times (seconds from the window's start) of an open loop's
    requests over ``seconds``, or None for a closed loop."""
    loop = traffic.get("loop", "closed")
    if loop == "closed":
        return None
    if loop != "open" or traffic["clients"] != 1:
        raise ValueError(f"loop {loop!r} with {traffic['clients']} clients is not closed, "
                         "or open with one dispatcher")
    rate = float(traffic["rate"])
    rng = np.random.default_rng([seed, 0xA77])
    n = int(rate * seconds * 1.5) + 16
    t = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return t[t < seconds]
