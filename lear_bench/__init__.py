"""The benchmark of ``repro_torch``: LEAR bulk ranking through
``RankingService.rank_batch`` on one NVIDIA H100.

One command runs one cell once (from the root of a checkout)::

    python3 -m lear_bench.run --workload msn1-bulk --seed 7 --seconds 10 --trace 0

The cells, metrics and bounds are listed in ``BENCHMARK.json`` at the root.
Everything that belongs to one configuration, traffic mix, cell or metric is
a file of its own, found by its name:

- ``configs/<name>.json``: a configuration as it is run (sizes, seeds of the
  exit policy, the service settings, and the ``system`` that serves it);
- ``workloads/<name>.json``: a cell (its configuration, traffic mix, exit
  threshold with the continue share it gives, and the limits of the check);
- ``traffic/<name>.json``: a traffic mix, the parameters of the one
  generator, :mod:`lear_bench.generator` (sizes, candidate draw, host or
  device inputs, a closed loop of some clients or an open loop at a rate);
- ``systems/<name>.py``: what the window drives (``build(...)``; by default
  ``ranking_service``, the program's ``RankingService``);
- ``metrics/<name>.py``: the reader of one metric (``read(ctx)``, over the
  run's readings, the system's counters and the trace).

The yardstick lives here too and imports nothing of the program:
:mod:`lear_bench.weights` (the weight draws), :mod:`lear_bench.generator`
(the traffic), :mod:`lear_bench.reference` (the plain cascade),
:mod:`lear_bench.check` (what decides ``correct``), :mod:`lear_bench.work`
(the work the inputs need, and the card's peaks) and
:mod:`lear_bench.trace` (the profiler's events reduced to busy time,
kernels and idle gaps).
"""
