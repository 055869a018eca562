"""The systems under test, one module a system, named by a configuration's
``system`` key. Each has ``build(ranker, clfs, sentinels, cfg, threshold,
dev)``, which returns an object whose ``rank_batch(X, mask)`` serves one
request and returns ``(top [Q, k], scores [Q, D])`` as numpy arrays, and
whose ``stats``, where it has one, is a dataclass of counters."""
