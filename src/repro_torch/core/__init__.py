"""The LEAR cascade: features, strategies, compaction, stages, classifier, engine."""
