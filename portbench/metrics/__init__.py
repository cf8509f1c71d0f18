"""Metric readers, one file a metric (the name before its first dot).
Each ``read(ctx)`` returns the metric's value, or None where the run
gave it nothing to read (``harness.context`` builds ``ctx``)."""
