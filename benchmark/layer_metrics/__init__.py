"""One reader for each per-layer metric, found by the metric's name: a
module ``<name>.py`` (dots in the name become underscores) with ``read(trace)``
returning the number, or None where the trace holds nothing to read."""
