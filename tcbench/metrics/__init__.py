"""One reader a metric, ``<name>.py`` with ``read(reading)``, found by the
metric's name in ``BENCHMARK.json``.  A reader that finds nothing to read
returns ``None``, and the metric is left out of the run's line."""
