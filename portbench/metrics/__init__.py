"""One reader a metric, ``<metric name>.py``, found by the name in
``BENCHMARK.json``: ``read(run)`` gives the metric's value from the run's
record (``run.record``), its trace (``run.summary``) and the yardstick
(``portbench/counts``), or None where it finds nothing to read."""
