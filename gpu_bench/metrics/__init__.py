"""One reader a metric, ``metrics/<metric name>.py``, found by the name in
``BENCHMARK.json``.  ``read(run)`` takes the run's record
(:class:`gpu_bench.harness.bench.Run`) and returns the number, or ``None``
where the run holds nothing for it to read (the metric is then left out
of the result line)."""
