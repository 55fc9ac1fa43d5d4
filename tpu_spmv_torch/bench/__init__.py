"""Benchmarking: the reference's GFLOPS protocol, a roofline model and
the probe kernels (:mod:`.probes`: bandwidth, launch cost, width-8 lane
sum, in-tile gathers)."""

from .harness import (DEFAULT_ITERS, TimingResult, bench_format_sweep,
                      bench_spmm, bench_spmv, format_name, time_chained,
                      time_fn, verify_against_oracle)
from .roofline import (Roofline, measured_copy_gbps, roofline, spmm_bytes,
                       spmv_bytes)

__all__ = ["DEFAULT_ITERS", "TimingResult", "time_fn", "time_chained",
           "format_name", "bench_spmv", "bench_spmm", "bench_format_sweep",
           "verify_against_oracle", "Roofline", "roofline", "spmv_bytes",
           "spmm_bytes", "measured_copy_gbps"]
