"""Benchmark harness: the reference's measurement protocol on a CUDA card.

Counterpart of ``tpu_spmv/bench/harness.py``.  The grep-able result line
stays ``### <FMT> <MODE> GFLOPS = <value>``; every benchmarked product is
checked against a float64 scipy oracle first (1e-10 for float64, 2e-5 for
float32, 2e-2 for a bf16 product against the unrounded matrix).  Timing
runs a chained loop ``v ← A·v·scale`` (``V ← A·V·scale`` on ``[n, nrhs]``
blocks for the SpMM) and takes the median over repeats after warm-up:
CUDA events on the card, the host clock on the CPU.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import numpy as np
import torch

from ..formats import BDIA, BSR, COO, CSC, CSR, DIA, ELL, convert, to_coo
from ..kernels.dia_stream import PSDIA, SDIA
from ..kernels.ell_packed import PackedELL
from ..kernels.gpr import GPCSR
from ..ops.spmm import spmm
from ..ops.spmv import spmv
from .roofline import measured_copy_gbps, roofline, spmm_bytes

__all__ = ["DEFAULT_ITERS", "TimingResult", "format_name", "time_fn",
           "time_chained", "verify_against_oracle", "bench_spmv",
           "bench_spmm", "bench_format_sweep"]

#: timed iterations per measurement (the reference's count)
DEFAULT_ITERS = 50

#: protocol names; the general-arm packs print their strategy's name
_NAMES = {COO: "COO", CSR: "CSR", CSC: "CSC", ELL: "ELL", DIA: "DIA",
          BSR: "BSR", BDIA: "BDIA", SDIA: "SDIA", PSDIA: "PSDIA",
          GPCSR: "GPR", PackedELL: "PALLAS_ELL"}


def format_name(A) -> str:
    return _NAMES.get(type(A), type(A).__name__)


@dataclasses.dataclass(frozen=True)
class TimingResult:
    median_s: float             # per call, median over repeats
    best_s: float               # per call, best repeat
    iters: int                  # calls per repeat


def _timed(run: Callable, on_cuda: bool, repeats: int) -> list[float]:
    """Seconds of each of ``repeats`` runs of ``run()``."""
    times = []
    for _ in range(repeats):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return times


def _result(times: list[float], iters: int) -> TimingResult:
    return TimingResult(median_s=statistics.median(times) / iters,
                        best_s=min(times) / iters, iters=iters)


def _is_cuda(v) -> bool:
    """Whether a tensor or a :class:`~..dist.sharded.ShardedVector` (the
    device of its first local chunk) is on the card."""
    return (v.chunks[v.local[0]] if hasattr(v, "chunks") else v).is_cuda


def time_fn(fn: Callable, *args, iters: int = DEFAULT_ITERS,
            warmup: int = 2, repeats: int = 5) -> TimingResult:
    """Per-call time of ``fn(*args)`` (``iters`` calls per repeat), which
    returns a tensor or a :class:`~..dist.sharded.ShardedVector`."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    on_cuda = _is_cuda(out)

    def run():
        for _ in range(iters):
            fn(*args)

    return _result(_timed(run, on_cuda, repeats), iters)


def time_chained(step: Callable, v0, *, iters: int = DEFAULT_ITERS,
                 warmup: int = 2, repeats: int = 5) -> TimingResult:
    """Per-step time of the dependent chain ``v ← step(v)``; ``v0`` is a
    tensor or a :class:`~..dist.sharded.ShardedVector` (timed on the
    device of its first chunk)."""
    on_cuda = _is_cuda(v0)
    v = v0
    for _ in range(warmup):
        v = step(v)

    def run():
        nonlocal v
        for _ in range(iters):
            v = step(v)

    return _result(_timed(run, on_cuda, repeats), iters)


def verify_against_oracle(A, x, y, rtol: float = 1e-10,
                          oracle=None, rounded: bool = False,
                          data_dtype: torch.dtype | None = None) -> float:
    """Max relative error of ``y`` against float64 scipy ``A @ x`` (``x``
    a vector or an ``[ncol, nrhs]`` block); raises above the gate (``rtol``
    for float64 output, 2e-5 for float32).  ``oracle`` supplies the scipy
    matrix for packed formats.

    A bf16 product (bfloat16 output, or bfloat16 coefficients) is held to
    the reference's 2e-2 against the unrounded matrix: the rounding of the
    coefficients alone costs about 2^-9.  With ``rounded=True`` the
    oracle holds the bf16-rounded values, and the product is held to the
    float32 gate, 2e-5.  ``data_dtype`` names the coefficients' type where
    ``A`` does not (a sharded container)."""
    sp_mat = (oracle.tocsr() if oracle is not None
              else to_coo(A).to_scipy()).astype(np.float64)
    y_ref = sp_mat @ x.detach().cpu().double().numpy()
    y_np = y.detach().cpu().double().numpy()
    rel = float(np.max(np.abs(y_np - y_ref))) / max(
        float(np.max(np.abs(y_ref))), 1e-300)
    bf16 = torch.bfloat16 in (y.dtype, data_dtype or getattr(A, "dtype",
                                                             None))
    if y.dtype == torch.float64:
        gate = rtol
    elif bf16 and not rounded:
        gate = max(rtol, 2e-2)
    else:
        gate = max(rtol, 2e-5)
    if rel > gate:
        raise AssertionError(
            f"{format_name(A)} product verification failed: rel err {rel:.3e} "
            f"> {gate:.0e}")
    return rel


def bench_spmv(A, x: torch.Tensor, *, mode: str, iters: int = DEFAULT_ITERS,
               check: bool = True, quiet: bool = False,
               spmv_fn: Callable | None = None, oracle=None) -> dict:
    """Benchmark one format's SpMV and print the protocol line.

    Square operands time the chain ``v ← (A v) / ||A||_inf``; others time
    repeated calls.  On the card the roofline divides by the measured copy
    bandwidth; a CPU run reports none."""
    fn = spmv_fn or spmv
    rel = (verify_against_oracle(A, x, fn(A, x), oracle=oracle)
           if check else float("nan"))
    nrow, ncol = A.shape
    if nrow == ncol:
        host = oracle.tocsr() if oracle is not None else to_coo(A).to_scipy()
        scale = 1.0 / max(float(abs(host).sum(axis=1).max()), 1e-300)
        t = time_chained(lambda v: fn(A, v) * scale, x, iters=iters)
    else:
        t = time_fn(fn, A, x, iters=iters)
    peak = measured_copy_gbps(x.device) if x.is_cuda else None
    rf = roofline(A, t.median_s, x_dtype=x.dtype, peak_gbps=peak)
    name = format_name(A)
    if not quiet:
        print(f"### {name} {mode} GFLOPS = {rf.gflops:.5f}")
        print(f"    {name} {mode}: {rf.summary()} | rel_err={rel:.2e}")
    return {"format": name, "mode": mode, "gflops": rf.gflops,
            "seconds": rf.seconds, "bytes": rf.bytes, "bw_gbps": rf.bw_gbps,
            "roofline_fraction": rf.fraction, "rel_err": rel,
            "iters": iters}


def bench_spmm(A, X: torch.Tensor, *, iters: int = DEFAULT_ITERS,
               check: bool = True, quiet: bool = False,
               spmm_fn: Callable | None = None, oracle=None) -> dict:
    """Benchmark one format's SpMM (``X [ncol, nrhs]``) and print the
    protocol lines ``### <FMT> SPMM<k> GFLOPS`` and ``<FMT> SPMM<k>:
    <t>/iter | rel_err=…``.

    Square operands time the chain ``V ← (A V) / ||A||_inf``; others time
    repeated calls."""
    fn = spmm_fn or spmm
    nrhs = int(X.shape[1])
    rel = (verify_against_oracle(A, X, fn(A, X), oracle=oracle)
           if check else float("nan"))
    nrow, ncol = A.shape
    if nrow == ncol:
        host = oracle.tocsr() if oracle is not None else to_coo(A).to_scipy()
        scale = 1.0 / max(float(abs(host).sum(axis=1).max()), 1e-300)
        t = time_chained(lambda V: fn(A, V) * scale, X, iters=iters)
    else:
        t = time_fn(fn, A, X, iters=iters)
    sec = t.median_s
    gflops = 2 * A.nnz * nrhs / sec / 1e9
    name = format_name(A)
    if not quiet:
        print(f"### {name} SPMM{nrhs} GFLOPS = {gflops:.5f}")
        ts = f"{sec * 1e3:.3f} ms" if sec >= 1e-4 else f"{sec * 1e6:.2f} us"
        print(f"    {name} SPMM{nrhs}: {ts}/iter | rel_err={rel:.2e}")
    return {"format": name, "mode": f"SPMM{nrhs}", "gflops": gflops,
            "seconds": sec, "bytes": spmm_bytes(A, nrhs, X.dtype),
            "rel_err": rel, "iters": iters}


def bench_format_sweep(coo: COO, x: torch.Tensor, *, formats, mode: str,
                       iters: int = DEFAULT_ITERS, check: bool = True,
                       quiet: bool = False,
                       spmv_fn: Callable | None = None) -> list[dict]:
    """The reference's per-format sweep: one :func:`bench_spmv` each
    (``spmv_fn`` in place of :func:`..ops.spmv.spmv`)."""
    return [bench_spmv(convert(coo, name), x, mode=mode, iters=iters,
                       check=check, quiet=quiet, spmv_fn=spmv_fn)
            for name in formats]
