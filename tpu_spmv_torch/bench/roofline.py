"""Memory-bandwidth roofline model for the sparse kernels.

Counterpart of ``tpu_spmv/bench/roofline.py``.  SpMV is memory-bound, so
the efficiency metric is achieved bytes/s against the card's bandwidth.
Byte counts are the minimum-traffic model: each matrix byte read once, x
read once, y written once.  The bandwidth is the card's own, measured as a
device-to-device copy (:func:`measured_copy_gbps`), not a table of
published figures; a CPU run has no roofline.
"""

from __future__ import annotations

import dataclasses
import functools
import statistics

import torch

__all__ = ["spmv_bytes", "spmm_bytes", "gpr_matrix_bytes",
           "ell_matrix_bytes", "measured_copy_gbps", "Roofline", "roofline"]


def gpr_matrix_bytes(nnz: int, rows: int, itemsize: int) -> int:
    """Matrix bytes the GPR kernel streams: a value and an int32 column
    per entry, an int32 row id and an int64 row pointer per row.  The
    planner's byte rule reads this before any pack exists."""
    return nnz * (itemsize + 4) + rows * 12


def ell_matrix_bytes(slots: int, slices: int, itemsize: int) -> int:
    """Matrix bytes the sliced-ELL kernel streams: a value and an int32
    column per stored slot (pads included), an int64 pointer per slice."""
    return slots * (itemsize + 4) + slices * 8


def _matrix_bytes(A) -> int:
    """Device-memory bytes of the operator that one product reads once."""
    from ..formats import COO, CSC, CSR, DIA
    from ..kernels.dia_stream import PSDIA, SDIA
    from ..kernels.ell_packed import PackedELL
    from ..kernels.gpr import GPCSR

    val = A.dtype.itemsize
    idx = 4  # int32
    if isinstance(A, COO):
        return A.nnz * (val + 2 * idx)
    if isinstance(A, CSR):
        return A.nnz * (val + 2 * idx) + (A.shape[0] + 1) * idx
    if isinstance(A, CSC):
        return A.nnz * (val + 2 * idx) + (A.shape[1] + 1) * idx
    if isinstance(A, (DIA, SDIA)):
        return A.data.numel() * val
    if isinstance(A, GPCSR):
        # + the closing row pointer and the fold's owner rows and runs
        return (gpr_matrix_bytes(A.nnz, A.nrow_internal, val) + 8
                + 8 * (A.hub_rows.numel() + A.hub_ptr.numel()))
    if isinstance(A, PackedELL):
        return (ell_matrix_bytes(A.slots, A.nslices, val) + 8
                + A.side.nnz * (val + 2 * idx))
    if isinstance(A, PSDIA):
        # the pattern is read once and then served from cache
        return A.pattern.numel() * val
    raise TypeError(f"unsupported sparse type {type(A).__name__}")


def spmv_bytes(A, x_dtype=None) -> int:
    """Minimum device-memory traffic of one ``y = A @ x``: the matrix, x
    read once, y written once.  A sharded streaming-DIA matrix
    (``ShardedSDIA``, ``ShardedPSDIA``) counts its data blocks (or its
    pattern, once on each device that holds it), x and y as a single-chip
    pack does, and, past one shard, the ``band`` values each side of every
    boundary between shards reads from its neighbour; at one shard it
    equals the single-chip pack's count."""
    from ..dist.planned import ShardedPSDIA, ShardedSDIA

    if isinstance(A, (ShardedSDIA, ShardedPSDIA)):
        if isinstance(A, ShardedSDIA):
            c = A.data[0]
            coef = sum(d.numel() for d in A.data) * c.element_size()
        else:
            c = A.pattern[0]
            coef = (len({p.device for p in A.pattern}) * c.numel()
                    * c.element_size())
        band = max(abs(o) for o in A.offsets)
        return coef + (A.shape[0] + A.shape[1] + 2 * band * (A.ndev - 1)) \
            * (x_dtype or c.dtype).itemsize
    xval = (x_dtype or A.dtype).itemsize
    return _matrix_bytes(A) + (A.shape[0] + A.shape[1]) * xval


def spmm_bytes(A, nrhs: int, x_dtype=None) -> int:
    """Minimum device-memory traffic of one ``Y = A @ X`` with ``nrhs``
    right-hand sides: the matrix once, ``nrhs`` x and y vectors.  The
    streaming-DIA kernels read and write ``[nrhs, npad]`` padded blocks."""
    from ..kernels.dia_stream import PSDIA, SDIA

    xval = (x_dtype or A.dtype).itemsize
    vec = (2 * A.npad if isinstance(A, (SDIA, PSDIA))
           else A.shape[0] + A.shape[1])
    return _matrix_bytes(A) + nrhs * vec * xval


@functools.cache
def measured_copy_gbps(device) -> float:
    """The card's copy bandwidth in GB/s: ``2·bytes / t`` of a 256 MiB
    device-to-device ``copy_`` (far past the 50 MB L2), timed with CUDA
    events, median of 10 runs of 20 copies after warm-up."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"copy bandwidth is measured on a CUDA device, "
                         f"not {device}")
    src = torch.rand(1 << 26, device=device)
    dst = torch.empty_like(src)
    for _ in range(3):
        dst.copy_(src)
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            dst.copy_(src)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / 20)
    return 2 * src.numel() * src.element_size() / statistics.median(times) / 1e9


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Achieved against the measured bandwidth for one timed kernel."""

    seconds: float
    bytes: int
    flops: int
    bw_gbps: float              # achieved GB/s of the byte model
    peak_gbps: float | None     # measured copy bandwidth; None on the CPU
    fraction: float | None      # bw / peak
    gflops: float

    def summary(self) -> str:
        head = (f"{self.gflops:8.3f} GFLOP/s | {self.bw_gbps:8.2f} GB/s "
                f"model")
        if self.peak_gbps is None:
            return head + " | roofline not measured (no card)"
        return (head + f" | {100 * self.fraction:5.1f}% of "
                f"{self.peak_gbps:.0f} GB/s measured copy")


def roofline(A, seconds: float, *, x_dtype=None,
             peak_gbps: float | None = None) -> Roofline:
    """A :class:`Roofline` from one measured per-call time; FLOPs are
    ``2·nnz`` with the true nnz."""
    nnz = A.nnz
    nbytes = spmv_bytes(A, x_dtype)
    bw = nbytes / seconds / 1e9
    return Roofline(seconds=seconds, bytes=nbytes, flops=2 * nnz,
                    bw_gbps=bw, peak_gbps=peak_gbps,
                    fraction=None if peak_gbps is None else bw / peak_gbps,
                    gflops=2 * nnz / seconds / 1e9)
