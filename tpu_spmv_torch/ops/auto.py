"""SpMV strategy planner — the analysis phase.

Counterpart of ``tpu_spmv/ops/auto.py``.  :func:`plan_spmv` inspects the
sparsity pattern once, on the host, and returns a plan: the operator packed
for the kernel that fits it, on the device the caller names (the card
unless the caller asks for the CPU).  Calling the plan is ``plan(x)``;
``plan.spmm(X)`` is the multi-RHS product with the strategy's SpMM kernel,
``plan.transpose()`` the plan of ``A^T`` and ``plan.matvec_differentiable()``
a matvec whose gradient in ``x`` runs the transpose plan.

The DIA arm keeps the reference's order: when the DIA storage is at most
4x nnz and no more than block-DIA storage,

1. a periodic pattern (:func:`..kernels.dia_stream.detect_period`) gives
   the periodic streaming DIA, ``"pdia_stream"`` (grid stencils);
2. otherwise a feasible row tile gives the streaming DIA, ``"dia_stream"``;
3. otherwise plain ``"dia"``.

The streaming arms are taken at every size: the reference's switchover
below a VMEM-residency threshold and its float64 reroute are TPU facts and
are not ported.

Otherwise a block-banded matrix, whose 8x8 block-DIA storage is at most
4x nnz (a structured PDE with 8 coupled components per grid point), gets
``"bdia"``: :class:`..formats.BDIA` with the torch-code
:func:`.spmv.spmv_bdia` / :func:`.spmm.spmm_bdia` (the reference's arm is
XLA-level code too).

Every other nonempty matrix takes the general arm, in the reference's
order (``tpu_spmv/ops/auto.py:416-474``):

- a row over 128 entries gives ``"gpr"`` (:mod:`..kernels.gpr`, hub rows
  split into virtual rows), the reference's hub rule;
- otherwise the bytes each kernel would stream, reckoned from the row
  lengths alone before any pack is built (:func:`..bench.roofline.
  ell_matrix_bytes`, :func:`..bench.roofline.gpr_matrix_bytes`): the
  sliced ELL, ``"pallas_ell"`` (:mod:`..kernels.ell_packed`), when its
  bytes are no larger, else ``"gpr"``.

The strategy names are the reference's, so plans carry over.  The
reference's TPU cost models (``pallas_ell_cost_s``, ``gpr_cost_s``), its
``ncol`` envelope and its row chunking are TPU facts and are not ported.
The reference reaches its ``"bsr"`` and ``"ell"`` arms only off its
kernel path (no Pallas general kernel for the matrix); the port's general
kernels cover every matrix, so it has no such arms (the formats themselves
run through :func:`.spmv.spmv`).  An empty matrix gets ``"csr"``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..bench.roofline import ell_matrix_bytes, gpr_matrix_bytes
from ..formats import BDIA, COO, CSR, DIA, to_coo
from ..kernels import dia_stream, ell_packed, gpr
from .spmm import spmm, spmm_bdia
from .spmv import spmv, spmv_bdia
from .transpose import transpose

__all__ = ["PatternStats", "SpmvPlan", "analyze", "plan_spmv",
           "plan_from_matrix", "general_strategy"]


@dataclasses.dataclass(frozen=True)
class PatternStats:
    """Host-side sparsity-pattern statistics."""

    nrow: int
    ncol: int
    nnz: int
    ndiags: int                 # occupied scalar diagonals
    nblockdiags_8: int          # occupied 8x8 block diagonals
    max_row_nnz: int
    avg_row_nnz: float
    block_fill_8: float         # nnz / (8*8 * occupied 8x8 blocks)
    ell_fill: float             # nnz / (nrow * max_row_nnz)


def _host_coo(mat, dtype=None) -> COO:
    """An unsorted host COO over ``mat``'s own arrays (zero-copy where
    the dtypes allow).  A port-format input is read back once here."""
    if not hasattr(mat, "tocoo"):          # a port format
        mat = to_coo(mat).to_scipy()
    m = mat.tocoo()
    coo = COO(row=torch.from_numpy(m.row), col=torch.from_numpy(m.col),
              data=torch.from_numpy(m.data), shape=m.shape,
              rows_sorted=False)
    return coo if dtype is None else coo.astype(dtype)


def _stats(coo: COO) -> PatternStats:
    row = coo.row.numpy().astype(np.int64, copy=False)
    col = coo.col.numpy().astype(np.int64, copy=False)
    nrow, ncol = coo.shape
    nnz = int(row.shape[0])
    if nnz == 0:
        return PatternStats(nrow, ncol, 0, 0, 0, 0, 0.0, 0.0, 0.0)
    # diagonal counts via bincount over the (nrow+ncol)-sized offset range
    ndiags = int((np.bincount(col - row + nrow - 1,
                              minlength=nrow + ncol - 1) > 0).sum())
    max_row = int(np.bincount(row, minlength=nrow).max())
    nbcol = -(-ncol // 8)
    brow, bcol = row // 8, col // 8
    # distinct blocks by sort and count: newer numpy's hash-based
    # np.unique made planning a 32M-entry matrix take 68.7 s on an H100
    # host, against 2.8 s with the sort
    keys = np.sort(brow * nbcol + bcol)
    blocks = int(np.count_nonzero(keys[1:] != keys[:-1])) + 1
    nblockdiags = int((np.bincount(bcol - brow + (-(-nrow // 8)) - 1,
                                   minlength=(-(-nrow // 8)) + nbcol - 1)
                       > 0).sum())
    return PatternStats(
        nrow=nrow, ncol=ncol, nnz=nnz, ndiags=ndiags,
        nblockdiags_8=nblockdiags,
        max_row_nnz=max_row, avg_row_nnz=nnz / max(nrow, 1),
        block_fill_8=nnz / (64.0 * max(blocks, 1)),
        ell_fill=nnz / (float(nrow) * max(max_row, 1)))


def analyze(mat) -> PatternStats:
    """Pattern statistics of a scipy matrix or a port format."""
    return _stats(_host_coo(mat))


#: streaming strategy -> (plain-vector kernel, padded-row-space kernel)
_KERNELS = {"pdia_stream": (dia_stream.spmv_psdia,
                            dia_stream.spmv_psdia_padded),
            "dia_stream": (dia_stream.spmv_sdia, dia_stream.spmv_sdia_padded)}
#: block and general-arm strategy -> kernel (solver_space is the identity
#: for these)
_GENERAL = {"bdia": spmv_bdia, "gpr": gpr.spmv_gpr,
            "pallas_ell": ell_packed.spmv_ell_packed}
#: strategy -> SpMM kernel for ``[ncol, nrhs]`` operands ("dia" and "csr"
#: take :func:`.spmm.spmm`)
_SPMM = {"pdia_stream": dia_stream.spmm_psdia,
         "dia_stream": dia_stream.spmm_sdia, "bdia": spmm_bdia,
         "gpr": gpr.spmm_gpr, "pallas_ell": ell_packed.spmm_ell_packed}
#: strategy -> the strategy of its transpose (the reference's swap table)
_TRANSPOSED = {"csr": "csc", "csc": "csr", "coo": "coo", "dia": "dia",
               "dia_stream": "dia_stream", "pdia_stream": "pdia_stream"}


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    """A chosen execution strategy: the packed matrix and its kernel."""

    matrix: object              # the converted / packed format instance
    strategy: str               # "pdia_stream" | "dia_stream" | "dia" |
    #                             "bdia" | "gpr" | "pallas_ell" | "csr"
    stats: PatternStats | None = None
    _kernel: Callable = spmv

    def __call__(self, x: torch.Tensor,
                 y: torch.Tensor | None = None) -> torch.Tensor:
        return self._kernel(self.matrix, x, y)

    def solver_space(self):
        """``(encode, matvec, decode)`` for running whole solver loops in
        the kernel's native vector space.

        The streaming strategies compute in a padded row space; a solver
        that calls the plan per iteration pays a pad and an unpad pass
        every SpMV.  Solvers ``encode`` once, loop on ``matvec``
        (shape-preserving; the pads stay exactly zero) and ``decode`` the
        result.  Dots and norms over padded vectors are exact because the
        pads are zero.  For every other strategy all three are identities
        or the plan itself."""
        if self.strategy in _KERNELS:
            A = self.matrix
            kern = _KERNELS[self.strategy][1]
            return (lambda v: dia_stream.pad_x(A, v),
                    lambda v: kern(A, v),
                    lambda v: dia_stream.unpad_y(A, v))
        return (lambda v: v), self, (lambda v: v)

    def spmm(self, X: torch.Tensor) -> torch.Tensor:
        """``A @ X`` for ``X [ncol, nrhs]`` (``[nrow, nrhs]``, contiguous)
        with the strategy's SpMM kernel; a non-contiguous ``X`` is copied
        into the kernels' row-major layout first."""
        return _SPMM.get(self.strategy, spmm)(self.matrix, X.contiguous())

    def transpose(self) -> "SpmvPlan":
        """The plan for ``A^T``, on the device (:mod:`.transpose`): CSR ↔
        CSC, COO and DIA in place, the streaming packs through
        ``transpose_sdia`` / ``transpose_psdia`` (the same kernels).  The
        packed and block strategies (``gpr`` / ``pallas_ell`` / ``bdia``,
        whose layouts bake in the row grouping) raise, as in the reference:
        re-plan from the host matrix (``plan_spmv(mat.T)``)."""
        if self.strategy not in _TRANSPOSED:
            raise TypeError(
                f"strategy {self.strategy!r} has no in-place transpose; "
                f"re-plan from the host matrix: plan_spmv(mat.T)")
        return plan_from_matrix(transpose(self.matrix),
                                _TRANSPOSED[self.strategy], self.stats)

    def matvec_differentiable(self, plan_T: "SpmvPlan | None" = None):
        """A matvec ``mv(x)`` differentiable in ``x`` (matrix held fixed):
        its backward is ``x_bar = A^T g``, the forward of ``plan_T``.

        Strategies with an in-place transpose get ``plan_T`` from
        :meth:`transpose`; packed strategies (``gpr`` / ``pallas_ell``)
        pass one, e.g. ``plan_spmv(mat.T)`` (for a symmetric matrix the
        plan itself).  Matrix-value gradients come from the streaming
        packs' own rules (``spmv_sdia`` / ``spmv_psdia``)."""
        if plan_T is None:
            plan_T = self.transpose()
        return functools.partial(_PlanMatvec.apply, self, plan_T)


class _PlanMatvec(torch.autograd.Function):
    """``plan(x)`` whose backward runs ``plan_T(g)``."""

    @staticmethod
    def forward(ctx, plan, plan_T, x):
        ctx.plan_T = plan_T
        return plan(x)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.plan_T(g.contiguous())


def plan_from_matrix(matrix, strategy: str,
                     stats: PatternStats | None = None) -> SpmvPlan:
    """An executable plan from an already converted or packed matrix."""
    kernel = (_KERNELS[strategy][0] if strategy in _KERNELS
              else _GENERAL.get(strategy, spmv))
    return SpmvPlan(matrix, strategy, stats, kernel)


def general_strategy(row_counts: np.ndarray, nnz: int, itemsize: int) -> str:
    """The general arm's pick from the row lengths alone: ``"gpr"`` for a
    row over 128 entries, else the kernel with fewer matrix bytes (ties go
    to ``"pallas_ell"``)."""
    if row_counts.max(initial=0) > gpr.LANES:
        return "gpr"
    width, nslices = ell_packed.slice_slots(row_counts)
    ell = ell_matrix_bytes(int(width.sum()) * ell_packed.SLICE, nslices,
                           itemsize)
    return ("pallas_ell" if ell <= gpr_matrix_bytes(nnz, len(row_counts),
                                                    itemsize)
            else "gpr")


def _no_bf16(strategy: str) -> ValueError:
    return ValueError(
        f"plan_spmv(dtype=bfloat16): the planner picks the {strategy!r} "
        f"arm, which has no bfloat16-coefficient kernel in the port (only "
        f"the streaming-DIA arms, pdia_stream and dia_stream, take bf16 "
        f"data); plan in float32")


def plan_spmv(mat, *, dtype=None, device="cuda") -> SpmvPlan:
    """Analyze ``mat`` (scipy or a port format) on the host and return the
    best-strategy plan with its operator on ``device`` (default: the
    card).

    ``dtype=None`` keeps the matrix's own value type.  Float64 runs
    natively through the kernels.  ``dtype=torch.bfloat16`` stores the
    coefficients in bf16 (the values rounded first, as the reference
    casts its host COO) for float32 vectors: the streaming arms take it
    (K1's bf16-data form, K2 on its pattern widened once), with the tile
    picked for 2-byte coefficients; the planner's other arms raise a
    ``ValueError`` that names the arm.  Duplicate entries are summed
    after the rounding, exactly, then rounded again (the reference sums
    them in bf16)."""
    bf16 = dtype in (torch.bfloat16, "bfloat16")
    hc = _host_coo(mat, None if bf16 else dtype)
    if bf16:
        hc = dataclasses.replace(
            hc, data=hc.data.to(torch.bfloat16).to(torch.float32))
    stats = _stats(hc)
    device = torch.device(device)
    data_dtype = torch.bfloat16 if bf16 else None
    if stats.nnz == 0:
        if bf16:
            raise _no_bf16("csr")
        return plan_from_matrix(CSR.from_coo(hc).to(device), "csr", stats)
    dia_storage = stats.ndiags * stats.nrow
    bdia_storage = stats.nblockdiags_8 * (-(-stats.nrow // 8)) * 64
    # storage ratio is the only criterion: DIA streams at memory speed,
    # so the 4x byte-inflation cap bounds the slowdown at 4x
    if dia_storage <= 4 * stats.nnz and dia_storage <= bdia_storage:
        hdata, hoffs = DIA.host_arrays(hc)
        hdia = DIA(data=torch.from_numpy(hdata), offsets=hoffs,
                   shape=hc.shape, nnz=stats.nnz)
        period = dia_stream.detect_period(hdia)
        if period is not None:
            try:
                # detect_period already proved periodicity on this data
                return plan_from_matrix(
                    dia_stream.pack_psdia(hdia, period=period, verify=False,
                                          device=device,
                                          data_dtype=data_dtype),
                    "pdia_stream", stats)
            except ValueError:
                pass
        itemsize = 2 if bf16 else hdata.dtype.itemsize
        if dia_stream.supports_sdia(hoffs, hc.shape, itemsize=itemsize):
            return plan_from_matrix(
                dia_stream.pack_sdia(hdia, device=device,
                                     data_dtype=data_dtype),
                "dia_stream", stats)
        if bf16:
            raise _no_bf16("dia")
        return plan_from_matrix(hdia.to(device), "dia", stats)
    if bdia_storage <= 4 * stats.nnz:
        if bf16:
            raise _no_bf16("bdia")
        # block-banded: the gather-free block-diagonal contraction
        return plan_from_matrix(BDIA.from_coo(hc, block_size=8).to(device),
                                "bdia", stats)
    if not gpr.supports(hc.shape, stats.nnz):
        if bf16:
            raise _no_bf16("csr")
        return plan_from_matrix(CSR.from_coo(hc).to(device), "csr", stats)
    counts = np.bincount(hc.row.numpy(), minlength=stats.nrow)
    strategy = general_strategy(counts, stats.nnz, hc.dtype.itemsize)
    if bf16:
        raise _no_bf16(strategy)
    host = mat if hasattr(mat, "tocsr") else hc.to_scipy()
    pack = gpr.pack_gpr if strategy == "gpr" else ell_packed.pack_ell
    return plan_from_matrix(pack(host, dtype=hc.dtype, device=device),
                            strategy, stats)
