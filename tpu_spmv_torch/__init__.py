"""tpu_spmv_torch — the PyTorch and CUDA port of tpu_spmv for NVIDIA Hopper.

The port mirrors the JAX reference package ``tpu_spmv`` module for module
and is held against it in the tests.  It imports neither JAX nor the
reference package.

- **Formats** (:mod:`.formats`): COO, CSR, CSC, ELL, DIA, BSR, BDIA as
  dataclasses of tensors.
- **Ops** (:mod:`.ops`): deterministic SpMV per format, BLAS-1, the
  planner :func:`plan_spmv` that picks and packs the operator, transpose
  and diagonal shift.
- **Kernels** (:mod:`.kernels`): hand-written CUDA kernels (``csrc/``)
  for the streaming DIA operators, the general-sparsity arm (GPR and
  sliced ELL) and the permutation engine, built at first use, each beside
  its plain PyTorch version (the probe kernels live in
  :mod:`.bench.probes`).
- **Reorder** (:mod:`.reorder`): RCM reordering, ``reorder_plan`` and the
  ``ReorderedOperator`` that permutes on the device.
- **Solvers** (:mod:`.solvers`): CG, multi-RHS CG, distributed CG,
  BiCGSTAB, GMRES, LSQR, Chebyshev, Lanczos, power iteration, multicolor
  SOR / SymGS, geometric multigrid and mixed-precision iterative
  refinement on bf16-data plans.
- **Dist** (:mod:`.dist`): row-partitioned sharding over a mesh of devices
  (one device may hold several shards), the distributed planner and its
  sharded kernels.
- **I/O** (:mod:`.io`): MatrixMarket read/write.
- **Bench** (:mod:`.bench`): the ``### <FMT> <MODE> GFLOPS`` protocol, a
  roofline against the card's measured copy bandwidth, and the probe
  path (bandwidth, launch cost, lane sums, in-tile gathers).
- **Interop** (:mod:`.interop`): operators packed by the reference carried
  over unchanged.
"""

from __future__ import annotations

from . import dist, reorder, solvers
from .formats import (BDIA, BSR, COO, CSC, CSR, DIA, ELL, FORMATS, convert,
                      to_coo)
from .interop import from_reference
from .io import read_matrix, write_matrix
from .kernels import (GPCSR, PSDIA, SDIA, PackedELL, PermutationPlan,
                      apply_permutation, apply_permutation_batched, pack_ell,
                      pack_gpr, pack_psdia, pack_sdia, plan_permutation,
                      spmv_ell_packed, spmv_gpr)
from .ops import (SpmvPlan, allclose, analyze, axpby, axpy, check_vector,
                  dot, fill, fill_random, norm2, plan_spmv, scale, shift,
                  shift_diagonal, spmv, transpose)
from .reorder import ReorderedOperator, reorder_plan

__version__ = "0.1.0"

__all__ = [
    "COO", "CSR", "CSC", "ELL", "DIA", "BSR", "BDIA", "FORMATS", "convert",
    "to_coo",
    "SDIA", "PSDIA", "pack_sdia", "pack_psdia",
    "GPCSR", "pack_gpr", "spmv_gpr", "PackedELL", "pack_ell",
    "spmv_ell_packed",
    "PermutationPlan", "plan_permutation", "apply_permutation",
    "apply_permutation_batched", "ReorderedOperator", "reorder_plan",
    "spmv", "plan_spmv", "analyze", "SpmvPlan", "transpose",
    "shift_diagonal",
    "dot", "axpby", "axpy", "fill", "fill_random", "scale", "shift",
    "norm2", "check_vector", "allclose",
    "read_matrix", "write_matrix", "from_reference", "solvers", "dist",
    "reorder",
    "__version__",
]
