"""Planner-chosen fast local kernels per shard, and the distributed planner.

Counterpart of ``tpu_spmv/dist/planned.py``.  Shards are uniform
(``global index = shard * C + local``), so each diagonal's x window is a
static slice of ``[left | own | right]`` neighbour chunks:

- :class:`ShardedDIA` runs K8a with whole neighbour chunks as slivers
  (:func:`spmv_dia_sharded`);
- :class:`ShardedSDIA` and :class:`ShardedPSDIA` split a streaming-DIA
  pack's padded row space into whole row tiles per shard and run K8a / K8b
  (:mod:`..kernels.dist_stream`) against two slivers of ``h`` values from
  the ring neighbours — the tail of the previous shard's chunk, the head of
  the next one's.  At one shard both slivers are the shard's own, and the
  wrapped reads meet zero data or masked rows, as in the reference;
- :class:`ShardedBDIA` owns whole block rows per shard and runs the
  torch-code block-diagonal contraction of :func:`..ops.spmv.spmv_bdia` on
  its chunk and two slivers of ``band`` block rows from the ring
  neighbours (:func:`spmv_bdia_sharded`);
- :class:`ShardedGPR` packs each shard's row block with the port's
  ``pack_gpr`` and runs ``gpr_spmv`` over the all-gathered x.

The single controller lets every shard pack its own rows, so the
reference's forced per-shard pack shapes and its 900k-entry routing cap
(SPMD and Clos facts) are not ported.  :func:`plan_dist_spmv` follows the
port's single-chip planner (streaming at every size): a square periodic
band gets ``"pdia_stream"``, then ``"dia_stream"``, then ``"dia"``; a
square block-banded pattern (8x8 block-DIA storage at most 4x nnz)
``"bdia"``; every other nonempty pattern ``"gpr"``; the CSR strategies are
taken when forced, and when GPR cannot pack or the matrix is empty the
general-CSR fallback takes :func:`predict_dist_costs`' pick, as the
reference's planner does.  That model is the reference's (its counts and
formulas) with constants measured on the H100 (``GATHER_GVALS``,
``LINK_GBPS``).  The reference's VMEM size rule and its GPR envelope are
not ported.

``plan_dist_spmv(dtype=torch.bfloat16)`` stores the coefficients in bf16
(rounded once, as the single-chip planner rounds them) for float32
vectors, on every arm: the streaming packs run K8a's bf16-data form and
K8b on the pattern widened once, ``ShardedGPR`` packs ``gpr_spmv``'s
bf16-data form, and the sharded DIA (K8a), the block and the CSR
strategies multiply bf16 values by a float32 x (torch code, float32 sums
by type promotion).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..formats import BDIA, DIA, to_coo
from ..formats.base import torch_dtype
from ..kernels import dia_stream, gpr
from ..kernels.dist_stream import (RingWalkPlan, halo_size, psdia_ring_plan,
                                   spmv_psdia_ring, spmv_sdia_ring)
from ..ops.auto import _host_coo, _stats
from ..ops.spmv import bdia_blocks
from . import blas
from .mesh import Mesh, make_mesh
from .partition import RowPlan, plan_even, plan_rows, plan_uniform
from .sharded import HaloCSR, NeighborCSR, ShardedCSR, ShardedVector
from .spmv import place, spmv_allgather, spmv_halo, spmv_neighbor

__all__ = ["ShardedDIA", "ShardedBDIA", "ShardedSDIA", "ShardedPSDIA",
           "ShardedGPR", "spmv_dia_sharded", "spmv_bdia_sharded",
           "spmv_sdia_sharded", "spmv_psdia_sharded", "spmv_gpr_sharded",
           "DistPlan", "GATHER_GVALS", "LINK_GBPS", "predict_dist_costs",
           "plan_dist_spmv", "bench_dist_spmv"]


def _band(offsets) -> int:
    return max(abs(int(o)) for o in offsets)


def _column_blocks(data: torch.Tensor, ndev: int, C: int):
    """``data [nd, n]`` zero-padded to ``ndev * C`` columns, one
    contiguous ``[nd, C]`` block per shard (no copy for one shard that
    needs no padding)."""
    pad = ndev * C - data.shape[1]
    if pad:
        data = F.pad(data, (0, pad))
    return tuple(data[:, s * C:(s + 1) * C].contiguous()
                 for s in range(ndev))


def _pad_plan(ndev: int, C: int) -> RowPlan:
    return RowPlan(tuple(i * C for i in range(ndev + 1)), ndev, ndev * C)


def _ring(mesh: Mesh, x: ShardedVector, h: int):
    """For each shard ``s``: the last ``h`` values of the previous shard's
    chunk and the first ``h`` of the next one's, on ``s``'s device (the two
    ``ppermute``s; at one shard, both are the shard's own)."""
    n, C = x.ndev, x.chunk_size
    return [(x.chunks[(s - 1) % n][C - h:].to(dev),
             x.chunks[(s + 1) % n][:h].to(dev))
            for s, dev in enumerate(mesh.devices)]


def _check_x(A, x: ShardedVector, plan: RowPlan) -> None:
    if x.starts != plan.starts:
        raise ValueError(f"x is split at {x.starts[:3]}..., the "
                         f"{type(A).__name__} at {plan.starts[:3]}...")


@dataclasses.dataclass(frozen=True)
class ShardedDIA:
    """Row-uniform-sharded DIA: shard ``s`` owns rows ``[s*R, (s+1)*R)``
    (zero-padded past ``nrow``), ``data[s][d, r] = A[s*R + r, s*R + r +
    offsets[d]]``."""

    data: tuple[torch.Tensor, ...]        # [ndiags, R] each
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    nnz: int

    @property
    def ndev(self) -> int:
        return len(self.data)

    @property
    def rows_per_shard(self) -> int:
        return int(self.data[0].shape[1])

    @property
    def row_plan(self) -> RowPlan:
        return plan_uniform(self.shape[0], self.ndev)

    @property
    def x_plan(self) -> RowPlan:
        return plan_uniform(self.shape[1], self.ndev)

    @staticmethod
    def build(dia: DIA, ndev: int) -> "ShardedDIA":
        nrow, ncol = dia.shape
        if nrow != ncol:
            raise ValueError("ShardedDIA requires a square matrix "
                             "(halo windows assume row/col chunk parity)")
        R = plan_uniform(nrow, ndev).max_count
        band = _band(dia.offsets)
        if band > R:
            raise ValueError(f"band {band} exceeds chunk size {R}: the 1-hop "
                             f"halo cannot cover it (use fewer devices or "
                             f"the CSR path)")
        return ShardedDIA(data=_column_blocks(dia.data, ndev, R),
                          offsets=tuple(dia.offsets), shape=tuple(dia.shape),
                          nnz=dia.nnz)


def spmv_dia_sharded(mesh: Mesh, A: ShardedDIA,
                     x: ShardedVector) -> ShardedVector:
    """Row-sharded DIA SpMV: K8a per shard with whole neighbour chunks as
    slivers (``h = R``; global row ``s*R + r`` reads ``[left | own |
    right]`` at ``R + r + off``)."""
    _check_x(A, x, A.x_plan)
    ys = []
    for s, (left, right) in enumerate(_ring(mesh, x, A.rows_per_shard)):
        ys.append(spmv_sdia_ring(A.data[s], A.offsets, x.chunks[s], left,
                                 right))
    return ShardedVector(chunks=tuple(ys), starts=A.row_plan.starts,
                         length=A.shape[0])


@dataclasses.dataclass(frozen=True)
class ShardedBDIA:
    """Block-row-uniform-sharded BDIA: shard ``s`` owns block rows
    ``[s*Rb, (s+1)*Rb)`` (zero-padded past ``nbrow``), ``data[s][d, r] =
    A_block[s*Rb + r, s*Rb + r + offsets[d]]``; its scalar chunk is ``C =
    Rb * bs`` rows and the x chunk of the same span."""

    data: tuple[torch.Tensor, ...]        # [ndiags, Rb, bs, bs] each
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    block_size: int
    nnz: int

    @property
    def ndev(self) -> int:
        return len(self.data)

    @property
    def blocks_per_shard(self) -> int:
        return int(self.data[0].shape[1])

    def _plan(self, length: int) -> RowPlan:
        C = self.blocks_per_shard * self.block_size
        return RowPlan(tuple(min(i * C, length)
                             for i in range(self.ndev + 1)),
                       self.ndev, length)

    @property
    def row_plan(self) -> RowPlan:
        return self._plan(self.shape[0])

    @property
    def x_plan(self) -> RowPlan:
        return self._plan(self.shape[1])

    @property
    def row_starts(self) -> tuple[int, ...]:
        return self.row_plan.starts

    @property
    def col_starts(self) -> tuple[int, ...]:
        return self.x_plan.starts

    @staticmethod
    def build(bdia: BDIA, ndev: int) -> "ShardedBDIA":
        """Shard a BDIA on its own device; raises ``ValueError`` for a
        non-square matrix or a block band wider than a shard's block
        rows (the one-hop halo cannot cover it)."""
        nrow, ncol = bdia.shape
        if nrow != ncol:
            raise ValueError("ShardedBDIA requires a square matrix")
        nbrow = bdia.nbrow
        Rb = max(-(-nbrow // ndev), 1)
        band = _band(bdia.offsets)
        if band > Rb:
            raise ValueError(f"block band {band} exceeds block chunk {Rb}: "
                             f"the 1-hop halo cannot cover it")
        data = bdia.data
        if ndev * Rb > nbrow:
            data = F.pad(data, (0, 0, 0, 0, 0, ndev * Rb - nbrow))
        return ShardedBDIA(data=tuple(data[:, s * Rb:(s + 1) * Rb]
                                      .contiguous() for s in range(ndev)),
                           offsets=tuple(bdia.offsets),
                           shape=tuple(bdia.shape),
                           block_size=bdia.block_size, nnz=bdia.nnz)


def spmv_bdia_sharded(mesh: Mesh, A: ShardedBDIA,
                      x: ShardedVector) -> ShardedVector:
    """Row-sharded BDIA SpMV: each shard receives the last ``band`` block
    rows of the previous shard's chunk and the first ``band`` of the next
    one's and contracts its block diagonals with the static slices of
    ``[left | own | right]`` (global block row ``s*Rb + r`` reads window
    block ``band + r + off``; at one shard the slivers are its own, and
    the wrapped reads meet zero blocks)."""
    _check_x(A, x, A.x_plan)
    Rb, bs = A.blocks_per_shard, A.block_size
    C, band, size = Rb * bs, _band(A.offsets), x.chunk_size
    if size < C:                # the matrix ends inside a shard's last block
        x = dataclasses.replace(x, chunks=tuple(F.pad(c, (0, C - size))
                                                for c in x.chunks))
    ys = []
    for s, (left, right) in enumerate(_ring(mesh, x, band * bs)):
        xw = torch.cat([left, x.chunks[s], right]).reshape(-1, bs)
        y = bdia_blocks(A.data[s], A.offsets, xw, band, Rb).reshape(-1)
        ys.append(y[:size])
    return ShardedVector(chunks=tuple(ys), starts=A.row_plan.starts,
                         length=A.shape[0])


@dataclasses.dataclass(frozen=True)
class ShardedSDIA:
    """Row-sharded streaming DIA: an :class:`~..kernels.dia_stream.SDIA`
    pack's padded row space in whole ``rb`` tiles per shard, ``Cp`` rows
    each; global pad tiles (zero data) past the pack's ``npad``.  x and y
    chunks share this layout, so chains feed y straight back in."""

    data: tuple[torch.Tensor, ...]        # [ndiags, Cp] each
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    nnz: int
    L: int                                # global front pad rows
    rb: int

    @property
    def ndev(self) -> int:
        return len(self.data)

    @property
    def rows_per_shard(self) -> int:
        return int(self.data[0].shape[1])

    @property
    def npad(self) -> int:
        return self.ndev * self.rows_per_shard

    @property
    def halo(self) -> int:
        """The sliver length ``h`` each shard receives from each side."""
        return halo_size(self.offsets, self.rb)

    @property
    def pad_plan(self) -> RowPlan:
        return _pad_plan(self.ndev, self.rows_per_shard)

    @staticmethod
    def build(sdia, ndev: int) -> "ShardedSDIA":
        """Shard a pack on its own device: ``Cp = ceil(T / ndev) * rb`` for
        the pack's ``T`` row tiles."""
        rb = sdia.rb
        if _band(sdia.offsets) > rb:
            raise ValueError(f"band {_band(sdia.offsets)} exceeds tile {rb}")
        Cp = -(-(sdia.npad // rb) // ndev) * rb
        return ShardedSDIA(data=_column_blocks(sdia.data, ndev, Cp),
                           offsets=tuple(sdia.offsets),
                           shape=tuple(sdia.shape), nnz=sdia.nnz, L=sdia.L,
                           rb=rb)

    def shard_xpad(self, xpad: torch.Tensor) -> ShardedVector:
        """Split a padded-row-space vector (``kernels.dia_stream.pad_x``
        layout, zero-extended to ``npad``) into the shards' chunks, on
        ``xpad``'s device."""
        return _shard_xpad(self, xpad)

    def unshard_y(self, y: ShardedVector) -> np.ndarray:
        """The global ``[nrow]`` result of padded shard chunks (host)."""
        return _unshard_y(self, y)


def _shard_xpad(A, xpad: torch.Tensor) -> ShardedVector:
    if xpad.shape[0] < A.npad:
        xpad = F.pad(xpad, (0, A.npad - xpad.shape[0]))
    return ShardedVector(chunks=tuple(xpad.split(A.rows_per_shard)),
                         starts=A.pad_plan.starts, length=A.npad)


def _unshard_y(A, y: ShardedVector) -> np.ndarray:
    return y.to_global()[A.L:A.L + A.shape[0]]


def spmv_sdia_sharded(mesh: Mesh, A: ShardedSDIA,
                      x: ShardedVector) -> ShardedVector:
    """Row-sharded streaming-DIA SpMV in padded row space: each shard
    receives the tail of the previous shard's chunk and the head of the
    next one's (``h`` values each) and runs K8a on its chunk."""
    _check_x(A, x, A.pad_plan)
    ys = []
    for s, (left, right) in enumerate(_ring(mesh, x, A.halo)):
        ys.append(spmv_sdia_ring(A.data[s], A.offsets, x.chunks[s], left,
                                 right))
    return ShardedVector(chunks=tuple(ys), starts=A.pad_plan.starts,
                         length=A.npad)


@dataclasses.dataclass(frozen=True)
class ShardedPSDIA:
    """Row-sharded periodic streaming DIA: the
    :class:`~..kernels.dia_stream.PSDIA` pack's padded row space in whole
    ``rb`` tiles per shard (``Cp`` a multiple of ``rb``, so the pattern
    phase is the same on every shard and one copy serves), the ``[ndiags,
    rb]`` pattern on every shard; rows outside ``[L, L + nrow)`` are
    masked by the global row ``s * Cp + k``."""

    pattern: tuple[torch.Tensor, ...]     # [ndiags, rb] each (replicated)
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    nnz: int
    L: int                                # global front pad rows
    period: int
    rb: int
    rows_per_shard: int                   # Cp

    @property
    def ndev(self) -> int:
        return len(self.pattern)

    @property
    def npad(self) -> int:
        return self.ndev * self.rows_per_shard

    @property
    def halo(self) -> int:
        return halo_size(self.offsets, self.rb)

    @property
    def pad_plan(self) -> RowPlan:
        return _pad_plan(self.ndev, self.rows_per_shard)

    @functools.cached_property
    def ring_plan(self) -> RingWalkPlan:
        """K8b's walk over a shard (:func:`psdia_ring_plan` for the pack's
        offsets, period and the type of its sums: a bf16 pattern runs
        widened, against float32 vectors), planned once and kept with the
        pack."""
        pat = self.pattern[0]
        itemsize = 4 if pat.dtype == torch.bfloat16 else pat.element_size()
        return psdia_ring_plan(self.offsets, self.period, itemsize)

    @staticmethod
    def build(psdia, ndev: int) -> "ShardedPSDIA":
        rb = psdia.rb
        if _band(psdia.offsets) > rb:
            raise ValueError(f"band {_band(psdia.offsets)} exceeds tile {rb}")
        Cp = -(-(psdia.npad // rb) // ndev) * rb
        return ShardedPSDIA(pattern=(psdia.pattern,) * ndev,
                            offsets=tuple(psdia.offsets),
                            shape=tuple(psdia.shape), nnz=psdia.nnz,
                            L=psdia.L, period=psdia.period, rb=rb,
                            rows_per_shard=Cp)

    def shard_xpad(self, xpad: torch.Tensor) -> ShardedVector:
        return _shard_xpad(self, xpad)

    def unshard_y(self, y: ShardedVector) -> np.ndarray:
        return _unshard_y(self, y)


def spmv_psdia_sharded(mesh: Mesh, A: ShardedPSDIA,
                       x: ShardedVector) -> ShardedVector:
    """Row-sharded periodic streaming-DIA SpMV in padded row space: the
    :func:`spmv_sdia_sharded` ring with K8b, the shard's first padded row
    ``s * Cp`` as the row mask's origin."""
    _check_x(A, x, A.pad_plan)
    Cp = A.rows_per_shard
    ys = []
    for s, (left, right) in enumerate(_ring(mesh, x, A.halo)):
        ys.append(spmv_psdia_ring(A.pattern[s], A.offsets, x.chunks[s], left,
                                  right, base=s * Cp, L=A.L, nrow=A.shape[0],
                                  plan=A.ring_plan))
    return ShardedVector(chunks=tuple(ys), starts=A.pad_plan.starts,
                         length=A.npad)


@dataclasses.dataclass(frozen=True)
class ShardedGPR:
    """Row-sharded GPR: shard ``s`` holds its ``plan_uniform`` row block,
    padded with empty rows to ``R``, packed on its own by the port's
    :func:`~..kernels.gpr.pack_gpr` against the full column space."""

    gpcsr: tuple[gpr.GPCSR, ...]
    shape: tuple[int, int]
    row_starts: tuple[int, ...]
    nnz: int

    @property
    def ndev(self) -> int:
        return len(self.gpcsr)

    @property
    def rows_per_shard(self) -> int:
        return self.gpcsr[0].shape[0]

    @property
    def row_plan(self) -> RowPlan:
        return RowPlan(self.row_starts, self.ndev, self.shape[0])

    @property
    def x_plan(self) -> RowPlan:
        return plan_uniform(self.shape[1], self.ndev)

    @staticmethod
    def build(sp_csr, ndev: int, *, dtype=None) -> "ShardedGPR":
        """Pack each shard's rows of a scipy matrix on the CPU
        (``dtype=None`` keeps the matrix's value type, as ``pack_gpr``);
        raises ``ValueError`` where ``pack_gpr`` cannot pack."""
        import scipy.sparse as sp

        sp_csr = sp_csr.tocsr()
        nrow, ncol = sp_csr.shape
        rplan = plan_uniform(nrow, ndev)
        R = rplan.max_count
        packs = []
        for i in range(ndev):
            m = sp_csr[rplan.starts[i]:rplan.starts[i + 1]]
            if m.shape[0] < R:
                m = sp.vstack([m, sp.csr_matrix((R - m.shape[0], ncol),
                                                dtype=m.dtype)])
            packs.append(gpr.pack_gpr(m, dtype=dtype, device="cpu"))
        return ShardedGPR(gpcsr=tuple(packs), shape=(int(nrow), int(ncol)),
                          row_starts=rplan.starts, nnz=int(sp_csr.nnz))


def spmv_gpr_sharded(mesh: Mesh, A: ShardedGPR,
                     x: ShardedVector) -> ShardedVector:
    """Row-sharded GPR SpMV: each shard gathers all x chunks and runs
    ``gpr_spmv`` and the virtual-row fold on its pack."""
    _check_x(A, x, A.x_plan)
    ys = []
    for s, dev in enumerate(mesh.devices):
        xg = torch.cat([c.to(dev) for c in x.chunks])[:A.shape[1]]
        ys.append(gpr.spmv_gpr(A.gpcsr[s], xg))
    return ShardedVector(chunks=tuple(ys), starts=A.row_starts,
                         length=A.shape[0])


# ---------------------------------------------------------------------------
# The distributed planner
# ---------------------------------------------------------------------------

_SPMV = {"dia": spmv_dia_sharded, "dia_stream": spmv_sdia_sharded,
         "pdia_stream": spmv_psdia_sharded, "bdia": spmv_bdia_sharded,
         "gpr": spmv_gpr_sharded,
         "csr_neighbor": spmv_neighbor, "csr_allgather": spmv_allgather,
         "csr_halo": spmv_halo}
_STREAMING = ("dia_stream", "pdia_stream")


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """A chosen distributed strategy: the sharded container, placed on
    ``mesh``; ``shard_x`` / ``y_to_global`` move vectors between global
    host arrays and the mesh; ``spmv`` runs one distributed SpMV."""

    matrix: object
    strategy: str   # "dia" | "dia_stream" | "pdia_stream" | "bdia" | "gpr"
    #                 | "csr_neighbor" | "csr_allgather" | "csr_halo"
    x_plan: RowPlan
    row_plan: RowPlan
    mesh: Mesh

    def shard_x(self, x, dtype=None) -> ShardedVector:
        """A global ``[ncol]`` vector (numpy or tensor) split over the
        mesh; the streaming strategies put ``x[i]`` at padded position
        ``L + i``."""
        x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        if self.strategy in _STREAMING:
            S = self.matrix
            xp = np.zeros(S.npad, dtype=x.dtype)
            xp[S.L:S.L + len(x)] = x
            x = xp
        return place(ShardedVector.from_global(x, self.x_plan, dtype=dtype),
                     self.mesh)

    def y_to_global(self, y: ShardedVector) -> np.ndarray:
        g = y.to_global()
        if self.strategy in _STREAMING:
            S = self.matrix
            return g[S.L:S.L + S.shape[0]]
        return g

    def spmv(self, x: ShardedVector) -> ShardedVector:
        return _SPMV[self.strategy](self.mesh, self.matrix, x)


#: the distributed cost model's constants, measured by ``chip_smoke.py``
#: (phase 4j) on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit.
#: ``GATHER_GVALS``: G values/s of the CSR strategies' local product (the
#: per-shard gather and ``segment_reduce`` of :mod:`.spmv`) on the 2048^2
#: Poisson at one shard (20,963,328 values in 5.21 ms).  ``LINK_GBPS``:
#: GB/s of a copy between two shards' buffers; with every shard on one
#: card that is a device-to-device copy (``copy_`` of one shard's 4 MiB
#: chunk of that Poisson at 4 shards, one launch a copy: 12.3 us), not a
#: link between cards, which no run has measured.
GATHER_GVALS = 4.03
LINK_GBPS = 341.2


def predict_dist_costs(sp_csr, ndev: int, *, balance: str = "nnz",
                       square: bool = False, itemsize: int = 4,
                       link_gbps: float = LINK_GBPS,
                       gather_gvals: float = GATHER_GVALS) -> dict:
    """The reference's analytic per-SpMV cost model of the general-CSR
    strategies (``csr_neighbor``, ``csr_allgather``, ``csr_halo``).

    All three run the same gather and segment-sum local product, so each
    strategy costs its padded gather work (values at ``gather_gvals`` G
    values/s) and its x-chunk traffic (bytes at ``link_gbps`` GB/s); the
    neighbour strategy's halo transfer counts as overlapped with its
    interior bucket, and the ring pays ``ndev x`` its largest bucket.
    Returns ``{strategy: {"predicted_us", "work_vals", "comm_bytes"}}``
    (``csr_neighbor`` also ``"halo_offsets"``) and ``"pick"``, the
    argmin."""
    import scipy.sparse as sp

    csr = (sp_csr if sp.issparse(sp_csr)
           else to_coo(sp_csr).to_scipy()).tocsr()
    nrow, ncol = csr.shape
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    rplan = plan_rows(indptr, ndev, balance=balance)
    cplan = rplan if (square and nrow == ncol) else plan_even(ncol, ndev)
    C = max(cplan.max_count, 1)
    cols = np.asarray(csr.indices, dtype=np.int64)
    row_ids = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(indptr))
    shard = rplan.owner_of(row_ids)
    owner = cplan.owner_of(cols)
    delta = (owner - shard) % ndev
    interior = delta == 0
    nnzp = max(int(np.bincount(shard, minlength=ndev).max()), 1)
    nnzi = max(int(np.bincount(shard[interior], minlength=ndev).max()), 1)
    nnzb = max(int(np.bincount(shard[~interior], minlength=ndev).max()), 0)
    k = len(np.unique(delta[~interior]))              # halo offsets
    ring_bucket = max(int(np.bincount(shard * ndev + delta,
                                      minlength=ndev * ndev).max()), 1)
    rate = gather_gvals * 1e9
    bw = link_gbps * 1e9
    chunk_bytes = C * itemsize
    ag_work, ag_comm = nnzp, (ndev - 1) * chunk_bytes
    t_ag = ag_work / rate + ag_comm / bw              # x lands, then compute
    nb_comm = k * chunk_bytes
    # the halo transfers overlap the interior bucket's compute
    t_nb = max(nnzi / rate, nb_comm / bw) + nnzb / rate
    ring_work = ndev * ring_bucket
    t_ring = max(ring_work / rate, (ndev - 1) * chunk_bytes / bw)
    out = {
        "csr_allgather": {"predicted_us": round(t_ag * 1e6, 2),
                          "work_vals": int(ag_work),
                          "comm_bytes": int(ag_comm)},
        "csr_neighbor": {"predicted_us": round(t_nb * 1e6, 2),
                         "work_vals": int(nnzi + nnzb),
                         "comm_bytes": int(nb_comm),
                         "halo_offsets": int(k)},
        "csr_halo": {"predicted_us": round(t_ring * 1e6, 2),
                     "work_vals": int(ring_work),
                     "comm_bytes": int((ndev - 1) * chunk_bytes)},
    }
    out["pick"] = min(("csr_neighbor", "csr_allgather", "csr_halo"),
                      key=lambda s: out[s]["predicted_us"])
    return out


def plan_dist_spmv(host_mat, mesh, *, dtype=None, strategy: str | None = None,
                   sdia_rb: int | None = None) -> DistPlan:
    """Analyze ``host_mat`` (scipy or a port format) on the host, shard it
    for the strategy's local kernel and place it on ``mesh`` (a
    :class:`~.mesh.Mesh`, or a shard count for one shard per card).

    ``dtype=None`` keeps the matrix's value type; ``torch.bfloat16`` stores
    bf16 coefficients for float32 vectors (module docstring); ``strategy``
    forces a choice; ``sdia_rb`` sets the streaming row tile (tests use
    small tiles).  The picks are in the module docstring."""
    if not isinstance(mesh, Mesh):
        mesh = make_mesh(mesh)
    ndev = mesh.ndev
    if strategy not in (None, *_SPMV):
        raise ValueError(f"unknown or unported distributed strategy "
                         f"{strategy!r}; valid: {', '.join(_SPMV)}")
    bf16 = dtype in (torch.bfloat16, "bfloat16")
    coo = _host_coo(host_mat, None if bf16 else dtype)
    if bf16:
        # rounded once, held as float32 on the host (numpy has no bf16)
        coo = dataclasses.replace(
            coo, data=coo.data.to(torch.bfloat16).to(torch.float32))
    data_dtype = torch.bfloat16 if bf16 else None
    cast = _to_bf16 if bf16 else (lambda A: A)
    stats = _stats(coo)
    nrow, ncol = coo.shape
    square = nrow == ncol

    def host_dia() -> DIA:
        hdata, hoffs = DIA.host_arrays(coo)
        return DIA(data=torch.from_numpy(hdata), offsets=hoffs,
                   shape=coo.shape, nnz=stats.nnz)

    def try_dia():
        A = ShardedDIA.build(host_dia(), ndev)       # raises if band > chunk
        return DistPlan(cast(A), "dia", A.x_plan, A.row_plan, mesh)

    def try_sdia():
        A = ShardedSDIA.build(dia_stream.pack_sdia(
            host_dia(), rb=sdia_rb, data_dtype=data_dtype), ndev)
        return DistPlan(A, "dia_stream", A.pad_plan, A.pad_plan, mesh)

    def try_psdia():
        hdia = host_dia()
        period = dia_stream.detect_period(hdia)
        if period is None:
            raise ValueError("no periodic diagonal structure")
        # detect_period proved the period on this same host data
        A = ShardedPSDIA.build(dia_stream.pack_psdia(
            hdia, period=period, rb=sdia_rb, verify=False,
            data_dtype=data_dtype), ndev)
        return DistPlan(A, "pdia_stream", A.pad_plan, A.pad_plan, mesh)

    def try_bdia():
        A = ShardedBDIA.build(BDIA.from_coo(coo, block_size=8), ndev)
        return DistPlan(cast(A), "bdia", A.x_plan, A.row_plan, mesh)

    arms = {"dia": try_dia, "dia_stream": try_sdia, "pdia_stream": try_psdia,
            "bdia": try_bdia}
    if strategy in arms:
        return _placed(arms[strategy]())
    if strategy is None and square and stats.nnz:
        dia_storage = stats.ndiags * stats.nrow
        bdia_storage = stats.nblockdiags_8 * (-(-stats.nrow // 8)) * 64
        if dia_storage <= 4 * stats.nnz and dia_storage <= bdia_storage:
            for arm in (try_psdia, try_sdia, try_dia):
                try:
                    return _placed(arm())
                except ValueError:
                    pass
        if bdia_storage <= 4 * stats.nnz:
            try:
                return _placed(try_bdia())
            except ValueError:
                pass
    sp_csr = coo.to_scipy().tocsr()
    sp_csr.sort_indices()
    if strategy == "gpr" or (strategy is None and stats.nnz):
        try:
            A = ShardedGPR.build(sp_csr, ndev, dtype=data_dtype or coo.dtype)
            return _placed(DistPlan(A, "gpr", A.x_plan, A.row_plan, mesh))
        except ValueError:
            if strategy == "gpr":
                raise
    if strategy is None:
        # the general-CSR fallback: the cost model's pick
        strategy = predict_dist_costs(sp_csr, ndev, square=square)["pick"]
    cls = {"csr_neighbor": NeighborCSR, "csr_allgather": ShardedCSR,
           "csr_halo": HaloCSR}[strategy]
    A = cls.build(sp_csr, ndev, square=square)
    return _placed(DistPlan(cast(A), strategy, A.col_plan, A.row_plan, mesh))


def _to_bf16(A):
    """A sharded container with its value arrays (``data``, or NeighborCSR's
    ``data_int`` / ``data_bnd``) in bf16: they hold bf16-rounded values,
    so the cast is exact."""
    return dataclasses.replace(A, **{
        f.name: tuple(t.to(torch.bfloat16) for t in getattr(A, f.name))
        for f in dataclasses.fields(A)
        if f.name in ("data", "data_int", "data_bnd")})


def _placed(plan: DistPlan) -> DistPlan:
    return dataclasses.replace(plan, matrix=place(plan.matrix, plan.mesh))


def bench_dist_spmv(host_mat, mesh, *, dtype=None, iters: int = 50,
                    check: bool = True, quiet: bool = False,
                    strategy: str | None = None,
                    plan: DistPlan | None = None) -> dict:
    """Benchmark the planned distributed SpMV over ``mesh`` with the chained
    protocol ``v <- (A v) / ||A||_inf`` and print ``### CSR DIST<ndev>
    GFLOPS`` and the strategy line.

    ``dtype=None`` is float32; ``torch.bfloat16`` plans bf16 coefficients
    for float32 vectors and holds the product to the oracle's bf16 gate
    (2e-2 against the unrounded ``host_mat``).  ``plan`` runs an already
    built plan on its mesh (``host_mat`` is then the oracle only).  Square
    matrices only: the chain feeds y chunks back as x chunks."""
    import scipy.sparse as sp

    from ..bench.harness import time_chained, verify_against_oracle

    dt = torch_dtype(np.float32 if dtype is None else dtype)
    if plan is None:
        plan = plan_dist_spmv(host_mat, mesh, dtype=dt, strategy=strategy)
    elif plan.mesh != mesh:
        raise ValueError("the plan is placed on another mesh")
    ndev = plan.mesh.ndev
    nrow, ncol = plan.matrix.shape
    if nrow != ncol:
        raise ValueError("bench_dist_spmv requires a square matrix")
    x = np.random.default_rng(0).random(ncol).astype(
        np.float64 if dt == torch.float64 else np.float32)
    xs = plan.shard_x(x)
    host = (host_mat if sp.issparse(host_mat)
            else to_coo(host_mat).to_scipy()).tocsr().astype(np.float64)
    rel = float("nan")
    if check:
        # the harness's gate: dtype-scaled tolerance, raises on failure
        rel = verify_against_oracle(
            plan.matrix, torch.from_numpy(x),
            torch.from_numpy(plan.y_to_global(plan.spmv(xs))), oracle=host,
            data_dtype=dt)
    scale = 1.0 / max(float(abs(host).sum(axis=1).max()), 1e-300)
    sec = time_chained(lambda v: blas.scale(plan.spmv(v), scale), xs,
                       iters=iters).median_s
    gflops = 2 * plan.matrix.nnz / sec / 1e9
    if not quiet:
        print(f"### CSR DIST{ndev} GFLOPS = {gflops:.5f}")
        print(f"    DIST{ndev}: strategy={plan.strategy} | "
              f"{sec * 1e3:.3f} ms/iter | rel_err={rel:.2e}")
    return {"format": "CSR", "mode": f"DIST{ndev}", "gflops": gflops,
            "seconds": sec, "strategy": plan.strategy, "rel_err": rel,
            "ndev": ndev, "iters": iters}
