"""Sharded streaming DIA — the per-shard kernels K8a (SDIA) and K8b (PSDIA)
of the distributed streaming strategies.

Counterpart of the ring kernels of ``tpu_spmv/dist/planned.py``
(``_sdia_ring_kernel``, ``_psdia_ring_kernel``).  One call computes one
shard of :mod:`..dist.planned`'s ``ShardedSDIA`` / ``ShardedPSDIA``: the
shard's ``cp`` padded rows from its own x chunk and two received slivers of
``h`` values, ``left`` (the tail of the previous shard's chunk) and
``right`` (the head of the next shard's chunk).  With ``xw`` the window
``[left | x | right]`` read at offset ``h``, local row ``k`` is

    y[k] = sum_d coef(d, k) * xw[h + k + off_d]

with ``coef(d, k) = data[d, k]`` (K8a) or ``pattern[d, k mod rb]`` (K8b,
rows whose global padded index ``base + k`` leaves ``[L, L + nrow)`` are
zero).

On a CUDA tensor the wrappers launch the hand-written Hopper kernels of
``csrc/dist_stream.cu`` (built at first use, :mod:`._build`) and count the
launch in :data:`LAUNCHES`; on a CPU tensor they run the plain PyTorch
versions beside them (``*_ref``).  Nothing falls back from one to the other.

K8b stages windows of ``[left | x | right]`` and the pattern's rows in
shared memory along a walk that :func:`psdia_ring_plan` picks on the host
(K3b's two walks at one right-hand side,
:func:`.dia_stream.psdia_spmm_plan`), once per sharded pack
(``ShardedPSDIA.ring_plan``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build
from . import dia_stream as _ds
from .dia_stream import _MAX_DIAGS, _offsets_on

__all__ = ["LAUNCHES", "halo_size", "spmv_sdia_ring", "spmv_sdia_ring_ref",
           "RingWalkPlan", "ring_cluster_walk", "psdia_ring_plan",
           "check_ring_walk",
           "spmv_psdia_ring", "spmv_psdia_ring_ref"]

#: kernel launches by the wrappers on CUDA tensors, one per shard (plain-
#: version calls on CPU tensors are not counted)
LAUNCHES = {"sdia_ring": 0, "psdia_ring": 0}
#: K8b's tile (``kRingTile`` in ``csrc/dist_stream.cu``): 256 threads of 4
#: rows, K3b's tile at one right-hand side
RING_TILE = 1024
#: slots of the cluster walk's ring (``kRingStages``)
RING_STAGES = _ds.SPMM_STAGES


def halo_size(offsets, rb: int) -> int:
    """The sliver length: the smallest power-of-two divisor of ``rb`` from
    ``min(1024, rb)`` up that covers the widest offset, else ``rb`` (the
    reference's ``kernels/dia_stream.py:_halo_size``, so the slivers are
    the reference's)."""
    need = max(max(abs(int(o)) for o in offsets), 1)
    h = min(1024, rb)
    while (h < need or rb % h) and h < rb:
        h *= 2
    return h if rb % h == 0 and h >= need else rb


def _shifted(x: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
             offsets):
    """``xw[h + k + off]`` for every local row ``k``, one tensor per
    offset."""
    h, cp = left.shape[0], x.shape[0]
    xw = torch.cat([left, x, right])
    return [xw[h + off:h + off + cp] for off in offsets]


def spmv_sdia_ring_ref(data: torch.Tensor, offsets, x: torch.Tensor,
                       left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8a: shifted windows of ``[left | x |
    right]`` times the diagonal data, summed in ascending offset order."""
    xs = _shifted(x, left, right, offsets)
    acc = data[0] * xs[0]
    for d in range(1, len(offsets)):
        acc = acc + data[d] * xs[d]
    return acc


def spmv_psdia_ring_ref(pattern: torch.Tensor, offsets, x: torch.Tensor,
                        left: torch.Tensor, right: torch.Tensor, *,
                        base: int, L: int, nrow: int) -> torch.Tensor:
    """Plain PyTorch version of K8b: the same sum with the pattern tiled
    over the shard's row tiles, then the row mask at the shard's origin
    ``base``."""
    reps = x.shape[0] // pattern.shape[1]
    xs = _shifted(x, left, right, offsets)
    acc = pattern[0].repeat(reps) * xs[0]
    for d in range(1, len(offsets)):
        acc = acc + pattern[d].repeat(reps) * xs[d]
    rows = base + torch.arange(x.shape[0], device=x.device)
    valid = (rows >= L) & (rows < L + nrow)
    return torch.where(valid, acc, torch.zeros_like(acc))


@dataclasses.dataclass(frozen=True)
class RingWalkPlan:
    """K8b's walk over a shard (:func:`psdia_ring_plan`), in tiles of
    :data:`RING_TILE` rows.

    - ``stride == 0``, the cluster walk: cluster ``c`` is diagonals
      ``starts[c]:starts[c + 1]``; for the tile at local row ``k0`` its
      window is columns ``k0 + a0[c] .. k0 + a0[c] + width[c]`` of the
      ring ``[left | x | right]`` (column 0 is ``x[0]``), staged with the
      cluster's coefficient rows in a ring of :data:`RING_STAGES` slots.
    - ``stride == M > 0``, the stride walk: one window a tile, columns
      ``k0 + a0[0] .. k0 + a0[0] + width[0]``; diagonal ``d`` reads the
      window of the tile ``jd[d] * M`` tiles away, so a tile reads
      ``jspan`` windows and the ring holds those and one in flight.  With
      ``reuse`` (``M * RING_TILE`` a multiple of the pattern's period)
      every tile of a segment has the same coefficient rows and a block
      stages them once per segment, ahead of the ring; otherwise each slot
      holds a tile's rows before its window.

    ``slot`` elements a slot, ``smem_bytes`` a block."""

    stride: int
    starts: tuple[int, ...]
    a0: tuple[int, ...]
    width: tuple[int, ...]
    jd: tuple[int, ...]
    slot: int
    reuse: bool
    smem_bytes: int

    @property
    def nclusters(self) -> int:
        return len(self.a0)

    @property
    def jspan(self) -> int:
        """Consecutive column positions whose windows a tile reads (0 on
        the cluster walk)."""
        return max(self.jd) - min(self.jd) + 1 if self.stride else 0

    @property
    def nslot(self) -> int:
        """Slots in the ring, a constant of the walk (the kernel's
        launcher derives it the same way)."""
        return self.jspan + 1 if self.stride else RING_STAGES

    @property
    def table(self) -> tuple[int, ...]:
        """What the kernel reads: the cluster walk's starts, window starts
        and widths (K3b's ``SpmmWindowPlan.table``), or the stride walk's
        lowest ``jd``, window start, width and every ``jd``."""
        if not self.stride:
            return self.starts + self.a0 + self.width
        return (min(self.jd), self.a0[0], self.width[0]) + self.jd


def ring_cluster_walk(offsets: tuple[int, ...],
                      itemsize: int) -> RingWalkPlan:
    """K8b's cluster walk: K3b's at one right-hand side
    (``dia_stream._cluster_walk``), which every operand has."""
    k3b = _ds._cluster_walk(tuple(int(o) for o in offsets), 1, itemsize)
    assert k3b.tk == RING_TILE and k3b.nslot == RING_STAGES
    return RingWalkPlan(stride=0, starts=k3b.starts, a0=k3b.a0,
                        width=k3b.width, jd=(), slot=k3b.slot, reuse=False,
                        smem_bytes=k3b.smem_bytes)


@functools.lru_cache(maxsize=256)
def psdia_ring_plan(offsets: tuple[int, ...], period: int,
                    itemsize: int) -> RingWalkPlan:
    """K8b's walk for the diagonal ``offsets`` (stored order), a pattern of
    ``period`` (any multiple of the true period is safe: ``rb`` always is)
    and values of ``itemsize`` bytes, chosen as K3b chooses at one
    right-hand side (:func:`.dia_stream.psdia_spmm_plan`): the stride walk
    (``dia_stream._stride_walk``) where its window is narrower than the
    cluster walk's windows together (:func:`ring_cluster_walk`), else the
    cluster walk; windows on 16-byte boundaries.  The stride walk reuses
    the coefficient rows where its stride is a multiple of ``period``, and
    keeps one window in flight beside the ``jspan`` it reads (three blocks
    an SM, the kernel's register cap: more windows in flight were slower
    on the card)."""
    offsets = tuple(int(o) for o in offsets)
    clusters = ring_cluster_walk(offsets, itemsize)
    k3b = _ds._stride_walk(offsets, 1, itemsize)
    if k3b is None or k3b.width[0] >= sum(clusters.width):
        return clusters
    nd, w = len(offsets), k3b.width[0]
    jspan = max(k3b.jd) - min(k3b.jd) + 1
    reuse = k3b.stride * RING_TILE % int(period) == 0
    coef = nd * RING_TILE if reuse else 0
    slot = _ds._roundup(w if reuse else nd * RING_TILE + w, 4)
    return RingWalkPlan(
        stride=k3b.stride, starts=(0, nd), a0=k3b.a0, width=(w,),
        jd=k3b.jd, slot=slot, reuse=reuse,
        smem_bytes=((jspan + 1) * slot + coef) * itemsize)


@functools.lru_cache(maxsize=256)
def check_ring_walk(plan: RingWalkPlan, offsets: tuple[int, ...],
                    itemsize: int) -> None:
    """Raise ``ValueError`` where K8b could not run ``plan`` on the
    diagonal ``offsets`` (stored order) with values of ``itemsize`` bytes:
    every row of a tile must read inside a staged window, windows and
    slots on 16-byte boundaries, each slot large enough for what is
    staged in it, the ring inside the shared-memory budget.  ``reuse`` is
    the pack's claim that the stride is a multiple of the pattern's period
    (``pack_psdia`` verifies the period) and is taken as given."""
    nd, vec = len(offsets), 16 // itemsize
    if plan.stride < 0 or not plan.nclusters:
        raise ValueError(f"spmv_psdia_ring: no walk in {plan}")
    fault = None
    if (len(plan.width) != plan.nclusters
            or len(plan.starts) != plan.nclusters + 1
            or plan.starts[0] != 0 or plan.starts[-1] != nd
            or any(a >= b for a, b in zip(plan.starts, plan.starts[1:]))):
        fault = f"clusters {plan.starts} do not split {nd} diagonals"
    elif any(v % vec for v in plan.a0 + plan.width + (plan.slot,)):
        fault = "windows or slots off 16-byte boundaries"
    elif plan.stride:
        span = plan.stride * RING_TILE
        reads = [(o - j * span, 0) for o, j in zip(offsets, plan.jd)]
        need = plan.width[0] + (0 if plan.reuse else nd * RING_TILE)
        if plan.nclusters != 1 or len(plan.jd) != nd:
            fault = f"a stride walk needs one window and {nd} jd"
    else:
        reads = [(o, c) for c in range(plan.nclusters)
                 for o in offsets[plan.starts[c]:plan.starts[c + 1]]]
        need = max((plan.starts[c + 1] - plan.starts[c]) * RING_TILE
                   + plan.width[c] for c in range(plan.nclusters))
        if plan.jd or plan.reuse:
            fault = "a cluster walk has no jd and no coefficient reuse"
    if fault is None:
        if any(off < plan.a0[c] or off + RING_TILE > plan.a0[c] + plan.width[c]
               for off, c in reads):
            fault = "a row reads outside its window"
        elif plan.slot < need:
            fault = f"slots of {plan.slot} hold less than {need}"
        elif (plan.nslot * plan.slot + (nd * RING_TILE if plan.reuse else 0)
              ) * itemsize > _ds.SPMM_SMEM_MAX:
            fault = "the ring exceeds the shared-memory budget"
    if fault:
        raise ValueError(f"spmv_psdia_ring: the walk does not fit the "
                         f"offsets {offsets}: {fault}")


def _check(name: str, coef: torch.Tensor, offsets, x: torch.Tensor,
           left: torch.Tensor, right: torch.Tensor, width: int) -> None:
    """Raise on anything the kernels do not take."""
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: x must be float32 or float64, got {x.dtype}")
    for what, t in (("matrix", coef), ("left", left), ("right", right)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {what} is {t.dtype} but x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
    h = left.shape[0]
    if x.dim() != 1 or left.dim() != 1 or tuple(right.shape) != (h,):
        raise ValueError(f"{name}: x, left and right must be 1-D with "
                         f"slivers of one length, got {tuple(x.shape)}, "
                         f"{tuple(left.shape)}, {tuple(right.shape)}")
    if max(abs(int(o)) for o in offsets) > h or h > x.shape[0]:
        raise ValueError(f"{name}: slivers of {h} must cover the band "
                         f"{max(abs(int(o)) for o in offsets)} and fit the "
                         f"chunk of {x.shape[0]}")
    if tuple(coef.shape) != (len(offsets), width):
        raise ValueError(f"{name}: coefficients {tuple(coef.shape)} do not "
                         f"match [{len(offsets)}, {width}]")
    if not all(t.is_contiguous() for t in (coef, x, left, right)):
        raise ValueError(f"{name}: operands must be contiguous")
    if len(offsets) > _MAX_DIAGS:
        raise ValueError(f"{name}: {len(offsets)} diagonals exceed the "
                         f"kernel's {_MAX_DIAGS}")


def spmv_sdia_ring(data: torch.Tensor, offsets, x: torch.Tensor,
                   left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """One shard of the sharded SDIA product: ``data [nd, cp]``, ``x
    [cp]``, slivers ``[h]`` -> ``y [cp]``.

    CUDA tensor: launches K8a (``sdia_ring`` in ``csrc/dist_stream.cu``);
    CPU tensor: :func:`spmv_sdia_ring_ref`."""
    _check("spmv_sdia_ring", data, offsets, x, left, right, x.shape[0])
    if x.is_cpu:
        return spmv_sdia_ring_ref(data, offsets, x, left, right)
    offs = _offsets_on(tuple(offsets), x.device)
    y = torch.empty_like(x)
    _build.launcher("sdia_ring", x.dtype)(
        x, data.data_ptr(), offs.data_ptr(), len(offsets), x.data_ptr(),
        left.data_ptr(), right.data_ptr(), y.data_ptr(), x.shape[0],
        left.shape[0])
    LAUNCHES["sdia_ring"] += 1
    return y


def spmv_psdia_ring(pattern: torch.Tensor, offsets, x: torch.Tensor,
                    left: torch.Tensor, right: torch.Tensor, *, base: int,
                    L: int, nrow: int,
                    plan: RingWalkPlan | None = None) -> torch.Tensor:
    """One shard of the sharded PSDIA product: ``pattern [nd, rb]`` (``rb``
    divides ``cp``), the shard's first padded row ``base``, the pack's
    valid rows ``[L, L + nrow)``; ``plan`` the walk
    (``ShardedPSDIA.ring_plan``), checked by :func:`check_ring_walk`
    wherever it is given and required on a CUDA tensor.

    CUDA tensor: launches K8b (``psdia_ring_stride`` or
    ``psdia_ring_clusters`` in ``csrc/dist_stream.cu``); CPU tensor:
    :func:`spmv_psdia_ring_ref`."""
    rb = pattern.shape[1]
    _check("spmv_psdia_ring", pattern, offsets, x, left, right, rb)
    if x.shape[0] % rb:
        raise ValueError(f"spmv_psdia_ring: the chunk of {x.shape[0]} is not "
                         f"a multiple of the row tile {rb}")
    offsets = tuple(int(o) for o in offsets)
    if plan is not None:
        check_ring_walk(plan, offsets, x.element_size())
    if x.is_cpu:
        return spmv_psdia_ring_ref(pattern, offsets, x, left, right,
                                   base=base, L=L, nrow=nrow)
    if plan is None:
        raise ValueError("spmv_psdia_ring: a CUDA launch needs the walk "
                         "(plan=ShardedPSDIA.ring_plan)")
    offs = _offsets_on(offsets, x.device)
    table = _offsets_on(plan.table, x.device)
    y = torch.empty_like(x)
    _build.launcher("psdia_ring", x.dtype)(
        x, pattern.data_ptr(), offs.data_ptr(), len(offsets),
        table.data_ptr(), plan.nclusters, plan.stride, plan.slot, plan.jspan,
        int(plan.reuse), rb, x.data_ptr(), left.data_ptr(), right.data_ptr(),
        y.data_ptr(), x.shape[0], left.shape[0], base, L, nrow)
    LAUNCHES["psdia_ring"] += 1
    return y
