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

K8b runs K2's kernel body (``csrc/psdia_walk.cuh``) on the ring ``[left |
x | right]``: windows and the pattern's rows staged in shared memory along
the walk that :func:`.dia_stream.psdia_walk_plan` picks on the host, once
per sharded pack (``ShardedPSDIA.ring_plan``).  The walk's host plan lives
with K2 in :mod:`.dia_stream`; its former names here (``RingWalkPlan``,
``ring_cluster_walk``, ``psdia_ring_plan``, ``check_ring_walk``,
``RING_TILE``, ``RING_STAGES``) are the same objects.
"""

from __future__ import annotations

import torch

from . import _build
from .dia_stream import _MAX_DIAGS, _offsets_on, _walk_args
from .dia_stream import WALK_STAGES as RING_STAGES
from .dia_stream import WALK_TILE as RING_TILE
from .dia_stream import WalkPlan as RingWalkPlan
from .dia_stream import check_walk as check_ring_walk
from .dia_stream import psdia_cluster_walk as ring_cluster_walk
from .dia_stream import psdia_walk_plan as psdia_ring_plan

__all__ = ["LAUNCHES", "halo_size", "spmv_sdia_ring", "spmv_sdia_ring_ref",
           "RING_TILE", "RING_STAGES", "RingWalkPlan", "ring_cluster_walk",
           "psdia_ring_plan", "check_ring_walk",
           "spmv_psdia_ring", "spmv_psdia_ring_ref"]

#: kernel launches by the wrappers on CUDA tensors, one per shard (plain-
#: version calls on CPU tensors are not counted)
LAUNCHES = {"sdia_ring": 0, "psdia_ring": 0}


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

    CUDA tensor: launches K8b (``psdia_walk_bulk``, ``psdia_walk_stride``
    or ``psdia_walk_clusters`` of ``csrc/psdia_walk.cuh``, from
    ``csrc/dist_stream.cu``); CPU tensor: :func:`spmv_psdia_ring_ref`."""
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
    y = torch.empty_like(x)
    _build.launcher("psdia_ring", x.dtype)(
        x, pattern.data_ptr(), _walk_args(plan, offsets, rb, x.device)[1],
        x.data_ptr(), left.data_ptr(), right.data_ptr(), y.data_ptr(),
        x.shape[0], left.shape[0], base, L, nrow)
    LAUNCHES["psdia_ring"] += 1
    return y
