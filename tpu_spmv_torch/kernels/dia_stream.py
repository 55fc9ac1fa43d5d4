"""Streaming DIA — the SpMV kernels K1 (SDIA) and K2 (PSDIA) and their
multi-RHS forms K3a and K3b.

Counterpart of ``tpu_spmv/kernels/dia_stream.py``.  The packs keep the
reference's padded-row-space contract and dataclass fields, so a JAX pack
carries over unchanged (:mod:`..interop`):

- ``xpad[k] = x[k - L]``; the front pad ``L`` and the back pad are whole
  row tiles of ``rb`` rows, and every row ``k`` of ``[L, L + nrow)`` reads
  ``xpad[k + off]`` inside ``[0, npad)``;
- :class:`SDIA` streams explicit diagonal data, zero on pad rows and
  out-of-range slots; :class:`PSDIA` holds one row tile of a periodic
  pattern (grid stencils) and zeroes the rows outside ``[L, L + nrow)``;
- the pads of y stay exactly zero, so padded products chain;
- ``transpose_sdia`` / ``transpose_psdia`` give ``A^T`` as another pack
  of the same kind (the same kernels run it), and ``spmv_sdia`` /
  ``spmv_psdia`` are differentiable in ``x`` and in ``A.data`` /
  ``A.pattern`` (the reference's custom VJPs as autograd Functions: ``x``'s
  gradient is K1/K2 on the transposed pack);
- the SpMM keeps the reference's transposed layout: ``Xt_pad`` and
  ``Yt_pad`` are ``[nrhs, npad]``, one padded row space per right-hand
  side (:func:`spmm_sdia_padded_t`); :func:`spmm_sdia` takes plain
  ``[n, nrhs]`` operands and transposes in and out.

On a CUDA tensor the wrappers launch the hand-written Hopper kernels of
``csrc/dia_stream.cu`` (built at first use, :mod:`._build`) and count the
launch in :data:`LAUNCHES`; on a CPU tensor they run the plain PyTorch
versions beside them (``*_ref``), which compute the same function with
per-diagonal zero-filled shifts.  Nothing falls back from one to the other.

K2 and K8b (:mod:`.dist_stream`) run one kernel body
(``csrc/psdia_walk.cuh``) along a walk that :func:`psdia_walk_plan` picks
on the host from the offsets, the period and the value type: windows of x
and the pattern's rows staged in shared memory, by bulk copy where the
operands are 16-byte aligned.  K2's wrapper looks the walk and its launch
arguments up once per pack key (:func:`_walk_launch`) and passes them as
one pointer; on an operand of few tiles (:func:`_direct_tiles`), K2 runs
one thread a row instead (``psdia_walk_direct``).

K3a and K3b run one kernel body too (``dia_spmm_stride`` and
``dia_spmm_clusters`` in ``csrc/dia_stream.cu``), along the walk that
:func:`psdia_spmm_plan` picks from the offsets, the RHS count and the
value type; they differ only in where a tile's coefficient rows come
from: K3b's pattern at ``k mod rb``, K3a's data rows at ``k``.

The row-tile size ``rb`` keeps the reference's rule (``_auto_rb`` and the
``pack_psdia`` rb block, derived from TPU VMEM budgets, with their ``nrhs``
argument for the SpMM layout) so the packs are identical; on Hopper it only
decides the padding.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.base import sparse_dataclass
from ..formats.dia import DIA
from . import _build

__all__ = ["SDIA", "PSDIA", "LAUNCHES", "pack_sdia", "supports_sdia",
           "detect_period", "pack_psdia", "pad_x", "unpad_y",
           "transpose_sdia", "transpose_psdia",
           "spmv_sdia_padded", "spmv_sdia_padded_ref", "spmv_sdia",
           "spmv_psdia_padded", "spmv_psdia_padded_ref", "spmv_psdia",
           "spmm_sdia_padded_t", "spmm_sdia_padded_t_ref", "spmm_sdia",
           "spmm_psdia_padded_t", "spmm_psdia_padded_t_ref", "spmm_psdia",
           "SpmmWindowPlan", "psdia_spmm_plan", "WALK_TILE", "WALK_STAGES",
           "BULK_AHEAD", "WalkPlan", "psdia_cluster_walk", "psdia_walk_plan",
           "check_walk"]

#: floor rows per row tile (the reference's rule, see module docstring)
RB = 16384
RB_MAX = 131072
#: per-buffer budget for the reference's [ndiags, rb] data block
_DATA_BLOCK_BUDGET = 3 << 20
#: the reference's budget for the [nrhs, rb] RHS panels of the SpMM layout
_RHS_PANEL_BUDGET = 8 << 20
#: kernel launches by the wrappers on CUDA tensors (plain-version calls on
#: CPU tensors are not counted)
LAUNCHES = {"sdia": 0, "sdia_bf16": 0, "psdia": 0, "sdia_spmm": 0,
            "psdia_spmm": 0}
#: the kernels keep the offsets in 48 KB of shared memory
_MAX_DIAGS = 12288
#: K3a and K3b (the same constants in ``csrc/dia_stream.cu``):
#: stage slots in a block's ring, the most dynamic shared memory a block
#: may ask for on sm_90, threads per block, and the outputs a thread keeps
#: (rows x right-hand sides)
SPMM_STAGES = 4
SPMM_SMEM_MAX = 232448
_SPMM_THREADS = 256
_SPMM_ROWS = 4
_SPMM_RHS = 4
#: what each of two blocks may hold of an H100 SM's 233472 bytes of
#: shared memory (the card keeps 1024 a block)
_TWO_BLOCK_SMEM = 233472 // 2 - 1024
#: largest period :func:`detect_period` tries
_MAX_PERIOD = 1 << 20


def _roundup(a: int, m: int) -> int:
    return -(-a // m) * m


@sparse_dataclass
class SDIA:
    """DIA matrix in padded row space for the streaming kernel.

    ``data[d, k]`` is diagonal ``offsets[d]`` at global row ``k - L``
    (zero for pad rows and out-of-range slots)."""

    data: torch.Tensor                    # [ndiags, npad]
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    nnz: int
    L: int                                # front pad rows (multiple of rb)
    rb: int = RB

    @property
    def npad(self) -> int:
        return int(self.data.shape[1])

    @property
    def ndiags(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype


@sparse_dataclass
class PSDIA:
    """Periodic DIA matrix for the streaming kernel.

    ``pattern[d, i]`` holds diagonal ``offsets[d]`` at global row
    ``i mod period``, tiled to one row tile ``[ndiags, rb]``; rows outside
    ``[L, L + nrow)`` are masked to zero."""

    pattern: torch.Tensor                 # [ndiags, rb]
    offsets: tuple[int, ...]
    shape: tuple[int, int]
    nnz: int
    L: int                                # front pad rows (multiple of rb)
    period: int
    rb: int = RB

    @property
    def npad(self) -> int:
        hi = max(0, max(self.offsets))
        U = _roundup(hi, self.rb) if hi else 0
        return self.L + _roundup(self.shape[0], self.rb) + U

    @property
    def ndiags(self) -> int:
        return int(self.pattern.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.pattern.dtype


# ---------------------------------------------------------------------------
# packing (host analysis, the reference's rules)
# ---------------------------------------------------------------------------


def _auto_rb(ndiags: int, offsets, nrow: int, nrhs: int = 1,
             itemsize: int = 4) -> int | None:
    """The reference's row-tile rule: as fat as its data-block budget
    allows, shrunk for small matrices, halved while ``nrhs`` 4-byte RHS
    panels of ``rb`` rows pass 8 MB (the SpMM layout), raised (within 2x
    budget) when the band needs it.  ``None`` = no feasible tile."""
    need = _roundup(max(max(abs(int(o)) for o in offsets), 1), 1024)
    rb = 65536
    while rb > RB and ndiags * rb * itemsize > _DATA_BLOCK_BUDGET:
        rb //= 2
    while rb > RB and rb >= 4 * nrow:
        rb //= 2
    while rb > 4096 and nrhs * rb * 4 > _RHS_PANEL_BUDGET:
        rb //= 2
    if need > rb:
        rb = need
        if rb > RB_MAX or ndiags * rb * itemsize > 2 * _DATA_BLOCK_BUDGET:
            return None
    return rb


def supports_sdia(offsets, shape, rb: int | None = None, *,
                  itemsize: int = 4, nrhs: int = 1) -> bool:
    """Feasibility probe for :func:`pack_sdia` (same rule, same itemsize
    and ``nrhs``)."""
    if shape[0] != shape[1]:
        return False
    if rb is None:
        return _auto_rb(len(offsets), offsets, shape[0], nrhs=nrhs,
                        itemsize=itemsize) is not None
    return max(abs(int(o)) for o in offsets) <= rb


def _coef_dtype(dia: DIA, data_dtype) -> torch.dtype:
    return dia.data.dtype if data_dtype is None else data_dtype


def pack_sdia(dia: DIA, rb: int | None = None, *, nrhs: int = 1,
              device=None, data_dtype=None) -> SDIA:
    """Lay a DIA matrix out in padded row space on ``device`` (default:
    the DIA's device); ``rb=None`` picks the tile with :func:`_auto_rb`,
    for the ``nrhs`` the pack will mostly serve (the reference's rule, so
    the pack equals the reference's for the same arguments).

    ``data_dtype`` (``torch.bfloat16``) stores the diagonals in a narrower
    type, its itemsize picking the tile as in the reference; the products
    keep x, y and the sums in x's type (K1's bf16-data form)."""
    nrow, _ = dia.shape
    dtype = _coef_dtype(dia, data_dtype)
    if rb is None:
        rb = _auto_rb(dia.ndiags, dia.offsets, nrow, nrhs=nrhs,
                      itemsize=dtype.itemsize)
    if rb is None or not supports_sdia(dia.offsets, dia.shape, rb):
        raise ValueError(
            f"sdia needs a square matrix with a feasible row tile "
            f"(max |offset| <= rb <= {RB_MAX}), got shape {dia.shape}, "
            f"offsets [{min(dia.offsets)}, {max(dia.offsets)}]")
    lo = max(0, -min(dia.offsets))
    hi = max(0, max(dia.offsets))
    L = _roundup(lo, rb) if lo else 0
    U = _roundup(hi, rb) if hi else 0
    npad = L + _roundup(nrow, rb) + U
    data = F.pad(dia.data.to(device=device, dtype=dtype),
                 (L, npad - L - nrow)).contiguous()
    return SDIA(data=data, offsets=tuple(dia.offsets), shape=dia.shape,
                nnz=dia.nnz, L=L, rb=rb)


def detect_period(dia: DIA) -> int | None:
    """Smallest period P (from the offset-derived candidates) such that
    every diagonal is P-periodic over its in-range rows — host analysis;
    ``None`` for device-resident data (no readback during planning; pass
    ``period=`` to :func:`pack_psdia`, which verifies it).

    Candidates: 1 (constant diagonals) and each distinct ``|offset| > 1``
    ascending — the minor grid dimension of a separable stencil is one of
    its offsets."""
    if dia.data.device.type != "cpu":
        return None
    data = (dia.data.float() if dia.data.dtype == torch.bfloat16
            else dia.data).numpy()         # bf16 widens exactly
    nrow = dia.shape[0]
    cands = [1] + sorted({abs(int(o)) for o in dia.offsets} - {0, 1})
    for P in cands:
        if P > _MAX_PERIOD or 2 * P > nrow:
            continue
        ok = True
        for d, off in enumerate(dia.offsets):
            off = int(off)
            seg = data[d, max(0, -off):nrow - max(0, off)]
            if seg.size > P and not np.array_equal(seg[P:], seg[:-P]):
                ok = False
                break
        if ok:
            return P
    return None


def _pattern_budget(nd: int) -> int:
    """The reference's budget for the resident [ndiags, rb] pattern."""
    return (8 << 20) if nd <= 5 else (2 << 20)


def _periodic(data: torch.Tensor, pat: torch.Tensor, offsets,
              nrow: int) -> bool:
    """True iff ``data`` equals the tiled ``pat`` at every in-range slot
    (out-of-range slots multiply the zero x pads — don't care)."""
    P = pat.shape[1]
    full = pat.repeat(1, -(-nrow // P))[:, :nrow]
    i = torch.arange(nrow, device=data.device)
    offs = torch.tensor(offsets, device=data.device)[:, None]
    valid = (i[None, :] + offs >= 0) & (i[None, :] + offs < nrow)
    return bool(torch.all((data == full) | ~valid))


def pack_psdia(dia: DIA, period: int | None = None, *, rb: int | None = None,
               nrhs: int = 1, verify: bool = True, device=None,
               data_dtype=None) -> PSDIA:
    """Build the periodic streaming operator on ``device`` (default: the
    DIA's device).  ``rb=None`` picks the reference's tile for ``nrhs``
    right-hand sides; ``data_dtype`` (``torch.bfloat16``) stores the
    pattern in a narrower type, whose itemsize picks the tile as in the
    reference.

    ``period=None`` detects it on host data (:func:`detect_period`).  With
    ``verify=True`` the claim is checked against every in-range entry, on
    the device that holds the DIA data, and a mismatch raises."""
    nrow, ncol = dia.shape
    if nrow != ncol:
        raise ValueError("psdia needs a square matrix")
    if period is None:
        period = detect_period(dia)
        if period is None:
            raise ValueError(
                "no periodic diagonal structure detected"
                + (" (device-resident diagonals are not scanned — pass "
                   "period= explicitly; it is verified on device)"
                   if dia.data.device.type != "cpu" else ""))
    P = int(period)
    nd = dia.ndiags
    offsets = tuple(int(o) for o in dia.offsets)
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    if rb is None:
        # period-aligned and 1024-aligned, as fat as the reference's
        # resident-pattern budget allows, not past the matrix
        unit = P * 1024 // math.gcd(P, 1024)
        if unit > RB_MAX:
            raise ValueError("period too large for any feasible row tile")
        isz = _coef_dtype(dia, data_dtype).itemsize
        cap = min(RB_MAX, max(_pattern_budget(nd) // (isz * nd), 1))
        if nrhs > 1:
            cap = min(cap, max(_RHS_PANEL_BUDGET // (4 * nrhs), 1))
        rb = max(unit, cap - cap % unit)
        small = _roundup(max(nrow, lo, hi, 1), unit)
        rb = min(rb, max(small, unit))
        if max(lo, hi, 1) > rb:         # wide band: raise rb to cover it
            rb = _roundup(max(lo, hi), unit)
    if rb % P or rb > RB_MAX or max(lo, hi, 1) > rb:
        raise ValueError(
            f"psdia needs rb a multiple of period={P} covering the band, "
            f"<= {RB_MAX}; got rb={rb}")
    # the first period window that is in range for EVERY diagonal (its
    # phase k0*P = 0 mod P keeps the alignment)
    k0 = -(-lo // P)
    if (k0 + 1) * P > nrow - hi:
        raise ValueError("matrix too small to extract an in-range period")
    pat = dia.data[:, k0 * P:(k0 + 1) * P]
    if verify and not _periodic(dia.data, pat, offsets, nrow):
        raise ValueError(f"diagonals are not periodic with period {P}")
    pattern = pat.to(device=device, dtype=_coef_dtype(dia, data_dtype)
                     ).repeat(1, rb // P).contiguous()
    L = _roundup(lo, rb) if lo else 0
    return PSDIA(pattern=pattern, offsets=offsets, shape=dia.shape,
                 nnz=dia.nnz, L=L, period=P, rb=rb)


# ---------------------------------------------------------------------------
# padded row space
# ---------------------------------------------------------------------------


def pad_x(A, x: torch.Tensor) -> torch.Tensor:
    """``xpad[k] = x[k - L]``, zero elsewhere (``[nrow] -> [npad]``)."""
    return F.pad(x, (A.L, A.npad - A.L - x.shape[0]))


def unpad_y(A, ypad: torch.Tensor) -> torch.Tensor:
    """The valid rows of a padded product (``[npad] -> [nrow]``, a view)."""
    return ypad[A.L:A.L + A.shape[0]]


def _shift(xpad: torch.Tensor, off: int) -> torch.Tensor:
    """``out[..., k] = xpad[..., k + off]``, zero where ``k + off`` leaves
    ``[0, npad)``."""
    n = xpad.shape[-1]
    out = torch.zeros_like(xpad)
    if abs(off) < n:
        if off >= 0:
            out[..., :n - off] = xpad[..., off:]
        else:
            out[..., -off:] = xpad[..., :n + off]
    return out


def _in_type_of(coef: torch.Tensor, xpad: torch.Tensor) -> torch.Tensor:
    """The coefficients in x's type: bf16 data widen exactly to float32."""
    return coef if coef.dtype == xpad.dtype else coef.to(xpad.dtype)


def spmv_sdia_padded_ref(A: SDIA, xpad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: per-diagonal zero-filled shifts of
    ``xpad`` times the diagonal data (bf16 data widened to x's type),
    summed in ascending offset order.  A leading axis of ``xpad`` (the
    SpMM's RHS axis) broadcasts."""
    data = _in_type_of(A.data, xpad)
    acc = data[0] * _shift(xpad, A.offsets[0])
    for d, off in enumerate(A.offsets[1:], start=1):
        acc = acc + data[d] * _shift(xpad, off)
    return acc


def spmv_psdia_padded_ref(A: PSDIA, xpad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: the same sum with the pattern (a bf16
    pattern widened to x's type) tiled over the row tiles, then the
    row-validity mask."""
    reps = A.npad // A.rb
    pattern = _in_type_of(A.pattern, xpad)
    acc = pattern[0].repeat(reps) * _shift(xpad, A.offsets[0])
    for d, off in enumerate(A.offsets[1:], start=1):
        acc = acc + pattern[d].repeat(reps) * _shift(xpad, off)
    rows = torch.arange(A.npad, device=xpad.device)
    valid = (rows >= A.L) & (rows < A.L + A.shape[0])
    return torch.where(valid, acc, torch.zeros_like(acc))


def spmm_sdia_padded_t_ref(A: SDIA, Xt_pad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3a: K1's plain version over the rows of
    ``Xt_pad`` (``[nrhs, npad] -> [nrhs, npad]``)."""
    return spmv_sdia_padded_ref(A, Xt_pad)


def spmm_psdia_padded_t_ref(A: PSDIA, Xt_pad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3b: K2's plain version over the rows of
    ``Xt_pad`` (``[nrhs, npad] -> [nrhs, npad]``)."""
    return spmv_psdia_padded_ref(A, Xt_pad)


@functools.cache
def _offsets_on(offsets: tuple[int, ...], device: torch.device):
    """The offsets (or K3b's plan table) as a device ``int32`` tensor, made
    once per tuple and device: the copy from the host waits for the
    stream, so it must not run on every launch (nor inside a CUDA graph's
    capture).  Entries are never dropped (a few hundred bytes each), so no
    kernel still queued on another stream can read a freed one."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def _check(name: str, coef: torch.Tensor, A, xpad: torch.Tensor,
           width: int, rhs_axis: bool = False, bf16_data: bool = False
           ) -> None:
    """Raise on anything the kernels do not take: ``xpad`` is ``[npad]``,
    or ``[nrhs, npad]`` with ``rhs_axis``; the coefficients are in x's
    type, or (``bf16_data``: the SpMVs K1 and K2) bfloat16 against a
    float32 x."""
    if xpad.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: x must be float32 or float64, "
                        f"got {xpad.dtype}")
    mixed = coef.dtype == torch.bfloat16 and xpad.dtype == torch.float32
    if coef.dtype != xpad.dtype and not (bf16_data and mixed):
        raise TypeError(f"{name}: matrix is {coef.dtype} but x is "
                        f"{xpad.dtype}")
    if coef.device != xpad.device:
        raise ValueError(f"{name}: matrix on {coef.device}, x on "
                         f"{xpad.device}")
    if xpad.dim() != 1 + rhs_axis or xpad.shape[-1] != A.npad:
        want = "[nrhs, npad" if rhs_axis else "[npad"
        raise ValueError(f"{name}: x must be {want}={A.npad}], got "
                         f"{tuple(xpad.shape)}")
    if tuple(coef.shape) != (len(A.offsets), width):
        raise ValueError(f"{name}: coefficients {tuple(coef.shape)} do not "
                         f"match [{len(A.offsets)}, {width}]")
    if not (coef.is_contiguous() and xpad.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if len(A.offsets) > _MAX_DIAGS:
        raise ValueError(f"{name}: {len(A.offsets)} diagonals exceed the "
                         f"kernel's {_MAX_DIAGS}")


def spmv_sdia_padded(A: SDIA, xpad: torch.Tensor) -> torch.Tensor:
    """``ypad = A @ xpad`` in padded row space (``[npad] -> [npad]``,
    chainable: the pads stay zero because the pad rows hold zero data).

    CUDA tensor: launches K1 (``sdia_spmv`` in ``csrc/dia_stream.cu``; on
    bfloat16 data against a float32 x its bf16-data form, instantiated
    ``<float, __nv_bfloat16>``, counted apart); CPU tensor:
    :func:`spmv_sdia_padded_ref`."""
    _check("spmv_sdia_padded", A.data, A, xpad, A.npad, bf16_data=True)
    if xpad.is_cpu:
        return spmv_sdia_padded_ref(A, xpad)
    bf16 = A.data.dtype == torch.bfloat16
    y = torch.empty_like(xpad)
    offs = _offsets_on(A.offsets, xpad.device)
    launch = (_build.launcher("sdia_spmv_bf16f32") if bf16
              else _build.launcher("sdia_spmv", xpad.dtype))
    launch(xpad, A.data.data_ptr(), offs.data_ptr(), A.ndiags,
           xpad.data_ptr(), y.data_ptr(), A.npad)
    LAUNCHES["sdia_bf16" if bf16 else "sdia"] += 1
    return y


def spmv_psdia_padded(A: PSDIA, xpad: torch.Tensor) -> torch.Tensor:
    """``ypad = A @ xpad`` in padded row space — same contract as
    :func:`spmv_sdia_padded`; the pads stay zero through the row mask.

    CUDA tensor: launches K2 (``psdia_walk_bulk``, ``psdia_walk_stride``
    or ``psdia_walk_clusters`` of ``csrc/psdia_walk.cuh``, from
    ``csrc/dia_stream.cu``) along the walk :func:`psdia_walk_plan` picks for
    the pack's offsets, period and value type, or, on few tiles
    (:func:`_direct_tiles`), one thread a row (``psdia_walk_direct``); CPU
    tensor: :func:`spmv_psdia_padded_ref`.  A bfloat16 pattern against a
    float32 x runs the float32 kernel on the pattern widened once
    (:func:`_widened`): the widening is exact, so the products are those
    of bf16 coefficients summed in float32."""
    _check("spmv_psdia_padded", A.pattern, A, xpad, A.rb, bf16_data=True)
    if xpad.is_cpu:
        return spmv_psdia_padded_ref(A, xpad)
    _, args = _walk_launch(A.offsets, A.period, A.rb, xpad.element_size(),
                           xpad.device)
    return _psdia_launch(A, xpad, args)


def _psdia_launch(A: PSDIA, xpad: torch.Tensor, args: int) -> torch.Tensor:
    """Launch K2 with the walk's launch arguments at ``args``
    (:func:`_walk_args`) on checked CUDA operands and count it."""
    y = torch.empty_like(xpad)
    _build.launcher("psdia_spmv", xpad.dtype)(
        xpad, _widened(A.pattern).data_ptr(), args, xpad.data_ptr(),
        y.data_ptr(), A.npad, A.L, A.shape[0])
    LAUNCHES["psdia"] += 1
    return y


#: id(pattern) -> (weak reference to it, its version, the float32 copy)
_WIDE: dict[int, tuple] = {}


def _widened(pattern: torch.Tensor) -> torch.Tensor:
    """A bfloat16 pattern as float32, made once per pattern tensor (and
    again only after an in-place change); other patterns as they are.  The
    pattern is ``ndiags x rb`` values, so the copy is a few MB at most."""
    if pattern.dtype != torch.bfloat16:
        return pattern
    key = id(pattern)
    hit = _WIDE.get(key)
    if hit is not None and hit[0]() is pattern and hit[1] == pattern._version:
        return hit[2]
    wide = pattern.float()
    _WIDE[key] = (weakref.ref(pattern, lambda _, k=key: _WIDE.pop(k, None)),
                  pattern._version, wide)
    return wide


def _spmv_psdia_launch(A: PSDIA, xpad: torch.Tensor,
                       plan: "WalkPlan") -> torch.Tensor:
    """Launch K2 along ``plan`` (checked by :func:`check_walk`), whatever
    the operand's size, on checked CUDA operands and count it: the walks
    side by side on the card."""
    check_walk(plan, A.offsets, xpad.element_size())
    return _psdia_launch(A, xpad,
                         _walk_args(plan, A.offsets, A.rb, xpad.device)[1])


# ---------------------------------------------------------------------------
# transposes and the reverse-mode rules
# ---------------------------------------------------------------------------


def _place_shifted(v: torch.Tensor, s: int, npad_dst: int) -> torch.Tensor:
    """``out[k] = v[k - s]`` with exact zero fill (``out`` has
    ``npad_dst`` slots) — pad and slice, no wraparound."""
    npad_src = int(v.shape[0])
    lo = max(0, s)
    hi = min(npad_dst, npad_src + s)
    if hi <= lo:
        return v.new_zeros(npad_dst)
    return F.pad(v[lo - s:hi - s], (lo, npad_dst - hi))


def transpose_sdia(A: SDIA) -> SDIA:
    """``A^T`` as another streaming operator — per-diagonal zero-filled
    shifts of the (already padded) data block.

    ``A^T[i, i+o'] = A[i+o', i]`` with ``o' = -o``, so in padded row space
    ``dataT[d', k] = data[d, k - s_d]`` with ``s_d = L_T - L + o``.
    Out-of-range slots stay exactly zero, so the pads stay structural
    zeros (the reference's derivation and layout)."""
    nrow, ncol = A.shape
    offs_T = [-int(o) for o in A.offsets]
    order = sorted(range(len(offs_T)), key=lambda d: offs_T[d])
    lo_T = max(0, -min(offs_T))
    hi_T = max(0, max(offs_T))
    L_T = _roundup(lo_T, A.rb) if lo_T else 0
    U_T = _roundup(hi_T, A.rb) if hi_T else 0
    npad_T = L_T + _roundup(nrow, A.rb) + U_T
    rows = [_place_shifted(A.data[d], L_T - A.L + int(A.offsets[d]), npad_T)
            for d in order]
    return SDIA(data=torch.stack(rows),
                offsets=tuple(offs_T[d] for d in order),
                shape=(ncol, nrow), nnz=A.nnz, L=L_T, rb=A.rb)


def transpose_psdia(A: PSDIA) -> PSDIA:
    """``A^T`` as another periodic operator: a cyclic roll of each pattern
    row (a shift of a P-periodic diagonal is a roll of its pattern, and
    ``rb % P == 0`` keeps the tiled layout)."""
    offs_T = [-int(o) for o in A.offsets]
    order = sorted(range(len(offs_T)), key=lambda d: offs_T[d])
    pat_T = torch.stack([torch.roll(A.pattern[d], -offs_T[d])
                         for d in order])
    offsets_T = tuple(offs_T[d] for d in order)
    lo_T = max(0, -min(offsets_T))
    L_T = _roundup(lo_T, A.rb) if lo_T else 0
    return PSDIA(pattern=pat_T, offsets=offsets_T,
                 shape=(A.shape[1], A.shape[0]), nnz=A.nnz, L=L_T,
                 period=A.period, rb=A.rb)


def _coef_bar(A, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[ndiags, npad]`` rows ``g_pad[k] * x_pad[k + off_d]``.  Pads and
    out-of-range slots come out exactly zero: ``g_pad`` is zero outside
    the real rows, and a real row ``k`` reads ``k + off_d`` inside
    ``[0, npad)``, so the roll's wrap-around meets only zero ``g_pad``."""
    gp = pad_x(A, g)
    xp = pad_x(A, x)
    return torch.stack([gp * torch.roll(xp, -int(off)) for off in A.offsets])


class _SpmvSDIA(torch.autograd.Function):
    """``unpad(K1(A, pad(x)))``, differentiable in ``A.data`` and ``x``
    (the reference's ``_spmv_sdia_bwd``):

    - ``x_bar = A^T g`` — K1 on :func:`transpose_sdia`;
    - ``data_bar[d, k] = g_pad[k] * x_pad[k + off_d]``."""

    @staticmethod
    def forward(ctx, data, x, A):
        A = dataclasses.replace(A, data=data)
        ctx.A = A
        ctx.save_for_backward(data, x)
        return unpad_y(A, spmv_sdia_padded(A, pad_x(A, x)))

    @staticmethod
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        A = dataclasses.replace(ctx.A, data=data)
        g = g.contiguous()
        data_bar = _coef_bar(A, g, x) if ctx.needs_input_grad[0] else None
        x_bar = (spmv_sdia(transpose_sdia(A), g)
                 if ctx.needs_input_grad[1] else None)
        return data_bar, x_bar, None


class _SpmvPSDIA(torch.autograd.Function):
    """``unpad(K2(A, pad(x)))``, differentiable in ``A.pattern`` and ``x``
    (the reference's ``_spmv_psdia_bwd``):

    - ``x_bar = A^T g`` — K2 on :func:`transpose_psdia`;
    - ``pattern_bar[d, j] = sum_t (g_pad * shift(x_pad, off_d))[t*rb + j]``,
      a fold of the padded row space over its row tiles."""

    @staticmethod
    def forward(ctx, pattern, x, A):
        A = dataclasses.replace(A, pattern=pattern)
        ctx.A = A
        ctx.save_for_backward(pattern, x)
        return unpad_y(A, spmv_psdia_padded(A, pad_x(A, x)))

    @staticmethod
    def backward(ctx, g):
        pattern, x = ctx.saved_tensors
        A = dataclasses.replace(ctx.A, pattern=pattern)
        g = g.contiguous()
        pattern_bar = (_coef_bar(A, g, x).reshape(A.ndiags, -1, A.rb).sum(1)
                       if ctx.needs_input_grad[0] else None)
        x_bar = (spmv_psdia(transpose_psdia(A), g)
                 if ctx.needs_input_grad[1] else None)
        return pattern_bar, x_bar, None


def spmv_sdia(A: SDIA, x: torch.Tensor,
              y: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` (+ ``y``) with plain ``[n]`` vectors (pads internally);
    differentiable in ``x`` and ``A.data`` (:class:`_SpmvSDIA`)."""
    out = _SpmvSDIA.apply(A.data, x, A)
    return out if y is None else y + out


def spmv_psdia(A: PSDIA, x: torch.Tensor,
               y: torch.Tensor | None = None) -> torch.Tensor:
    """``A @ x`` (+ ``y``) with plain ``[n]`` vectors (pads internally);
    differentiable in ``x`` and ``A.pattern`` (:class:`_SpmvPSDIA`)."""
    out = _SpmvPSDIA.apply(A.pattern, x, A)
    return out if y is None else y + out


def spmm_sdia_padded_t(A: SDIA, Xt_pad: torch.Tensor) -> torch.Tensor:
    """``Yt_pad = (A @ Xt_pad.T).T`` for transposed multi-RHS operands
    ``[nrhs, npad] -> [nrhs, npad]`` (shape-preserving and chainable, as
    :func:`spmv_sdia_padded`: row ``q`` of ``Xt_pad`` is right-hand side
    ``q`` in padded row space); the rows outside ``[L, L + nrow)`` come
    out zero, and every column is bitwise K1's on the same pack.

    CUDA tensor: launches K3a (``sdia_spmm`` in ``csrc/dia_stream.cu``:
    K3b's walks with the data rows as the coefficients) with the tiling of
    :func:`psdia_spmm_plan`; CPU tensor: :func:`spmm_sdia_padded_t_ref`."""
    _check("spmm_sdia_padded_t", A.data, A, Xt_pad, A.npad, rhs_axis=True)
    if Xt_pad.is_cpu:
        return spmm_sdia_padded_t_ref(A, Xt_pad)
    return _spmm_launch(A, Xt_pad, psdia_spmm_plan(
        A.offsets, Xt_pad.shape[0], Xt_pad.element_size()))


@dataclasses.dataclass(frozen=True)
class SpmmWindowPlan:
    """The tiling of K3a and K3b on one operand for one RHS count
    (:func:`psdia_spmm_plan`).

    A tile is ``tk`` padded rows of a chunk of ``qcap`` right-hand sides
    (``nchunks`` chunks); ``qt`` of the kernel's threads run along the
    RHS.  Its windows are columns of ``Xt``, staged in shared memory with
    the tile's coefficient rows in a ring of ``nslot`` slots of ``slot``
    elements (``smem_bytes`` a block).

    - ``stride == 0``, the cluster walk: the diagonals fall into clusters
      of nearby offsets, cluster ``c`` being diagonals ``starts[c]:starts[c
      + 1]``; for the tile at row ``k0`` each cluster has its own window,
      columns ``k0 + a0[c] .. k0 + a0[c] + width[c]``.
    - ``stride == M > 0``, the stride walk: one window per tile, columns
      ``k0 + a0[0] .. k0 + a0[0] + width[0]``, and diagonal ``d`` reads
      the window of the tile ``jd[d] * M`` tiles away (its offset is near
      ``jd[d] * M * tk``), so a block that walks tiles ``M`` apart reads
      each window from device memory once and keeps it for every tile
      that needs it; ``lookahead`` windows are in flight."""

    qt: int
    tk: int
    qcap: int
    nchunks: int
    stride: int
    starts: tuple[int, ...]
    a0: tuple[int, ...]
    width: tuple[int, ...]
    jd: tuple[int, ...]
    lookahead: int
    slot: int
    nslot: int
    smem_bytes: int

    @property
    def nclusters(self) -> int:
        return len(self.a0)

    @property
    def table(self) -> tuple[int, ...]:
        """What the kernel reads: the cluster walk's ``starts``, ``a0``
        and ``width``; the stride walk's ``min(jd)``, the span of ``jd``,
        ``a0``, ``width``, ``lookahead`` and then ``jd``."""
        if not self.stride:
            return self.starts + self.a0 + self.width
        lo = min(self.jd)
        return ((lo, max(self.jd) - lo + 1, self.a0[0], self.width[0],
                 self.lookahead) + self.jd)


def _tile(nrhs: int) -> tuple[int, int, int, int]:
    """The kernel's tile for ``nrhs`` RHS: ``qt`` (1, 2, 4 or 8) threads
    along the RHS, the smallest that holds ``nrhs`` at :data:`_SPMM_RHS`
    each; ``tk = _SPMM_ROWS * _SPMM_THREADS / qt`` rows; ``qcap`` RHS a
    chunk; ``nchunks`` chunks."""
    qt = 1
    while qt < 8 and qt * _SPMM_RHS < nrhs:
        qt *= 2
    qcap = _SPMM_RHS * qt
    nchunks = -(-max(nrhs, 1) // qcap)
    return qt, _SPMM_ROWS * _SPMM_THREADS // qt, qcap, nchunks


def _cluster_walk(offsets: tuple[int, ...], nrhs: int,
                  itemsize: int) -> SpmmWindowPlan:
    """The cluster walk: runs of consecutive diagonals, each offset closer
    than ``tk`` to the one before (a gap that wide costs more in the
    window than a stage of its own), cut where the slot would pass the
    budget: a :data:`SPMM_STAGES`-th of what two blocks may each hold on
    one SM, or of :data:`SPMM_SMEM_MAX` where one diagonal alone needs
    more.  A cluster of one diagonal always fits, so every operand has
    this plan."""
    qt, tk, qcap, nchunks = _tile(nrhs)
    vec = 16 // itemsize
    nq = min(max(nrhs, 1), qcap)

    def window(d0: int, d1: int) -> tuple[int, int]:
        lo, hi = min(offsets[d0:d1]), max(offsets[d0:d1])
        a0 = lo - lo % vec
        return a0, tk + _roundup(hi, vec) - a0

    def slot(d0: int, d1: int) -> int:
        return (d1 - d0) * tk + nq * window(d0, d1)[1]

    budget = _TWO_BLOCK_SMEM // SPMM_STAGES // itemsize
    if max(slot(d, d + 1) for d in range(len(offsets))) > budget:
        budget = SPMM_SMEM_MAX // SPMM_STAGES // itemsize
    starts = [0]
    for d in range(1, len(offsets)):
        if (abs(offsets[d] - offsets[d - 1]) >= tk
                or slot(starts[-1], d + 1) > budget):
            starts.append(d)
    starts.append(len(offsets))
    spans = list(zip(starts[:-1], starts[1:]))
    windows = [window(d0, d1) for d0, d1 in spans]
    slot_elems = _roundup(max(slot(d0, d1) for d0, d1 in spans), 4)
    return SpmmWindowPlan(
        qt=qt, tk=tk, qcap=qcap, nchunks=nchunks, stride=0,
        starts=tuple(starts), a0=tuple(a for a, _ in windows),
        width=tuple(w for _, w in windows), jd=(), lookahead=SPMM_STAGES - 1,
        slot=slot_elems, nslot=SPMM_STAGES,
        smem_bytes=SPMM_STAGES * slot_elems * itemsize)


def _stride_walk(offsets: tuple[int, ...], nrhs: int,
                 itemsize: int) -> SpmmWindowPlan | None:
    """The stride walk with the narrowest window, or ``None``: strides
    ``M`` of whole tiles near each offset's length, ``jd`` the nearest
    multiple of ``M * tk`` to each offset, at most three windows a tile
    (``jd`` spans 3 or less), with the most windows in flight (up to 3)
    that still fit two blocks an SM, else one block."""
    qt, tk, qcap, nchunks = _tile(nrhs)
    vec = 16 // itemsize
    nq = min(max(nrhs, 1), qcap)
    nd = len(offsets)
    best = None
    for m in sorted({1} | {(abs(o) + tk // 2) // tk for o in offsets
                           if abs(o) >= tk}):
        span = m * tk
        jd = tuple((2 * o + span) // (2 * span) for o in offsets)
        jspan = max(jd) - min(jd) + 1
        if jspan > 3:
            continue
        dev = [o - j * span for o, j in zip(offsets, jd)]
        a0 = min(dev) - min(dev) % vec
        w = tk + _roundup(max(dev), vec) - a0
        slot = _roundup(nd * tk + nq * w, 4)
        fits = [la for b in (_TWO_BLOCK_SMEM, SPMM_SMEM_MAX)
                for la in (3, 2, 1) if (jspan + la) * slot * itemsize <= b]
        if fits and (best is None or w < best.width[0]):
            best = SpmmWindowPlan(
                qt=qt, tk=tk, qcap=qcap, nchunks=nchunks, stride=m,
                starts=(0, nd), a0=(a0,), width=(w,), jd=jd,
                lookahead=fits[0], slot=slot, nslot=jspan + fits[0],
                smem_bytes=(jspan + fits[0]) * slot * itemsize)
    return best


@functools.lru_cache(maxsize=256)
def psdia_spmm_plan(offsets: tuple[int, ...], nrhs: int,
                    itemsize: int) -> SpmmWindowPlan:
    """The shared-memory plan of K3a and K3b for the diagonal ``offsets``
    (in stored order), ``nrhs`` right-hand sides and values of
    ``itemsize`` bytes (the tiles start at the pack's ``L``, so neither
    ``rb`` nor the period enters it):
    the stride walk (:func:`_stride_walk`) where it stages fewer columns a
    tile than the cluster walk's windows together (the 2-D Poisson:
    ``tk + 8`` against ``3 tk + 8``), else the cluster walk
    (:func:`_cluster_walk`).  Windows start and end on 16-byte boundaries
    (the kernel's copies)."""
    offsets = tuple(int(o) for o in offsets)
    clusters = _cluster_walk(offsets, nrhs, itemsize)
    stride = _stride_walk(offsets, nrhs, itemsize)
    if stride is not None and stride.width[0] < sum(clusters.width):
        return stride
    return clusters


def _spmm_launch(A: SDIA | PSDIA, Xt_pad: torch.Tensor,
                 plan: SpmmWindowPlan) -> torch.Tensor:
    """Launch K3a (an SDIA pack: its data rows are the coefficients) or
    K3b (a PSDIA pack: its pattern) with ``plan`` on checked CUDA operands;
    count it.  The launcher refuses a plan that does not fit."""
    sdia = isinstance(A, SDIA)
    Yt = torch.empty_like(Xt_pad)
    offs = _offsets_on(A.offsets, Xt_pad.device)
    table = _offsets_on(plan.table, Xt_pad.device)
    name = "sdia_spmm" if sdia else "psdia_spmm"
    _build.launcher(name, Xt_pad.dtype)(
        Xt_pad, (A.data if sdia else A.pattern).data_ptr(), offs.data_ptr(),
        A.ndiags, table.data_ptr(), plan.nclusters, plan.stride, plan.qt,
        plan.tk, plan.slot, plan.nslot, A.rb, Xt_pad.data_ptr(),
        Yt.data_ptr(), A.npad, A.L, A.shape[0], Xt_pad.shape[0])
    LAUNCHES[name] += 1
    return Yt


def spmm_psdia_padded_t(A: PSDIA, Xt_pad: torch.Tensor) -> torch.Tensor:
    """``Yt_pad = (A @ Xt_pad.T).T`` for transposed ``[nrhs, npad]``
    operands — same contract as :func:`spmm_sdia_padded_t`; the rows
    outside ``[L, L + nrow)`` come out zero (the row mask).

    CUDA tensor: launches K3b (``psdia_spmm`` in ``csrc/dia_stream.cu``)
    with the tiling of :func:`psdia_spmm_plan`; CPU tensor:
    :func:`spmm_psdia_padded_t_ref`."""
    _check("spmm_psdia_padded_t", A.pattern, A, Xt_pad, A.rb, rhs_axis=True)
    if Xt_pad.is_cpu:
        return spmm_psdia_padded_t_ref(A, Xt_pad)
    return _spmm_launch(A, Xt_pad, psdia_spmm_plan(
        A.offsets, Xt_pad.shape[0], Xt_pad.element_size()))


def _spmm_plain_layout(A, X: torch.Tensor, kernel) -> torch.Tensor:
    """``A @ X`` for plain ``[n, nrhs]`` operands through a padded-t
    kernel: transpose and pad in, slice and transpose out (one copy each
    way, as the reference)."""
    if X.dim() != 2:
        raise ValueError(f"X must be [ncol, nrhs], got {tuple(X.shape)}")
    Xt = F.pad(X.T, (A.L, A.npad - A.L - X.shape[0])).contiguous()
    Yt = kernel(A, Xt)
    return Yt[:, A.L:A.L + A.shape[0]].T.contiguous()


def spmm_sdia(A: SDIA, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` with plain ``[n, nrhs]`` operands (K3a inside)."""
    return _spmm_plain_layout(A, X, spmm_sdia_padded_t)


def spmm_psdia(A: PSDIA, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` with plain ``[n, nrhs]`` operands (K3b inside)."""
    return _spmm_plain_layout(A, X, spmm_psdia_padded_t)


# ---------------------------------------------------------------------------
# the walks of K2 and K8b (csrc/psdia_walk.cuh)
# ---------------------------------------------------------------------------

#: the walks' tile (``kWalkTile`` in ``csrc/psdia_walk.cuh``): 256 threads
#: of 4 rows, K3b's tile at one right-hand side
WALK_TILE = 1024
#: slots of the cluster walk's ring (``kWalkStages``)
WALK_STAGES = SPMM_STAGES
#: windows the bulk stride walk keeps in flight, at most (``kBulkAhead``)
BULK_AHEAD = 3


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """The walk of K2 over a pack's padded row space, or of K8b over a
    shard (:func:`psdia_walk_plan`), in tiles of :data:`WALK_TILE` rows;
    column ``j`` of a window is ``xpad[j]`` (K2; zero outside ``[0,
    npad)``) or of the ring ``[left | x | right]`` (K8b; ``x[0]`` is
    column 0).

    - ``stride == 0``, the cluster walk: cluster ``c`` is diagonals
      ``starts[c]:starts[c + 1]``; for the tile at row ``k0`` its window
      is columns ``k0 + a0[c] .. k0 + a0[c] + width[c]``, staged with the
      cluster's coefficient rows in a ring of :data:`WALK_STAGES` slots.
    - ``stride == M > 0``, the stride walk: one window a tile, columns
      ``k0 + a0[0] .. k0 + a0[0] + width[0]``; diagonal ``d`` reads the
      window of the tile ``jd[d] * M`` tiles away, so a tile reads
      ``jspan`` windows and the ring holds those and the copies in flight.
      With ``reuse`` (``M * WALK_TILE`` a multiple of the pattern's period)
      every tile of a segment has the same coefficient rows and a block
      stages them once per segment, ahead of the ring; otherwise each slot
      holds a tile's rows before its window.  The windows and rows
      arrive by bulk copy where the operands are 16-byte aligned
      (``ahead`` windows in flight), else by ``cp.async`` (one in flight).

    ``slot`` elements a slot, ``smem_bytes`` the ring of the ``cp.async``
    walk; ``ahead`` is 0 on the cluster walk."""

    stride: int
    starts: tuple[int, ...]
    a0: tuple[int, ...]
    width: tuple[int, ...]
    jd: tuple[int, ...]
    slot: int
    reuse: bool
    smem_bytes: int
    ahead: int = 0

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
        """Slots in the ``cp.async`` walk's ring, a constant of the walk
        (the kernel's launcher derives it the same way)."""
        return self.jspan + 1 if self.stride else WALK_STAGES

    @property
    def table(self) -> tuple[int, ...]:
        """What the kernel reads: the cluster walk's starts, window starts
        and widths (K3b's ``SpmmWindowPlan.table``), or the stride walk's
        lowest ``jd``, window start, width and every ``jd``."""
        if not self.stride:
            return self.starts + self.a0 + self.width
        return (min(self.jd), self.a0[0], self.width[0]) + self.jd



def psdia_cluster_walk(offsets: tuple[int, ...],
                       itemsize: int) -> WalkPlan:
    """The cluster walk: K3b's at one right-hand side
    (:func:`_cluster_walk`), which every operand has."""
    k3b = _cluster_walk(tuple(int(o) for o in offsets), 1, itemsize)
    assert k3b.tk == WALK_TILE and k3b.nslot == WALK_STAGES
    return WalkPlan(stride=0, starts=k3b.starts, a0=k3b.a0, width=k3b.width,
                    jd=(), slot=k3b.slot, reuse=False,
                    smem_bytes=k3b.smem_bytes)


@functools.lru_cache(maxsize=256)
def psdia_walk_plan(offsets: tuple[int, ...], period: int,
                    itemsize: int) -> WalkPlan:
    """The walk of K2 and K8b for the diagonal ``offsets`` (stored order),
    a pattern of ``period`` (any multiple of the true period is safe:
    ``rb`` always is) and values of ``itemsize`` bytes, chosen as K3b
    chooses at one right-hand side (:func:`psdia_spmm_plan`): the stride
    walk (:func:`_stride_walk`) where its window is narrower than the
    cluster walk's windows together (:func:`psdia_cluster_walk`), else the
    cluster walk; windows on 16-byte boundaries.  The stride walk reuses
    the coefficient rows where its stride is a multiple of ``period`` and
    copies by bulk copy where the operands allow, with ``ahead`` windows
    in flight: the most up to :data:`BULK_AHEAD` whose ring leaves room
    for two blocks an SM, else one.  Its ``cp.async`` ring (operands not
    16-byte aligned) keeps one window in flight beside the ``jspan`` it
    reads (three blocks an SM, the kernel's register cap: more
    ``cp.async`` windows in flight were slower on the card)."""
    offsets = tuple(int(o) for o in offsets)
    clusters = psdia_cluster_walk(offsets, itemsize)
    k3b = _stride_walk(offsets, 1, itemsize)
    if k3b is None or k3b.width[0] >= sum(clusters.width):
        return clusters
    nd, w = len(offsets), k3b.width[0]
    jspan = max(k3b.jd) - min(k3b.jd) + 1
    reuse = k3b.stride * WALK_TILE % int(period) == 0
    coef = nd * WALK_TILE if reuse else 0
    slot = _roundup(w if reuse else nd * WALK_TILE + w, 4)
    ahead = next((a for a in range(BULK_AHEAD, 1, -1)
                  if ((jspan + a) * slot + coef) * itemsize
                  <= _TWO_BLOCK_SMEM), 1)
    return WalkPlan(
        stride=k3b.stride, starts=(0, nd), a0=k3b.a0, width=(w,),
        jd=k3b.jd, slot=slot, reuse=reuse,
        smem_bytes=((jspan + 1) * slot + coef) * itemsize, ahead=ahead)


@functools.lru_cache(maxsize=256)
def check_walk(plan: WalkPlan, offsets: tuple[int, ...],
               itemsize: int) -> None:
    """Raise ``ValueError`` where K2 or K8b could not run ``plan`` on the
    diagonal ``offsets`` (stored order) with values of ``itemsize`` bytes:
    every row of a tile must read inside a staged window, windows and
    slots on 16-byte boundaries, each slot large enough for what is
    staged in it, the ring inside the shared-memory budget.  ``reuse`` is
    the pack's claim that the stride is a multiple of the pattern's period
    (``pack_psdia`` verifies the period) and is taken as given.  Cached:
    a plan is checked once per offsets and value type."""
    nd, vec = len(offsets), 16 // itemsize
    if plan.stride < 0 or not plan.nclusters:
        raise ValueError(f"psdia walk: no walk in {plan}")
    fault = None
    if (len(plan.width) != plan.nclusters
            or len(plan.starts) != plan.nclusters + 1
            or plan.starts[0] != 0 or plan.starts[-1] != nd
            or any(a >= b for a, b in zip(plan.starts, plan.starts[1:]))):
        fault = f"clusters {plan.starts} do not split {nd} diagonals"
    elif any(v % vec for v in plan.a0 + plan.width + (plan.slot,)):
        fault = "windows or slots off 16-byte boundaries"
    elif plan.stride:
        span = plan.stride * WALK_TILE
        reads = [(o - j * span, 0) for o, j in zip(offsets, plan.jd)]
        need = plan.width[0] + (0 if plan.reuse else nd * WALK_TILE)
        if plan.nclusters != 1 or len(plan.jd) != nd:
            fault = f"a stride walk needs one window and {nd} jd"
    else:
        reads = [(o, c) for c in range(plan.nclusters)
                 for o in offsets[plan.starts[c]:plan.starts[c + 1]]]
        need = max((plan.starts[c + 1] - plan.starts[c]) * WALK_TILE
                   + plan.width[c] for c in range(plan.nclusters))
        if plan.jd or plan.reuse:
            fault = "a cluster walk has no jd and no coefficient reuse"
    if fault is None:
        if any(off < plan.a0[c] or off + WALK_TILE > plan.a0[c] + plan.width[c]
               for off, c in reads):
            fault = "a row reads outside its window"
        elif plan.slot < need:
            fault = f"slots of {plan.slot} hold less than {need}"
        elif ((plan.nslot + plan.ahead - 1 if plan.stride else plan.nslot)
              * plan.slot + (nd * WALK_TILE if plan.reuse else 0)) * itemsize \
                + (0 if plan.stride else 4 * (nd + len(plan.table))) \
                > SPMM_SMEM_MAX:
            fault = "the ring exceeds the shared-memory budget"
        elif not (1 <= plan.ahead <= BULK_AHEAD if plan.stride
                  else plan.ahead == 0):
            fault = f"{plan.ahead} bulk windows in flight"
        elif plan.jspan > 3:
            fault = f"a tile reads {plan.jspan} windows, the kernel 3 at most"
    if fault:
        raise ValueError(f"psdia walk: the walk does not fit the offsets "
                         f"{offsets}: {fault}")


class _WalkArgs(ctypes.Structure):
    """A walk's launch arguments as the kernels' launcher reads them
    (``WalkArgs`` in ``csrc/psdia_walk.cuh``)."""

    _fields_ = [("offsets", ctypes.c_void_p), ("table", ctypes.c_void_p),
                ("rb", ctypes.c_int64), ("ndiags", ctypes.c_int),
                ("nclusters", ctypes.c_int), ("stride", ctypes.c_int),
                ("slot", ctypes.c_int), ("jspan", ctypes.c_int),
                ("reuse", ctypes.c_int), ("ahead", ctypes.c_int),
                ("direct_tiles", ctypes.c_int)]


@functools.cache
def _direct_tiles(device: torch.device) -> int:
    """The most tiles of :data:`WALK_TILE` rows holding rows of the
    operand for which K2 runs one thread a row (``psdia_walk_direct``)
    and not its walk: four per SM of the card (an operand that small sits
    in L2, and staging its tiles cost more than it saved: on the H100 the
    walk lost to one thread a row at 144 and 256 tiles and held its own
    at 1024); 0 off a card."""
    if device.type != "cuda":
        return 0
    return 4 * torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _walk_args(plan: WalkPlan, offsets: tuple[int, ...], rb: int,
               device: torch.device,
               direct: bool = False) -> tuple[_WalkArgs, int]:
    """The launch arguments of ``plan`` for the diagonal ``offsets`` and
    row tile ``rb`` on ``device`` (the offsets and the plan's table as
    device tensors, :func:`_offsets_on`, and the plan's scalars), made
    once, and their address: a launch passes one pointer.  With
    ``direct`` (K2's wrapper) an operand of at most :func:`_direct_tiles`
    tiles runs one thread a row; otherwise (K8b, a walk asked for by
    name) always the walk.  Entries are never dropped, like the tensors
    they point to."""
    args = _WalkArgs(_offsets_on(offsets, device).data_ptr(),
                     _offsets_on(plan.table, device).data_ptr(), rb,
                     len(offsets), plan.nclusters, plan.stride, plan.slot,
                     plan.jspan, int(plan.reuse), plan.ahead,
                     _direct_tiles(device) if direct else 0)
    return args, ctypes.addressof(args)


@functools.cache
def _walk_launch(offsets: tuple[int, ...], period: int, rb: int,
                 itemsize: int, device: torch.device):
    """K2's walk for one pack key, made once: the plan
    (:func:`psdia_walk_plan`, checked by :func:`check_walk`) and the
    address of its launch arguments (:func:`_walk_args`, one thread a row
    on few tiles)."""
    plan = psdia_walk_plan(offsets, period, itemsize)
    check_walk(plan, offsets, itemsize)
    return plan, _walk_args(plan, offsets, rb, device, True)[1]
