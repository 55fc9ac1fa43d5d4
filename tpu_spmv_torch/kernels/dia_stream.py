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

The row-tile size ``rb`` keeps the reference's rule (``_auto_rb`` and the
``pack_psdia`` rb block, derived from TPU VMEM budgets, with their ``nrhs``
argument for the SpMM layout) so the packs are identical; on Hopper it only
decides the padding.
"""

from __future__ import annotations

import dataclasses
import functools
import math

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
           "spmm_psdia_padded_t", "spmm_psdia_padded_t_ref", "spmm_psdia"]

#: floor rows per row tile (the reference's rule, see module docstring)
RB = 16384
RB_MAX = 131072
#: per-buffer budget for the reference's [ndiags, rb] data block
_DATA_BLOCK_BUDGET = 3 << 20
#: the reference's budget for the [nrhs, rb] RHS panels of the SpMM layout
_RHS_PANEL_BUDGET = 8 << 20
#: kernel launches by the wrappers on CUDA tensors (plain-version calls on
#: CPU tensors are not counted)
LAUNCHES = {"sdia": 0, "psdia": 0, "sdia_spmm": 0, "psdia_spmm": 0}
#: the kernels keep the offsets in 48 KB of shared memory
_MAX_DIAGS = 12288
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


def pack_sdia(dia: DIA, rb: int | None = None, *, nrhs: int = 1,
              device=None) -> SDIA:
    """Lay a DIA matrix out in padded row space on ``device`` (default:
    the DIA's device); ``rb=None`` picks the tile with :func:`_auto_rb`,
    for the ``nrhs`` the pack will mostly serve (the reference's rule, so
    the pack equals the reference's for the same arguments)."""
    nrow, _ = dia.shape
    if rb is None:
        rb = _auto_rb(dia.ndiags, dia.offsets, nrow, nrhs=nrhs,
                      itemsize=dia.data.element_size())
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
    data = F.pad(dia.data.to(device), (L, npad - L - nrow)).contiguous()
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
    data = dia.data.numpy()
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
               nrhs: int = 1, verify: bool = True, device=None) -> PSDIA:
    """Build the periodic streaming operator on ``device`` (default: the
    DIA's device).  ``rb=None`` picks the reference's tile for ``nrhs``
    right-hand sides.

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
        isz = dia.data.element_size()
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
    pattern = pat.to(device).repeat(1, rb // P).contiguous()
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


def spmv_sdia_padded_ref(A: SDIA, xpad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: per-diagonal zero-filled shifts of
    ``xpad`` times the diagonal data, summed in ascending offset order.
    A leading axis of ``xpad`` (the SpMM's RHS axis) broadcasts."""
    acc = A.data[0] * _shift(xpad, A.offsets[0])
    for d, off in enumerate(A.offsets[1:], start=1):
        acc = acc + A.data[d] * _shift(xpad, off)
    return acc


def spmv_psdia_padded_ref(A: PSDIA, xpad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: the same sum with the pattern tiled
    over the row tiles, then the row-validity mask."""
    reps = A.npad // A.rb
    acc = A.pattern[0].repeat(reps) * _shift(xpad, A.offsets[0])
    for d, off in enumerate(A.offsets[1:], start=1):
        acc = acc + A.pattern[d].repeat(reps) * _shift(xpad, off)
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


@functools.lru_cache(maxsize=64)
def _offsets_on(offsets: tuple[int, ...], device: torch.device):
    """The offsets as a device ``int32`` tensor, made once per pack."""
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def _check(name: str, coef: torch.Tensor, A, xpad: torch.Tensor,
           width: int, rhs_axis: bool = False) -> None:
    """Raise on anything the kernels do not take: ``xpad`` is ``[npad]``,
    or ``[nrhs, npad]`` with ``rhs_axis``."""
    if xpad.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: x must be float32 or float64, "
                        f"got {xpad.dtype}")
    if coef.dtype != xpad.dtype:
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


def _fn(lib, kernel: str, dtype: torch.dtype):
    suffix = "f32" if dtype == torch.float32 else "f64"
    return getattr(lib, f"tsp_{kernel}_{suffix}")


def spmv_sdia_padded(A: SDIA, xpad: torch.Tensor) -> torch.Tensor:
    """``ypad = A @ xpad`` in padded row space (``[npad] -> [npad]``,
    chainable: the pads stay zero because the pad rows hold zero data).

    CUDA tensor: launches K1 (``sdia_spmv`` in ``csrc/dia_stream.cu``);
    CPU tensor: :func:`spmv_sdia_padded_ref`."""
    _check("spmv_sdia_padded", A.data, A, xpad, A.npad)
    if xpad.device.type == "cpu":
        return spmv_sdia_padded_ref(A, xpad)
    if xpad.device.type != "cuda":
        raise ValueError(f"spmv_sdia_padded: no kernel for {xpad.device}")
    lib = _build.load()
    y = torch.empty_like(xpad)
    offs = _offsets_on(A.offsets, xpad.device)
    # the launch goes to the calling thread's current device: make it x's
    with torch.cuda.device(xpad.device):
        stream = torch.cuda.current_stream(xpad.device).cuda_stream
        code = _fn(lib, "sdia_spmv", xpad.dtype)(
            A.data.data_ptr(), offs.data_ptr(), A.ndiags, xpad.data_ptr(),
            y.data_ptr(), A.npad, stream)
    _build.check(lib, "sdia_spmv", code)
    LAUNCHES["sdia"] += 1
    return y


def spmv_psdia_padded(A: PSDIA, xpad: torch.Tensor) -> torch.Tensor:
    """``ypad = A @ xpad`` in padded row space — same contract as
    :func:`spmv_sdia_padded`; the pads stay zero through the row mask.

    CUDA tensor: launches K2 (``psdia_spmv`` in ``csrc/dia_stream.cu``);
    CPU tensor: :func:`spmv_psdia_padded_ref`."""
    _check("spmv_psdia_padded", A.pattern, A, xpad, A.rb)
    if xpad.device.type == "cpu":
        return spmv_psdia_padded_ref(A, xpad)
    if xpad.device.type != "cuda":
        raise ValueError(f"spmv_psdia_padded: no kernel for {xpad.device}")
    lib = _build.load()
    y = torch.empty_like(xpad)
    offs = _offsets_on(A.offsets, xpad.device)
    with torch.cuda.device(xpad.device):
        stream = torch.cuda.current_stream(xpad.device).cuda_stream
        code = _fn(lib, "psdia_spmv", xpad.dtype)(
            A.pattern.data_ptr(), offs.data_ptr(), A.ndiags, A.rb,
            xpad.data_ptr(), y.data_ptr(), A.npad, A.L, A.shape[0], stream)
    _build.check(lib, "psdia_spmv", code)
    LAUNCHES["psdia"] += 1
    return y


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
    ``q`` in padded row space).

    CUDA tensor: launches K3a (``sdia_spmm`` in ``csrc/dia_stream.cu``);
    CPU tensor: :func:`spmm_sdia_padded_t_ref`."""
    _check("spmm_sdia_padded_t", A.data, A, Xt_pad, A.npad, rhs_axis=True)
    if Xt_pad.device.type == "cpu":
        return spmm_sdia_padded_t_ref(A, Xt_pad)
    if Xt_pad.device.type != "cuda":
        raise ValueError(f"spmm_sdia_padded_t: no kernel for {Xt_pad.device}")
    lib = _build.load()
    Yt = torch.empty_like(Xt_pad)
    offs = _offsets_on(A.offsets, Xt_pad.device)
    with torch.cuda.device(Xt_pad.device):
        stream = torch.cuda.current_stream(Xt_pad.device).cuda_stream
        code = _fn(lib, "sdia_spmm", Xt_pad.dtype)(
            A.data.data_ptr(), offs.data_ptr(), A.ndiags, Xt_pad.data_ptr(),
            Yt.data_ptr(), A.npad, Xt_pad.shape[0], stream)
    _build.check(lib, "sdia_spmm", code)
    LAUNCHES["sdia_spmm"] += 1
    return Yt


def spmm_psdia_padded_t(A: PSDIA, Xt_pad: torch.Tensor) -> torch.Tensor:
    """``Yt_pad = (A @ Xt_pad.T).T`` for transposed ``[nrhs, npad]``
    operands — same contract as :func:`spmm_sdia_padded_t`; the rows
    outside ``[L, L + nrow)`` come out zero (the row mask).

    CUDA tensor: launches K3b (``psdia_spmm`` in ``csrc/dia_stream.cu``);
    CPU tensor: :func:`spmm_psdia_padded_t_ref`."""
    _check("spmm_psdia_padded_t", A.pattern, A, Xt_pad, A.rb, rhs_axis=True)
    if Xt_pad.device.type == "cpu":
        return spmm_psdia_padded_t_ref(A, Xt_pad)
    if Xt_pad.device.type != "cuda":
        raise ValueError(f"spmm_psdia_padded_t: no kernel for "
                         f"{Xt_pad.device}")
    lib = _build.load()
    Yt = torch.empty_like(Xt_pad)
    offs = _offsets_on(A.offsets, Xt_pad.device)
    with torch.cuda.device(Xt_pad.device):
        stream = torch.cuda.current_stream(Xt_pad.device).cuda_stream
        code = _fn(lib, "psdia_spmm", Xt_pad.dtype)(
            A.pattern.data_ptr(), offs.data_ptr(), A.ndiags, A.rb,
            Xt_pad.data_ptr(), Yt.data_ptr(), A.npad, A.L, A.shape[0],
            Xt_pad.shape[0], stream)
    _build.check(lib, "psdia_spmm", code)
    LAUNCHES["psdia_spmm"] += 1
    return Yt


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
