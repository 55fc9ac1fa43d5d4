"""The permutation engine — ``out[i] = x[perm[i]]`` — as one gather kernel.

Counterpart of ``tpu_spmv/kernels/permute.py``.  The reference routes an
arbitrary permutation on the host as a Clos network (``plan_permutation``:
int8 lane-gather planes, a row exchange, a two-level form past ~1.6M
entries) because a TPU gathers fast only inside 128 lanes; its Pallas
kernels K7a–K7e apply the planes.  A Hopper thread reads any address, so
the port's plan is the index vector itself and one gather applies it:

- :class:`PermutationPlan` holds ``perm`` on the device (int32 while
  ``n < 2**31``, else int64) and ``n``; :func:`plan_permutation` and
  :func:`plan_permutation_auto` give the same plan at every ``n``;
- :func:`apply_permutation` (K7a–K7c) launches ``permute_gather`` of
  ``csrc/permute.cu``; :func:`apply_permutation_batched` (K7d/K7e) launches
  ``permute_gather_batched`` on ``[nrhs, n]`` with one perm for every row;
- :func:`plan_tile_permutation` / :func:`apply_tile_permutation` are the
  same gather on one ``[128, 128]`` tile (16384 entries).

A negative ``perm[i]`` is a don't-care slot, as in the reference; the
reference leaves garbage there, the port writes zero.  The kernels move
words without arithmetic, so the result is bitwise ``x[perm]``.

On a CUDA tensor the wrappers launch the kernels and count the launch in
:data:`LAUNCHES`; on a CPU tensor they run the plain versions (``*_ref``,
an ``index_select``).  Nothing falls back from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.base import sparse_dataclass
from . import _build

__all__ = ["Q", "TILE", "LAUNCHES", "PermutationPlan", "permute_reference",
           "plan_permutation", "plan_permutation_auto",
           "plan_tile_permutation", "apply_permutation",
           "apply_permutation_ref", "apply_permutation_batched",
           "apply_permutation_batched_ref", "apply_tile_permutation",
           "apply_tile_permutation_ref"]

#: the reference's tile edge; a tile permutation has ``TILE`` entries
Q = 128
TILE = Q * Q
#: kernel launches by the wrappers on CUDA tensors (plain-version calls on
#: CPU tensors are not counted)
LAUNCHES = {"permute": 0, "permute_batched": 0}
_WORD_BYTES = (1, 2, 4, 8)


def permute_reference(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """``out[i] = x[perm[i]]`` (numpy oracle, the reference's)."""
    return np.asarray(x).ravel()[perm].reshape(np.asarray(x).shape)


@sparse_dataclass
class PermutationPlan:
    """``out.flat[i] = x.flat[perm[i]]`` for ``i < n``; ``perm[i] < 0`` is
    a don't-care slot (written as zero)."""

    perm: torch.Tensor          # [n] int32 (int64 when n >= 2**31)
    n: int


def plan_permutation(perm, *, device="cuda") -> PermutationPlan:
    """The plan of an index vector (numpy or torch; entries ``< n``,
    negative = don't care) on ``device`` (default: the card)."""
    if isinstance(perm, torch.Tensor):
        p = perm.detach().to(device=device, dtype=torch.int64)
    else:
        p = torch.from_numpy(np.asarray(perm, dtype=np.int64)).to(device)
    if p.dim() != 1:
        raise ValueError(f"perm must be 1-D, got shape {tuple(p.shape)}")
    n = int(p.shape[0])
    if n and int(p.max()) >= n:
        raise ValueError(f"perm entries must be < n = {n}")
    p = torch.clamp(p, min=-1)
    if n < 2**31:
        p = p.to(torch.int32)
    return PermutationPlan(perm=p.contiguous(), n=n)


def plan_permutation_auto(perm, *, device="cuda") -> PermutationPlan:
    """:func:`plan_permutation` at every ``n``: the reference's
    single-level cap and two-level routing are VMEM and Clos facts."""
    return plan_permutation(perm, device=device)


def plan_tile_permutation(perm, *, device="cuda") -> PermutationPlan:
    """The plan of a permutation of one ``[128, 128]`` tile (flat,
    row-major; ``TILE`` entries)."""
    if tuple(np.shape(perm)) != (TILE,):
        raise ValueError(f"perm must have {TILE} entries")
    return plan_permutation(perm, device=device)


def _check(name: str, plan: PermutationPlan, x: torch.Tensor) -> None:
    if plan.perm.device != x.device:
        raise ValueError(f"{name}: plan on {plan.perm.device}, x on "
                         f"{x.device}")
    if x.element_size() not in _WORD_BYTES:
        raise TypeError(f"{name}: no kernel for {x.dtype}")


def _gather_ref(plan: PermutationPlan, x2: torch.Tensor) -> torch.Tensor:
    """``x2[..., perm]`` along the last axis, zero at don't-care slots."""
    idx = plan.perm.long()
    out = torch.index_select(x2, -1, idx.clamp(min=0))
    return torch.where(idx >= 0, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))


def _launch(kernel: str, key: str, plan: PermutationPlan, src: torch.Tensor,
            *nrhs: int) -> torch.Tensor:
    out = torch.empty_like(src)
    _build.launcher(kernel)(
        src, src.data_ptr(), plan.perm.data_ptr(), plan.perm.element_size(),
        out.data_ptr(), plan.n, *nrhs, src.element_size())
    LAUNCHES[key] += 1
    return out


def apply_permutation_ref(plan: PermutationPlan,
                          x: torch.Tensor) -> torch.Tensor:
    """Plain version of K7a–K7c: ``x.flat[perm]`` in ``x``'s shape."""
    return _gather_ref(plan, x.reshape(-1)).reshape(x.shape)


def apply_permutation(plan: PermutationPlan, x: torch.Tensor) -> torch.Tensor:
    """``out.flat[i] = x.flat[perm[i]]`` in ``x``'s shape (``x.numel() ==
    plan.n``).

    CUDA tensor: launches ``permute_gather`` (``csrc/permute.cu``); CPU
    tensor: :func:`apply_permutation_ref`."""
    _check("apply_permutation", plan, x)
    if x.numel() != plan.n:
        raise ValueError(f"apply_permutation: x has {x.numel()} elements, "
                         f"the plan {plan.n}")
    if x.is_cpu:
        return apply_permutation_ref(plan, x)
    return _launch("permute_gather", "permute", plan,
                   x.reshape(-1).contiguous()).reshape(x.shape)


def apply_permutation_batched_ref(plan: PermutationPlan,
                                  X: torch.Tensor) -> torch.Tensor:
    """Plain version of K7d/K7e: ``X[:, perm]``."""
    return _gather_ref(plan, X)


def apply_permutation_batched(plan: PermutationPlan,
                              X: torch.Tensor) -> torch.Tensor:
    """One permutation applied to every row: ``X [nrhs, n]`` → same
    shape, ``out[q, i] = X[q, perm[i]]``.

    CUDA tensor: launches ``permute_gather_batched``; CPU tensor:
    :func:`apply_permutation_batched_ref`."""
    _check("apply_permutation_batched", plan, X)
    if X.dim() != 2 or X.shape[1] != plan.n:
        raise ValueError(f"apply_permutation_batched: X must be [nrhs, "
                         f"{plan.n}], got {tuple(X.shape)}")
    if X.is_cpu:
        return apply_permutation_batched_ref(plan, X)
    if not X.is_contiguous():
        raise ValueError("apply_permutation_batched: X must be contiguous")
    return _launch("permute_gather_batched", "permute_batched", plan, X,
                   X.shape[0])


def apply_tile_permutation_ref(x: torch.Tensor,
                               plan: PermutationPlan) -> torch.Tensor:
    """Plain version of K7a on one ``[128, 128]`` tile."""
    return apply_permutation_ref(plan, x)


def apply_tile_permutation(x: torch.Tensor,
                           plan: PermutationPlan) -> torch.Tensor:
    """Apply a tile plan to a ``[128, 128]`` array (the reference's
    argument order): ``permute_gather`` over the flat tile."""
    if tuple(x.shape) != (Q, Q) or plan.n != TILE:
        raise ValueError(f"apply_tile_permutation: needs a [{Q}, {Q}] tile "
                         f"and a {TILE}-entry plan, got {tuple(x.shape)} and "
                         f"{plan.n}")
    return apply_permutation(plan, x)
