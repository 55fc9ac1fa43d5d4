"""Distributed geometric multigrid: the MG-PCG preconditioner on a mesh.

Counterpart of ``tpu_spmv/solvers/dist_multigrid.py``.  The serial V-cycle
(:mod:`.multigrid`) is stencil arithmetic, and the only reads that cross a
row-sharded grid are the +-1-row neighbour reads of the smoother and
residual stencil and the one-row support of the cell-centred transfers.
So each shard holds a ``[gx / ndev, ...]`` slab of the grid (the flat
vector's uniform split lands on slab boundaries when ``gx % ndev == 0``)
and runs the serial arithmetic on it:

- **halos**: the stencil reads one row from each neighbour, copied from
  the neighbour's slab to the shard's device (the reference's
  ``ppermute``); a shard at a global edge gets zeros, the Dirichlet
  closure;
- **prolongation** along axis 0 reads the same halos, and a shard at a
  global edge clamps to its own boundary row, as the serial
  :func:`.multigrid._interp1d` clamps; the other axes are local;
- **restriction** is the exact adjoint of that sharded prolongation,
  written out from :func:`.multigrid._interp1d_adjoint`: the fine rows
  whose prolongation read a neighbour's row go back to that neighbour (the
  transpose of the halo copy), which adds them into its own coarse rows.
  Exact adjointness across shards keeps the V-cycle symmetric, so a valid
  PCG preconditioner;
- **replicated tail**: once a level's slab would be thinner than
  ``max(min_local, 2)`` rows (or odd), the slabs are gathered once on
  shard 0's device and the serial cycle (:func:`.multigrid._vcycle`) runs
  the remaining levels there; each shard's slab of the correction is then
  copied back.  One controller computes the tail once, where the
  reference computes it on every device; the numbers are the same.

Each sharded step does the serial step's elementwise operations in the
serial order on the shard's rows, so the cycle is the serial
:func:`.multigrid.mg_preconditioner` (same hierarchy, smoother and
Chebyshev coarsest solve).  The V-cycle has no reduction and no kernel:
the reference's is XLA code with no Pallas, and this is torch code.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from ..dist.sharded import ShardedVector
from .multigrid import (_check_sweeps, _interp1d, _interp1d_adjoint,
                        _levels, _vcycle)

__all__ = ["dist_mg_preconditioner"]


def _halos(us, devices):
    """``(row above, row below)`` of each shard's slab: the neighbours'
    boundary rows copied to the shard's device; a global edge gets
    ``None``."""
    n = len(us)
    return ([us[s - 1][-1:].to(devices[s]) if s > 0 else None
             for s in range(n)],
            [us[s + 1][:1].to(devices[s]) if s < n - 1 else None
             for s in range(n)])


def _stencil(us, shift: float, devices):
    """The serial :func:`.multigrid.poisson_stencil_apply` on axis-0
    slabs: ``(2d + shift) u`` minus the neighbours, axis 0 first (its
    reads past the slab from the halos, zero at a global edge), then the
    local axes, each subtraction in the serial order."""
    d = us[0].dim()
    ups, dns = _halos(us, devices)
    ys = []
    for u, up, dn in zip(us, ups, dns):
        y = (2 * d + shift) * u
        lx = u.shape[0]
        y.narrow(0, 0, lx - 1).sub_(u.narrow(0, 1, lx - 1))
        if dn is not None:
            y.narrow(0, lx - 1, 1).sub_(dn)
        y.narrow(0, 1, lx - 1).sub_(u.narrow(0, 0, lx - 1))
        if up is not None:
            y.narrow(0, 0, 1).sub_(up)
        for ax in range(1, d):
            g = u.shape[ax]
            y.narrow(ax, 0, g - 1).sub_(u.narrow(ax, 1, g - 1))
            y.narrow(ax, 1, g - 1).sub_(u.narrow(ax, 0, g - 1))
        ys.append(y)
    return ys


def _prolong(us, devices):
    """d-linear prolongation of axis-0 slabs: axis 0 with the halos (a
    global edge clamps to its own boundary row), then the local axes."""
    ups, dns = _halos(us, devices)
    fs = []
    for u, up, dn in zip(us, ups, dns):
        lx = u.shape[0]
        um = torch.cat([u[:1] if up is None else up, u.narrow(0, 0, lx - 1)])
        uq = torch.cat([u.narrow(0, 1, lx - 1), u[-1:] if dn is None else dn])
        even = (3.0 * u + um) * 0.25
        odd = (3.0 * u + uq) * 0.25
        f = torch.stack([even, odd], dim=1).reshape(
            (2 * lx,) + tuple(u.shape[1:]))
        for ax in range(1, u.dim()):
            f = _interp1d(f, ax)
        fs.append(f)
    return fs


def _restrict(rs, devices):
    """The exact adjoint of :func:`_prolong`, scaled by ``2^-d``: the local
    axes' adjoints in reverse order, then axis 0's with each shard's
    boundary fine rows sent back to the neighbour whose row their
    prolongation read."""
    d = rs[0].dim()
    for ax in reversed(range(1, d)):
        rs = [_interp1d_adjoint(r, ax) for r in rs]
    n = len(rs)
    pairs = [r.reshape((r.shape[0] // 2, 2) + tuple(r.shape[1:]))
             for r in rs]
    es = [p.select(1, 0) for p in pairs]
    os_ = [p.select(1, 1) for p in pairs]
    out = []
    for s, (e, o) in enumerate(zip(es, os_)):
        g = e.shape[0]
        # e[i] read u[i-1] and o[i] read u[i+1]: u[i] gets e[i+1] / 4 and
        # o[i-1] / 4; past the slab they are the neighbours' rows
        nxt = (es[s + 1][:1].to(devices[s]) if s < n - 1
               else torch.zeros_like(e[:1]))
        prv = (os_[s - 1][-1:].to(devices[s]) if s > 0
               else torch.zeros_like(o[:1]))
        e_back = torch.cat([e.narrow(0, 1, g - 1), nxt])
        o_fwd = torch.cat([prv, o.narrow(0, 0, g - 1)])
        u = 0.75 * (e + o) + 0.25 * (e_back + o_fwd)
        if s == 0:                   # the clamped ends fold onto themselves
            u.narrow(0, 0, 1).add_(0.25 * e.narrow(0, 0, 1))
        if s == n - 1:
            u.narrow(0, g - 1, 1).add_(0.25 * o.narrow(0, g - 1, 1))
        out.append(u * (0.5 ** d))
    return out


def dist_mg_preconditioner(mesh, grid_shape: Sequence[int], *,
                           shift: float = 0.0, nu1: int = 2, nu2: int = 2,
                           omega: float = 0.8, coarsest: int = 8,
                           coarse_degree: int = 16,
                           min_local: int = 8) -> Callable:
    """``apply(r: ShardedVector) -> ShardedVector``, the V-cycle
    preconditioner of the axis-0-sharded grid operator
    ``laplacian_2d/_3d(...) + shift·I`` (2-D and 3-D grids) on ``mesh``.

    Pass it as ``precond=`` to :func:`~.dist_cg.dist_cg`.  The vector must
    be the uniform split (:func:`~..dist.partition.plan_uniform`, or
    ``plan_rows(balance="rows")``, which is the same split here) of the
    flat ``[prod(grid_shape)]`` grid vector with ``grid_shape[0] % ndev ==
    0``.  Levels whose slab would be thinner than ``max(min_local, 2)``
    rows run on shard 0's device (module docstring); the other arguments
    are :func:`~.multigrid.mg_preconditioner`'s."""
    gshape = tuple(int(g) for g in grid_shape)
    d = len(gshape)
    if d not in (2, 3):
        raise ValueError(f"dist_mg_preconditioner supports 2-D/3-D "
                         f"grids, got {gshape}")
    gx = gshape[0]
    devices = mesh.devices
    ndev = len(devices)
    if gx % ndev:
        raise ValueError(f"gx={gx} must be divisible by ndev={ndev}")
    _check_sweeps(nu1, nu2)
    shapes, shifts = _levels(gshape, shift, coarsest)
    nlev = len(shapes)
    # the sharded prefix: the local axis-0 slab stays even and at least
    # max(min_local, 2) rows
    nshard = 0
    while (nshard < nlev - 1
           and shapes[nshard][0] % ndev == 0
           and shapes[nshard][0] // ndev >= max(min_local, 2)
           and (shapes[nshard][0] // ndev) % 2 == 0):
        nshard += 1
    tail = _vcycle(shapes, shifts, nu1=nu1, nu2=nu2, omega=omega,
                   coarse_degree=coarse_degree)
    n = math.prod(gshape)
    C = n // ndev
    local0 = (gx // ndev,) + gshape[1:]

    def smooth(us, bs, lvl, sweeps):
        dinv = omega / (2 * d + shifts[lvl])
        for _ in range(sweeps):
            st = _stencil(us, shifts[lvl], devices)
            us = [u + dinv * (b - y) for u, b, y in zip(us, bs, st)]
        return us

    def vcycle(lvl, bs):
        if lvl == nshard:
            # gather the (small) level grid once, run the serial tail,
            # and copy each shard's slab back
            dev0 = devices[0]
            z = tail(lvl, torch.cat([b.to(dev0) for b in bs]))
            return [c.to(dev) for c, dev in zip(z.chunk(ndev), devices)]
        us = smooth([torch.zeros_like(b) for b in bs], bs, lvl, nu1)
        rs = [b - y for b, y in zip(bs, _stencil(us, shifts[lvl], devices))]
        es = vcycle(lvl + 1, _restrict(rs, devices))
        us = [u + 4.0 * p for u, p in zip(us, _prolong(es, devices))]
        return smooth(us, bs, lvl, nu2)

    starts = tuple(i * C for i in range(ndev + 1))

    def apply(r: ShardedVector) -> ShardedVector:
        if r.length != n or r.chunk_size != C or r.starts != starts:
            raise ValueError(
                f"dist_mg_preconditioner built for the uniform "
                f"{'x'.join(map(str, gshape))} grid split over {ndev} "
                f"shards (chunks of {C}); got length={r.length} "
                f"chunk={r.chunk_size}")
        zs = vcycle(0, [c.reshape(local0) for c in r.chunks])
        return ShardedVector(chunks=tuple(z.reshape(C) for z in zs),
                             starts=r.starts, length=r.length)

    return apply
