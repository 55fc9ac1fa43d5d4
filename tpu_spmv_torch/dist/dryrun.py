"""Dry runs of the distribution layer across processes.

Counterpart of ``__graft_entry__.py:dryrun_multichip``, run by one process
a shard over ``torch.distributed`` (:func:`~.mesh.init_multihost`):

- :func:`dryrun_multichip` runs, on the process mesh, the reference's one
  distributed step on its tiny operands — the halo, all-gather and
  column-split CSR products, the sharded DIA, GPR and periodic streaming
  DIA products, ``dot`` and ``axpy``, and the distributed V-cycle — each
  checked against scipy (or the serial V-cycle) with the reference's
  tolerances (``rtol=2e-5, atol=1e-6``);
- :func:`parity_cases` runs every distributed product, the reductions and
  the distributed solvers on small float64 operands on any mesh, so a
  process mesh's results can be held bitwise against the single
  controller's on the same shards;
- :func:`full_width` runs the planner's streaming products of the 4096²
  Poisson and Jacobi ``dist_cg`` on the 2048² Poisson, timed;
- :func:`spawn` starts ``n`` ranks on this host with
  ``torch.multiprocessing`` (forked from a server process that has
  imported this module, a free port on ``127.0.0.1``, a process-group
  timeout and a deadline for the whole group) and returns what each rank
  function returned.  A failed rank fails the group: nothing falls back to
  one process.

The rank functions live here, so a spawned rank imports torch and this
package only.  Usage::

    torchrun --nproc-per-node 4 -m tpu_spmv_torch.dist.dryrun
    python -m tpu_spmv_torch.dist.dryrun --nproc 4 --device cpu

The first joins the group torchrun describes (NCCL, one card a rank, where
there are cards); the second spawns the ranks itself, all on one device
(over Gloo: NCCL needs one card a rank).
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import socket
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import utils
from . import blas
from .mesh import STAGED, init_multihost, make_mesh
from .partition import plan_uniform
from .planned import plan_dist_spmv
from .sharded import (ColShardedCSR, HaloCSR, NeighborCSR, ShardedCSR,
                      ShardedVector)
from .spmv import (place, spmm_neighbor, spmv_allgather, spmv_colsplit,
                   spmv_halo, spmv_neighbor)

__all__ = ["dryrun_multichip", "parity_cases", "parity_rank", "full_width",
           "spawn", "Ranks", "main"]

#: the reference's tolerances against scipy (``__graft_entry__.py``)
RTOL, ATOL = 2e-5, 1e-6


def _local(v: ShardedVector) -> list:
    """The chunks this process holds, as host arrays."""
    return [v.chunks[s].cpu().numpy() for s in v.local]


def _sync(mesh) -> None:
    if mesh.devices[mesh.local[0]].type == "cuda":
        torch.cuda.synchronize()


def _counters():
    """The counters a rank zeroes at its start and returns: the launches
    of the kernels on the distributed path, and the staged exchanges."""
    from ..kernels import dia_stream, dist_stream, gpr

    return (dist_stream.LAUNCHES, gpr.LAUNCHES, dia_stream.LAUNCHES, STAGED)


def _zero_counters() -> None:
    for c in _counters():
        for k in c:
            c[k] = 0


def _read_counters(out: dict) -> dict:
    *kernels, staged = _counters()
    out["launches"] = {k: v for c in kernels for k, v in c.items() if v}
    out["staged"] = {k: v for k, v in staged.items() if v}
    return out


# ---------------------------------------------------------------------------
# the reference's dry run
# ---------------------------------------------------------------------------

def dryrun_multichip(n_devices: int, *, mesh=None, device=None) -> dict:
    """One distributed step of every strategy on tiny operands over an
    ``n_devices`` mesh — by default this process group's
    (:func:`~.mesh.make_mesh` with ``device``), else ``mesh`` — each
    product checked against scipy float64 and the V-cycle against the
    serial one (``rtol=2e-5, atol=1e-6``); raises ``AssertionError`` on a
    miss.  Returns each product's local chunks (host arrays), the
    replicated ``dot`` and the summary line."""
    from ..solvers import dist_mg_preconditioner, mg_preconditioner

    mesh = make_mesh(device=device) if mesh is None else mesh
    if mesh.ndev != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) on a mesh of "
                         f"{mesh.ndev} shards")
    n, f32 = n_devices, torch.float32
    dev = mesh.devices[mesh.local[0]]
    lap8 = utils.laplacian_2d(8)
    csr = lap8.astype(np.float32).tocsr()          # 64-row Poisson, tiny
    A = place(HaloCSR.build(csr, n, balance="nnz"), mesh)
    Ag = place(ShardedCSR.build(csr, n, balance="nnz"), mesh)
    Ac = place(ColShardedCSR.build(csr, n), mesh)
    # the planner's sharded DIA (the port plans small bands to streaming:
    # forced), GPR on a general pattern and the periodic streaming DIA
    dplan = plan_dist_spmv(lap8, mesh, dtype=f32, strategy="dia")
    gmat = utils.random_sparse(96, 96, 0.08, seed=9).tocsr()
    gmat.sort_indices()
    gplan = plan_dist_spmv(gmat, mesh, dtype=f32, strategy="gpr")
    xg_host = np.random.default_rng(1).random(96).astype(np.float32)
    pmat = utils.laplacian_2d(32)
    pplan = plan_dist_spmv(pmat, mesh, dtype=f32, strategy="pdia_stream",
                           sdia_rb=256)
    xp_host = np.random.default_rng(2).random(pmat.shape[1]).astype(
        np.float32)
    x = np.random.default_rng(0).random(csr.shape[1]).astype(np.float32)
    xs = place(ShardedVector.from_global(x, A.col_plan), mesh)
    xc = place(ShardedVector.from_global(x, Ac.col_plan), mesh)

    y = spmv_halo(mesh, A, xs)
    y2 = spmv_allgather(mesh, Ag, xs)
    y3 = spmv_colsplit(mesh, Ac, xc)
    y4 = dplan.spmv(dplan.shard_x(x))
    y5 = gplan.spmv(gplan.shard_x(xg_host))
    y6 = pplan.spmv(pplan.shard_x(xp_host))
    rho = blas.dot(y, y)
    out = blas.axpy(1.0 / (rho + 1.0), y, y2)
    _sync(mesh)

    y_ref = lap8 @ x.astype(np.float64)
    for got in (y.to_global(), y2.to_global(), y3.to_global(),
                dplan.y_to_global(y4)):
        np.testing.assert_allclose(got, y_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gplan.y_to_global(y5), gmat @ xg_host,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pplan.y_to_global(y6), pmat @ xp_host,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.to_global(),
                               y_ref / (float(rho) + 1.0) + y_ref,
                               rtol=RTOL, atol=ATOL)
    assert np.isfinite(float(rho))

    # the distributed V-cycle against the serial one on the same r
    gmg = 8 * n
    rmg = np.random.default_rng(3).standard_normal(gmg * gmg).astype(
        np.float32)
    rsh = place(ShardedVector.from_global(rmg, plan_uniform(gmg * gmg, n)),
                mesh)
    z = dist_mg_preconditioner(mesh, (gmg, gmg))(rsh)
    zs = mg_preconditioner((gmg, gmg))(torch.from_numpy(rmg).to(dev))
    np.testing.assert_allclose(z.to_global(), zs.cpu().numpy(), rtol=RTOL,
                               atol=ATOL)
    kind = "processes" if mesh.is_process else "shards of one controller"
    return {"halo": _local(y), "allgather": _local(y2),
            "colsplit": _local(y3), "dia": _local(y4), "gpr": _local(y5),
            "pdia_stream": _local(y6), "axpy": _local(out),
            "vcycle": _local(z), "dot": rho.cpu().numpy(),
            "line": f"dryrun_multichip({n}) on {n} {kind} ({dev}): OK - "
                    f"halo+allgather+colsplit SpMV, sharded DIA/periodic "
                    f"DIA/GPR local kernels, psum dot, sharded axpy, "
                    f"distributed MG V-cycle, all verified"}


# ---------------------------------------------------------------------------
# parity: the same cases on any mesh
# ---------------------------------------------------------------------------

#: the streaming and DIA cases' row tile (small operands)
PARITY_RB = 256
#: every case of :func:`parity_cases`
PARITY_CASES = ("exchanges", "halo", "allgather", "neighbor", "colsplit",
                "spmm_neighbor", "dia", "dia_stream", "pdia_stream", "gpr",
                "bdia", "dots", "dist_cg", "dist_cg_ca", "dist_gmres",
                "dist_bicgstab", "vcycle")


def nonsymmetric() -> "object":
    """The reference tests' nonsymmetric operand, ``laplacian_2d(12, 12) +
    0.5 (P - P^T) + 2 I`` (``tests/test_solvers.py:736-738``)."""
    import scipy.sparse as sp

    pert = sp.random(144, 144, density=0.02, random_state=7, format="csr")
    return (utils.laplacian_2d(12, 12) + 0.5 * (pert - pert.T)
            + 2.0 * sp.eye(144, format="csr")).tocsr()


def _exchanges(mesh, dev) -> list:
    """Every exchange of the mesh on seeded ``[6, 2]`` chunks, the local
    shards' results flattened (one array a local shard)."""
    n = mesh.ndev
    chunks = [torch.from_numpy(np.random.default_rng(10 + s)
                               .standard_normal((6, 2))).to(dev)
              for s in mesh.local]
    offsets = tuple(d for d in (1, n - 1, 2) if 0 < d < n)
    offsets = tuple(dict.fromkeys(offsets))
    rings = mesh.ring(chunks, [2 * c for c in chunks], 2)
    shifted = mesh.shift(chunks)
    nbrs = mesh.neighbors(chunks, offsets) if offsets else [[]] * len(chunks)
    gathered = mesh.all_gather(chunks)
    total = mesh.psum([c.sum(0) for c in chunks])
    parts = [torch.from_numpy(np.random.default_rng(20 + s)
                              .standard_normal(3 * n)).to(dev)
             for s in mesh.local]
    scattered = mesh.reduce_scatter(parts, 3)
    return [torch.cat([t.reshape(-1) for t in (*ring, sh, *nb, *ga, total,
                                               rs)]).cpu().numpy()
            for ring, sh, nb, ga, rs in zip(rings, shifted, nbrs, gathered,
                                            scattered)]


def parity_cases(mesh, *, only=None) -> dict:
    """Every distributed product, the reductions, the solvers and the
    V-cycle on small float64 operands over ``mesh``, on the device of its
    first local shard.  Returns, by case (:data:`PARITY_CASES`, or those in
    ``only``): the local shards' chunks (host arrays) of each vector, and
    the solvers' iterations and residual norms.  Every input comes from a
    fixed seed, so two meshes of one shard count give comparable
    results."""
    from ..bench.dist_bench import sharded_jacobi
    from ..solvers import (dist_bicgstab, dist_cg, dist_cg_ca, dist_gmres,
                           dist_mg_preconditioner)

    cases = PARITY_CASES if only is None else tuple(only)
    n = mesh.ndev
    dev = mesh.devices[mesh.local[0]]
    out = {}

    def on_mesh(v, plan):
        return place(ShardedVector.from_global(v, plan), mesh)

    if "exchanges" in cases:
        out["exchanges"] = _exchanges(mesh, dev)
    gen = utils.random_sparse(120, 120, 0.06, seed=4).tocsr()
    x = np.random.default_rng(3).standard_normal(120)
    for name, cls, fn in (("halo", HaloCSR, spmv_halo),
                          ("allgather", ShardedCSR, spmv_allgather),
                          ("neighbor", NeighborCSR, spmv_neighbor)):
        if name in cases:
            A = place(cls.build(gen, n, square=True), mesh)
            out[name] = _local(fn(mesh, A, on_mesh(x, A.col_plan)))
    if "colsplit" in cases:
        A = place(ColShardedCSR.build(gen, n), mesh)
        out["colsplit"] = _local(spmv_colsplit(mesh, A,
                                               on_mesh(x, A.col_plan)))
    if "spmm_neighbor" in cases:
        A = place(NeighborCSR.build(gen, n, square=True), mesh)
        X = np.random.default_rng(5).standard_normal((120, 3))
        out["spmm_neighbor"] = _local(spmm_neighbor(mesh, A,
                                                    on_mesh(X, A.col_plan)))
    lap = utils.laplacian_2d(16)
    xl = np.random.default_rng(4).standard_normal(lap.shape[1])
    for name, m in (("dia", lap), ("dia_stream", lap), ("pdia_stream", lap),
                    ("gpr", utils.random_sparse(96, 96, 0.08, seed=9)),
                    ("bdia", utils.block_laplacian(12, bs=8, seed=2))):
        if name in cases:
            plan = plan_dist_spmv(m, mesh, strategy=name, sdia_rb=PARITY_RB)
            xv = xl if m is lap else np.random.default_rng(6).standard_normal(
                m.shape[1])
            out[name] = _local(plan.spmv(plan.shard_x(xv)))
    spd = utils.laplacian_2d(12, 12).tocsr()
    b = np.random.default_rng(5).standard_normal(144)
    A = place(NeighborCSR.build(spd, n, square=True), mesh)
    bs = on_mesh(b, A.row_plan)
    if "dots" in cases:
        ys = on_mesh(np.random.default_rng(8).standard_normal(144),
                     A.row_plan)
        out["dots"] = [blas.dot(bs, ys).cpu().numpy(),
                       blas.dot_stack((bs, ys), (bs, bs),
                                      (ys, ys)).cpu().numpy(),
                       blas.norm2(ys).cpu().numpy()]
    jac = sharded_jacobi(on_mesh(1.0 / spd.diagonal(), A.row_plan))
    ns = nonsymmetric()
    An = place(HaloCSR.build(ns, n, square=True), mesh)
    bn = on_mesh(b, An.row_plan)
    jn = sharded_jacobi(on_mesh(1.0 / ns.diagonal(), An.row_plan))
    for name, run in (
            ("dist_cg", lambda: dist_cg(mesh, A, bs, tol=1e-10,
                                        maxiter=2000)),
            ("dist_cg_ca", lambda: dist_cg_ca(mesh, A, bs, tol=1e-10,
                                              maxiter=2000, precond=jac)),
            ("dist_gmres", lambda: dist_gmres(mesh, An, bn, tol=1e-10,
                                              restart=20, maxiter=2000,
                                              precond=jn)),
            ("dist_bicgstab", lambda: dist_bicgstab(mesh, An, bn, tol=1e-10,
                                                    maxiter=2000))):
        if name in cases:
            res = run()
            out[name] = {"iterations": res.iterations, "x": _local(res.x),
                         "residual_norm": res.residual_norm.cpu().numpy(),
                         "converged": bool(res.converged)}
    if "vcycle" in cases:
        g = 32
        r = np.random.default_rng(9).standard_normal(g * g)
        M = dist_mg_preconditioner(mesh, (g, g), min_local=2)
        out["vcycle"] = _local(M(on_mesh(r, plan_uniform(g * g, n))))
    _sync(mesh)
    return out


def parity_rank(sizes=(1, 2, 4), *, device="cpu", only=None,
                dryrun: bool = True) -> dict:
    """A rank of a spawned group: :func:`parity_cases` on a process mesh of
    each size in ``sizes`` (the group's first ranks, a subgroup each), then
    (``dryrun``) :func:`dryrun_multichip` over the whole group.  Returns
    ``{size: cases}`` for the sizes this rank is in, the dry run's result
    under ``"dryrun"``, and the rank's kernel launches and staged
    exchanges (``"launches"``, ``"staged"``, counted from its start)."""
    import torch.distributed as tdist

    rank = tdist.get_rank()
    _zero_counters()
    out = {}
    for k in sizes:
        group = tdist.new_group(list(range(k)))     # every rank takes part
        if rank < k:
            out[k] = parity_cases(make_mesh(device=device, group=group),
                                  only=only)
    if dryrun:
        out["dryrun"] = dryrun_multichip(tdist.get_world_size(),
                                         device=device)
    return _read_counters(out)


# ---------------------------------------------------------------------------
# full width
# ---------------------------------------------------------------------------

def _host_ms(mesh, fn, iters: int) -> float:
    """ms a call of ``fn`` by the host clock: every rank starts together
    (a barrier) and the clock stops after a synchronize and a barrier."""
    import torch.distributed as tdist

    fn()
    _sync(mesh)
    tdist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(mesh)
    tdist.barrier(group=mesh.group)
    return (time.perf_counter() - t0) * 1e3 / iters


#: :func:`full_width`'s products: the planner's pick, then K8a forced
FULL_WIDTH_STRATEGIES = (None, "dia_stream")
FULL_WIDTH_ITERS = 20               # products timed a strategy
CG_MAXITER = 20_000                 # a cap the CG never reaches


def full_width(cg_b, cg_tol: float, *, device=None, spmv_grid: int = 4096,
               cg_grid: int = 2048) -> dict:
    """A rank's full-width run on this process group's mesh, float32: first
    :func:`dryrun_multichip` over the group; then ``plan_dist_spmv`` of the
    ``spmv_grid``² Poisson for each of :data:`FULL_WIDTH_STRATEGIES`
    (``None``: the planner's pick), one product of a seeded x (its local
    chunk returned, the gathered y's error against scipy float64 on rank
    0) and :data:`FULL_WIDTH_ITERS` products timed by the host clock; then
    ``dist_cg`` with a sharded Jacobi over ``NeighborCSR`` (rows balanced)
    on the ``cg_grid``² Poisson with right-hand side ``cg_b`` to
    ``cg_tol``, timed.  The
    kernels' launch counts and the staged exchanges are zeroed at the start
    and returned."""
    from ..bench.dist_bench import sharded_jacobi
    from ..solvers import dist_cg

    _zero_counters()
    mesh = make_mesh(device=device)
    out = {"rank": mesh.rank, "ndev": mesh.ndev, "device": str(mesh.device),
           "spmv": []}
    out["dryrun"] = dryrun_multichip(mesh.ndev, mesh=mesh)
    lap = utils.laplacian_2d(spmv_grid)
    x = np.random.default_rng(0).random(lap.shape[1]).astype(np.float32)
    ref = lap @ x.astype(np.float64)
    for strategy in FULL_WIDTH_STRATEGIES:
        t0 = time.perf_counter()
        plan = plan_dist_spmv(lap, mesh, dtype=torch.float32,
                              strategy=strategy)
        plan_s = time.perf_counter() - t0
        xs = plan.shard_x(x)
        y = plan.spmv(xs)
        yg = plan.y_to_global(y)
        rel = (float(np.max(np.abs(yg - ref)) / np.max(np.abs(ref)))
               if mesh.rank == 0 else None)
        out["spmv"].append({
            "strategy": plan.strategy, "plan_s": plan_s,
            "y": _local(y)[0], "rel": rel,
            "ms": _host_ms(mesh, lambda: plan.spmv(xs), FULL_WIDTH_ITERS)})
        del plan, xs, y
    del lap, ref
    lap = utils.laplacian_2d(cg_grid).astype(np.float32).tocsr()
    A = place(NeighborCSR.build(lap, mesh.ndev, balance="rows",
                                square=True), mesh)
    bs = place(ShardedVector.from_global(cg_b, A.row_plan), mesh)
    jac = sharded_jacobi(place(ShardedVector.from_global(
        (1.0 / lap.diagonal()).astype(np.float32), A.row_plan), mesh))
    _sync(mesh)
    t0 = time.perf_counter()
    res = dist_cg(mesh, A, bs, tol=cg_tol, maxiter=CG_MAXITER, precond=jac)
    _sync(mesh)
    sec = time.perf_counter() - t0
    out["cg"] = {"iterations": res.iterations, "x": _local(res.x)[0],
                 "converged": bool(res.converged),
                 "ms": sec * 1e3 / max(res.iterations, 1), "s": sec}
    return _read_counters(out)


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A port on ``127.0.0.1`` that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank, fn, args, kwargs, nprocs, port, backend, timeout, threads,
          out_dir):
    """A spawned rank: join the group, run ``fn``, write its result."""
    import torch.distributed as tdist

    torch.set_num_threads(threads)
    init_multihost(f"127.0.0.1:{port}", nprocs, rank, backend=backend,
                   timeout=timeout)
    result = fn(*args, **kwargs)
    tdist.destroy_process_group()
    tmp = Path(out_dir) / f"{rank}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    tmp.rename(Path(out_dir) / f"{rank}.pkl")


class Ranks:
    """A started group of ranks (:func:`spawn`)."""

    def __init__(self, ctx, out_dir: Path, nprocs: int, timeout: float):
        self._ctx, self._out, self.nprocs = ctx, out_dir, nprocs
        self.timeout = timeout
        self._deadline = time.monotonic() + timeout

    def join(self) -> list:
        """Wait for every rank (until the deadline) and return their
        results in rank order.  A rank that raised or died raises here
        (``torch.multiprocessing``'s exception, the others killed); past
        the deadline every rank is killed and ``TimeoutError`` raised."""
        try:
            while not self._ctx.join(
                    timeout=max(self._deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= self._deadline:
                    alive = [i for i, p in enumerate(self._ctx.processes)
                             if p.is_alive()]
                    for p in self._ctx.processes:
                        if p.is_alive():
                            p.kill()
                    for p in self._ctx.processes:
                        p.join()
                    raise TimeoutError(
                        f"ranks {alive} of {self.nprocs} still running after "
                        f"{self.timeout:.0f} s: killed")
            results = []
            for r in range(self.nprocs):
                with open(self._out / f"{r}.pkl", "rb") as f:
                    results.append(pickle.load(f))
            return results
        finally:
            shutil.rmtree(self._out, ignore_errors=True)


def spawn(fn, nprocs: int, *, args=(), kwargs=None, backend: str = "gloo",
          timeout: float = 60.0, threads: int = 1) -> Ranks:
    """Start ``nprocs`` ranks of one process group on this host: each runs
    ``fn(*args, **kwargs)`` (a function of an importable module; the
    arguments pickled) after
    :func:`~.mesh.init_multihost` with ``backend`` on a free port of
    ``127.0.0.1``, with ``threads`` torch threads.  ``timeout`` (seconds)
    bounds each collective and the whole group (:meth:`Ranks.join`)."""
    import multiprocessing

    import torch.multiprocessing as mp

    # the ranks fork from one server process that imports torch and this
    # module once and outlives the group (a second group starts in a
    # fraction of a second); nothing of this process, its threads or its
    # card crosses a fork
    multiprocessing.get_context("forkserver").set_forkserver_preload(
        [__name__])
    out_dir = Path(tempfile.mkdtemp(prefix="tpu_spmv_ranks_"))
    ctx = mp.start_processes(
        _rank, args=(fn, tuple(args), dict(kwargs or {}), nprocs,
                     free_port(), backend, timeout, threads, str(out_dir)),
        nprocs=nprocs, join=False, start_method="forkserver")
    return Ranks(ctx, out_dir, nprocs, timeout)


def _dryrun_rank(n: int, device) -> str:
    return dryrun_multichip(n, device=device)["line"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_spmv_torch.dist.dryrun")
    p.add_argument("--nproc", type=int, default=4,
                   help="ranks to spawn when not started by torchrun")
    p.add_argument("--device", default=None,
                   help="each rank's device (default: cuda:LOCAL_RANK under "
                        "torchrun where there are cards; spawned ranks share "
                        "cuda:0, or the CPU without a card)")
    p.add_argument("--backend", default=None,
                   help="nccl or gloo (default: init_multihost's choice "
                        "under torchrun, gloo for spawned ranks)")
    p.add_argument("--timeout", type=float, default=300.0)
    a = p.parse_args(argv)
    if "WORLD_SIZE" in os.environ:          # started by torchrun
        import torch.distributed as tdist

        init_multihost(backend=a.backend, timeout=a.timeout)
        line = dryrun_multichip(tdist.get_world_size(),
                                device=a.device)["line"]
        if tdist.get_rank() == 0:
            print(line)
        tdist.destroy_process_group()
        return 0
    device = a.device or ("cuda:0" if torch.cuda.is_available() else "cpu")
    lines = spawn(_dryrun_rank, a.nproc, args=(a.nproc, device),
                  backend=a.backend or "gloo", timeout=a.timeout).join()
    print(lines[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
