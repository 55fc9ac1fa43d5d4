"""Weak- and strong-scaling benchmark of the distributed SpMV strategies.

Counterpart of ``tpu_spmv/bench/dist_bench.py`` (BASELINE.json config 5:
row-partitioned CSR SpMV over N devices, weak-scaling efficiency in
nnz/s).  Strategies: ``allgather`` (x replicated), ``neighbor`` (only the
touched neighbour chunks), ``halo`` (the ``ndev``-step ring).  Every point
is checked against scipy float64 (rel < 2e-5) before it is timed with the
chained protocol (:func:`~.harness.time_chained`), and records the
:func:`~..dist.planned.predict_dist_costs` model's prediction for its
strategy.  ``--sweep`` adds the power-law leg through ``ShardedGPR``
(``gpr_spmv`` on each shard) and the solver legs: ``dist_cg`` with
``dist_mg_preconditioner`` on the Poisson and ``dist_cg_ca`` with a
sharded Jacobi on a random SPD operator.

Where the reference's ``--cpu N`` forces N virtual devices, ``--device``
puts every shard on one device (``cpu`` or ``cuda:0``); the default is one
shard per card.  A sweep whose shards share one device says
``"virtual_mesh": true``: its weak scaling then checks the machinery and
bounds the per-shard overhead, and is not a scaling result.

Usage::

    python -m tpu_spmv_torch.bench.dist_bench --grid 1024 --ndev 4
    python -m tpu_spmv_torch.bench.dist_bench --sweep --device cuda:0 --out DIST.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import dist
from ..solvers import dist_cg, dist_cg_ca, dist_mg_preconditioner
from ..utils import laplacian_2d, power_law
from .harness import time_chained

STRATS = ["allgather", "neighbor", "halo"]
_KINDS = {"allgather": (dist.ShardedCSR, dist.spmv_allgather),
          "neighbor": (dist.NeighborCSR, dist.spmv_neighbor),
          "halo": (dist.HaloCSR, dist.spmv_halo)}


def _rel(y, ref) -> float:
    return float(np.max(np.abs(y - ref)) / np.max(np.abs(ref)))


def _require(cond: bool, what) -> None:
    """A gate of the benchmark: raises ``AssertionError`` with ``what``."""
    if not cond:
        raise AssertionError(what)


def sharded_jacobi(d: dist.ShardedVector):
    """The sharded Jacobi scale ``r -> d * r`` (``d`` the inverse
    diagonal, on the mesh)."""
    def apply(r: dist.ShardedVector) -> dist.ShardedVector:
        return r.map(lambda c, s: c * s, d)
    return apply


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_spmv_torch.bench.dist_bench")
    p.add_argument("--grid", type=int, default=512,
                   help="NxN Poisson grid (n = grid^2 rows)")
    p.add_argument("--ndev", type=int, default=0,
                   help="shards (0 = one per card; with --device, 8)")
    p.add_argument("--strategy", choices=STRATS + ["both"], default="both")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--balance", choices=["nnz", "rows"], default="nnz")
    p.add_argument("--json", action="store_true")
    p.add_argument("--sweep", action="store_true",
                   help="weak-scaling sweep: 1, 2, 4 and 8 shards with the "
                        "grid scaled to hold nnz per shard constant, each "
                        "point's efficiency against one shard; then the "
                        "power-law GPR leg and the solver legs")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="with --sweep: also write the sweep JSON here")
    p.add_argument("--device", default=None,
                   help="put every shard on this one device (cpu, cuda:0); "
                        "default: one shard per CUDA card")
    args = p.parse_args(argv)
    t_main = time.perf_counter()

    def log(msg: str) -> None:
        """A progress line on stderr, stamped with the seconds so far."""
        print(f"[{time.perf_counter() - t_main:6.1f} s] {msg}",
              file=sys.stderr)

    if args.device is None:
        nall = dist.device_count()
        if nall == 0:
            raise SystemExit("dist_bench: no CUDA card; pass --device cpu "
                             "to put every shard on the CPU")
    else:
        nall = 8
    kind = (torch.cuda.get_device_name(torch.device(args.device or "cuda"))
            if (args.device or "cuda").startswith("cuda") else "cpu")
    virtual = args.device is not None

    def mesh_of(ndev: int) -> dist.Mesh:
        return dist.make_mesh(ndev, device=args.device)

    def bench_point(grid: int, ndev: int, strategies) -> list:
        mesh = mesh_of(ndev)
        mat = laplacian_2d(grid).astype(np.float32)
        n, nnz = mat.shape[0], mat.nnz
        log(f"dist_bench: grid={grid} n={n} nnz={nnz} ndev={ndev} "
            f"device={kind}")
        x = np.random.default_rng(0).random(n).astype(np.float32)
        ref = mat.astype(np.float64) @ x.astype(np.float64)
        scale = float(np.float32(1.0 / abs(mat).sum(axis=1).max()))
        costs = dist.predict_dist_costs(mat, ndev, square=True,
                                        balance=args.balance)
        out = []
        for strat in strategies:
            cls, fn = _KINDS[strat]
            A = dist.place(cls.build(mat, ndev, balance=args.balance,
                                     square=True), mesh)
            xs = dist.place(dist.ShardedVector.from_global(x, A.row_plan),
                            mesh)
            # correctness first
            rel = _rel(fn(mesh, A, xs).to_global(), ref)
            _require(rel < 2e-5, f"{strat}: rel err {rel}")
            sec = time_chained(
                lambda v, A=A, fn=fn: dist.blas.scale(fn(mesh, A, v), scale),
                xs, iters=args.iters).median_s
            out.append({
                "strategy": strat, "ndev": ndev, "grid": grid,
                "n": n, "nnz": nnz,
                "us_per_spmv": round(sec * 1e6, 2),
                "gnnz_per_s": round(nnz / sec / 1e9, 3),
                "gflops": round(2 * nnz / sec / 1e9, 3),
                "rel_err": rel,
                # the cost model's prediction for this strategy (H100
                # constants; on a virtual mesh a check of the ordering)
                "model_predicted_us": costs["csr_" + strat][
                    "predicted_us"],
            })
        return out

    strategies = STRATS if args.strategy == "both" else [args.strategy]

    if not args.sweep:
        ndev = args.ndev or nall
        for line in bench_point(args.grid, ndev, strategies):
            if args.json:
                print(json.dumps(line))
            else:
                print(f"### CSR DIST-{line['strategy'].upper()} GFLOPS = "
                      f"{line['gflops']:.5f}")
                print(f"    {line['strategy']}: {line['us_per_spmv']} "
                      f"us/iter | {line['gnnz_per_s']} Gnnz/s | "
                      f"rel_err={line['rel_err']:.2e}")
        return 0

    # weak scaling: nnz per shard held about constant (nnz ~ 5 grid^2, so
    # the grid scales by sqrt(ndev)); a point's efficiency is its
    # per-shard throughput against the one-shard point of its strategy
    ndevs = [d for d in (1, 2, 4, 8) if d <= nall]
    sweep = {s: [] for s in strategies}
    for d in ndevs:
        for line in bench_point(int(round(args.grid * d ** 0.5)), d,
                                strategies):
            sweep[line["strategy"]].append(line)
    report = {"mode": "weak_scaling", "base_grid": args.grid,
              "device_kind": kind, "virtual_mesh": virtual,
              "model_pick": dist.predict_dist_costs(
                  laplacian_2d(args.grid).astype(np.float32), max(ndevs),
                  square=True)["pick"],
              "points": []}
    if virtual:
        report["note"] = (
            "virtual mesh: every shard runs on one device, so per-shard "
            "throughput cannot scale; efficiency_pct here checks the sweep "
            "machinery and bounds the per-shard overhead only; the "
            "BASELINE >=80% gate applies to this same command with one "
            "shard per card")

    def per_shard(line):
        # from the unrounded-enough time: a CPU point's Gnnz/s rounds to 0
        return line["nnz"] / line["us_per_spmv"] / line["ndev"]

    for s in strategies:
        base = per_shard(sweep[s][0])
        for line in sweep[s]:
            line["efficiency_pct"] = round(100.0 * per_shard(line) / base, 1)
            report["points"].append(line)
            log(f"    {s} ndev={line['ndev']} grid={line['grid']}: "
                f"{line['gnnz_per_s']} Gnnz/s, "
                f"{line['efficiency_pct']}% weak-scaling eff, "
                f"model {line['model_predicted_us']} us")

    # the unstructured leg: a power-law matrix through ShardedGPR
    # (gpr_spmv on each shard) at each shard count, rel-err gated, nnz per
    # shard held about constant; on the CPU the plain versions run and
    # the leg is not timed
    on_cpu = kind == "cpu"
    report["gpr_points"] = []
    base_rows = 24_000                 # ~13 nnz a row -> ~300k a shard
    for d in ndevs:
        n_d = base_rows * d
        m = power_law(n_d, n_d, avg_nnz_per_row=13, alpha=1.5, seed=7,
                      dtype=np.float32).tocsr()
        mesh = mesh_of(d)
        plan = dist.plan_dist_spmv(m, mesh, dtype=torch.float32,
                                   strategy="gpr")
        xg = np.random.default_rng(1).random(n_d).astype(np.float32)
        xs = plan.shard_x(xg)
        rel = _rel(plan.y_to_global(plan.spmv(xs)),
                   m.astype(np.float64) @ xg.astype(np.float64))
        pt = {"strategy": "gpr", "ndev": d, "n": n_d, "nnz": int(m.nnz),
              "rel_err": rel, "plain": on_cpu}
        _require(rel < 2e-5, pt)
        if not on_cpu:
            scale = float(np.float32(1.0 / abs(m).sum(axis=1).max()))
            sec = time_chained(
                lambda v, plan=plan: dist.blas.scale(plan.spmv(v), scale),
                xs, iters=50).median_s
            pt["us_per_spmv"] = round(sec * 1e6, 2)
            pt["gnnz_per_s"] = round(m.nnz / sec / 1e9, 3)
        report["gpr_points"].append(pt)
        log(f"    gpr ndev={d} n={n_d} nnz={m.nnz}: rel {rel:.1e}"
            + (" (plain versions)" if on_cpu else
               f", {pt['us_per_spmv']} us"))

    # the solver legs: iteration counts and true residuals, and the cost
    # of one V-cycle and one matvec by the chained protocol; multigrid's
    # count should stay O(1) as the mesh grows
    report["solver_points"] = []
    for d in ndevs:
        gmg = int(round(args.grid * d ** 0.5))
        unit = 16 * d                  # row-divisible, MG-coarsenable
        gmg = max(gmg - gmg % unit, unit)
        mesh = mesh_of(d)
        lap = laplacian_2d(gmg).astype(np.float32).tocsr()
        A = dist.place(dist.NeighborCSR.build(lap, d, balance="rows",
                                              square=True), mesh)
        bh = np.random.default_rng(5).standard_normal(gmg * gmg).astype(
            np.float32)
        bs = dist.place(dist.ShardedVector.from_global(bh, A.row_plan), mesh)
        M = dist_mg_preconditioner(mesh, (gmg, gmg))
        res = dist_cg(mesh, A, bs, tol=1e-5, maxiter=100, precond=M)
        rtrue = float(np.linalg.norm(bh - lap @ res.x.to_global())
                      / np.linalg.norm(bh))
        apply_s = time_chained(
            lambda v, A=A, M=M, mesh=mesh: dist.spmv_neighbor(mesh, A, M(v)),
            bs, iters=20).median_s
        pt = {"solver": "dist_mgpcg", "ndev": d, "grid": gmg,
              "n": gmg * gmg, "iterations": int(res.iterations),
              "converged": bool(res.converged),
              "true_rel_residual": rtrue,
              "per_apply_us": round(apply_s * 1e6, 1)}
        _require(pt["converged"] and rtrue < 1e-4, pt)
        report["solver_points"].append(pt)
        log(f"    dist_mgpcg ndev={d} grid={gmg}: {pt['iterations']} "
            f"iters, true rel {rtrue:.1e}")

    # the unstructured solver leg: Jacobi-preconditioned single-reduction
    # CG on a random symmetric diagonally dominant operator, all shards;
    # R from a Generator seeded 9 (a RandomState, the reference's int
    # seed, draws a permutation of all nu^2 positions: 8 GiB and about a
    # minute at 8 shards)
    d = max(ndevs)
    mesh = mesh_of(d)
    nu = 4096 * d
    R = sp.random(nu, nu, density=12.0 / nu,
                  random_state=np.random.default_rng(9), format="csr",
                  dtype=np.float64)
    S = (R + R.T) * 0.5
    Au = (S + sp.diags(np.abs(S).sum(axis=1).A1 + 1.0)).tocsr()
    Au32 = Au.astype(np.float32)
    Ad = dist.place(dist.NeighborCSR.build(Au32, d, square=True), mesh)
    bh = np.random.default_rng(11).standard_normal(nu).astype(np.float32)
    bs = dist.place(dist.ShardedVector.from_global(bh, Ad.row_plan), mesh)
    dinv = dist.place(dist.ShardedVector.from_global(
        (1.0 / Au.diagonal()).astype(np.float32), Ad.row_plan), mesh)
    res = dist_cg_ca(mesh, Ad, bs, tol=1e-6, maxiter=500,
                     precond=sharded_jacobi(dinv))
    rtrue = float(np.linalg.norm(bh - Au32 @ res.x.to_global())
                  / np.linalg.norm(bh))
    upt = {"solver": "dist_cg_ca+jacobi", "operator": "random_spd",
           "ndev": d, "n": nu, "nnz": int(Au.nnz),
           "iterations": int(res.iterations),
           "converged": bool(res.converged), "true_rel_residual": rtrue}
    _require(upt["converged"] and rtrue < 1e-4, upt)
    report["solver_points"].append(upt)
    log(f"    dist_cg_ca+jacobi (random_spd) ndev={d} n={nu}: "
        f"{upt['iterations']} iters, true rel {rtrue:.1e}")

    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
