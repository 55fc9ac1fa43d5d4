"""Command-line entry point: SpMV and SpMM benchmark and CG solve.

Counterpart of the main-path part of ``tpu_spmv/cli.py``: load a
MatrixMarket file or generate a synthetic matrix, benchmark the chosen
formats (or the planner's pick with ``--auto``) and print the
``### <FMT> <MODE> GFLOPS`` protocol lines, each product checked against a
float64 scipy oracle; optionally benchmark the SpMM with ``--spmm NRHS``
(``### <FMT> SPMM<k> GFLOPS``), the planned distributed SpMV over ``--dist
NDEV`` shards (``### CSR DIST<ndev> GFLOPS``) and solve with CG, one
right-hand side or ``--solve-nrhs K`` at once (``cg_multi`` through the
plan's SpMM).  MODE is ``GPU`` on the card and ``CPU`` on the CPU, with
``-AUTO`` for the planner's pick.

Usage::

    python -m tpu_spmv_torch matrix.mtx                   # sweep formats
    python -m tpu_spmv_torch --synthetic laplacian:4096 --auto --solve cg
    python -m tpu_spmv_torch --synthetic banded:20000,40 --device cpu
    python -m tpu_spmv_torch --synthetic powerlaw:400000,13 --auto   # GPR
    python -m tpu_spmv_torch --synthetic laplacian:4096 --auto --spmm 32
    python -m tpu_spmv_torch --synthetic laplacian:256 --auto --solve cg \
        --solve-nrhs 8
    python -m tpu_spmv_torch --synthetic laplacian:4096 --dist 1   # sharded
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _parse_synthetic(spec: str):
    """``name:arg1[,arg2...]`` → scipy matrix via :mod:`.utils`."""
    from . import utils

    name, _, argstr = spec.partition(":")
    try:
        args = [int(a) for a in argstr.split(",")] if argstr else []
    except ValueError:
        raise SystemExit(f"tpu_spmv_torch: bad synthetic spec {spec!r}")
    gens = {
        "laplacian": lambda n=256, m=None: utils.laplacian_2d(n, m),
        "laplacian3d": lambda n=32, m=None, k=None: utils.laplacian_3d(
            n, m, k),
        "random": lambda n=4096, m=None, d=None: utils.random_sparse(
            n, m or n, (d or 10) / 1000.0),
        "banded": lambda n=65536, b=5: utils.banded(n, b),
        "powerlaw": lambda n=65536, k=8: utils.power_law(n, n, k),
    }
    if name not in gens:
        raise SystemExit(
            f"unknown synthetic matrix {name!r}; valid: {sorted(gens)}")
    return gens[name](*args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_spmv_torch",
        description="SpMV benchmark and CG solve on a CUDA card (the "
                    "PyTorch and CUDA port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("matrix", nargs="?", help="MatrixMarket .mtx[.gz] file")
    src.add_argument(
        "--synthetic", metavar="SPEC",
        help="generate a matrix: laplacian:N[,M] | laplacian3d:N[,M,K] "
             "| random:N[,M,density_permille] | banded:N[,bw] "
             "| powerlaw:N[,avg_nnz]")
    p.add_argument("--formats", default="coo,csr,dia",
                   help="comma-separated format list (coo, csr, dia)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"], help="compute dtype")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--iters", type=int, default=50,
                   help="timed iterations per format")
    p.add_argument("--no-check", action="store_true",
                   help="skip the float64 oracle check")
    p.add_argument("--auto", action="store_true",
                   help="let the strategy planner pick the execution format")
    p.add_argument("--spmm", type=int, metavar="NRHS", default=0,
                   help="also benchmark SpMM with NRHS right-hand sides (the "
                        "plan's with --auto, and each format's)")
    p.add_argument("--dist", type=int, metavar="NDEV", default=0,
                   help="also benchmark the planned distributed SpMV over "
                        "NDEV shards: one per card with --device cuda, all "
                        "on one device with --device cuda:N or cpu (square "
                        "matrices only)")
    p.add_argument("--dist-strategy", default=None,
                   choices=["dia", "dia_stream", "pdia_stream", "gpr",
                            "csr_halo", "csr_neighbor", "csr_allgather"],
                   help="force the distributed strategy (default: the "
                        "distributed planner's pick)")
    p.add_argument("--solve", choices=["cg", "pcg"], default=None,
                   help="solve A x = b with CG (pcg: Jacobi-preconditioned) "
                        "and report iterations, residual and wall time")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="solver convergence tolerance (with --solve)")
    p.add_argument("--solve-nrhs", type=int, metavar="K", default=0,
                   help="with --solve cg: solve K right-hand sides at once "
                        "through the plan's SpMM (k lockstep CG "
                        "recurrences)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the numpy generator of x and b")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line per result instead of text")
    return p


#: cap on the sweep's dense DIA expansion (a scattered pattern occupies
#: thousands of diagonals and would need nrow values for each)
_DENSE_CAP_BYTES = 1 << 30


def _drop_explosive_formats(formats, host_mat, itemsize):
    """Drop sweep formats whose dense expansion would not fit the cap."""
    if host_mat.nnz == 0 or "dia" not in formats:
        return formats
    ndiags = int(np.count_nonzero(np.bincount(
        host_mat.col.astype(np.int64) - host_mat.row + host_mat.shape[0] - 1)))
    est = ndiags * host_mat.shape[0] * itemsize
    if est <= _DENSE_CAP_BYTES:
        return formats
    print(f"tpu_spmv_torch: skipping DIA — dense expansion needs "
          f"~{est / 2**30:.1f} GiB (cap {_DENSE_CAP_BYTES >> 30} GiB)",
          file=sys.stderr)
    return [f for f in formats if f != "dia"]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import scipy.sparse as sp
    import torch

    from .formats import COO, FORMATS

    try:
        device = torch.device(args.device)
    except RuntimeError:
        raise SystemExit(f"tpu_spmv_torch: bad device {args.device!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tpu_spmv_torch: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    dtype = getattr(torch, args.dtype)

    formats = [f.strip().lower() for f in args.formats.split(",")
               if f.strip()]
    unknown = [f for f in formats if f not in FORMATS]
    if unknown:
        raise SystemExit(f"tpu_spmv_torch: unknown format(s) {unknown}; "
                         f"valid: {sorted(FORMATS)}")

    if args.synthetic:
        host_mat = _parse_synthetic(args.synthetic).tocoo()
    else:
        from .io.mmio import read_mtx_arrays

        try:
            row, col, val, shape = read_mtx_arrays(args.matrix)
        except FileNotFoundError:
            raise SystemExit(
                f"tpu_spmv_torch: matrix file not found: {args.matrix}")
        except ValueError as e:
            raise SystemExit(f"tpu_spmv_torch: cannot read {args.matrix}: {e}")
        host_mat = sp.coo_matrix((val, (row, col)), shape=shape)
    src = f"synthetic {args.synthetic}" if args.synthetic else args.matrix
    print(f"{src}: shape={host_mat.shape} nnz={host_mat.nnz}")

    rng = np.random.default_rng(args.seed)
    x = torch.tensor(rng.random(host_mat.shape[1]), dtype=dtype,
                     device=device)
    mode = "GPU" if device.type == "cuda" else "CPU"

    from .bench import bench_format_sweep, bench_spmm, bench_spmv
    from .ops.auto import plan_spmv

    plan = None
    coo = None
    if not args.auto or args.spmm > 0:
        coo = COO.from_arrays(host_mat.row, host_mat.col, host_mat.data,
                              host_mat.shape, dtype=dtype, device=device)
        formats = _drop_explosive_formats(formats, host_mat,
                                          dtype.itemsize)
    if args.auto:
        plan = plan_spmv(host_mat, dtype=dtype, device=device)
        if not args.json:
            print(f"planner: strategy={plan.strategy}")
        results = [bench_spmv(plan.matrix, x, mode=f"{mode}-AUTO",
                              iters=args.iters, check=not args.no_check,
                              quiet=args.json, spmv_fn=plan._kernel,
                              oracle=host_mat)]
    else:
        results = bench_format_sweep(coo, x, formats=formats, mode=mode,
                                     iters=args.iters,
                                     check=not args.no_check,
                                     quiet=args.json)

    if args.spmm > 0:
        from .formats import convert

        X = torch.tensor(rng.random((host_mat.shape[1], args.spmm)),
                         dtype=dtype, device=device)
        kw = dict(iters=max(args.iters // 5, 3), check=not args.no_check,
                  quiet=args.json)
        if plan is not None:
            # the planner's SpMM kernel (streaming DIA, GPR or sliced ELL)
            results.append(bench_spmm(plan.matrix, X,
                                      spmm_fn=lambda A_, V: plan.spmm(V),
                                      oracle=host_mat, **kw))
        results += [bench_spmm(convert(coo, name), X, oracle=host_mat, **kw)
                    for name in formats]

    if args.dist > 0:
        from .dist import bench_dist_spmv, make_mesh

        try:
            mesh = make_mesh(args.dist, device=device)
        except ValueError as e:
            raise SystemExit(f"tpu_spmv_torch: --dist {args.dist}: {e}")
        results.append(bench_dist_spmv(
            host_mat, mesh, dtype=dtype, iters=args.iters,
            check=not args.no_check, quiet=args.json,
            strategy=args.dist_strategy))

    if args.solve is not None:
        if host_mat.shape[0] != host_mat.shape[1]:
            print("error: --solve needs a square matrix", file=sys.stderr)
            return 2
        from .solvers import cg, cg_multi, safe_dinv

        solve_plan = plan or plan_spmv(host_mat, dtype=dtype, device=device)
        rng_b = np.random.default_rng(args.seed + 1)
        nrhs = args.solve_nrhs if args.solve == "cg" else 0
        if nrhs > 1:
            B = torch.tensor(rng_b.random((host_mat.shape[0], nrhs)),
                             dtype=dtype, device=device)
            t0 = time.perf_counter()
            mres = cg_multi(solve_plan, B, tol=args.tol, maxiter=10_000)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            rels = mres.residual_norm / torch.linalg.norm(B, dim=0)
            line = {"solver": "cg", "strategy": solve_plan.strategy,
                    "nrhs": nrhs, "iterations": mres.iterations,
                    "rel_residual_max": float(rels.max()),
                    "converged": bool(mres.converged.all()),
                    "wall_s": round(wall, 3)}
            msg = (f"    CG x{nrhs} ({solve_plan.strategy}): "
                   f"{mres.iterations} iters, max rel residual "
                   f"{line['rel_residual_max']:.2e}, "
                   f"converged={line['converged']} ({line['wall_s']}s)")
        else:
            b = torch.tensor(rng_b.random(host_mat.shape[0]), dtype=dtype,
                             device=device)
            precond = None
            if args.solve == "pcg":
                # Jacobi from the host diagonal (packed strategy formats
                # have no CSR view to take it from)
                inv = safe_dinv(host_mat.diagonal().astype(np.float64),
                                dtype=dtype, device=device)
                precond = lambda r: inv * r
            t0 = time.perf_counter()
            res = cg(solve_plan, b, tol=args.tol, maxiter=10_000,
                     precond=precond)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            rel = float(res.residual_norm / torch.linalg.norm(b))
            line = {"solver": args.solve, "strategy": solve_plan.strategy,
                    "iterations": res.iterations, "rel_residual": rel,
                    "converged": bool(res.converged),
                    "wall_s": round(wall, 3)}
            msg = (f"    {args.solve.upper()} ({solve_plan.strategy}): "
                   f"{res.iterations} iters, rel residual {rel:.2e}, "
                   f"converged={line['converged']} ({line['wall_s']}s)")
        if args.json:
            results.append(line)
        else:
            print(msg)

    if args.json:
        for r in results:
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
