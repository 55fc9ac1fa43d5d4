"""Command-line entry point: SpMV and SpMM benchmark and CG solve.

Counterpart of the main-path part of ``tpu_spmv/cli.py``: load a
MatrixMarket file or generate a synthetic matrix, benchmark the chosen
formats (or the planner's pick with ``--auto``) and print the
``### <FMT> <MODE> GFLOPS`` protocol lines, each product checked against a
float64 scipy oracle; optionally benchmark the SpMM with ``--spmm NRHS``
(``### <FMT> SPMM<k> GFLOPS``), the planned distributed SpMV over ``--dist
NDEV`` shards (``### CSR DIST<ndev> GFLOPS``) and run a solver on the plan
with ``--solve``: CG (one right-hand side, or ``--solve-nrhs K`` at once
through the plan's SpMM), Jacobi-, Chebyshev- or multigrid-preconditioned
CG, mixed-precision iterative refinement (a bf16 plan inside, the float32
plan's residual outside), BiCGSTAB, GMRES, multicolor Gauss-Seidel, power
iteration or Lanczos.  MODE is ``GPU`` on the card and ``CPU`` on the CPU,
with ``-AUTO`` for the planner's pick.

``--dtype bfloat16`` stores the matrix's values and x in bf16, as the
reference does; the port's kernels take float32 vectors, so each product
widens x once (exactly), sums in float32 and rounds the result to bf16,
the reference's result type.  With ``--spmm`` X is rounded to bf16 as the
reference builds it, then widened exactly to the float32 the bf16-data
SpMMs take; ``--solve-nrhs`` solves with a float32 B and ``--dist`` plans
bf16 coefficients for float32 vectors (the reference keeps X, B and x in
bf16).  ``--cache DIR`` (with ``--auto``) saves the
planned pack (:mod:`.io.checkpoint`) and reloads it on the next run on the
same source and dtype; ``--profile DIR`` writes a ``torch.profiler`` trace
of the run (CUDA activity included on the card) to ``DIR/trace.json``.

Usage::

    python -m tpu_spmv_torch matrix.mtx                   # sweep formats
    python -m tpu_spmv_torch --synthetic laplacian:4096 --auto --solve cg
    python -m tpu_spmv_torch --synthetic banded:20000,40 --device cpu
    python -m tpu_spmv_torch --synthetic powerlaw:400000,13 --auto   # GPR
    python -m tpu_spmv_torch --synthetic powerlaw:400000,13 --auto \
        --dtype bfloat16 --cache plans/      # bf16 GPR, packed once
    python -m tpu_spmv_torch --synthetic laplacian:1024 --auto \
        --profile traces/                   # torch.profiler trace
    python -m tpu_spmv_torch --synthetic laplacian:4096 --auto --spmm 32
    python -m tpu_spmv_torch --synthetic laplacian:2048 --auto \
        --dtype bfloat16 --spmm 32 --dist 4 --device cuda:0
    python -m tpu_spmv_torch --synthetic laplacian:256 --auto --solve cg \
        --solve-nrhs 8
    python -m tpu_spmv_torch --synthetic laplacian:2048 --auto --solve mgpcg
    python -m tpu_spmv_torch --synthetic laplacian:1024 --auto --solve ir \
        --inner-iters 100
    python -m tpu_spmv_torch --synthetic laplacian:1024 --auto --solve gmres
    python -m tpu_spmv_torch --synthetic laplacian:1024 --auto --solve lanczos
    python -m tpu_spmv_torch --synthetic laplacian:4096 --dist 1   # sharded
    python -m tpu_spmv_torch --synthetic laplacian:512 --dist 4 \
        --device cuda:0 --dist-strategy bdia     # sharded block diagonals
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


#: the ``--solve`` choices (the reference's)
SOLVERS = ["cg", "pcg", "chebcg", "mgpcg", "ir", "bicgstab", "gmres",
           "power", "lanczos", "sor"]


def _grid_shape(spec: str | None) -> tuple[int, ...]:
    """The grid of a ``laplacian`` / ``laplacian3d`` synthetic spec (the
    generators' defaults filled in), for ``--solve mgpcg``."""
    name, _, argstr = (spec or "").partition(":")
    dims = [int(a) for a in argstr.split(",") if a]
    if name == "laplacian":
        gx = dims[0] if dims else 256
        return (gx, dims[1] if len(dims) > 1 else gx)
    if name == "laplacian3d":
        gx = dims[0] if dims else 32
        gy = dims[1] if len(dims) > 1 else gx
        return (gx, gy, dims[2] if len(dims) > 2 else gy)
    raise SystemExit("tpu_spmv_torch: --solve mgpcg needs a grid operator "
                     "(--synthetic laplacian:N / laplacian3d:N); for general "
                     "SPD matrices use pcg or chebcg")


def _solve(args, solve_plan, host_mat, dtype, device):
    """Run ``--solve`` (one right-hand side) on ``solve_plan``: the result
    line (a dict) and its text form.  ``dtype`` is the vectors' type
    (float32 for a plan of bf16 coefficients)."""
    import torch

    from .ops.auto import plan_spmv
    from . import solvers

    n = host_mat.shape[0]
    t0 = time.perf_counter()

    def wall():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return round(time.perf_counter() - t0, 3)

    if args.solve == "power":
        lam, _ = solvers.power_iteration(solve_plan, n=n, iters=200)
        line = {"solver": "power", "strategy": solve_plan.strategy,
                "eigenvalue": float(lam), "wall_s": wall()}
        return line, (f"    power-iteration ({solve_plan.strategy}): "
                      f"lambda_max = {float(lam):.6g} ({line['wall_s']}s)")
    if args.solve == "lanczos":
        lmin, lmax = solvers.eigsh_lanczos(solve_plan, k=80, n=n,
                                           full_reorth=True)
        line = {"solver": "lanczos", "strategy": solve_plan.strategy,
                "eigenvalue_min": lmin, "eigenvalue_max": lmax,
                "wall_s": wall()}
        return line, (f"    lanczos(k=80, {solve_plan.strategy}): spectrum "
                      f"in [{lmin:.6g}, {lmax:.6g}] ({line['wall_s']}s)")
    rng_b = np.random.default_rng(args.seed + 1)
    b = torch.tensor(rng_b.random(n), dtype=dtype, device=device)
    precond = None
    if args.solve == "mgpcg":
        precond = solvers.mg_preconditioner(_grid_shape(args.synthetic))
    if args.solve in ("pcg", "chebcg"):
        # Jacobi from the host diagonal (packed strategy formats have no
        # CSR view to take it from)
        inv = solvers.safe_dinv(host_mat.diagonal().astype(np.float64),
                                dtype=dtype, device=device)
        precond = (solvers.chebyshev_preconditioner(solve_plan, dinv=inv,
                                                    n=n)
                   if args.solve == "chebcg" else (lambda r: inv * r))
    if args.solve == "bicgstab":
        res = solvers.bicgstab(solve_plan, b, tol=args.tol, maxiter=10_000)
    elif args.solve == "gmres":
        res = solvers.gmres(solve_plan, b, tol=args.tol, maxiter=10_000)
    elif args.solve == "sor":
        res = solvers.sor(solve_plan, b, host_mat=host_mat.tocsr(),
                          tol=args.tol, maxiter=10_000)
    elif args.solve == "ir":
        # the bf16-data plan of the same matrix inside, a float32 plan's
        # true residual outside (the bf16 kernels take float32 vectors)
        bf16_plan = getattr(solve_plan.matrix, "dtype",
                            None) == torch.bfloat16
        hi = solve_plan
        if dtype != torch.float32 or bf16_plan:
            hi = plan_spmv(host_mat, dtype=torch.float32, device=device)
            b = b.float()
        low = (solve_plan if bf16_plan
               else plan_spmv(host_mat, dtype=torch.bfloat16, device=device))
        ires = solvers.ir_solve(hi, b, low=low,
                                inner_iters=args.inner_iters, maxiter=400,
                                tol=args.tol)
        res = solvers.CGResult(x=ires.x, iterations=ires.outer_iterations,
                               residual_norm=ires.residual_norm,
                               converged=ires.converged)
    else:
        res = solvers.cg(solve_plan, b, tol=args.tol, maxiter=10_000,
                         precond=precond)
    rel = float(res.residual_norm / torch.linalg.norm(b))
    line = {"solver": args.solve, "strategy": solve_plan.strategy,
            "iterations": int(res.iterations), "rel_residual": rel,
            "converged": bool(res.converged), "wall_s": wall()}
    return line, (f"    {args.solve.upper()} ({solve_plan.strategy}): "
                  f"{line['iterations']} iters, rel residual {rel:.2e}, "
                  f"converged={line['converged']} ({line['wall_s']}s)")


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
    p.add_argument("--formats", default="coo,csr,csc,ell,dia,bsr",
                   help="comma-separated format list (coo, csr, csc, ell, "
                        "dia, bsr, bdia)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"],
                   help="compute dtype (bfloat16: bf16 matrix values and "
                        "x; each product widens x to float32 once, sums in "
                        "float32 and rounds the result to bf16)")
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
                   choices=["dia", "dia_stream", "pdia_stream", "bdia",
                            "gpr", "csr_halo", "csr_neighbor",
                            "csr_allgather"],
                   help="force the distributed strategy (default: the "
                        "distributed planner's pick)")
    p.add_argument("--solve", choices=SOLVERS, default=None,
                   help="run a solver on the planned matrix and report "
                        "iterations, residual and wall time: cg, pcg "
                        "(Jacobi), chebcg (Chebyshev polynomial) and mgpcg "
                        "(geometric multigrid, laplacian / laplacian3d "
                        "synthetics only) need SPD; ir = mixed-precision "
                        "iterative refinement (bf16-data inner CG, float32 "
                        "true residual); bicgstab and gmres take general "
                        "square matrices; power = dominant eigenvalue; "
                        "lanczos = both spectrum ends of a symmetric "
                        "matrix; sor = multicolor Gauss-Seidel")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="solver convergence tolerance (with --solve)")
    p.add_argument("--solve-nrhs", type=int, metavar="K", default=0,
                   help="with --solve cg: solve K right-hand sides at once "
                        "through the plan's SpMM (k lockstep CG "
                        "recurrences)")
    p.add_argument("--inner-iters", type=int, default=100,
                   help="with --solve ir: bf16 inner-CG steps per "
                        "refinement cycle")
    p.add_argument("--cache", metavar="DIR", default=None,
                   help="with --auto: keep the planned pack in DIR, so a "
                        "second run on the same input and dtype skips "
                        "analysis and packing")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run (CUDA "
                        "activity included on the card) to DIR/trace.json")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the numpy generator of x and b")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line per result instead of text")
    return p


#: cap on the sweep's dense expansions (a scattered pattern occupies
#: thousands of diagonals and would need nrow values for each; one long row
#: widens every row of an ELL)
_DENSE_CAP_BYTES = 1 << 30


def _drop_explosive_formats(formats, host_mat, itemsize):
    """Drop sweep formats whose dense expansion would not fit the cap."""
    if host_mat.nnz == 0:
        return formats
    nrow = host_mat.shape[0]
    row = host_mat.row.astype(np.int64)
    keep = []
    for name in formats:
        est = None
        if name == "ell":
            width = int(np.bincount(row, minlength=nrow).max())
            est = nrow * width * (itemsize + 4)
        elif name == "dia":
            ndiags = int(np.count_nonzero(np.bincount(
                host_mat.col.astype(np.int64) - row + nrow - 1)))
            est = ndiags * nrow * itemsize
        if est is not None and est > _DENSE_CAP_BYTES:
            print(f"tpu_spmv_torch: skipping {name.upper()} — dense "
                  f"expansion needs ~{est / 2**30:.1f} GiB (cap "
                  f"{_DENSE_CAP_BYTES >> 30} GiB)", file=sys.stderr)
            continue
        keep.append(name)
    return keep


def _widened(fn):
    """``fn(A, x)`` for a bf16 ``x``: x widened to float32 once (exact),
    the float32 product rounded to bf16 (the reference's result type)."""
    import torch

    return lambda A, v: fn(A, v.float()).to(torch.bfloat16)


def _cache_file(args) -> str:
    """The pack's file under ``--cache``: the reference's key (the source,
    with a file's mtime, and the dtype) and name."""
    import hashlib
    import os

    src = args.synthetic or os.path.abspath(args.matrix)
    if args.matrix:
        src += f":{os.path.getmtime(args.matrix)}"
    key = hashlib.sha1(f"{src}|{args.dtype}".encode()).hexdigest()[:16]
    os.makedirs(args.cache, exist_ok=True)
    return os.path.join(args.cache, f"plan_{key}.npz")


def _auto_plan(args, host_mat, dtype, device):
    """The planner's pick, reloaded from ``--cache`` where a good pack is
    there, else planned (and then cached)."""
    import os
    import zipfile

    from .io.checkpoint import load_matrix, save_matrix
    from .ops.auto import plan_from_matrix, plan_spmv

    cache_file = _cache_file(args) if args.cache else None
    if cache_file and os.path.exists(cache_file):
        try:
            A, extra = load_matrix(cache_file, with_extra=True,
                                   device=device)
            plan = plan_from_matrix(A, extra["strategy"])
            if not args.json:
                print(f"planner: reloaded {extra['strategy']} pack from "
                      f"{cache_file} (no re-analysis)")
            return plan
        except (ValueError, KeyError, TypeError, OSError, EOFError,
                zipfile.BadZipFile) as e:
            # stale or damaged: plan again and overwrite
            if not args.json:
                print(f"planner: cache stale ({e}); re-packing")
    plan = plan_spmv(host_mat, dtype=dtype, device=device)
    if cache_file:
        save_matrix(cache_file, plan.matrix,
                    extra={"strategy": plan.strategy})
        if not args.json:
            print(f"planner: cached pack to {cache_file}")
    return plan


def _run(args, host_mat, x, formats, mode, dtype, device, rng):
    """The benchmarks and the solve: the result lines, or None for a
    refused ``--solve``."""
    import torch

    from .bench import bench_format_sweep, bench_spmm, bench_spmv
    from .formats import COO
    from .ops.auto import plan_spmv
    from .ops.spmv import spmv

    bf16 = dtype == torch.bfloat16
    plan = None
    coo = None
    if not args.auto or args.spmm > 0:
        coo = COO.from_arrays(host_mat.row, host_mat.col, host_mat.data,
                              host_mat.shape, dtype=dtype, device=device)
        formats = _drop_explosive_formats(formats, host_mat,
                                          dtype.itemsize)
    if args.auto:
        plan = _auto_plan(args, host_mat, dtype, device)
        if not args.json:
            print(f"planner: strategy={plan.strategy}")
        kern = _widened(plan._kernel) if bf16 else plan._kernel
        results = [bench_spmv(plan.matrix, x, mode=f"{mode}-AUTO",
                              iters=args.iters, check=not args.no_check,
                              quiet=args.json, spmv_fn=kern,
                              oracle=host_mat)]
    else:
        results = bench_format_sweep(coo, x, formats=formats, mode=mode,
                                     iters=args.iters,
                                     check=not args.no_check,
                                     quiet=args.json,
                                     spmv_fn=_widened(spmv) if bf16
                                     else None)

    if args.spmm > 0:
        from .formats import convert

        # bf16: X rounded to bf16 as the reference builds it, then widened
        # exactly to the float32 the bf16-data kernels take
        X = torch.tensor(rng.random((host_mat.shape[1], args.spmm)),
                         dtype=dtype, device=device)
        if bf16:
            X = X.float()
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
            return None
        from .solvers import cg_multi

        solve_plan = plan or plan_spmv(host_mat, dtype=dtype, device=device)
        rng_b = np.random.default_rng(args.seed + 1)
        nrhs = args.solve_nrhs if args.solve == "cg" else 0
        if nrhs > 1:
            # the vectors of a bf16-coefficient plan are float32
            B = torch.tensor(rng_b.random((host_mat.shape[0], nrhs)),
                             dtype=torch.float32 if bf16 else dtype,
                             device=device)
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
            # the vectors of a bf16-coefficient plan are float32
            line, msg = _solve(args, solve_plan, host_mat,
                               torch.float32 if bf16 else dtype, device)
        if args.json:
            results.append(line)
        else:
            print(msg)

    return results


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import scipy.sparse as sp
    import torch

    from .formats import FORMATS

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

    bf16 = dtype == torch.bfloat16
    rng = np.random.default_rng(args.seed)
    x = torch.tensor(rng.random(host_mat.shape[1]), dtype=dtype,
                     device=device)
    if bf16 and not args.json:
        print("dtype bfloat16: bf16 matrix values and x; each product "
              "widens x to float32 once (exact), sums in float32 and "
              "rounds the result to bf16")
    mode = "GPU" if device.type == "cuda" else "CPU"
    if not args.profile:
        results = _run(args, host_mat, x, formats, mode, dtype, device, rng)
    else:
        import os

        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            results = _run(args, host_mat, x, formats, mode, dtype, device,
                           rng)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        if not args.json:
            print(f"profile: trace written to {trace}")
    if results is None:
        return 2

    if args.json:
        for r in results:
            print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
