"""Launch-path A/B: the launch-bound kernels and K1/K2 at full size, timed
through the ``tpu_spmv_torch`` of a given checkout, for comparing two
checkouts on one card in one call (parent, change, change, parent)::

    python3 tpu_spmv_torch/bench/launch_ab.py --root PARENT_CHECKOUT
    python3 tpu_spmv_torch/bench/launch_ab.py --root .

It prints one JSON line: ms per call (CUDA events, median of repeats,
after warm-up; each kernel and its yardsticks timed in turns, so that
drift in the host's speed falls on all of them) of ``launch_probe`` (T1)
beside ``copy_`` and ``clone()``, ``segsum8`` (T2) beside ``sum``,
``tile_permute`` S (T3) beside ``take_along_dim``, ``gpr_spmv`` on
``random_sparse(100000, 100000, 7e-5)`` beside cuSPARSE, K2 and K1 on the
4096x4096-grid Poisson, CG on the 256x256-grid Poisson (ms per
iteration), with the root, the card's name and power limit.

The script calls only functions that every checkout since the probe
kernels were ported has, and carries its own timing helpers, so any such
checkout can be the other side.  Needs a CUDA card; builds that
checkout's kernels at first use.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import warnings
from pathlib import Path


def event_ms(fn, iters: int, repeats: int = 10, warmup: int = 3) -> float:
    """Median ms per call of ``fn()`` over ``repeats`` runs of ``iters``
    calls (CUDA events around each run)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def interleaved_ms(fns: dict, iters: int, rounds: int = 10) -> dict:
    """Median ms per call of each of ``fns`` (name -> call), timed in
    turns: every round runs :func:`event_ms` once (``iters`` calls) for
    each function, so a change in the host's speed falls on all alike."""
    for fn in fns.values():
        event_ms(fn, 1, 1)
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(event_ms(fn, iters, 1, warmup=0))
    return {name: statistics.median(t) for name, t in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose tpu_spmv_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("launch_ab: needs a CUDA card")
    import tpu_spmv_torch
    from tpu_spmv_torch import utils
    from tpu_spmv_torch.bench import probes as pr
    from tpu_spmv_torch.formats import COO, DIA
    from tpu_spmv_torch.kernels import dia_stream as ds
    from tpu_spmv_torch.kernels import gpr
    from tpu_spmv_torch.ops.auto import plan_spmv
    from tpu_spmv_torch.solvers import cg_runner

    if Path(tpu_spmv_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"launch_ab: imported {tpu_spmv_torch.__file__}, "
                         f"not the package under {root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    out = {"root": str(root)}

    tile = torch.rand(pr.Q, pr.Q, device=dev)
    dst = torch.empty_like(tile)
    v = torch.from_numpy(pr.t2_operand(args.seed)).to(dev)
    prog, src, _, _ = pr.tile_variants(pr.t3_operands(args.seed),
                                       pr.t4_operands(args.seed, T=1),
                                       dev)["S"]
    gl = prog.idx[0].long()
    out.update(interleaved_ms({"launch_probe": lambda: pr.launch_probe(tile),
                               "copy_": lambda: dst.copy_(tile),
                               "clone()": tile.clone}, 400))
    out.update(interleaved_ms({"segsum8": lambda: pr.segsum8(v),
                               "sum": lambda: v.view(-1, 16, 8).sum(-1)},
                              300))
    out.update(interleaved_ms(
        {"tile_permute S": lambda: pr.tile_permute(prog, src),
         "take_along_dim": lambda: torch.take_along_dim(src, gl, dim=1)},
        100))

    m = utils.random_sparse(100_000, 100_000, 7e-5, seed=0)
    G = gpr.pack_gpr(m, dtype=torch.float32, device=dev)
    xg = torch.tensor(rng.random(m.shape[1]), dtype=torch.float32,
                      device=dev)
    csr = m.tocsr()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)     # "beta state"
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr).int(),
            torch.from_numpy(csr.indices).int(),
            torch.from_numpy(csr.data).float(), size=csr.shape).to(dev)
    out.update(interleaved_ms(
        {"gpr_spmv 100k": lambda: gpr.spmv_gpr_rows(G, xg),
         "cuSPARSE 100k": lambda: torch.mv(A, xg)}, 200))
    del G, A

    mat = utils.laplacian_2d(4096)
    plan = plan_spmv(mat, dtype=torch.float32, device=dev)
    P = plan.matrix
    x = torch.tensor(rng.random(mat.shape[0]), dtype=torch.float32,
                     device=dev)
    xp = ds.pad_x(P, x)
    out["K2 4096^2"] = event_ms(lambda: ds.spmv_psdia_padded(P, xp), 50, 5)
    del plan, P, xp
    mc = mat.tocoo()
    S = ds.pack_sdia(DIA.from_coo(COO.from_arrays(
        mc.row, mc.col, mc.data, mat.shape, dtype=torch.float32,
        sort=False)), device=dev)
    del mc, mat
    xs = ds.pad_x(S, x)
    out["K1 4096^2"] = event_ms(lambda: ds.spmv_sdia_padded(S, xs), 50, 5)
    del S, xs, x

    m256 = utils.laplacian_2d(256)
    plan256 = plan_spmv(m256, dtype=torch.float32, device=dev)
    b = torch.tensor(m256 @ rng.random(m256.shape[0]), dtype=torch.float32,
                     device=dev)
    run = cg_runner(plan256, iters=200, report_tol=1e-5)
    out["CG 256^2 ms/iteration"] = event_ms(lambda: run(b), 1, 5) / 200

    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
