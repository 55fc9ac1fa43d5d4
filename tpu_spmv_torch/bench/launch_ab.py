"""Launch-path A/B: the launch-bound kernels and K1/K2 at full size, timed
through the ``tpu_spmv_torch`` of a given checkout, for comparing two
checkouts on one card in one call (parent, change, change, parent)::

    python3 tpu_spmv_torch/bench/launch_ab.py --root PARENT_CHECKOUT
    python3 tpu_spmv_torch/bench/launch_ab.py --root .

(``--probes``: the probe kernels T1–T4 alone.)

It prints one JSON line: ms per call (CUDA events, median of repeats,
after warm-up; each kernel and its yardsticks timed in turns, so that
drift in the host's speed falls on all of them) of ``launch_probe`` (T1)
beside ``copy_`` and ``clone()``, ``segsum8`` (T2) beside ``sum``,
``tile_permute`` S (T3) beside ``take_along_dim``; every ``tile_permute``
variant of T3/T4 at the probes' shapes in turns with ``launch_probe``,
per call and replayed from a CUDA graph (``<name>:graph``); on
``random_sparse(100000, 100000, 7e-5)``, ``power_law(400000, 400000,
13)``, ``random_sparse(2000000, 2000000, 8e-6)`` and a 2048x2048-grid
Poisson in a shuffled node order: ``gpr_spmv`` beside cuSPARSE and
``embedding_bag`` (X of one column; at 2M rows also ``ell_spmv``), and
``gpr_spmm`` (K6) with 1, 3, 32 and 40 right-hand sides beside
``embedding_bag`` (at 32 also cuSPARSE ``torch.sparse.mm``); K2 and K1
on the 4096x4096-grid Poisson, K2's walk in turns with its cluster walk
where the checkout has the walks, and K2 on the 128^3 7-point Poisson;
K8b (``psdia_ring``) on one shard of the
plan's pack in turns with K2 on the same pack, and the sharded chain
(``spmv_psdia_sharded``) at 1 and 4 shards on one card, K8b and K2 at
one shard in float64; K3b there at 8
right-hand sides (the plan's own pack) and at 32 (the pack for 32)
beside 8 and 32 launches of K2; CG on the 256x256-grid Poisson (ms per
iteration), with the root, the card's name and power limit.

The script calls only functions that every checkout since the probe
kernels were ported has, and carries its own timing helpers, so any such
checkout can be the other side.  Needs a CUDA card; builds that
checkout's kernels at first use.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """ms per call of ``fn()`` replayed from one CUDA graph of ``calls``
    calls (the device's time with no host work between launches)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return event_ms(graph.replay, 1, replays) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose tpu_spmv_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probes", action="store_true",
                    help="time only the probe kernels (T1-T4)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("launch_ab: needs a CUDA card")
    import tpu_spmv_torch
    from tpu_spmv_torch import dist as tdist
    from tpu_spmv_torch import utils
    from tpu_spmv_torch.bench import probes as pr
    from tpu_spmv_torch.formats import COO, DIA
    from tpu_spmv_torch.kernels import dia_stream as ds
    from tpu_spmv_torch.kernels import dist_stream as dstream
    from tpu_spmv_torch.kernels import ell_packed as ell
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
    # every variant at the probes' shapes, in turns with launch_probe (the
    # launcher's floor), and replayed
    for name, (prog, src, mul, psum8) in pr.tile_variants(
            pr.t3_operands(args.seed), pr.t4_operands(args.seed),
            dev).items():
        def call(prog=prog, src=src, mul=mul, psum8=psum8):
            return pr.tile_permute(prog, src, mul, psum8)

        t = interleaved_ms({"v": call, "lp": lambda: pr.launch_probe(tile)},
                           100)
        out[f"tile_permute {name}"] = t["v"]
        out[f"launch_probe beside tile_permute {name}"] = t["lp"]
        out[f"tile_permute {name}:graph"] = graph_ms(call)
        del prog, src, mul

    if args.probes:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(json.dumps(out))
        return 0

    # the general kernels on phase 4b's operands: 100k rows (launch
    # bound), the power law (X about the L2's size), 2M rows (past the L2)
    # and the shuffled Poisson; yardsticks: cuSPARSE, and embedding_bag,
    # which computes the same per-row sum of data[j] * X[indices[j]]
    lap = utils.laplacian_2d(2048)
    perm = np.random.default_rng(3).permutation(lap.shape[0])
    for label, m, iters in (
            ("100k", utils.random_sparse(100_000, 100_000, 7e-5, seed=0),
             200),
            ("power law", utils.power_law(400_000, 400_000, 13, alpha=1.5,
                                          seed=6), 50),
            ("2M", utils.random_sparse(2_000_000, 2_000_000, 8e-6, seed=2),
             50),
            ("shuffled 2048^2", lap[perm][:, perm].tocsr(), 50)):
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
        # int64 bags, cast outside the timed calls
        idx64 = torch.from_numpy(csr.indices).long().to(dev)
        off64 = torch.from_numpy(csr.indptr[:-1]).long().to(dev)
        w = torch.from_numpy(csr.data).float().to(dev)

        def bag(X):
            return F.embedding_bag(idx64, X, off64, mode="sum",
                                   per_sample_weights=w)

        xcol = xg[:, None]
        out.update(interleaved_ms(
            {f"gpr_spmv {label}": lambda: gpr.spmv_gpr_rows(G, xg),
             f"cuSPARSE {label}": lambda: torch.mv(A, xg),
             f"embedding_bag {label}": lambda: bag(xcol)}, iters))
        if label == "2M":
            E = ell.pack_ell(m, dtype=torch.float32, device=dev)
            out[f"ell_spmv {label}"] = interleaved_ms(
                {"ell": lambda: ell.spmv_ell_main(E, xg)}, iters)["ell"]
            del E
        for nrhs in (1, 3, 32, 40):
            X = torch.rand(m.shape[1], nrhs, device=dev)
            fns = {f"gpr_spmm {label} {nrhs} RHS":
                   lambda: gpr.spmm_gpr_rows(G, X),
                   f"embedding_bag {label} {nrhs} RHS": lambda: bag(X)}
            if nrhs == 32:
                fns[f"cuSPARSE spmm {label} {nrhs} RHS"] = \
                    lambda: torch.sparse.mm(A, X)
            out.update(interleaved_ms(fns, max(2, iters // 5)))
            del X
        del G, A, m, csr, idx64, off64, w
    del lap, perm

    mat = utils.laplacian_2d(4096)
    n = mat.shape[0]
    plan = plan_spmv(mat, dtype=torch.float32, device=dev)
    P = plan.matrix
    x = torch.tensor(rng.random(n), dtype=torch.float32, device=dev)
    xp = ds.pad_x(P, x)
    out["K2 4096^2"] = event_ms(lambda: ds.spmv_psdia_padded(P, xp), 50, 5)
    if hasattr(ds, "psdia_walk_plan"):
        # K2's walk (the plan's, by bulk copy) and the cluster walk, in
        # turns
        walks = {"K2 walk": ds.psdia_walk_plan(P.offsets, P.period, 4),
                 "K2 walk clusters": ds.psdia_cluster_walk(P.offsets, 4)}
        out.update(interleaved_ms(
            {k: (lambda wp: lambda: ds._spmv_psdia_launch(P, xp, wp))(wp)
             for k, wp in walks.items()}, 50, rounds=5))
    mc = mat.tocoo()
    hdia = DIA.from_coo(COO.from_arrays(
        mc.row, mc.col, mc.data, mat.shape, dtype=torch.float32, sort=False))
    del mc, mat
    S = ds.pack_sdia(hdia, device=dev)
    xs = ds.pad_x(S, x)
    out["K1 4096^2"] = event_ms(lambda: ds.spmv_sdia_padded(S, xs), 50, 5)
    del S, xs
    # K8b on the plan's pack: one shard's launch in turns with K2 on the
    # same pack, and the sharded chain at 1 and 4 shards on one card
    for nd in (1, 4):
        mesh = tdist.make_mesh(nd, device="cuda:0")
        A = tdist.place(tdist.ShardedPSDIA.build(P, nd), mesh)
        xsh = tdist.place(A.shard_xpad(xp), mesh)
        fns = {f"psdia_ring sharded {nd}":
               lambda: tdist.spmv_psdia_sharded(mesh, A, xsh)}
        if nd == 1:
            x0 = xsh.chunks[0]
            left, right = x0[-A.halo:], x0[:A.halo]
            # the pack's own walk where the checkout has one
            plan_kw = ({"plan": A.ring_plan} if hasattr(A, "ring_plan")
                       else {})
            fns["psdia_ring 1 shard"] = lambda: dstream.spmv_psdia_ring(
                A.pattern[0], A.offsets, x0, left, right, base=0, L=A.L,
                nrow=A.shape[0], **plan_kw)
            fns["K2 (psdia_ring's pack)"] = lambda: ds.spmv_psdia_padded(P,
                                                                         xp)
        out.update(interleaved_ms(fns, 50, rounds=5))
        del A, xsh, fns
    # the same at one shard in float64 (the pack's values widened)
    P64 = dataclasses.replace(P, pattern=P.pattern.double())
    xp64 = xp.double()
    mesh = tdist.make_mesh(1, device="cuda:0")
    A = tdist.place(tdist.ShardedPSDIA.build(P64, 1), mesh)
    x0 = A.shard_xpad(xp64).chunks[0]
    plan_kw = {"plan": A.ring_plan} if hasattr(A, "ring_plan") else {}
    out.update(interleaved_ms({
        "psdia_ring 1 shard f64": lambda: dstream.spmv_psdia_ring(
            A.pattern[0], A.offsets, x0, x0[-A.halo:], x0[:A.halo], base=0,
            L=A.L, nrow=A.shape[0], **plan_kw),
        "K2 f64": lambda: ds.spmv_psdia_padded(P64, xp64)}, 50, rounds=5))
    del P64, xp64, A, x0, x, xp
    # K3b at 8 RHS on the plan's own pack (cg_multi_runner's shape) and at
    # 32 on the pack for 32 RHS (phase 4c), beside as many K2 launches on
    # the same pack, timed in turns
    P32 = ds.pack_psdia(hdia, period=P.period, nrhs=32, device=dev)
    del hdia
    for nrhs, A, iters in ((8, P, 10), (32, P32, 5)):
        Xt = F.pad(torch.rand(nrhs, n, device=dev),
                   (A.L, A.npad - A.L - n)).contiguous()
        cols = [Xt[q] for q in range(nrhs)]
        out.update(interleaved_ms(
            {f"K3b {nrhs} RHS": lambda: ds.spmm_psdia_padded_t(A, Xt),
             f"{nrhs} x K2": lambda: [ds.spmv_psdia_padded(A, v)
                                     for v in cols]}, iters, rounds=5))
        del Xt, cols
    del plan, P, P32

    m3 = utils.laplacian_3d(128)
    plan3 = plan_spmv(m3, dtype=torch.float32, device=dev)
    xp3 = ds.pad_x(plan3.matrix, torch.tensor(rng.random(m3.shape[0]),
                                              dtype=torch.float32, device=dev))
    out["K2 128^3"] = event_ms(
        lambda: ds.spmv_psdia_padded(plan3.matrix, xp3), 50, 5)
    del m3, plan3, xp3

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
