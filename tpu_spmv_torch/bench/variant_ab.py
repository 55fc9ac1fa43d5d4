"""A/B of the hand-written kernels under design variants::

    for v in none cap2 cap4 ahead2 ahead2 cap4 cap2 none; do
        python3 tpu_spmv_torch/bench/variant_ab.py --suite walk --variant $v
    done
    python3 tpu_spmv_torch/bench/variant_ab.py --suite walk --root PARENT
    for v in none last last-half last-half last none; do
        python3 tpu_spmv_torch/bench/variant_ab.py --suite gpr_spmm \\
            --variant $v
    done

``none`` times the package under ``--root`` (default: this checkout; any
checkout since the probe kernels were ported prints what it has).  The
other variants first write a copy of this checkout's package under
``build/variant_ab/<variant>/`` with its sources changed, ``+`` joining
changes:

- ``cap2``, ``cap4``: the bulk stride walk of K2 and K8b
  (``csrc/psdia_walk.cuh:psdia_walk_bulk``, a producer warp beside the
  consumers) under a register cap of two or four blocks an SM instead of
  three;
- ``ahead1``, ``ahead2``: at most one or two bulk windows in flight
  instead of three (the walk plan's ``BULK_AHEAD``);
- ``nodirect``, ``direct8``: K2 on its walk at any size, or one thread
  a row up to eight tiles an SM (not four);
- ``plainstore``: one thread a row stores its row with a plain store,
  not a streaming one;
- ``noring``: ``tile_permute``'s whole-tile programs one block a tile,
  with one stage buffer, where there are more tiles than SMs too (not one
  persistent block an SM with two);
- ``full512``: whole-tile blocks of 512 threads instead of 1024;
- ``nopad``: ``tile_permute``'s staged rows unpadded (128 values and 128
  index bytes a row);
- ``last``, ``last-half``: ``gpr_spmm`` (K6) loads X with
  ``ld.global.nc.L2::cache_hint`` under a policy from
  ``createpolicy.fractional``: ``L2::evict_last`` for every load, or for
  half of them (``L2::evict_unchanged`` for the rest).

Each run builds its copy's kernels and prints one JSON line with a hash
of each output (a variant changes no bit) and the card's name and power
limit.  ``--suite walk``: ms per call (CUDA events, median of 15 runs
after warm-up) of K2 on the 4096x4096-grid Poisson in float32 and float64
along its plan, K8b on one shard of the same pack, K2 on the 128^3 Poisson,
K2 on the 384, 512, 1024 and 256-wide grids' Poisson in float32 and
float64 per call and replayed from a CUDA graph, CG on the last
(``cg_runner``, ms per iteration, per call over 200 iterations and
replayed from a graph of 20), and every
``tile_permute`` variant of the probes replayed from a CUDA graph;
``--suite tiles``: the ``tile_permute`` variants alone; ``--suite
gpr_spmm``: ``gpr_spmm`` on the four operands of ``bench/launch_ab.py``
(``random_sparse(100000, 7e-5)``, ``power_law(400000, 13)``,
``random_sparse(2000000, 8e-6)``, the shuffled 2048x2048-grid Poisson)
at 1, 3, 32 and 40 right-hand sides.  Run the variants in turns in one
call, so that drift in the card's speed falls on all of them.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]

_L2_LOAD = r'''
// X loads under an L2 eviction policy
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> ld_policy(const Pack<T, V>* p,
                                                uint64_t pol) {
  Pack<T, V> r;
  if constexpr (std::is_same<T, float>::value && V == 4)
    asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
        : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
        : "l"(p), "l"(pol));
  else if constexpr (std::is_same<T, float>::value && V == 2)
    asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(r.v[0]), "=f"(r.v[1]) : "l"(p), "l"(pol));
  else if constexpr (std::is_same<T, float>::value)
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(r.v[0]) : "l"(p), "l"(pol));
  else if constexpr (V == 2)
    asm("ld.global.nc.L2::cache_hint.v2.f64 {%0, %1}, [%2], %3;"
        : "=d"(r.v[0]), "=d"(r.v[1]) : "l"(p), "l"(pol));
  else
    asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;"
        : "=d"(r.v[0]) : "l"(p), "l"(pol));
  return r;
}
'''


def _l2_policy(qualifiers: str, fraction: str) -> list:
    """``gpr_spmm``'s X loads under ``createpolicy.fractional``."""
    anchor = "// gpr_spmm: entries whose X values a lane loads before"
    loop = "  for (int q = threadIdx.x % G; q < xstride; q += G) {"
    return [
        ("csrc/general.cu", anchor, _L2_LOAD + "\n" + anchor),
        ("csrc/general.cu", "  const int64_t xstride = nrhs / V;\n" + loop,
         "  const int64_t xstride = nrhs / V;\n  uint64_t pol;\n"
         f'  asm("createpolicy.fractional.{qualifiers}.b64 %0, {fraction};"'
         ' : "=l"(pol));\n' + loop),
        ("csrc/general.cu",
         "xv[i] = xp[static_cast<int64_t>(col[i]) * xstride + q];",
         "xv[i] = ld_policy<T, V>(\n"
         "              xp + static_cast<int64_t>(col[i]) * xstride + q, "
         "pol);"),
    ]


#: each change: its edits (file under the package, text, replacement)
CHANGES = {
    "cap2": [("csrc/psdia_walk.cuh", "__launch_bounds__(kBulkThreads, 3)",
              "__launch_bounds__(kBulkThreads, 2)")],
    "cap4": [("csrc/psdia_walk.cuh", "__launch_bounds__(kBulkThreads, 3)",
              "__launch_bounds__(kBulkThreads, 4)")],
    "ahead1": [("kernels/dia_stream.py", "\nBULK_AHEAD = 3\n",
                "\nBULK_AHEAD = 1\n")],
    "ahead2": [("kernels/dia_stream.py", "\nBULK_AHEAD = 3\n",
                "\nBULK_AHEAD = 2\n")],
    "nodirect": [("kernels/dia_stream.py", "    return 4 * torch.cuda",
                  "    return 0 * torch.cuda")],
    "direct8": [("kernels/dia_stream.py", "    return 4 * torch.cuda",
                 "    return 8 * torch.cuda")],
    "plainstore": [("csrc/psdia_walk.cuh", "  __stcs(y + k, acc);",
                    "  y[k] = acc;")],
    "noring": [("csrc/probes.cu",
                "const bool ring = ntiles > sms && 2 * stage_bytes(a) <= "
                "kSmemMax;", "const bool ring = false;")],
    "full512": [("csrc/probes.cu", "launch_tile_t<PSUM8, 1024>",
                 "launch_tile_t<PSUM8, 512>")],
    "nopad": [("csrc/probes.cu", "const int zs = nc + 4, is = nc + 16;",
               "const int zs = nc, is = nc;")],
    "last": _l2_policy("L2::evict_last", "1.0"),
    "last-half": _l2_policy("L2::evict_last.L2::evict_unchanged", "0.5"),
}


def make_variant(variant: str) -> Path:
    """Write this checkout's package with ``variant``'s changes under
    ``build/variant_ab/<variant>/``; return that root."""
    root = _ROOT / "build" / "variant_ab" / variant
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_ROOT / "tpu_spmv_torch", root / "tpu_spmv_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for change in variant.split("+"):
        for name, old, new in CHANGES[change]:
            src = root / "tpu_spmv_torch" / name
            text = src.read_text()
            if text.count(old) != 1:
                raise SystemExit(f"variant_ab: {name} has changed: {old!r}")
            src.write_text(text.replace(old, new))
    return root


def _hash(y) -> str:
    return hashlib.sha1(y.cpu().numpy().tobytes()).hexdigest()[:12]


def _tiles(out, dev, graph_ms):
    from tpu_spmv_torch.bench import probes as pr

    for name, (prog, src, mul, psum8) in pr.tile_variants(
            pr.t3_operands(), pr.t4_operands(), dev).items():
        def call(prog=prog, src=src, mul=mul, psum8=psum8):
            return pr.tile_permute(prog, src, mul, psum8)

        out[f"tile_permute {name} hash"] = _hash(call())
        out[f"tile_permute {name}:graph"] = graph_ms(call)


def _walk(out, dev, event_ms, graph_ms):
    import numpy as np
    import torch

    from tpu_spmv_torch import dist as tdist
    from tpu_spmv_torch import utils
    from tpu_spmv_torch.kernels import dia_stream as ds
    from tpu_spmv_torch.kernels import dist_stream as dst
    from tpu_spmv_torch.ops.auto import plan_spmv
    from tpu_spmv_torch.solvers import cg_runner

    rng = np.random.default_rng(0)

    def record(key, fn, iters):
        out[f"{key} hash"] = _hash(fn())
        out[key] = event_ms(fn, iters, 15)

    mat = utils.laplacian_2d(4096)
    P = plan_spmv(mat, dtype=torch.float32, device=dev).matrix
    del mat
    for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        A = (P if dtype == torch.float32 else
             dataclasses.replace(P, pattern=P.pattern.double()))
        xp = ds.pad_x(A, torch.tensor(rng.random(A.shape[0]), dtype=dtype,
                                      device=dev))
        record(f"K2 {dname}", lambda: ds.spmv_psdia_padded(A, xp), 50)
        S = tdist.place(tdist.ShardedPSDIA.build(A, 1),
                        tdist.make_mesh(1, device="cuda:0"))
        x0 = S.shard_xpad(xp).chunks[0]
        kw = ({"plan": S.ring_plan} if hasattr(S, "ring_plan") else {})
        record(f"K8b {dname}", lambda: dst.spmv_psdia_ring(
            S.pattern[0], S.offsets, x0, x0[-S.halo:], x0[:S.halo], base=0,
            L=S.L, nrow=S.shape[0], **kw)[:A.npad], 50)
        del A, xp, S, x0
    del P

    m3 = utils.laplacian_3d(128)
    A = plan_spmv(m3, dtype=torch.float32, device=dev).matrix
    xp = ds.pad_x(A, torch.tensor(rng.random(m3.shape[0]),
                                  dtype=torch.float32, device=dev))
    record("K2 128^3 f32", lambda: ds.spmv_psdia_padded(A, xp), 50)
    del m3, A, xp
    for nx in (384, 512, 1024, 256):
        m = utils.laplacian_2d(nx)
        x = rng.random(m.shape[0])
        for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            plan = plan_spmv(m, dtype=dtype, device=dev)
            A = plan.matrix
            xp = ds.pad_x(A, torch.tensor(x, dtype=dtype, device=dev))
            record(f"K2 {nx}^2 {dname}", lambda: ds.spmv_psdia_padded(A, xp),
                   200)
            out[f"K2 {nx}^2 {dname}:graph"] = graph_ms(
                lambda: ds.spmv_psdia_padded(A, xp))
    m256, x256 = m, x
    for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        plan256 = plan_spmv(m256, dtype=dtype, device=dev)
        b = torch.tensor(m256 @ x256, dtype=dtype, device=dev)
        run = cg_runner(plan256, iters=200, report_tol=1e-5)
        out[f"CG 256^2 {dname} ms/iteration"] = event_ms(
            lambda: run(b), 1, 5) / 200
        run20 = cg_runner(plan256, iters=20, report_tol=1e-5)
        try:
            out[f"CG 256^2 {dname} ms/iteration:graph"] = graph_ms(
                lambda: run20(b).x, calls=1, replays=15) / 20
        except RuntimeError as e:   # a checkout whose CG cannot be captured
            out[f"CG 256^2 {dname} ms/iteration:graph"] = str(e)[:200]


def _gpr_spmm(out, dev, event_ms):
    import numpy as np
    import torch

    from tpu_spmv_torch import utils
    from tpu_spmv_torch.kernels import gpr

    lap = utils.laplacian_2d(2048)
    perm = np.random.default_rng(3).permutation(lap.shape[0])
    for label, make, iters in (
            ("100k", lambda: utils.random_sparse(100_000, 100_000, 7e-5,
                                                 seed=0), 40),
            ("power law", lambda: utils.power_law(400_000, 400_000, 13,
                                                  alpha=1.5, seed=6), 10),
            ("2M", lambda: utils.random_sparse(2_000_000, 2_000_000, 8e-6,
                                               seed=2), 10),
            ("shuffled 2048^2", lambda: lap[perm][:, perm].tocsr(), 10)):
        m = make()
        G = gpr.pack_gpr(m, dtype=torch.float32, device=dev)
        for nrhs in (1, 3, 32, 40):
            torch.manual_seed(nrhs)
            X = torch.rand(m.shape[1], nrhs, device=dev)
            out[f"{label} {nrhs} RHS hash"] = _hash(gpr.spmm_gpr_rows(G, X))
            out[f"{label} {nrhs} RHS"] = event_ms(
                lambda: gpr.spmm_gpr_rows(G, X), iters, 15)
            del X
        del G, m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", choices=["walk", "tiles", "gpr_spmm"],
                    required=True)
    ap.add_argument("--variant", default="none")
    ap.add_argument("--root", default=str(_ROOT),
                    help="checkout whose package the 'none' variant times")
    args = ap.parse_args(argv)
    if args.variant != "none" and any(c not in CHANGES for c in
                                      args.variant.split("+")):
        raise SystemExit(f"variant_ab: no variant {args.variant!r}")
    root = (Path(args.root).resolve() if args.variant == "none"
            else make_variant(args.variant))
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("variant_ab: needs a CUDA card")
    import tpu_spmv_torch

    if Path(tpu_spmv_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"variant_ab: imported {tpu_spmv_torch.__file__}, "
                         f"not the package under {root}")
    # this checkout's timing helpers, whatever the root
    spec = importlib.util.spec_from_file_location(
        "variant_ab_timing", Path(__file__).with_name("launch_ab.py"))
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    dev = torch.device("cuda")
    out = {"suite": args.suite, "variant": args.variant, "root": str(root)}
    if args.suite == "gpr_spmm":
        _gpr_spmm(out, dev, timing.event_ms)
    else:
        _tiles(out, dev, timing.graph_ms)
        if args.suite == "walk":
            _walk(out, dev, timing.event_ms, timing.graph_ms)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
