"""A/B of the hand-written kernels under design variants::

    for v in none cap2 cap4 ahead2 ahead2 cap4 cap2 none; do
        python3 tpu_spmv_torch/bench/variant_ab.py --suite walk --variant $v
    done
    python3 tpu_spmv_torch/bench/variant_ab.py --suite walk --root PARENT
    for r in PARENT . . PARENT; do
        python3 tpu_spmv_torch/bench/variant_ab.py --suite gather --root $r
    done
    for v in none last last-half last-half last none; do
        python3 tpu_spmv_torch/bench/variant_ab.py --suite gpr_spmm \\
            --variant $v
    done
    for r in PARENT . . PARENT; do
        python3 tpu_spmv_torch/bench/variant_ab.py --suite spmm --root $r
    done
    for r in PARENT . . PARENT; do
        python3 tpu_spmv_torch/bench/variant_ab.py --suite batched --root $r
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
  half of them (``L2::evict_unchanged`` for the rest);
- ``ellb2``, ``ellb8``: ``ell_spmv`` loads 2 or 8 slots before its x
  gathers (not 4); ``ellplain``: its slots with plain loads, not
  streaming ones; ``ellcap``: its grid capped at 132 x 8 blocks (each
  warp walks several slices); ``ellocc``: a register cap of 8 blocks an
  SM;
- ``pu4``, ``pu16``: the two-pass gather's pass 2 keeps 4 or 16 words of
  1 or 2 bytes in flight a thread (not 8); ``async4``, ``async16``: 4 or
  16 cp.async copies of 4-byte words in flight a lane (not 8);
  ``vecs1``, ``vecs4``: pass 1 loads 1 or 4 runs of 8 offsets a thread
  at once (not 2); ``nolast``: the two-pass form on rows loads its
  offsets under an L2 evict-normal policy (not evict-last); ``pt1024``:
  blocks of 1024 threads (not 512);
- ``direct4``: the direct gather on rows (``permute_gather_batched``)
  uses each group of four indices for 4 rows whatever their bytes (not as
  many as fit ``BATCH_L2_BYTES``); ``lagk``: the two-pass form on rows
  puts pass 2 of a chunk K items after its pass 1 (not K plus half the
  grid), ``lag4`` K plus a quarter of the grid; ``occ1``, ``occ3``: its
  blocks under a register cap of one or three an SM (not two);
  ``noinline``: the pass bodies called, not inlined (each allocates its
  own registers); diagnostics that change the result: ``nowait`` (no
  item waits for another), ``p1only``, ``p2only`` (the other pass's items
  do nothing);
- ``ellcs``, ``ellnc``: ``ell_spmm`` loads its slots with streaming
  (``__ldcs``) or read-only (``__ldg``) loads, not plain ones;
  ``ellmb2``: twice the slots a batch; ``ellpf``, ``ellpf2``: the next
  batch's slot lines prefetched (``prefetch.global.L1`` / ``.L2``) before
  a batch's X loads; ``ellpf1``: the same in L1 from the first lane of
  each row only; ``carry``: the SpMM body of ``gpr_spmm`` and
  ``ell_spmm`` loads the first entry of the next batch with each batch
  (a row one entry wider than a batch then needs no second trip).

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
at 1, 3, 32 and 40 right-hand sides; ``--suite gather``: the gather
(K7b) at 4,194,304 slots on the identity, the RCM perm of chip_smoke.py's
shuffled band and a random perm, f32 and f64, beside ``index_select`` (a
checkout with the two-pass plan also times, in f32, the direct and the
two-pass form of each, each pass alone, chunks of 4096, 8192 and 16384
words,
perms of growing scatter with their ``far_share`` -- random inside
windows of 64 to 65536 slots, the identity with a share of its slots
shuffled -- and random perms of 2^14 to 2^22 slots), ``ro(x)`` on the
shuffled band and K1 inside it, ``ell_spmv`` (K4) on the 2048x2048-grid
Poisson in its natural order and in a shuffled one and on the shuffled
band beside cuSPARSE, f32 and f64, and the batched gather (K7d/K7e) as
``--suite batched`` times it; per call and replayed, every input from its
own seed so that two checkouts hash alike; ``--suite gather-quick``: the
same without the band and the batched gather; ``--suite batched``: the
batched gather (``apply_permutation_batched``) on the RCM perm of the
2048x2048-grid Poisson in a shuffled node order (seed 3; n = 4,194,304,
a two-pass plan) at 32 and 8 rows in f32 and f64, the same rows with the
plan forced direct, and on the RCM perm of ``banded(1000000, 5)`` in its
natural order (a direct plan) at 32 rows in f32, each beside
``torch.index_select`` and one ``apply_permutation`` per row (each row its
own memory, so that no row is served from L2 by the call before), per
call and replayed; then ``ro(x)`` on chip_smoke.py's shuffled band with
both of its perms forced direct and forced two-pass, timed in turns
(direct, two-pass, two-pass, direct);
``--suite spmm``: K3a (``spmm_sdia_padded_t``) on the 4096x4096-grid
Poisson forced to SDIA beside K3b (``spmm_psdia_padded_t``) on its PSDIA
pack, both packs built for 32 RHS, at 8 and 32 right-hand sides, and
``ell_spmm`` (``spmm_ell_main``) beside ``gpr_spmm`` (``spmm_gpr_rows``)
on the 2048x2048-grid Poisson in a shuffled node order (seed 3) and in
its natural order at 3, 32 and 40 right-hand sides (f64: 32), each with
cuSPARSE ``torch.sparse.mm`` at 8 and 32; f32 and f64, per call and
replayed, every input from its own seed (about 95 s a run);
``--suite spmm-general``: the same without K3a and K3b.
Run the variants in turns in one call, so that drift in the card's speed
falls on all of them.  Needs a CUDA card.
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


def _ell_slots(load: str) -> list:
    """``ell_spmm``'s slot loads (the SpMM body at STEP 32) through
    ``load``."""
    return [("csrc/general.cu",
             "        col[i] = j < end ? indices[j] : 0;\n"
             "        v[i] = j < end ? data[j] : T(0);",
             f"        col[i] = j < end ? (STEP == 1 ? indices[j] : "
             f"{load}(indices + j)) : 0;\n"
             f"        v[i] = j < end ? (STEP == 1 ? data[j] : "
             f"{load}(data + j)) : T(0);")]


def _ell_prefetch(level: str, leader: bool = False) -> list:
    """``ell_spmm`` (the SpMM body at STEP 32) asks for the lines of the
    next batch's slots (``prefetch.global.<level>``) before this batch's
    X loads, on every lane or (``leader``) on the first lane of each row:
    a row's slots lie 128 bytes apart, so without it a row wider than a
    batch waits on one more trip to memory for its next slot."""
    cond = "jn < end && threadIdx.x % G == 0" if leader else "jn < end"
    return [("csrc/general.cu",
             "      P xv[kBatch];\n",
             "      if constexpr (STEP > 1) {\n"
             "#pragma unroll\n"
             "        for (int i = 0; i < kBatch; ++i) {\n"
             "          const int64_t jn = j0 + (kBatch + i) * STEP;\n"
             f"          if ({cond}) {{\n"
             f'            asm volatile("prefetch.global.{level} [%0];" '
             ':: "l"(indices + jn));\n'
             f'            asm volatile("prefetch.global.{level} [%0];" '
             ':: "l"(data + jn));\n'
             "          }\n"
             "        }\n"
             "      }\n"
             "      P xv[kBatch];\n")]


_CARRY_OLD = """\
    for (int64_t j0 = begin; j0 < end; j0 += kBatch * STEP) {
      int col[kBatch];
      T v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
"""
_CARRY_NEW = """\
    int c0 = begin < end ? indices[begin] : 0;
    T v0 = begin < end ? data[begin] : T(0);
    for (int64_t j0 = begin; j0 < end; j0 += kBatch * STEP) {
      int col[kBatch];
      T v[kBatch];
      col[0] = c0;
      v[0] = v0;
      {
        const int64_t jn = j0 + kBatch * STEP;
        c0 = jn < end ? indices[jn] : 0;
        v0 = jn < end ? data[jn] : T(0);
      }
#pragma unroll
      for (int i = 1; i < kBatch; ++i) {
"""


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
    "ellb8": [("csrc/general.cu", "constexpr int kEllBatch = 4;",
               "constexpr int kEllBatch = 8;")],
    "ellcap": [("csrc/general.cu",
                "  if (blocks > 0x7fffffff) blocks = 0x7fffffff;\n  ell_spmv",
                "  if (blocks > 132 * 8) blocks = 132 * 8;\n  ell_spmv")],
    "ellocc": [("csrc/general.cu",
                "__launch_bounds__(kThreads)\n    ell_spmv(",
                "__launch_bounds__(kThreads, 8)\n    ell_spmv(")],
    "pu4": [("csrc/permute.cu", "constexpr int kPassUnroll = 8;",
             "constexpr int kPassUnroll = 4;")],
    "pu16": [("csrc/permute.cu", "constexpr int kPassUnroll = 8;",
              "constexpr int kPassUnroll = 16;")],
    "pt1024": [("csrc/permute.cu", "constexpr int kPassThreads = 512;",
                "constexpr int kPassThreads = 1024;")],
    "async4": [("csrc/permute.cu", "  constexpr int kAsync = 8;",
                "  constexpr int kAsync = 4;")],
    "async16": [("csrc/permute.cu", "  constexpr int kAsync = 8;",
                 "  constexpr int kAsync = 16;")],
    "vecs1": [("csrc/permute.cu", "constexpr int kVecs = 2;",
               "constexpr int kVecs = 1;")],
    "vecs4": [("csrc/permute.cu", "constexpr int kVecs = 2;",
               "constexpr int kVecs = 4;")],
    "nolast": [("csrc/permute.cu",
                "createpolicy.fractional.L2::evict_last.b64",
                "createpolicy.fractional.L2::evict_normal.b64")],
    "direct4": [("kernels/permute.py", "\nBATCH_L2_BYTES = 24 << 20\n",
                 "\nBATCH_L2_BYTES = 1 << 40\n")],
    "lagk": [("csrc/permute.cu",
              "      nchunks + (grid / 2 < nchunks ? grid / 2 : nchunks);",
              "      nchunks;")],
    "lag4": [("csrc/permute.cu",
              "      nchunks + (grid / 2 < nchunks ? grid / 2 : nchunks);",
              "      nchunks + (grid / 4 < nchunks ? grid / 4 : nchunks);")],
    "nowait": [("csrc/permute.cu", "      wait_count(done + g, "
                "static_cast<unsigned>(nchunks));\n",
                "      __syncthreads();\n")],
    "p1only": [("csrc/permute.cu", "      rows_pass2<W, R>(smem, st,",
                "      if (false) rows_pass2<W, R>(smem, st,")],
    "p2only": [("csrc/permute.cu",
                "      rows_pass1<W, R>(reinterpret_cast<W*>(smem),",
                "      if (false) rows_pass1<W, R>(reinterpret_cast<W*>("
                "smem),")],
    "noinline": [("csrc/permute.cu",
                  "__device__ __forceinline__ void rows_pass1(",
                  "__device__ __noinline__ void rows_pass1("),
                 ("csrc/permute.cu",
                  "__device__ __forceinline__ void rows_pass2(",
                  "__device__ __noinline__ void rows_pass2(")],
    "occ1": [("csrc/permute.cu", "constexpr int kRowsBlocksPerSM = 2;",
              "constexpr int kRowsBlocksPerSM = 1;")],
    "occ3": [("csrc/permute.cu", "constexpr int kRowsBlocksPerSM = 2;",
              "constexpr int kRowsBlocksPerSM = 3;")],
    "ellb2": [("csrc/general.cu", "constexpr int kEllBatch = 4;",
               "constexpr int kEllBatch = 2;")],
    "ellplain": [("csrc/general.cu",
                  "  col = __ldcs(c);\n  val = __ldcs(v);",
                  "  col = *c;\n  val = *v;")],
    "ellpf": _ell_prefetch("L1"),
    "ellpf2": _ell_prefetch("L2"),
    "ellpf1": _ell_prefetch("L1", leader=True),
    "carry": [("csrc/general.cu", _CARRY_OLD, _CARRY_NEW)],
    "ellcs": _ell_slots("__ldcs"),
    "ellnc": _ell_slots("__ldg"),
    "ellmb2": [("csrc/general.cu",
                "  constexpr int kBatch = spmm_batch(G, V);",
                "  constexpr int kBatch =\n"
                "      spmm_batch(G, V) * (STEP == 1 ? 1 : 2);")],
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


def _shuffled_band(n: int):
    """The band of chip_smoke.py's phase 4e: ``banded(n, 5)`` in a random
    node order (seed 3), entry (r, c) moved to (inv[r], inv[c])."""
    import numpy as np
    import scipy.sparse as sp

    from tpu_spmv_torch import utils

    bc = utils.banded(n, 5).tocoo()
    order = np.random.default_rng(3).permutation(n)
    inv = np.empty_like(order)
    inv[order] = np.arange(n)
    return sp.csr_matrix((bc.data, (inv[bc.row], inv[bc.col])),
                         shape=bc.shape)


def _rand(dev, shape, dtype, seed):
    """Inputs from their own seed: both sides of an A/B get the same."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=dev, dtype=dtype)


def _batched(out, dev, event_ms, graph_ms, band=None, quick=False):
    """K7d/K7e (``apply_permutation_batched``) at the main path's shapes,
    beside ``index_select`` and one ``apply_permutation`` per row; then
    ``ro(x)`` on the shuffled band (``band``, built if not given) with its
    perms forced to each form, in turns.  ``quick``: the batched gather
    alone at 32 rows (f32 and f64, forced direct, the natural band)."""
    import numpy as np
    import torch

    from tpu_spmv_torch import utils
    from tpu_spmv_torch.kernels import permute as pk
    from tpu_spmv_torch.reorder import reorder_plan

    lap = utils.laplacian_2d(2048)
    perm = np.random.default_rng(3).permutation(lap.shape[0])
    rop = reorder_plan(lap[perm][:, perm].tocsr(), dtype=torch.float32,
                       device=dev)
    rcm = rop.perm_plan
    natural = reorder_plan(utils.banded(1_000_000, 5, seed=1),
                           dtype=torch.float32, device=dev).perm_plan
    del lap, perm, rop
    out["K7d RCM method"] = rcm.method
    out["K7d natural band method"] = natural.method
    forced = pk._plan(rcm.perm, dev, "direct", pk.CHUNK)
    cases = [("RCM", rcm, 32, torch.float32), ("RCM", rcm, 8, torch.float32),
             ("RCM", rcm, 32, torch.float64), ("RCM", rcm, 8, torch.float64),
             ("RCM forced direct", forced, 32, torch.float32),
             ("natural band RCM", natural, 32, torch.float32)]
    for seed, (name, plan, rows, dtype) in enumerate(cases):
        if quick and rows != 32:
            continue
        X = _rand(dev, (rows, plan.n), dtype, 10 + seed)
        idx = plan.perm.long()
        key = (f"K7d {name} {rows} rows "
               f"{'f32' if dtype == torch.float32 else 'f64'}")
        one = [X[q] for q in range(rows)]   # each row its own memory
        fns = {"": lambda: pk.apply_permutation_batched(plan, X),
               " index_select": lambda: torch.index_select(X, 1, idx),
               f" {rows} x apply_permutation": lambda: [
                   pk.apply_permutation(plan, v) for v in one]}
        out[f"{key} hash"] = _hash(fns[""]())
        for side, fn in list(fns.items())[:1 if quick else None]:
            out[f"{key}{side}"] = event_ms(fn, 5, 11)
            out[f"{key}{side}:graph"] = graph_ms(fn, calls=4, replays=7)
        del X, one, fns
    del rcm, natural, forced
    if quick:
        return

    # ro(x) on the shuffled band with both perms forced to one form
    ro = reorder_plan(band if band is not None else _shuffled_band(4_194_304),
                      dtype=torch.float32, device=dev)
    forms = {f: (pk._plan(ro.perm, dev, f, pk.CHUNK),
                 pk._plan(ro.inv_perm, dev, f, pk.CHUNK))
             for f in ("direct", "two_pass")}
    xs = _rand(dev, ro.perm.numel(), torch.float32, 3)

    def ro_x(form):
        p, q = forms[form]
        return lambda: pk.apply_permutation(q, ro.plan(
            pk.apply_permutation(p, xs)))

    for turn, form in enumerate(("direct", "two_pass", "two_pass",
                                 "direct")):
        key = f"ro(x) {form} turn {turn}"
        out[f"ro(x) {form} hash"] = _hash(ro_x(form)())
        out[key] = event_ms(ro_x(form), 50, 15)
        out[f"{key}:graph"] = graph_ms(ro_x(form))


def _gather(out, dev, event_ms, graph_ms, quick=False):
    import time

    import numpy as np
    import torch

    from tpu_spmv_torch import utils
    from tpu_spmv_torch.kernels import dia_stream as ds
    from tpu_spmv_torch.kernels import ell_packed as ell
    from tpu_spmv_torch.kernels import permute as pk
    from tpu_spmv_torch.ops.auto import plan_spmv
    from tpu_spmv_torch.reorder import reorder_plan

    # a checkout with the planned two-pass gather also times both forms
    planned = hasattr(pk, "_plan")

    def rand(shape, dtype, seed):
        return _rand(dev, shape, dtype, seed)

    def record(key, fn, iters):
        out[f"{key} hash"] = _hash(fn())
        out[key] = event_ms(fn, iters, 15)
        out[f"{key}:graph"] = graph_ms(fn)

    def library(key, fn, iters):
        out[key] = event_ms(fn, iters, 15)
        try:
            out[f"{key}:graph"] = graph_ms(fn)
        except RuntimeError as e:   # a library call that cannot be captured
            out[f"{key}:graph"] = str(e)[:200]

    def plan(p, form="auto", chunk=None):
        t0 = time.perf_counter()
        pp = (pk.plan_permutation(p, device=dev) if form == "auto" and
              chunk is None else pk._plan(p, dev, form, chunk or pk.CHUNK))
        torch.cuda.synchronize()
        return pp, time.perf_counter() - t0

    n = 4_194_304
    perms = {"identity": torch.arange(n, device=dev),
             "random": torch.from_numpy(
                 np.random.default_rng(5).permutation(n)).to(dev)}
    if not quick:
        band = _shuffled_band(n)
        ro = reorder_plan(band, dtype=torch.float32, device=dev)
        perms["RCM"] = ro.perm
    for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        x = rand(n, dtype, 1)
        for pname, p in perms.items():
            key = f"K7b {pname} {dname}"
            pp, out[f"{key} plan s"] = plan(p)
            record(key, lambda: pk.apply_permutation(pp, x), 100)
            library(f"{key} index_select",
                    lambda: torch.index_select(x, 0, p), 100)
            if planned:
                out[f"{key} method"] = pp.method
                if x.element_size() > 4:    # 8-byte words: the direct form
                    continue
                for form in ("direct", "two_pass"):
                    pm, _ = plan(p, form)
                    record(f"{key} {form}",
                           lambda: pk.apply_permutation(pm, x), 100)
                # each pass alone (pass 2 reading the stage pass 1 wrote)
                st = pk._one_pass(pm, x, 1)
                for which, src in ((1, x), (2, st)):
                    out[f"{key} pass {which}:graph"] = graph_ms(
                        lambda: pk._one_pass(pm, src, which))
        del x
    if planned:
        # the two-pass gather's chunk, and where it overtakes the direct
        # one: random perms of growing size (replayed)
        x = rand(n, torch.float32, 2)
        for pname in ("RCM", "random")[quick:]:
            for chunk in (4096, 8192, 16384):
                pm, _ = plan(perms[pname], "two_pass", chunk)
                fn = lambda: pk.apply_permutation(pm, x)   # noqa: E731
                key = f"K7b {pname} f32 two_pass C={chunk}"
                out[f"{key} hash"] = _hash(fn())
                out[f"{key}:graph"] = graph_ms(fn)
        # perms of growing scatter, each with its far_share beside both
        # forms: a random perm inside each window of w slots, and the
        # identity with a share f of its slots shuffled among themselves
        rng = np.random.default_rng(7)
        mixed = {}
        for w in (64, 1024, 4096, 16384, 65536):
            mixed[f"window {w}"] = (rng.random((n // w, w)).argsort(axis=1)
                                    + np.arange(0, n, w)[:, None]).reshape(-1)
        for f in (0.1, 0.25, 0.5, 0.75):
            p = np.arange(n)
            moved = np.flatnonzero(rng.random(n) < f)
            p[moved] = rng.permutation(moved)
            mixed[f"share {f}"] = p
        for name, p in mixed.items():
            pt = torch.from_numpy(p).to(dev)
            out[f"K7b {name} far_share"] = pk.far_share(pt)
            for form in ("direct", "two_pass"):
                pm, _ = plan(pt, form)
                out[f"K7b {name} f32 {form}:graph"] = graph_ms(
                    lambda: pk.apply_permutation(pm, x))
        rng = np.random.default_rng(6)
        for m in (2**14, 2**16, 2**18, 2**20, 2**21, 2**22):
            p = rng.permutation(m)
            xm = x[:m].clone()
            for form in ("direct", "two_pass"):
                pm, _ = plan(p, form)
                out[f"K7b random n={m} {form}:graph"] = graph_ms(
                    lambda: pk.apply_permutation(pm, xm))
        del x, xm
    if not quick:
        # ro(x) on the shuffled band: the two gathers around K1 (the
        # reordered band's SDIA pack), and K1 alone on the same pack
        xs = rand(n, torch.float32, 3)
        record("ro(x) f32", lambda: ro(xs), 50)
        A1 = ro.plan.matrix
        xp1 = ds.pad_x(A1, pk.apply_permutation(ro.perm_plan, xs))
        record("K1 in ro(x) f32", lambda: ds.spmv_sdia_padded(A1, xp1), 50)
        del xs, xp1, A1

    # K4: sliced ELL forced on the 2048x2048-grid Poisson in its natural
    # order and in a shuffled node order (seed 3; the same slots and
    # bytes), and on the shuffled band (the planner's pick where it picks
    # sliced ELL); cuSPARSE torch.mv beside each
    lap = utils.laplacian_2d(2048)
    perm = np.random.default_rng(3).permutation(lap.shape[0])
    operands = {"natural 2048^2": lap,
                "shuffled 2048^2": lap[perm][:, perm].tocsr()}
    if not quick:
        band_plan = plan_spmv(band, dtype=torch.float32, device=dev)
        out["shuffled band strategy"] = band_plan.strategy
        del band_plan
        operands["shuffled band"] = band
    for name, m in operands.items():
        csr = m.tocsr()
        for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            A = ell.pack_ell(m, dtype=dtype, device=dev)
            x = rand(m.shape[1], dtype, 4)
            record(f"K4 {name} {dname}", lambda: ell.spmv_ell_main(A, x), 50)
            L = torch.sparse_csr_tensor(
                torch.from_numpy(csr.indptr.astype(np.int32)),
                torch.from_numpy(csr.indices.astype(np.int32)),
                torch.from_numpy(csr.data).to(dtype),
                size=csr.shape).to(dev)
            library(f"K4 {name} {dname} cuSPARSE", lambda: torch.mv(L, x), 50)
            del A, x, L
    if quick:
        return
    del ro, perms, operands
    _batched(out, dev, event_ms, graph_ms, band)


def _spmm(out, dev, event_ms, graph_ms, general_only=False):
    import numpy as np
    import torch

    from tpu_spmv_torch import COO, convert, utils
    from tpu_spmv_torch.kernels import dia_stream as ds
    from tpu_spmv_torch.kernels import ell_packed as ell
    from tpu_spmv_torch.kernels import gpr

    F = torch.nn.functional

    def rand(shape, dtype, seed):
        """Inputs from their own seed: both sides of an A/B get the same."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype)

    def record(key, fn, iters, calls):
        out[f"{key} hash"] = _hash(fn())
        out[key] = event_ms(fn, iters, 11)
        out[f"{key}:graph"] = graph_ms(fn, calls=calls, replays=5)

    def cusparse(m, dtype):
        csr = m.tocsr()
        return torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype(np.int32)),
            torch.from_numpy(csr.indices.astype(np.int32)),
            torch.from_numpy(csr.data).to(dtype), size=csr.shape).to(dev)

    if not general_only:
        # K3a on the 4096x4096-grid Poisson forced to SDIA, beside K3b on
        # its PSDIA pack, both packs built for 32 RHS, and cuSPARSE
        mat = utils.laplacian_2d(4096)
        n = mat.shape[0]
        dia = convert(COO.from_scipy(mat, dtype=torch.float32, device=dev),
                      "dia")
        S = ds.pack_sdia(dia, nrhs=32)
        P = ds.pack_psdia(dia, period=4096, nrhs=32)
        del dia
        out["4096^2 packs"] = f"rb {S.rb} npad {S.npad} / rb {P.rb}"
        for dname, dtype in (("f32", torch.float32),
                             ("f64", torch.float64)):
            Sd = dataclasses.replace(S, data=S.data.to(dtype))
            Pd = dataclasses.replace(P, pattern=P.pattern.to(dtype))
            lib = cusparse(mat, dtype)
            for k in (8, 32):
                X = rand((n, k), dtype, k)
                calls = 2 if k == 32 else 4
                for kname, A, kern in (("K3a", Sd, ds.spmm_sdia_padded_t),
                                       ("K3b", Pd, ds.spmm_psdia_padded_t)):
                    Xt = F.pad(X.T, (A.L, A.npad - A.L - n)).contiguous()
                    record(f"{kname} 4096^2 {k} RHS {dname}",
                           lambda: kern(A, Xt), 5, calls)
                    del Xt
                out[f"cuSPARSE 4096^2 {k} RHS {dname}"] = event_ms(
                    lambda: torch.sparse.mm(lib, X), 3, 5)
                del X
            del Sd, Pd, lib
        del S, P, mat

    # ell_spmm (K4 SpMM) on the 2048x2048-grid Poisson in a shuffled node
    # order (seed 3; the planner's sliced-ELL pick) and in its natural
    # order, beside gpr_spmm (K6) on the same operand and cuSPARSE
    lap = utils.laplacian_2d(2048)
    perm = np.random.default_rng(3).permutation(lap.shape[0])
    for name, m in (("shuffled 2048^2", lap[perm][:, perm].tocsr()),
                    ("natural 2048^2", lap)):
        for dname, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            E = ell.pack_ell(m, dtype=dtype, device=dev)
            G = gpr.pack_gpr(m, dtype=dtype, device=dev)
            lib = cusparse(m, dtype)
            for k in ((3, 32, 40) if dname == "f32" else (32,)):
                X = rand((m.shape[1], k), dtype, 100 + k)
                calls = 4 if k >= 32 else 10
                record(f"ell_spmm {name} {k} RHS {dname}",
                       lambda: ell.spmm_ell_main(E, X), 10, calls)
                record(f"gpr_spmm {name} {k} RHS {dname}",
                       lambda: gpr.spmm_gpr_rows(G, X), 10, calls)
                if k == 32:
                    out[f"cuSPARSE {name} {k} RHS {dname}"] = event_ms(
                        lambda: torch.sparse.mm(lib, X), 5, 5)
                del X
            del E, G, lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite",
                    choices=["walk", "tiles", "gpr_spmm", "gather",
                             "gather-quick", "batched", "batched-quick",
                             "spmm",
                             "spmm-general"],
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
    elif args.suite.startswith("spmm"):
        _spmm(out, dev, timing.event_ms, timing.graph_ms,
              general_only=args.suite == "spmm-general")
    elif args.suite.startswith("batched"):
        _batched(out, dev, timing.event_ms, timing.graph_ms,
                 quick=args.suite == "batched-quick")
    elif args.suite.startswith("gather"):
        _gather(out, dev, timing.event_ms, timing.graph_ms,
                quick=args.suite == "gather-quick")
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
