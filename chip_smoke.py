"""Chip smoke test: drive the port's main paths once on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. toolchain — Python, torch and CUDA versions, ``nvcc --version``, the
   card's name and power limit;
2. build — ``nvcc`` compiles ``tpu_spmv_torch/csrc/dia_stream.cu``,
   ``general.cu``, ``dist_stream.cu``, ``permute.cu`` and ``probes.cu``
   for ``sm_90a`` (one process each, started together) into one library
   under ``build/tpu_spmv_torch/``; at the same time ``nvcc -Xptxas -v``
   of ``general.cu``, ``permute.cu``, ``dia_stream.cu``,
   ``dist_stream.cu`` and ``probes.cu``, which prints the registers,
   spills and static shared memory of every instantiation (the bf16-data
   forms too) of ``gpr_spmv``, ``ell_spmv``, ``gpr_spmm`` and
   ``ell_spmm`` (``gpr_spmm_lanes``, ``ell_spmm_lanes`` on 2 or 4 lanes of
   one RHS), ``sdia_ring`` (K8a), the gathers ``permute_gather``, ``permute_pass1``,
   ``permute_pass2`` and their forms on rows ``permute_gather_batched``
   and ``permute_rows_two_pass``, the two walks of K3a and K3b
   (``dia_spmm_stride``,
   ``dia_spmm_clusters``),
   the walks of K2 and K8b (``csrc/psdia_walk.cuh``: ``psdia_walk_bulk``,
   ``psdia_walk_stride``, ``psdia_walk_clusters``) and ``tile_permute``;
3. kernels against their plain PyTorch versions on small operands, f32 and
   f64, each against the plain version (rel 1e-6 f32, 1e-13 f64), against
   scipy float64 (2e-5 f32, 1e-10 f64) and for bitwise reproducibility:
   K1 (SDIA) and K2 (PSDIA), pads exactly zero; ``gpr_spmv`` and
   ``ell_spmv`` on ``bus420.mtx``, ``powerlaw800.mtx`` and
   ``random_sparse(2000, 200000)``, the planner's pick and the other one
   forced, with the virtual-row fold checked against a host fold; the
   SpMM kernels K3a (``sdia_spmm``), K3b (``psdia_spmm``), ``gpr_spmm`` and
   ``ell_spmm`` on the same operands with 1, 3, 32 and 40 right-hand
   sides (K3a and K3b also 8), each column also against the SpMV kernel
   (bitwise: K3a's against K1's, K3b's against K2's, ``ell_spmm``'s
   against ``ell_spmv``'s); K1/K2 on the
   transposed packs (``transpose_sdia`` / ``transpose_psdia``) against
   scipy ``A^T x``, and the backward of ``spmv_sdia`` / ``spmv_psdia``
   (``x.grad`` against scipy ``A^T g``, the coefficient gradient against
   the same rule on the CPU); the permutation gathers ``permute_gather``
   (``apply_permutation`` at n = 1000, 16384, 60000, 99991 and
   ``apply_tile_permutation``), the two-pass gather on the same perms
   (chunks of 1024 words; each pass alone also against its plain
   version, in f32: 8-byte words take the direct gather) and both forms
   on rows, ``permute_gather_batched`` and ``permute_rows_two_pass`` (1,
   3, 32, 40 RHS; f64 takes the direct form), bitwise against their plain
   versions and ``x[perm]``, with and without don't-care slots, and
   reproducible; the probe kernels
   ``copy_scale`` (K9), ``launch_probe`` (T1), ``segsum8`` (T2) and every
   ``tile_permute`` variant of T3/T4 at the probes' shapes, bitwise against
   their plain versions (and the tile variants against the numpy
   composition of each probe's kernel body), reproducible; the block
   formats' products (ELL, BSR, BDIA; torch code) with 0, 1, 3 and 32
   right-hand sides on ``bus420.mtx`` and ``block_laplacian(12, bs=8)``,
   f32 and f64, against the CPU path and scipy, reproducible;
4. the main paths at full size, each with the launch counters zeroed just
   before it and read just after:
   a. streaming DIA: the 4096x4096-grid 2-D Poisson (16,777,216 rows,
      83,869,696 nonzeros, float32) through ``plan_spmv`` to PSDIA,
      checked against scipy float64; 50 fixed CG iterations on it; the
      same operand forced to SDIA; the 128^3 7-point Poisson and a 1M-row
      11-diagonal band through the planner; f64 CG with the true-residual
      gate on the 256x256-grid Poisson;
   b. general sparsity: ``random_sparse(100000, 100000, 7e-5)``,
      ``power_law(400000, 400000, 13)``, ``random_sparse(2000000,
      2000000, 8e-6)`` and a 2048x2048-grid Poisson in a shuffled node
      order through ``plan_spmv`` (GPR or sliced ELL, never CSR), each
      checked against scipy float64; 50 fixed CG iterations on the SPD
      operator P + P^T + diag(row sums of |P + P^T| + 1) of the power-law
      P and on the shuffled Poisson; f64 CG with the true-residual gate on
      ``bus420.mtx``;
   c. multi-RHS (32 right-hand sides): ``plan.spmm`` on the 4096x4096
      Poisson (PSDIA) and on the four general operands (GPR or sliced ELL,
      GPR forced on the shuffled Poisson), and K3b/K3a on PSDIA/SDIA packs
      built for 32 RHS, each against scipy float64 (every K3b column also
      bitwise against K2 on the same pack, every K3a column against K1);
      50 fixed
      ``cg_multi_runner`` iterations with 8 RHS on the Poisson and on the
      power-law SPD operator; f64 ``cg_multi`` with 4 RHS on the 256x256
      Poisson and ``bus420.mtx``, every column's true residual <= 1e-10;
   d. distributed (shards on the one card): first, on the small operands
      of phase 3, K8a (``sdia_ring``) and K8b (``psdia_ring``, the sharded
      pack's walk) per shard at 1, 2 and 4 shards, f32 and f64, against
      their plain versions, scipy and (the concatenated shards) the
      single-chip K1/K2 on the same pack, K8b's bitwise; then, counters
      zeroed, the 4096x4096 Poisson's packs of phase 4a sharded (no second
      planning) through ``bench_dist_spmv``'s chain at 1 and 4 shards, each
      product bitwise the single-chip K2/K1 and beside the plain K2/K1
      chain on the same pack (the reference's ``dist1_psdia_parity`` and
      ``dist1_parity``);
      ``ShardedGPR`` at one shard on ``random_sparse(100000, 100000,
      7e-5)`` beside the plain ``gpr_spmv`` chain (``dist1_gpr_parity``);
      f64 ``dist_cg`` over ``csr_neighbor`` at 4 shards on the 256x256
      Poisson, converged, its true residual against scipy;
   e. reorder and operator transforms: ``banded(4194304, 5)`` in a random
      node order (seed 3; 46,137,314 nonzeros) through ``plan_spmv`` (a
      general kernel) and ``reorder_plan`` (RCM, then ``dia_stream`` at
      bandwidth 5: both perms planned on the card to the two-pass gather,
      ``ro(x)`` launches it twice and K1 once), against scipy; the
      shuffled 2048x2048 Poisson of 4b through ``reorder_plan``, 50 fixed
      CG iterations in permuted space, and ``apply_permutation_batched``
      with its RCM perm on 32 and 8 rows of 4,194,304 (f32: the two-pass
      form ``permute_rows_two_pass``; f64: the direct form
      ``permute_gather_batched``) and with that perm planned direct, each
      bitwise the plain version, ``index_select`` and the other form; 4a's
      1M-row band in its natural order through ``reorder_plan`` (a local
      perm: two direct gathers) and the batched gather on 32 rows with
      its perm (the direct form); ``plan.transpose()`` of 4a's 1M-row band
      (K1 on the
      transposed SDIA); one backward through ``spmv_psdia`` on 4a's PSDIA
      pack and ``matvec_differentiable`` on the power-law GPR plan with
      ``plan_spmv(P.T)``, against scipy; the screened Poisson
      ``shift_diagonal(PSDIA, 1.0)`` with 40 CG iterations, true residual
      <= 1e-5 (the reference's ``cg16m_ms_iter`` leg);
   f. block formats: ``block_laplacian(512, bs=8)`` (2,097,152 rows,
      83,755,008 nonzeros, float32) through ``plan_spmv`` to ``bdia``,
      against scipy, and ``plan.spmm`` with 32 right-hand sides; the same
      operand with BSR forced and with the general arm forced (its sliced
      ELL or GPR kernel); the SPD form B + B^T + diag(row sums of |B + B^T|
      + 1) through ``plan_spmv`` to ``bdia`` with 50 fixed CG iterations;
      ``block_laplacian(64, bs=8)`` (the reference's ``bsr_gflops``
      operand); f64 CG to a true residual <= 1e-10 on the SPD form at 32;
      ``plan_dist_spmv`` of the 512 operand at 1 and 4 shards on the one
      card (``bdia``) against the single-chip plan, and f64 ``dist_cg`` at 4
      shards over it on the SPD form at 32, true residual <= 1e-10; ELL
      forced on ``random_sparse(100000, 100000, 7e-5)`` against sliced ELL
      (K4);
   g. the solvers behind ``--solve`` on 4a's 4096x4096 Poisson plan (no
      second planning of it), the counters zeroed and read around each
      solver, its iterations, ms/iteration (host clock) and launches
      printed: ``power_iteration`` (50 steps; its Rayleigh quotient at or
      under the analytic lambda_max) and ``eigsh_lanczos(k=80)`` (both
      ends inside the analytic spectrum); on the screened operator ``A +
      I`` (4e's ``shift_diagonal`` of the PSDIA pack) ``bicgstab``,
      ``gmres(restart=30)``, ``chebyshev`` on ``[1, 9]``, CG with
      ``chebyshev_preconditioner`` and multicolor ``sor``, each to a true
      relative residual <= 1e-5 by scipy float64; CG with
      ``mg_preconditioner((4096, 4096))`` on the unscreened operator to
      ``tol=1e-5`` within 200 iterations beside plain CG's iterations;
      ``lsqr`` on 4a's 1M-row band with its plan's ``transpose()``, its
      residual norms after 10, 20, ... 50 iterations non-increasing;
      ``ir_solve`` on the screened operator to a true residual <= 1e-5
      twice: both plans forced to SDIA (hi K1 f32, low K1 on bf16 data)
      and as planned (hi K2, low ``plan_spmv(A + I,
      dtype=torch.bfloat16)``: K2 on the bf16 pattern widened once); K1
      on bf16 data through ``plan_spmv(dtype=torch.bfloat16)`` of a
      random-valued ``banded(1000000, 5)``, against its plain version (2e-5
      relative) and scipy float64 of the f32 matrix (printed as the
      reference's ``bf16_data_rel_err``);
   h. bf16 coefficients on the general arm, refinement, SpGEMM and
      checkpoints: ``plan_spmv(dtype=torch.bfloat16)`` of 4b's
      ``random_sparse(2000000, 2000000, 8e-6)`` (``gpr``) and shuffled
      2048x2048 Poisson (``pallas_ell``), and ``pack_ell(dtype=bfloat16)``
      of the Poisson in its natural order, each product within 2e-5 of
      scipy float64 on the bf16-rounded matrix and within 2e-2 of the
      unrounded one (``bf16_data_rel_err``); ``ir_solve`` with a float32
      plan outside and a bf16 plan inside (32 inner steps) on 4b's
      P + P^T + diag (GPR) and on the shuffled Poisson screened, A + I
      (sliced ELL), each to a true residual <= 1e-5 by scipy float64;
      ``spgemm(A, A)`` of 4a's Poisson as DIA (13 diagonals), packed with
      ``pack_sdia`` and run by K1 against K2(K2(x)) within 2e-5; then, the
      counters read, ``gpr_spmv`` and ``ell_spmv`` on bf16 data
      (``tsp_gpr_spmv_bf16f32``, ``tsp_ell_spmv_bf16f32``) bitwise their
      plain versions and reproducible, timed (CUDA events, median) beside
      the f32 kernel of the same matrix, their bounds, plain versions and
      cuSPARSE ``torch.mv`` on bf16 data where torch has it;
      ``spgemm_csr`` on ``random_sparse(100000, 100000, 7e-5)`` squared
      (f32) and ``bus420.mtx`` squared (f64) against scipy (2e-5, 1e-12,
      the pattern equal), run twice for the bits, the host symbolic
      seconds beside the device numeric ms; ``save_matrix`` /
      ``load_matrix`` of 4b's power-law GPR plan and 4a's PSDIA plan, each
      reloaded product bitwise the original's, pack, save and load
      seconds; the CLI twice as a subprocess, ``--synthetic
      powerlaw:400000,13 --auto --dtype bfloat16 --cache DIR`` (the second
      run reloads the pack and writes a ``--profile`` trace);
   i. bf16 data on the SpMMs and the distributed path: ``plan_spmv(dtype=
      torch.bfloat16)`` of 4a's 4096x4096 Poisson and ``plan.spmm`` with
      32 right-hand sides (K3b on the widened pattern, bitwise the f32
      plan's on these exact values), the same matrix's 32-RHS SDIA pack of
      4c at bf16 through ``plan.spmm`` (K3a bf16), the bf16 plans of 4b's
      ``random_sparse(2000000, 2000000, 8e-6)`` (``gpr_spmm`` bf16) and
      shuffled 2048x2048 Poisson (``ell_spmm`` bf16; also in its natural
      order, sliced ELL forced), each within 2e-5 of scipy on the
      bf16-rounded matrix and 2e-2 of the unrounded one;
      ``cg_multi_runner`` with 8 right-hand sides on the bf16 plan of the
      screened Poisson to a true residual <= 1e-5; ``plan_dist_spmv(dtype=
      torch.bfloat16)`` at 4 shards on the card of the Poisson (K8b on the
      widened pattern), the Poisson forced to ``dia_stream`` (K8a bf16)
      and the 2M-row matrix (``ShardedGPR`` bf16), each through
      ``bench_dist_spmv``'s bf16 gate, beside the single-card bf16 plan's
      chain (parity; the streaming products bitwise it); ``spmm_allgather``,
      ``spmm_halo`` and ``spmm_neighbor`` at 4 shards with 8 right-hand
      sides on the shuffled Poisson against scipy; then, the counters
      read, the four bf16-data forms (K3a ``sdia_spmm_bf16``,
      ``gpr_spmm_bf16``, ``ell_spmm_bf16``, K8a ``sdia_ring_bf16`` at one
      shard) bitwise their plain versions at those shapes, timed beside
      the f32 kernel of the same matrix, their bounds, plain versions and
      cuSPARSE on bf16 data where torch has the call (K8a bf16 also as the
      chain of four shards on the card, bitwise K1 bf16, replayed from a
      CUDA graph beside the one shard); the CLI as a
      subprocess with ``--dtype bfloat16 --spmm 32 --dist 4 --solve cg
      --solve-nrhs 8`` (all shards on the card);
   j. the distributed solvers at full width, four shards on the card, f32
      (``dist_solvers_phase``): ``dist_mg_preconditioner`` on the
      2048x2048 Poisson (4,194,304 rows, 20,963,328 nonzeros) against the
      serial ``mg_preconditioner`` on the same r (rel <= 2e-5); ``dist_cg``
      with it over ``NeighborCSR`` (``balance="rows"``) to tol 1e-5,
      converged, true relative residual <= 1e-4 and within one iteration
      of the single card's ``cg(precond=mg_preconditioner)`` through K2,
      and a profile of one V-cycle and one matvec; ``dist_gmres`` (restart
      30) and ``dist_bicgstab`` with a sharded Jacobi on ``laplacian_2d
      (2048) + 0.5 (P - P^T) + 2I`` (P: ``scipy.sparse.random`` at density
      2/n), each converged with a true residual <= 1e-4, beside the single
      card's ``gmres`` / ``bicgstab`` with the same Jacobi through the
      planner's general kernel; ``dist_cg`` and ``dist_cg_ca`` with the
      Jacobi on the Poisson within one iteration of the single card's
      ``cg`` with it, and their true residuals within 2x of its;
      ``bench/dist_bench.py --sweep --device cuda:0 --iters 20`` in process
      (its JSON on a line of its own, its gates passed), the counters
      zeroed just before it and read just after, its GPR leg's
      ``gpr_spmv`` launches required and reported apart;
      the cost model's two constants (``predict_dist_costs``): the CSR
      local product's values/s at one shard, and the copy rate of one
      shard's chunk on the card;
5. the probe path first (``run_probes``: ``copy_scale`` and torch's
   ``copy_`` over 256 MiB, whose higher rate is the roofline's peak, the
   launch probe once and four in a row, ``segsum8`` and every
   ``tile_permute`` variant at the probes' shapes), its launch counters
   zeroed before it; the host breakdown of one launch (µs per call by the
   host clock over 10,000 calls of each step of the launch path: the
   steps of the former per-wrapper launch and of the launcher, the bare
   ctypes call under ``CDLL`` and ``PyDLL``, the whole ``launch_probe``
   wrapper beside ``clone()``); ``cg_runner(iters=200)`` in f32 on the 256x256 Poisson,
   where the launches set the pace; then each kernel at the main paths'
   shapes against its plain version, timed (CUDA events, median) beside
   its bound and one library call of the same function, a yardstick the
   port never calls (cuSPARSE: ``torch.sparse_csr_tensor @ x``,
   ``torch.sparse.mm`` for the SpMMs; ``torch.index_select`` for the
   gathers); ``ell_spmv`` also on the 2048x2048 Poisson in its natural
   order beside the shuffled one, and ``ell_spmm`` there (32 RHS) in
   turns with ``gpr_spmm`` and cuSPARSE; the gathers on the inputs of 4e (the
   direct gather on the RCM perm of the 1M band in its natural order, the
   two-pass gather on the RCM perm of the shuffled band, each pass also
   alone beside its plain version and ``index_select`` /
   ``index_copy_``) and on 4,194,304 f32 values with the identity and a
   random perm, each beside the direct gather and ``index_select``,
   bitwise, on rotated copies of its inputs that hold four times the L2,
   replayed from a CUDA graph (and repeated on one input, in L2); the
   batched gather at 4e's shapes per call (the two-pass form on the
   shuffled Poisson's RCM perm at 32 and 8 rows beside the same perm
   planned direct, the direct form on the natural band's perm at 32 rows
   and on the RCM perm in f64), each beside its bound, its plain version,
   ``index_select`` and one ``apply_permutation`` a row; every
   record no faster than its bound, and ``ro(x)``; each SpMM also beside
   ``plan.spmm`` end to end and 32 times its SpMV kernel; the two walks
   of K3b and of K3a (the plan's pick and the cluster walk) timed in
   turns on the 32-RHS packs with 32 and (K3a) 8 right-hand sides and
   K3b's, with 8, on the plan's own pack (``cg_multi_runner``'s shape)
   beside 8 launches of K2, each with its shared-memory plan; K1 on bf16
   data (``sdia_spmv_bf16``) on 4a's SDIA pack with its data cast to
   bf16, after K1 and K2, beside its bound ((2 ndiags + 8) npad bytes),
   its plain version and K1 f32 (no library call computes bf16 data with
   f32 sums: ``library_ms`` null); K2 on its
   walk (the plan's stride walk by bulk copy), and the walks of K8b on the one shard and of K2 on
   the pack in turns (the plan's, the stride walk with the coefficients
   per tile, the cluster walk), each bitwise K2; K8a on the one shard
   also in f64 (bitwise K1 f64, beside it) and as the chain of four
   shards on the card, bitwise K1, replayed from a CUDA graph beside the
   one shard and four times a quarter shard;
   ``gpr_spmv`` and ``gpr_spmm`` on every general operand in turns with
   ``embedding_bag`` (and ``gpr_spmm`` with cuSPARSE), with
   ``gpr_spmm``'s rate of X lines; the GPR packs' rows per width class;
   the probe kernels beside their plain versions, bounds
   and one library call (``torch.mul``, ``copy_`` and ``clone()``,
   ``sum``, ``take_along_dim``, for the whole-tile variants on their flat
   source with the steps' composed index; timed in turns with the
   kernel), every
   ``tile_permute`` variant with its own bound
   (``bench/roofline.py:tile_permute_bytes``), its replayed time and its
   launches on the probe path; the block
   products ``spmv_bdia``, ``spmv_bsr`` and ``spmm_bdia`` (32 RHS) at 512
   beside their bounds and cuSPARSE BSR (``torch.sparse_bsr_tensor``, or
   the CSR product where torch refuses BSR on CUDA); last, one line of
   the launch-bound rows (T1, T2, T3 S, ``gpr_spmv`` and the sharded GPR
   at 100k rows, the 256x256 CG).

The last lines are the kernels' JSON record, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import itertools
import json
import math
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def require(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_err(y, ref) -> float:
    import numpy as np

    y = np.asarray(y, dtype=np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


#: kernel-vs-plain limits (the same sums, in another order for GPR and
#: sliced ELL; FMA rounding may differ)
PLAIN_TOL = {"float32": 1e-6, "float64": 1e-13}
#: scipy float64 oracle gates
ORACLE_TOL = {"float32": 2e-5, "float64": 1e-10}
#: the bound's peak rates, from NVIDIA's H100 SXM data sheet: bytes/s of
#: HBM3 and float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time (ms) the card could take, and what sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def csr_tensor(mat, dtype, device):
    """A scipy matrix as a ``torch.sparse_csr_tensor`` of ``dtype`` on
    ``device``: the cuSPARSE yardsticks' operand."""
    import torch

    csr = mat.tocsr()
    itype = torch.int32 if csr.nnz < 2**31 else torch.int64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # "beta state"
        return torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr).to(itype),
            torch.from_numpy(csr.indices).to(itype),
            torch.from_numpy(csr.data).to(dtype),
            size=csr.shape).to(device)


def library_ms(mat, x) -> float:
    """One cuSPARSE call of the same product in the type of ``x``:
    ``torch.mv`` of a ``torch.sparse_csr_tensor`` for a vector,
    ``torch.sparse.mm`` for an ``[n, nrhs]`` block (a yardstick; the port
    never calls it)."""
    import torch

    from tpu_spmv_torch.bench.harness import time_fn

    A = csr_tensor(mat, x.dtype, x.device)
    fn = torch.mv if x.dim() == 1 else torch.sparse.mm
    return time_fn(fn, A, x, iters=20).median_s * 1e3


#: the mangled names' letters of the kernels' template type arguments
_MANGLED = {"f": "float", "d": "double", "h": "uint8", "t": "uint16",
            "j": "uint32", "m": "uint64", "i": "int32", "l": "int64"}


def ptxas_usage(sources: dict, during=None) -> list[str]:
    """Registers, spills and static shared memory of kernels, as
    ``nvcc -Xptxas -v`` reports them: ``sources`` maps a ``csrc`` file to
    the kernel names to report (one nvcc per file, all started together,
    into a temporary directory); ``during()``, if given, runs while they
    compile (the library's own build, on the same cores)."""
    import re
    import tempfile

    from tpu_spmv_torch.kernels import _build

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = {src: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             f"{tmp}/{src}.o", str(ROOT / "tpu_spmv_torch" / "csrc" / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources}
        if during is not None:
            try:
                during()
            except BaseException:
                for proc in procs.values():     # stop what this started
                    proc.kill()
                    proc.wait()
                raise
        for src, proc in procs.items():
            out = proc.communicate()[0]
            require(proc.returncode == 0, f"nvcc -Xptxas -v {src}:\n{out}")
            entry = None
            for line in out.splitlines():
                m = re.search(r"(?:Compiling entry function|Function "
                              r"properties for) '?([^' ]+)", line)
                if m:
                    entry = m.group(1)
                    continue
                name = next((k for k in sources[src]
                             if entry and re.search(rf"\d{k}I", entry)), None)
                if name and ("spill" in line or "Used" in line):
                    # the template arguments follow the name in the mangling
                    # (I ... E; a type letter, or Li<n>E for an int)
                    seg = entry.split(f"{name}I", 1)[1]
                    toks = re.findall(r"(\d+__nv_bfloat16)|Li(-?\d+)E|"
                                      r"Lb([01])E|([fdhtjmil])",
                                      seg[:seg.index("EEv")])
                    args = ", ".join(
                        "bf16" if h else _MANGLED.get(t, n) if not b
                        else ("false", "true")[int(b)]
                        for h, n, b, t in toks)
                    lines.append(f"{name}<{args}>: "
                                 f"{' '.join(line.split(':', 1)[-1].split())}")
    return lines


def read_fixture(name: str):
    """A matrix of ``tests/fixtures`` as scipy CSR, read by the port's own
    MatrixMarket reader."""
    import scipy.sparse as sp

    from tpu_spmv_torch.io.mmio import read_mtx_arrays

    row, col, val, shape = read_mtx_arrays(ROOT / "tests" / "fixtures" / name,
                                           use_native=False)
    return sp.csr_matrix((val, (row, col)), shape=shape)


def zero(*counters) -> None:
    for c in counters:
        for k in c:
            c[k] = 0


def check_general(name, m, A, kern, plain, full, dname, x64, x, host_fold):
    """One general-arm kernel on a small operand: against its plain
    version, the full product against scipy, bitwise reproducible, and
    (GPR with hub rows) the fold against a host fold."""
    import numpy as np
    import torch

    ref = m @ x64
    y1, y2, yr, yf = kern(A, x), kern(A, x), plain(A, x), full(A, x)
    torch.cuda.synchronize()
    e_plain = float((y1 - yr).abs().max() / yr.abs().max())
    e1 = rel_err(yf.cpu(), ref)
    er = rel_err(full(A.to("cpu"), x.cpu()), ref)
    extra = ""
    if host_fold:
        yi = y1.cpu().double().numpy()
        n = A.shape[0]
        folded = yi[:n].copy()
        np.add.at(folded, A.hub_owner.cpu().numpy(), yi[n:])
        e_fold = rel_err(yf.cpu(), folded)
        extra = f" | fold of {A.nv} virtual rows vs host {e_fold:.2e}"
        require(e_fold <= PLAIN_TOL[dname], f"{name} fold {e_fold:.2e}")
    print(f"{A.__class__.__name__:9s} {name:24s} {dname}: rel vs plain "
          f"{e_plain:.2e} | kernel vs scipy {e1:.2e} | plain vs scipy "
          f"{er:.2e} | bitwise {torch.equal(y1, y2)}{extra}")
    require(e_plain <= PLAIN_TOL[dname], f"{name} {dname} vs plain "
            f"{e_plain:.2e}")
    require(e1 <= ORACLE_TOL[dname] and er <= ORACLE_TOL[dname],
            f"{name} {dname} vs scipy {e1:.2e}/{er:.2e}")
    require(torch.equal(y1, y2), f"{name} not bitwise reproducible")


def check_spmm(name, A, kern, plain, unpad, spmv_col, Xk, ref, dname) -> None:
    """One SpMM kernel on a small operand: against its plain version, the
    product against scipy (``unpad`` maps the kernel's output to ``[nrow,
    nrhs]``), bitwise reproducible, and column ``q`` against the SpMV
    kernel (``spmv_col(q)`` gives the kernel's column ``q`` and the SpMV's
    product)."""
    import torch

    Y1, Y2, Yr = kern(A, Xk), kern(A, Xk), plain(A, Xk)
    torch.cuda.synchronize()
    e_plain = float((Y1 - Yr).abs().max() / Yr.abs().max())
    e1, er = rel_err(unpad(Y1).cpu(), ref), rel_err(unpad(Yr).cpu(), ref)
    e_col = 0.0
    for q in range(ref.shape[1]):
        yq, sq = spmv_col(Y1, q)
        e_col = max(e_col, float((yq - sq).abs().max() / sq.abs().max()))
    print(f"{name} {dname} nrhs={ref.shape[1]}: rel vs plain {e_plain:.2e} "
          f"| kernel vs scipy {e1:.2e} | plain vs scipy {er:.2e} | columns "
          f"vs SpMV kernel {e_col:.2e} | bitwise {torch.equal(Y1, Y2)}")
    require(e_plain <= PLAIN_TOL[dname], f"{name} {dname} vs plain "
            f"{e_plain:.2e}")
    require(e1 <= ORACLE_TOL[dname] and er <= ORACLE_TOL[dname],
            f"{name} {dname} vs scipy {e1:.2e}/{er:.2e}")
    require(e_col <= PLAIN_TOL[dname], f"{name} {dname} columns vs SpMV "
            f"{e_col:.2e}")
    require(torch.equal(Y1, Y2), f"{name} not bitwise reproducible")


def backward_errors(A, coef: str, fn, m, x64, g64, dt) -> tuple:
    """The backward of ``fn`` (``spmv_sdia`` / ``spmv_psdia``) on the card:
    ``x.grad`` of ``<g, A x>`` against scipy ``A^T g``, and the coefficient
    gradient (``data`` / ``pattern``) against the same rule run on a CPU
    copy (the plain versions)."""
    import dataclasses

    import torch

    grads = []
    for pack in (A, A.to("cpu")):
        dev = getattr(pack, coef).device
        c = getattr(pack, coef).detach().clone().requires_grad_(True)
        x = torch.tensor(x64, dtype=dt, device=dev, requires_grad=True)
        y = fn(dataclasses.replace(pack, **{coef: c}), x)
        torch.autograd.backward(y, torch.tensor(g64, dtype=dt, device=dev))
        grads.append((x.grad, c.grad))
    (xg, cg), (_, cg_cpu) = grads
    return (rel_err(xg.cpu(), m.T @ g64),
            float((cg.cpu() - cg_cpu).abs().max() / cg_cpu.abs().max()))


def numpy_tile_variant(name: str, t3: dict, t4: dict):
    """The numpy composition of one probe's Pallas kernel body
    (``tools/profile_sublane.py``, ``tools/prof_tgtg_mxu.py``)."""
    import numpy as np

    def tak(z, idx, axis):
        return np.take_along_axis(z, idx.astype(np.int64), axis=axis)

    def sum8(a):
        a = a.reshape(*a.shape[:-1], 16, 8)
        s = a[..., 0].copy()
        for k in range(1, 8):
            s = (s + a[..., k]).astype(np.float32)
        return s

    z, g = t3["z"], t3["g"]
    T, Q = z.shape[0], z.shape[1]
    if name == "S":
        return tak(z, g, 1)
    if name == "G-S-G":
        return tak(tak(tak(z, g, 2), g, 1), g, 2)
    if name.startswith("exchange"):
        zz = tak(tak(z.reshape(T * Q, Q)[t3["rowsrc"]].reshape(T, Q, Q), g,
                     1), g, 2)
        return sum8(zz * z) if name.endswith("psum8") else zz
    if name == "s1v2":
        rows = tak(t3["x2d"][t3["gseg"]], t3["glidx"], 1).reshape(T, 88, Q)
        zz = np.concatenate([rows, np.zeros((T, Q - 88, Q), np.float32)], 1)
        return tak(tak(zz, g, 1), g, 2)
    Z = t4["Z"]
    zz = tak(np.swapaxes(Z, -1, -2), np.broadcast_to(t4["g2"], Z.shape), -1)
    return tak(np.swapaxes(zz, -1, -2), np.broadcast_to(t4["g3"], Z.shape),
               -1)


def host_breakdown(dev, n: int = 10_000) -> dict:
    """µs per call by the host clock, over ``n`` calls each, of every host
    step of one T1 launch (``launch_probe`` on a ``[128, 128]`` tile): the
    steps of the former per-wrapper launch (device context, stream
    object, ``CDLL`` call) and those of the launcher, each alone, then
    the whole wrappers.  Steps that launch return before the card runs
    the copy; the card is drained after each step."""
    import ctypes

    import torch

    from tpu_spmv_torch.bench import probes as pr
    from tpu_spmv_torch.kernels import _build

    tile = torch.rand(pr.Q, pr.Q, device=dev)
    out = torch.empty_like(tile)
    v = torch.from_numpy(pr.t2_operand()).to(dev)
    vout = torch.empty(16, 512, 16, device=dev)
    index = tile.get_device()
    pylib = _build.load()
    clib = _build.declare(ctypes.CDLL(pylib._name))
    current, raw = _build._cuda_hooks()
    xp, op = tile.data_ptr(), out.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def former_launch_probe(x):
        """The wrapper as it was before the launcher, step for step
        (``_device_kind``, ``_aligned``, the allocation, ``_call``)."""
        if tuple(x.shape) != (pr.Q, pr.Q):
            raise ValueError("launch_probe: needs a tile")
        if x.dtype != torch.float32 or x.device.type not in ("cpu", "cuda"):
            raise TypeError("launch_probe: needs float32 on cpu or cuda")
        x = x.contiguous()
        x = x if x.data_ptr() % 16 == 0 else x.clone()
        y = torch.empty_like(x)
        _build.load()
        with torch.cuda.device(x.device):         # then called via CDLL
            s_ = torch.cuda.current_stream(x.device).cuda_stream
            code = getattr(clib, "tsp_launch_probe")(x.data_ptr(),
                                                     y.data_ptr(), s_)
        _build.check(clib, "launch_probe", code)
        return y

    def enter_device():
        with torch.cuda.device(dev):
            pass

    steps = {
        "the timing loop alone (an empty call)": lambda: None,
        "torch.cuda.device(dev) entered and left (former path)":
            enter_device,
        "torch.cuda.current_stream(dev).cuda_stream (former path)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream handle, torch._C._cuda_getCurrentRawStream (launcher)":
            lambda: raw(index),
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch._C._cuda_getDevice() (launcher's device check)": current,
        "torch.empty_like(tile)": lambda: torch.empty_like(tile),
        "bare ctypes tsp_launch_probe, CDLL (releases the GIL)":
            lambda: clib.tsp_launch_probe(xp, op, stream),
        "bare ctypes tsp_launch_probe, PyDLL (holds the GIL; launcher)":
            lambda: pylib.tsp_launch_probe(xp, op, stream),
        "the launcher alone (pointers given)":
            lambda: pr._LAUNCH_PROBE(tile, xp, op),
        "launch_probe wrapper, former path":
            lambda: former_launch_probe(tile),
        "launch_probe wrapper (launcher)": lambda: pr.launch_probe(tile),
        "tile.clone()": tile.clone,
        "out.copy_(tile)": lambda: out.copy_(tile),
        "T2's output, v.new_empty((16, 512, 16))":
            lambda: v.new_empty((16, 512, 16)),
        "segsum8's launcher alone (pointers given)":
            lambda: pr._SEGSUM8(v, v.data_ptr(), vout.data_ptr(), 131072),
        "segsum8 wrapper, [16, 512, 128] (launcher)": lambda: pr.segsum8(v),
        "v.view(-1, 16, 8).sum(-1), [16, 512, 128]":
            lambda: v.view(-1, 16, 8).sum(-1),
    }
    us = {}
    for label, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us[label] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return us


DIST_GRID = 2048                # phase 4j's Poisson, the width of mgpcg_x_2048
DIST_BENCH_ARGS = ("--sweep", "--device", "cuda:0", "--iters", "20")


def dist_solvers_phase(card: str, counters) -> dict:
    """Phase 4j: the distributed solvers at full width, four shards on
    ``cuda:0`` (module docstring).  Returns the launch counts of the phase,
    those of the benchmark's sweep alone, and the cost model's two
    measured constants."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from tpu_spmv_torch import dist as tdist
    from tpu_spmv_torch import utils
    from tpu_spmv_torch.bench import dist_bench
    from tpu_spmv_torch.bench.harness import time_fn
    from tpu_spmv_torch.ops.auto import plan_spmv
    from tpu_spmv_torch.solvers import (bicgstab, cg, dist_bicgstab,
                                        dist_cg, dist_cg_ca, dist_gmres,
                                        dist_mg_preconditioner, gmres,
                                        mg_preconditioner)

    t4j = time.perf_counter()
    dev = torch.device("cuda:0")
    sync = torch.cuda.synchronize
    grid = DIST_GRID
    print(f"== 4j. distributed solvers at full width: 4 shards on {dev}, "
          f"f32 (counters zeroed; {card})")
    n = grid * grid
    mesh = tdist.make_mesh(4, device=dev)
    rng = np.random.default_rng(42)
    zero(*counters)

    def on_mesh(v, plan):
        return tdist.place(tdist.ShardedVector.from_global(v, plan), mesh)

    def true_rel(m, b, x) -> float:
        return float(np.linalg.norm(b - m @ x.astype(np.float64))
                     / np.linalg.norm(b))

    def solve(fn, iters_of):
        """Run one solve, host clock around it with a synchronize: the
        result, its iterations, ms an iteration and seconds."""
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        sec = time.perf_counter() - t0
        it = iters_of(res)
        return res, it, sec * 1e3 / max(it, 1), sec

    t0 = time.perf_counter()
    lap = utils.laplacian_2d(grid).astype(np.float32).tocsr()
    A = tdist.place(tdist.NeighborCSR.build(lap, 4, balance="rows",
                                            square=True), mesh)
    build_s = time.perf_counter() - t0
    print(f"  laplacian_2d({grid}): {n} rows, {lap.nnz} nnz; NeighborCSR "
          f"at 4 shards (balance rows) built in {build_s:.2f} s")

    # (a) the V-cycle against the serial one on the same r
    r64 = rng.standard_normal(n)
    r = torch.tensor(r64, dtype=torch.float32, device=dev)
    Ms = mg_preconditioner((grid, grid))
    Md = dist_mg_preconditioner(mesh, (grid, grid))
    rs = on_mesh(r64.astype(np.float32), tdist.plan_uniform(n, 4))
    z_ser = Ms(r).cpu().numpy()
    z_dist = Md(rs).to_global()
    vrel = rel_err(z_dist, z_ser.astype(np.float64))
    same = bool(np.array_equal(z_dist, z_ser))
    ser_ms = time_fn(Ms, r, iters=3, warmup=1).median_s * 1e3
    dist_ms = time_fn(Md, rs, iters=3, warmup=1).median_s * 1e3
    print(f"  (a) dist_mg_preconditioner(({grid}, {grid})) at 4 shards vs "
          f"the serial mg_preconditioner: rel {vrel:.2e} (bitwise "
          f"{same}) | one V-cycle {dist_ms:.4f} ms on 4 shards, "
          f"{ser_ms:.4f} ms serial ({card})")
    require(vrel <= 2e-5, f"dist V-cycle vs serial rel {vrel:.2e}")

    # (b) distributed MG-PCG beside the single-card MG-PCG on K2's plan
    b64 = rng.standard_normal(n)
    b32 = b64.astype(np.float32)
    bs = on_mesh(b32, A.row_plan)
    bt = torch.tensor(b32, device=dev)
    t0 = time.perf_counter()
    plan = plan_spmv(lap, dtype=torch.float32, device=dev)
    sync()
    plan_s = time.perf_counter() - t0
    dres, dit, dms, dsec = solve(lambda: dist_cg(
        mesh, A, bs, tol=1e-5, maxiter=200, precond=Md),
        lambda o: o.iterations)
    sres, sit, sms, ssec = solve(lambda: cg(
        plan, bt, tol=1e-5, maxiter=200, precond=Ms),
        lambda o: o.iterations)
    drel = true_rel(lap, b64, dres.x.to_global())
    srel = true_rel(lap, b64, sres.x.cpu().numpy())
    print(f"  (b) dist_cg + dist_mg_preconditioner over csr_neighbor: "
          f"{dit} iterations, converged {bool(dres.converged)}, "
          f"{dms:.4f} ms/iteration ({dsec:.3f} s), true rel residual "
          f"{drel:.3e} | single card cg + mg_preconditioner via "
          f"{plan.strategy} (planned in {plan_s:.2f} s): {sit} "
          f"iterations, {sms:.4f} ms/iteration ({ssec:.3f} s), true rel "
          f"{srel:.3e} ({card})")
    require(bool(dres.converged) and drel <= 1e-4,
            f"dist MG-PCG: converged {bool(dres.converged)}, rel {drel:.2e}")
    require(abs(dit - sit) <= 1, f"dist MG-PCG {dit} iterations against "
            f"the single card's {sit}")

    # where one dist MG-PCG iteration's time goes: a profile of one
    # V-cycle and one matvec at 4 shards
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            tdist.spmv_neighbor(mesh, A, Md(bs))
        sync()
        wall = (time.perf_counter() - t0) / 3
    ka = [e for e in prof.key_averages()
          if getattr(e, "device_time_total", 0) > 0]
    busy = sum(getattr(e, "self_device_time_total", 0) for e in ka)
    busy_ms = busy / 1e3 / 3
    top = sorted(ka, key=lambda e: -getattr(e, "self_device_time_total",
                                            0))[:5]
    print(f"  profile of one V-cycle + one matvec at 4 shards: "
          f"{wall * 1e3:.3f} ms wall, device busy "
          + (f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%; "
             f"idle {100 - 100 * busy_ms / (wall * 1e3):.1f}%), "
             f"{sum(e.count for e in ka) // 3} device ops; top: "
             + "; ".join(f"{e.key[:40]} "
                         f"{e.self_device_time_total / 1e3 / 3:.3f} ms"
                         for e in top)
             if busy else "not measured (no device time in the trace)"))

    # (c) GMRES(30) and BiCGSTAB with a sharded Jacobi on the reference
    # tests' nonsymmetric operand at full width; P from a Generator seeded
    # 7 (a RandomState, the reference tests' int seed, draws a permutation
    # of all n^2 positions, 128 TiB at this n)
    P = sp.random(n, n, density=2 / n, random_state=np.random.default_rng(7),
                  format="csr")
    ns = (lap.astype(np.float64) + 0.5 * (P - P.T)
          + 2.0 * sp.eye(n, format="csr")).tocsr()
    ns32 = ns.astype(np.float32)
    t0 = time.perf_counter()
    An = tdist.place(tdist.NeighborCSR.build(ns32, 4, square=True), mesh)
    dinv = (1.0 / ns.diagonal()).astype(np.float32)
    jac = dist_bench.sharded_jacobi(on_mesh(dinv, An.row_plan))
    bn = on_mesh(b32, An.row_plan)
    nplan = plan_spmv(ns32, dtype=torch.float32, device=dev)
    sync()
    nbuild_s = time.perf_counter() - t0
    dinv_t = torch.tensor(dinv, device=dev)
    print(f"  (c) laplacian_2d({grid}) + 0.5 (P - P^T) + 2I: {ns.nnz} nnz; "
          f"NeighborCSR at 4 shards and the single-card plan "
          f"({nplan.strategy}) built in {nbuild_s:.2f} s")
    for name, dfn, sfn in (
            ("gmres(restart=30)",
             lambda: dist_gmres(mesh, An, bn, tol=1e-5, restart=30,
                                maxiter=1000, precond=jac),
             lambda: gmres(nplan, bt, tol=1e-5, restart=30, maxiter=1000,
                           precond=lambda v: v * dinv_t)),
            ("bicgstab",
             lambda: dist_bicgstab(mesh, An, bn, tol=1e-5, maxiter=1000,
                                   precond=jac),
             lambda: bicgstab(nplan, bt, tol=1e-5, maxiter=1000,
                              precond=lambda v: v * dinv_t))):
        dres, dit, dms, dsec = solve(dfn, lambda o: o.iterations)
        sres, sit, sms, ssec = solve(sfn, lambda o: o.iterations)
        drel = true_rel(ns, b64, dres.x.to_global())
        srel = true_rel(ns, b64, sres.x.cpu().numpy())
        print(f"      dist_{name} + Jacobi: {dit} iterations, converged "
              f"{bool(dres.converged)}, {dms:.4f} ms/iteration ({dsec:.3f} "
              f"s), true rel {drel:.3e} | single card {name} via "
              f"{nplan.strategy}: {sit} iterations, converged "
              f"{bool(sres.converged)}, {sms:.4f} ms/iteration, true rel "
              f"{srel:.3e}")
        require(bool(dres.converged) and drel <= 1e-4,
                f"dist_{name}: converged {bool(dres.converged)}, rel "
                f"{drel:.2e}")
    del An, bn, nplan, ns, ns32, P
    # dist_cg and dist_cg_ca with the Jacobi on the SPD Poisson, beside the
    # single-card cg with the same Jacobi: the iteration counts within one
    # and the true residuals within 2x of each other (both float32 CG
    # recurrences drift from the true residual over thousands of steps)
    jl = dist_bench.sharded_jacobi(on_mesh(
        (1.0 / lap.diagonal()).astype(np.float32), A.row_plan))
    dl = torch.tensor(1.0 / lap.diagonal(), dtype=torch.float32, device=dev)
    sres, sit, sms, _ = solve(lambda: cg(
        plan, bt, tol=1e-5, maxiter=20_000, precond=lambda v: v * dl),
        lambda o: o.iterations)
    srel = true_rel(lap, b64, sres.x.cpu().numpy())
    for name, fn in (("dist_cg", dist_cg), ("dist_cg_ca", dist_cg_ca)):
        dres, dit, dms, dsec = solve(lambda fn=fn: fn(
            mesh, A, bs, tol=1e-5, maxiter=20_000, precond=jl),
            lambda o: o.iterations)
        drel = true_rel(lap, b64, dres.x.to_global())
        print(f"      {name} + Jacobi: {dit} iterations, converged "
              f"{bool(dres.converged)}, {dms:.4f} ms/iteration ({dsec:.3f} "
              f"s), true rel {drel:.3e} | single card cg + Jacobi: {sit} "
              f"iterations, {sms:.4f} ms/iteration, true rel {srel:.3e}")
        require(bool(dres.converged) and abs(dit - sit) <= 1,
                f"{name} + Jacobi: {dit} iterations against the single "
                f"card's {sit}")
        require(drel <= 2 * srel, f"{name} + Jacobi: true rel {drel:.3e} "
                f"against the single card's {srel:.3e}")
    del plan, sres, dres

    sync()
    launches = {k: v for c in counters for k, v in c.items() if v}
    print(f"launch counts on the 4j solvers' path: {launches}")

    # (d) the benchmark's sweep, in process, its counts read apart: its GPR
    # leg (spmv_gpr_sharded) is the slice's one kernel path
    zero(*counters)
    t0 = time.perf_counter()
    require(dist_bench.main(list(DIST_BENCH_ARGS)) == 0, "dist_bench --sweep")
    sync()
    bench_launches = {k: v for c in counters for k, v in c.items() if v}
    print(f"  (d) dist_bench {' '.join(DIST_BENCH_ARGS)}: "
          f"{time.perf_counter() - t0:.1f} s; launch counts of the sweep "
          f"alone: {bench_launches}")
    require(bench_launches.get("gpr", 0) > 0,
            "dist_bench's GPR leg never launched gpr_spmv")
    for k, v in bench_launches.items():
        launches[k] = launches.get(k, 0) + v

    # (e) the cost model's constants: the CSR local product's values/s on
    # the Poisson at one shard, and the copy rate of one shard's chunk
    mesh1 = tdist.make_mesh(1, device=dev)
    A1 = tdist.place(tdist.NeighborCSR.build(lap, 1, square=True), mesh1)
    x1 = tdist.place(tdist.ShardedVector.from_global(b32, A1.row_plan),
                     mesh1)
    g_ms = time_fn(tdist.spmv_neighbor, mesh1, A1, x1,
                   iters=20).median_s * 1e3
    gather_gvals = lap.nnz / (g_ms * 1e-3) / 1e9
    src = bs.chunks[1]
    dst = torch.empty_like(src)
    c_ms = time_fn(dst.copy_, src, iters=50).median_s * 1e3
    link_gbps = src.numel() * src.element_size() / (c_ms * 1e-3) / 1e9
    print(f"  (e) predict_dist_costs constants: GATHER_GVALS = "
          f"{gather_gvals:.4f} G values/s (spmv_neighbor at one shard, "
          f"{lap.nnz} values in {g_ms:.4f} ms) | LINK_GBPS = "
          f"{link_gbps:.1f} GB/s (copy_ of one shard's chunk, "
          f"{src.numel() * src.element_size()} B in {c_ms:.4f} ms, a "
          f"copy between two buffers on {dev}) | {card}")
    print(f"launch counts on the 4j path (solvers and sweep): {launches}")
    print(f"  (phase 4j {time.perf_counter() - t4j:.1f} s)")
    return {"launches": launches, "bench_launches": bench_launches,
            "gather_gvals": gather_gvals, "link_gbps": link_gbps}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, str(ROOT))
    import tpu_spmv_torch

    require(Path(tpu_spmv_torch.__file__).resolve().parent.parent == ROOT,
            f"tpu_spmv_torch imported from {tpu_spmv_torch.__file__}, not "
            f"from this checkout")
    import numpy as np
    import scipy.sparse as sp

    from tpu_spmv_torch import dist as tdist
    from tpu_spmv_torch import utils
    from tpu_spmv_torch.bench import probes as pr
    from tpu_spmv_torch.bench.harness import (time_chained, time_fn,
                                              verify_against_oracle)
    from tpu_spmv_torch.bench.launch_ab import graph_ms, interleaved_ms
    from tpu_spmv_torch.bench.roofline import (measured_copy_gbps,
                                               spmm_bytes, spmv_bytes,
                                               tile_permute_bytes)
    from tpu_spmv_torch.formats import COO, DIA, convert
    from tpu_spmv_torch.io.checkpoint import load_matrix, save_matrix
    from tpu_spmv_torch.kernels import _build
    from tpu_spmv_torch.kernels import dia_stream as ds
    from tpu_spmv_torch.kernels import dist_stream as dst
    from tpu_spmv_torch.kernels import ell_packed as ell
    from tpu_spmv_torch.kernels import gpr
    from tpu_spmv_torch.kernels import permute as pk
    from tpu_spmv_torch.ops.auto import (general_strategy, plan_from_matrix,
                                         plan_spmv)
    from tpu_spmv_torch.ops import spmm, spmv
    from tpu_spmv_torch.ops.shift import shift_diagonal
    from tpu_spmv_torch.ops.spgemm import (_numeric, _symbolic, spgemm,
                                           spgemm_csr)
    from tpu_spmv_torch.ops.spmm import spmm_coo
    from tpu_spmv_torch.reorder import rcm_permutation, reorder_plan
    from tpu_spmv_torch.solvers import (bicgstab, cg, cg_multi,
                                        cg_multi_runner, cg_runner, chebyshev,
                                        chebyshev_preconditioner, dist_cg,
                                        eigsh_lanczos, gmres, ir_solve, lsqr,
                                        mg_preconditioner, multicolor,
                                        power_iteration, safe_dinv, sor)
    F = torch.nn.functional

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    t_start = time.perf_counter()

    # -- 1. toolchain -------------------------------------------------------
    print("== 1. toolchain")
    print(f"python {sys.version.split()[0]} | torch {torch.__version__} | "
          f"torch CUDA {torch.version.cuda} | devices "
          f"{torch.cuda.device_count()}")
    nvcc = _build._nvcc()
    print(subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1])
    print(f"card: {card}")

    # -- 2. build -----------------------------------------------------------
    print("== 2. build")
    # the library's build and `nvcc -Xptxas -v` of the sources it reports
    # run at the same time: what ptxas gives each instantiation of the
    # kernels redesigned last (gpr_spmv<value type, stored type>; gpr_spmm
    # and ell_spmm<value type, stored type, lanes a row, RHS a lane> (one
    # body) and, on 2 or 4 lanes of one RHS, gpr_spmm_lanes and
    # ell_spmm_lanes<value type, stored type, lanes a row>; the two walks
    # of K3a and K3b, dia_spmm_stride and dia_spmm_clusters<value type,
    # stored type, threads along the RHS, elements per copy, the SDIA data
    # rows as the coefficients (K3a)>; K8a's sdia_ring<value type, stored
    # type>; the stored type is bf16 in the bf16-data forms; the walks of
    # K2 and K8b, psdia_walk_bulk<value type> and psdia_walk_stride and
    # psdia_walk_clusters<value type, elements per copy>;
    # tile_permute<sums of eight>; the walks' dynamic shared memory is the
    # host plan's, which phase 5 prints)
    t0 = time.perf_counter()
    build_s = []

    def build():
        tb = time.perf_counter()
        _build.load()
        build_s.append(time.perf_counter() - tb)

    lines = ptxas_usage({"general.cu": ("gpr_spmv", "gpr_spmm",
                                        "gpr_spmm_lanes", "ell_spmv",
                                        "ell_spmm", "ell_spmm_lanes"),
                         "permute.cu": ("permute_gather", "permute_pass1",
                                        "permute_pass2",
                                        "permute_gather_batched",
                                        "permute_rows_two_pass"),
                         "dia_stream.cu": ("dia_spmm_stride",
                                           "dia_spmm_clusters",
                                           "psdia_walk_bulk",
                                           "psdia_walk_stride",
                                           "psdia_walk_clusters"),
                         "dist_stream.cu": ("sdia_ring",),
                         "probes.cu": ("tile_permute",)}, during=build)
    print(f"nvcc {' '.join(_build.NVCC_FLAGS)} -c, one process per source "
          f"of tpu_spmv_torch/csrc/{{{','.join(_build._SOURCES)}}}, then "
          f"-shared -> {_build.library_path().relative_to(ROOT)} "
          f"in {build_s[0]:.2f} s (beside nvcc -Xptxas -v of general.cu, "
          f"permute.cu, dia_stream.cu, dist_stream.cu and probes.cu; both "
          f"{time.perf_counter() - t0:.2f} s)")
    for line in lines:
        print(f"ptxas {line}")

    # -- 3. kernels against plain versions, small operands ------------------
    print("== 3. kernels vs plain versions (small operands)")
    rng = np.random.default_rng(0)
    small = {"laplacian_2d(64)": utils.laplacian_2d(64),
             "laplacian_3d(16)": utils.laplacian_3d(16),
             "banded(20000,40)": utils.banded(20000, 40)}
    for name, m in small.items():
        x64 = rng.random(m.shape[0])
        ref = m @ x64
        for dt in (torch.float32, torch.float64):
            dname = str(dt).removeprefix("torch.")
            dia = convert(COO.from_scipy(m, dtype=dt, device=dev), "dia")
            packs = [("sdia", ds.pack_sdia(dia), ds.spmv_sdia_padded,
                      ds.spmv_sdia_padded_ref)]
            if name.startswith("laplacian"):
                packs.append(("psdia", ds.pack_psdia(dia, period=ds.detect_period(
                    dia.to("cpu"))), ds.spmv_psdia_padded,
                    ds.spmv_psdia_padded_ref))
            x = torch.tensor(x64, dtype=dt, device=dev)
            for kname, A, kern, plain in packs:
                xp = ds.pad_x(A, x)
                y1, y2, yr = kern(A, xp), kern(A, xp), plain(A, xp)
                torch.cuda.synchronize()
                e_plain = float((y1 - yr).abs().max() / yr.abs().max())
                e1 = rel_err(ds.unpad_y(A, y1).cpu(), ref)
                er = rel_err(ds.unpad_y(A, yr).cpu(), ref)
                pads = bool((y1[:A.L] == 0).all()
                            and (y1[A.L + m.shape[0]:] == 0).all())
                print(f"{kname:5s} {name:17s} {dname}: rel vs plain "
                      f"{e_plain:.2e} | kernel vs scipy {e1:.2e} | plain vs "
                      f"scipy {er:.2e} | bitwise {torch.equal(y1, y2)} | "
                      f"pads zero {pads}")
                require(e_plain <= PLAIN_TOL[dname], f"{kname} {name} {dname} "
                        f"vs plain {e_plain:.2e}")
                require(e1 <= ORACLE_TOL[dname] and er <= ORACLE_TOL[dname],
                        f"{kname} {name} {dname} vs scipy {e1:.2e}/{er:.2e}")
                require(torch.equal(y1, y2), f"{kname} {name} not bitwise "
                        f"reproducible")
                require(pads, f"{kname} {name} pads not zero")
                # the same kernel on the transposed pack, and the backward
                At = (ds.transpose_sdia(A) if kname == "sdia"
                      else ds.transpose_psdia(A))
                xt = ds.pad_x(At, x)
                yt, ytr = kern(At, xt), plain(At, xt)
                torch.cuda.synchronize()
                et_plain = float((yt - ytr).abs().max() / ytr.abs().max())
                et = rel_err(ds.unpad_y(At, yt).cpu(), m.T @ x64)
                g64 = rng.random(m.shape[0])
                eg, ec = backward_errors(
                    A, "data" if kname == "sdia" else "pattern",
                    ds.spmv_sdia if kname == "sdia" else ds.spmv_psdia,
                    m, x64, g64, dt)
                print(f"      transposed: rel vs plain {et_plain:.2e} | vs "
                      f"scipy A^T x {et:.2e} | backward: x.grad vs scipy "
                      f"A^T g {eg:.2e}, coefficient grad vs the CPU rule "
                      f"{ec:.2e}")
                require(et_plain <= PLAIN_TOL[dname]
                        and et <= ORACLE_TOL[dname], f"transposed {kname} "
                        f"{name} {dname}: {et_plain:.2e}/{et:.2e}")
                require(eg <= ORACLE_TOL[dname] and ec <= PLAIN_TOL[dname],
                        f"{kname} {name} {dname} backward {eg:.2e}/{ec:.2e}")

    # K3a/K3b on the same operands, 1, 3, 32 and 40 right-hand sides (40:
    # a full chunk of 32 and a tail of 8)
    for name, m in small.items():
        n = m.shape[0]
        for dt in (torch.float32, torch.float64):
            dname = str(dt).removeprefix("torch.")
            dia = convert(COO.from_scipy(m, dtype=dt, device=dev), "dia")
            period = ds.detect_period(dia.to("cpu"))
            for nrhs in (1, 3, 8, 32, 40):
                X64 = rng.random((n, nrhs))
                packs = [("sdia_spmm", ds.pack_sdia(dia, nrhs=nrhs),
                          ds.spmm_sdia_padded_t, ds.spmm_sdia_padded_t_ref,
                          ds.spmv_sdia_padded)]
                if period is not None:
                    packs.append(("psdia_spmm", ds.pack_psdia(
                        dia, period=period, nrhs=nrhs), ds.spmm_psdia_padded_t,
                        ds.spmm_psdia_padded_t_ref, ds.spmv_psdia_padded))
                for kname, A, kern, plain, spmv_kern in packs:
                    Xt = F.pad(torch.tensor(X64.T, dtype=dt, device=dev),
                               (A.L, A.npad - A.L - n)).contiguous()
                    check_spmm(
                        f"{kname:10s} {name:17s}", A, kern, plain,
                        lambda Y, A=A: Y[:, A.L:A.L + n].T,
                        lambda Y, q, A=A, k=spmv_kern, Xt=Xt: (
                            Y[q], k(A, Xt[q])),
                        Xt, m @ X64, dname)
                    Y = kern(A, Xt)
                    require(bool((Y[:, :A.L] == 0).all()
                                 and (Y[:, A.L + n:] == 0).all()),
                            f"{kname} {name} pads not zero")
                    # K3a and K3b sum each RHS in K1's and K2's order:
                    # bit for bit
                    require(all(torch.equal(Y[q], spmv_kern(A, Xt[q]))
                                for q in range(nrhs)),
                            f"{kname} {name} {dname} nrhs={nrhs}: a column "
                            f"differs from its SpMV kernel")

    general_small = {
        "bus420.mtx": read_fixture("bus420.mtx"),
        "powerlaw800.mtx": read_fixture("powerlaw800.mtx"),
        "random_sparse(2000,200000)": utils.random_sparse(
            2000, 200000, 8 / 200000)}
    picks = {}
    for name, m in general_small.items():
        x64 = rng.random(m.shape[1])
        for dt in (torch.float32, torch.float64):
            dname = str(dt).removeprefix("torch.")
            plan = plan_spmv(m, dtype=dt, device=dev)
            require(plan.strategy in ("gpr", "pallas_ell"),
                    f"{name} planned to {plan.strategy}")
            picks[name] = plan.strategy
            x = torch.tensor(x64, dtype=dt, device=dev)
            packs = {"gpr": (gpr.spmv_gpr_rows, gpr.spmv_gpr_ref,
                             gpr.spmv_gpr),
                     "pallas_ell": (ell.spmv_ell_main,
                                    ell.spmv_ell_packed_ref,
                                    ell.spmv_ell_packed)}
            for strategy, (kern, plain, full) in packs.items():
                A = (plan.matrix if strategy == plan.strategy else
                     (gpr.pack_gpr if strategy == "gpr" else ell.pack_ell)(
                         m, dtype=dt, device=dev))
                check_general(name, m, A, kern, plain, full, dname, x64, x,
                              host_fold=strategy == "gpr" and A.nv > 0)
            rel = rel_err(plan(x).cpu(), m @ x64)
            require(rel <= ORACLE_TOL[dname], f"{name} plan {rel:.2e}")
    print(f"planner picks: {picks}")
    # gpr_spmm and ell_spmm on the same operands; the output's own rows
    # take the fold (GPR) or the side COO (ELL) before scipy sees them
    unpads = {"gpr_spmm": lambda A, X: (
                  lambda Y: gpr.fold_hub_rows(A, Y.clone())),
              "ell_spmm": lambda A, X: (
                  lambda Y: Y + spmm_coo(A.side, X) if A.side.nnz else Y)}
    for name, m in general_small.items():
        for dt in (torch.float32, torch.float64):
            dname = str(dt).removeprefix("torch.")
            for kname, pack, kern, plain, spmv_kern in (
                    ("gpr_spmm", gpr.pack_gpr, gpr.spmm_gpr_rows,
                     gpr.spmm_gpr_ref, gpr.spmv_gpr_rows),
                    ("ell_spmm", ell.pack_ell, ell.spmm_ell_main,
                     ell.spmm_ell_packed_ref, ell.spmv_ell_main)):
                A = pack(m, dtype=dt, device=dev)
                for nrhs in (1, 3, 32, 40):
                    X64 = rng.random((m.shape[1], nrhs))
                    X = torch.tensor(X64, dtype=dt, device=dev)
                    check_spmm(
                        f"{kname:10s} {name:26s}", A, kern, plain,
                        unpads[kname](A, X),
                        lambda Y, q, A=A, X=X, k=spmv_kern: (
                            Y[:, q], k(A, X[:, q].contiguous())),
                        X, m @ X64, dname)
                    if kname == "ell_spmm":
                        # every slot of a row in order, as ell_spmv
                        Y = kern(A, X)
                        require(all(torch.equal(Y[:, q], spmv_kern(
                            A, X[:, q].contiguous())) for q in range(nrhs)),
                            f"ell_spmm {name} {dname} nrhs={nrhs}: a "
                            f"column differs from ell_spmv")
    require(gpr.pack_gpr(general_small["powerlaw800.mtx"], device=dev).nv > 0,
            "powerlaw800 has no virtual rows")

    # K7: the gathers, bitwise against their plain versions and x[perm],
    # with and without don't-care slots (written as zero), reproducible;
    # the direct gather (the plan's pick at these sizes) and the two-pass
    # gather (chunks of 1024 words; 8-byte words take the direct gather),
    # and each pass alone against its plain version
    for n_p in (1000, 16384, 60000, 99991):
        p_full = rng.permutation(n_p)
        p_dc = p_full.copy()
        p_dc[rng.random(n_p) < 0.1] = -1
        X64 = rng.random((40, n_p))
        for label, p_host in (("perm", p_full), ("perm with -1 slots", p_dc)):
            pplan = pk.plan_permutation(p_host, device=dev)
            tplan = pk._plan(p_host, dev, "two_pass", 1024)
            require(pplan.method == "direct", f"n={n_p}: {pplan.method}")
            real = p_host >= 0
            src = np.where(real, p_host, 0)
            for dt in (torch.float32, torch.float64):
                x1 = torch.tensor(X64[0], dtype=dt, device=dev)
                cases = [(pk.apply_permutation, pk.apply_permutation_ref, x1,
                          pplan), (pk.apply_permutation,
                                   pk.apply_permutation_ref, x1, tplan)]
                cases += [(pk.apply_permutation_batched,
                           pk.apply_permutation_batched_ref,
                           torch.tensor(X64[:k], dtype=dt, device=dev), q)
                          for k in (1, 3, 32, 40) for q in (pplan, tplan)]
                for kern, plain, xk, plan_k in cases:
                    y1, y2, yr = kern(plan_k, xk), kern(plan_k, xk), plain(
                        plan_k, xk)
                    torch.cuda.synchronize()
                    yh, xh = y1.cpu().numpy(), xk.cpu().numpy()
                    require(torch.equal(y1, y2) and torch.equal(y1, yr)
                            and np.array_equal(yh[..., real],
                                               xh[..., src][..., real])
                            and not yh[..., ~real].any(),
                            f"{kern.__name__} {plan_k.method} n={n_p} {label} "
                            f"{dt} {tuple(xk.shape)}")
                if dt == torch.float32:
                    stage = pk._one_pass(tplan, x1, 1)
                    out = pk._one_pass(tplan, stage, 2)
                    stage_r, out_r = pk.two_pass_ref(tplan, x1)
                    require(torch.equal(stage, stage_r)
                            and torch.equal(out, out_r),
                            f"two-pass passes n={n_p} {label} {dt}")
            print(f"permute_gather(_batched) n={n_p} {label}: f32 and f64, "
                  f"1 vector (direct, and two-pass in f32 with each pass "
                  f"alone against its plain version) and 1, 3, 32, 40 rows "
                  f"(both forms on rows), bitwise equal to the plain "
                  f"versions and x[perm], reproducible, don't-care slots "
                  f"zero")
    p_tile = rng.permutation(pk.TILE)
    tplan = pk.plan_tile_permutation(p_tile, device=dev)
    for dt in (torch.float32, torch.float64):
        xt = torch.tensor(rng.random((pk.Q, pk.Q)), dtype=dt, device=dev)
        y1, yr = (pk.apply_tile_permutation(xt, tplan),
                  pk.apply_tile_permutation_ref(xt, tplan))
        torch.cuda.synchronize()
        require(torch.equal(y1, yr) and np.array_equal(
            y1.cpu().numpy(), pk.permute_reference(xt.cpu().numpy(), p_tile)),
            f"apply_tile_permutation {dt}")
    print("apply_tile_permutation [128, 128] f32 and f64: bitwise equal to "
          "the plain version and permute_reference")

    # the probe kernels, bitwise against their plain versions (which fix
    # the kernels' order of operations) and reproducible; tile_permute
    # also against the numpy composition of each probe's kernel body
    xc = torch.rand((1 << 20) + 3, device=dev)
    tile = torch.rand(pr.Q, pr.Q, device=dev)
    v2 = torch.from_numpy(pr.t2_operand()).to(dev)
    for kern, plain, arg, label in (
            (pr.copy_scale, pr.copy_scale_ref, xc, "copy_scale 2^20+3"),
            (pr.copy_scale, pr.copy_scale_ref, xc[1:],
             "copy_scale 2^20+2, 4-byte offset (scalar path)"),
            (pr.launch_probe, pr.launch_probe_ref, tile, "launch_probe"),
            (pr.segsum8, pr.segsum8_ref, v2, "segsum8 [16, 512, 128]")):
        y1, y2, yr = kern(arg), kern(arg), plain(arg)
        torch.cuda.synchronize()
        require(torch.equal(y1, y2) and torch.equal(y1, yr), label)
    print("copy_scale, launch_probe, segsum8: bitwise equal to their plain "
          "versions, reproducible")
    t3, t4 = pr.t3_operands(), pr.t4_operands()
    for vname, (prog, src, mul, psum8) in pr.tile_variants(t3, t4,
                                                           dev).items():
        y1, y2 = (pr.tile_permute(prog, src, mul, psum8),
                  pr.tile_permute(prog, src, mul, psum8))
        yr = pr.tile_permute_ref(prog, src, mul, psum8)
        torch.cuda.synchronize()
        same_np = np.array_equal(y1.cpu().numpy(),
                                 numpy_tile_variant(vname, t3, t4))
        print(f"tile_permute {vname:24s} {tuple(y1.shape)}: bitwise equal to "
              f"the plain version {torch.equal(y1, yr)}, to numpy "
              f"{same_np}, reproducible {torch.equal(y1, y2)}")
        require(torch.equal(y1, yr) and same_np and torch.equal(y1, y2),
                f"tile_permute {vname}")
    del xc, tile, v2

    # the block formats' products (torch code) on the card: 1, 3 and 32
    # right-hand sides, against the same code on the CPU and scipy
    block_small = {"bus420.mtx": general_small["bus420.mtx"],
                   "block_laplacian(12)": utils.block_laplacian(12, bs=8)}
    for name, m in block_small.items():
        x64 = rng.random(m.shape[1])
        for dt in (torch.float32, torch.float64):
            dname = str(dt).removeprefix("torch.")
            for fmt in ("ell", "bsr", "bdia"):
                Ah = convert(COO.from_scipy(m, dtype=dt), fmt)
                A = Ah.to(dev)
                errs = []
                for nrhs in (0, 1, 3, 32):
                    if nrhs:
                        X64 = rng.random((m.shape[1], nrhs))
                        fn = spmm
                    else:
                        X64, fn = x64, spmv
                    Xd = torch.tensor(X64, dtype=dt, device=dev)
                    y1, y2 = fn(A, Xd), fn(A, Xd)
                    yc = fn(Ah, Xd.cpu())
                    torch.cuda.synchronize()
                    e_cpu = float((y1.cpu() - yc).abs().max()
                                  / yc.abs().max())
                    e_sc = rel_err(y1.cpu(), m @ X64)
                    require(e_cpu <= PLAIN_TOL[dname]
                            and e_sc <= ORACLE_TOL[dname]
                            and torch.equal(y1, y2),
                            f"{fmt} {name} {dname} nrhs={nrhs}: vs CPU "
                            f"{e_cpu:.2e}, vs scipy {e_sc:.2e}")
                    errs.append((e_cpu, e_sc))
                print(f"{fmt:4s} {name:19s} {dname}: spmv and spmm (1, 3, 32 "
                      f"RHS) vs the CPU path <= "
                      f"{max(e for e, _ in errs):.2e} | vs scipy <= "
                      f"{max(e for _, e in errs):.2e} | bitwise "
                      f"reproducible")

    # -- 4a. streaming-DIA main path at full size ---------------------------
    print("== 4a. streaming-DIA main path (counters zeroed)")
    GRID = 4096
    t0 = time.perf_counter()
    mat = utils.laplacian_2d(GRID)
    print(f"laplacian_2d({GRID}): {mat.shape[0]} rows, {mat.nnz} nnz "
          f"(scipy build {time.perf_counter() - t0:.1f} s)")
    x_host = rng.random(mat.shape[0])
    # b = A·x_true: a right-hand side whose residual CG shrinks from the
    # first iterations (for a random b the 2-norm residual rises first)
    b_host = mat @ rng.random(mat.shape[0])
    counters = (ds.LAUNCHES, gpr.LAUNCHES, ell.LAUNCHES)
    zero(*counters)

    t0 = time.perf_counter()
    plan = plan_spmv(mat, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    P = plan.matrix
    pack_s = {"4096^2 PSDIA": plan_s}
    print(f"plan_spmv: strategy={plan.strategy} rb={P.rb} "
          f"period={getattr(P, 'period', None)} npad={P.npad} "
          f"(host planning {plan_s:.2f} s)")
    require(plan.strategy == "pdia_stream", f"strategy {plan.strategy}")
    x = torch.tensor(x_host, dtype=torch.float32, device=dev)
    rel = verify_against_oracle(P, x, plan(x), oracle=mat)
    print(f"plan(x) vs scipy f64: rel err {rel:.2e}")

    b = torch.tensor(b_host, dtype=torch.float32, device=dev)
    run = cg_runner(plan, iters=50, report_tol=1e-5)
    run(b)                                   # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    res = run(b)
    end.record()
    end.synchronize()
    cg_ms = start.elapsed_time(end) / 50
    r50 = float(torch.linalg.norm(b - plan(res.x)) / torch.linalg.norm(b))
    print(f"cg_runner(iters=50) f32: {cg_ms:.4f} ms/iter | true rel residual "
          f"1.0 -> {r50:.3e}")
    require(np.isfinite(r50) and r50 < 0.1, "CG residual did not fall")

    t0 = time.perf_counter()
    mc = mat.tocoo()
    S = ds.pack_sdia(DIA.from_coo(COO.from_arrays(
        mc.row, mc.col, mc.data, mat.shape, dtype=torch.float32,
        sort=False)), device=dev)
    rel_s = verify_against_oracle(S, x, ds.spmv_sdia(S, x), oracle=mat)
    print(f"forced SDIA: rb={S.rb} npad={S.npad} rel err {rel_s:.2e} "
          f"(pack {time.perf_counter() - t0:.2f} s)")
    del mc

    mat3 = utils.laplacian_3d(128)
    t0 = time.perf_counter()
    plan3 = plan_spmv(mat3, dtype=torch.float32, device=dev)
    print(f"laplacian_3d(128): {mat3.shape[0]} rows, {mat3.nnz} nnz -> "
          f"{plan3.strategy} period={getattr(plan3.matrix, 'period', None)} "
          f"rb={plan3.matrix.rb} (host planning "
          f"{time.perf_counter() - t0:.2f} s)")
    require(plan3.strategy == "pdia_stream", f"3-D strategy {plan3.strategy}")
    x3 = torch.tensor(rng.random(mat3.shape[0]), dtype=torch.float32,
                      device=dev)
    rel3 = verify_against_oracle(plan3.matrix, x3, plan3(x3), oracle=mat3)
    print(f"laplacian_3d(128) plan(x) vs scipy f64: rel err {rel3:.2e}")
    del plan3, x3

    band = utils.banded(1_000_000, 5, seed=1)
    planb = plan_spmv(band, dtype=torch.float32, device=dev)
    require(planb.strategy == "dia_stream", f"band strategy {planb.strategy}")
    xb = torch.tensor(rng.random(band.shape[0]), dtype=torch.float32,
                      device=dev)
    relb = verify_against_oracle(planb.matrix, xb, planb(xb), oracle=band)
    print(f"banded(1000000,5) -> {planb.strategy} rb={planb.matrix.rb}: "
          f"rel err {relb:.2e}")
    del xb

    m256 = utils.laplacian_2d(256)
    plan64 = plan_spmv(m256, dtype=torch.float64, device=dev)
    b256 = rng.random(m256.shape[0])
    t0 = time.perf_counter()
    res64 = cg(plan64, torch.tensor(b256, device=dev), tol=1e-11,
               true_tol=1e-10, maxiter=10_000)
    torch.cuda.synchronize()
    cg64_s = time.perf_counter() - t0
    xs = res64.x.cpu().numpy()
    true_rel = float(np.linalg.norm(b256 - m256 @ xs) / np.linalg.norm(b256))
    print(f"cg(true_tol=1e-10) f64 laplacian_2d(256) via {plan64.strategy}: "
          f"{res64.iterations} iterations, true rel residual {true_rel:.3e} "
          f"(scipy), converged={bool(res64.converged)} ({cg64_s:.2f} s)")
    require(true_rel <= 1e-10, f"f64 CG true residual {true_rel:.3e}")

    torch.cuda.synchronize()
    launches = dict(ds.LAUNCHES)
    print(f"launch counts on the streaming-DIA path: {launches}")
    require(launches["psdia"] > 0, "K2 (psdia) never launched")
    require(launches["sdia"] > 0, "K1 (sdia) never launched")

    # -- 4b. general-sparsity main path at full size ------------------------
    print("== 4b. general-sparsity main path (counters zeroed)")
    t0 = time.perf_counter()
    lap = utils.laplacian_2d(2048)
    perm = np.random.default_rng(3).permutation(lap.shape[0])
    general = {
        "random_sparse(100000,7e-5)": utils.random_sparse(
            100_000, 100_000, 7e-5, seed=2),
        "power_law(400000,13)": utils.power_law(400_000, 400_000, 13,
                                                alpha=1.5, seed=6),
        "random_sparse(2000000,8e-6)": utils.random_sparse(
            2_000_000, 2_000_000, 8e-6, seed=2),
        "shuffled laplacian_2d(2048)": lap[perm][:, perm].tocsr(),
    }
    del lap, perm
    plaw = general["power_law(400000,13)"]
    sym = (plaw + plaw.T).tocsr()
    spd = (sym + sp.diags(np.asarray(abs(sym).sum(axis=1)).ravel()
                          + 1.0)).tocsr()
    del sym
    bus = read_fixture("bus420.mtx")
    print(f"host build of the general operands {time.perf_counter() - t0:.1f} s")
    zero(*counters)
    gplans, gx = {}, {}
    for name, m in general.items():
        t0 = time.perf_counter()
        p = plan_spmv(m, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        require(p.strategy in ("gpr", "pallas_ell"),
                f"{name} planned to {p.strategy}")
        xg = torch.tensor(rng.random(m.shape[1]), dtype=torch.float32,
                          device=dev)
        relg = verify_against_oracle(p.matrix, xg, p(xg), oracle=m)
        counts = np.diff(m.indptr)
        A = p.matrix
        shape = (f"nv={A.nv} class_rows={A.class_rows}"
                 if p.strategy == "gpr" else
                 f"slices={A.nslices} slots={A.slots} side={A.side.nnz}")
        print(f"{name}: {m.shape[0]} rows, {m.nnz} nnz, largest row "
              f"{counts.max()} -> {p.strategy} ({shape}); plan(x) vs scipy "
              f"f64 rel err {relg:.2e} (host planning {plan_s:.2f} s)")
        gplans[name], gx[name] = p, xg
        pack_s[name] = plan_s

    plan_spd = plan_spmv(spd, dtype=torch.float32, device=dev)
    require(plan_spd.strategy in ("gpr", "pallas_ell"),
            f"SPD operator planned to {plan_spd.strategy}")
    b = torch.tensor(spd @ rng.random(spd.shape[0]), dtype=torch.float32,
                     device=dev)
    run = cg_runner(plan_spd, iters=50, report_tol=1e-5)
    run(b)                                   # warm-up
    start.record()
    res = run(b)
    end.record()
    end.synchronize()
    cg_gen_ms = start.elapsed_time(end) / 50
    r50 = float(torch.linalg.norm(b - plan_spd(res.x)) / torch.linalg.norm(b))
    print(f"cg_runner(iters=50) f32 on P + P^T + diag ({spd.shape[0]} rows, "
          f"{spd.nnz} nnz) via {plan_spd.strategy}: {cg_gen_ms:.4f} ms/iter | "
          f"true rel residual 1.0 -> {r50:.3e}")
    require(np.isfinite(r50) and r50 < 0.1, "general CG residual did not fall")
    del b, res, run

    name = "shuffled laplacian_2d(2048)"
    plan_sh, m = gplans[name], general[name]
    b = torch.tensor(m @ rng.random(m.shape[0]), dtype=torch.float32,
                     device=dev)
    run = cg_runner(plan_sh, iters=50, report_tol=1e-5)
    run(b)                                   # warm-up
    start.record()
    res = run(b)
    end.record()
    end.synchronize()
    cg_sh_ms = start.elapsed_time(end) / 50
    r50 = float(torch.linalg.norm(b - plan_sh(res.x)) / torch.linalg.norm(b))
    print(f"cg_runner(iters=50) f32 on the {name} via {plan_sh.strategy}: "
          f"{cg_sh_ms:.4f} ms/iter | true rel residual 1.0 -> {r50:.3e}")
    require(np.isfinite(r50) and r50 < 0.1, "shuffled CG residual did not fall")
    del plan_sh, b, res, run

    plan_bus = plan_spmv(bus, dtype=torch.float64, device=dev)
    bb = rng.random(bus.shape[0])
    res64 = cg(plan_bus, torch.tensor(bb, device=dev), tol=1e-11,
               true_tol=1e-10, maxiter=10_000)
    true_rel = float(np.linalg.norm(bb - bus @ res64.x.cpu().numpy())
                     / np.linalg.norm(bb))
    print(f"cg(true_tol=1e-10) f64 bus420.mtx via {plan_bus.strategy}: "
          f"{res64.iterations} iterations, true rel residual {true_rel:.3e} "
          f"(scipy), converged={bool(res64.converged)}")
    require(true_rel <= 1e-10, f"bus420 f64 CG true residual {true_rel:.3e}")

    torch.cuda.synchronize()
    glaunches = {**gpr.LAUNCHES, **ell.LAUNCHES}
    print(f"launch counts on the general path: {glaunches}")
    require(glaunches["gpr"] > 0, "gpr_spmv never launched")
    require(glaunches["ell"] > 0, "ell_spmv never launched")

    # -- 4c. multi-RHS main path at full size -------------------------------
    NRHS = 32
    print(f"== 4c. multi-RHS main path, {NRHS} right-hand sides (counters "
          f"zeroed)")
    gen = torch.Generator(device=dev).manual_seed(7)
    n = mat.shape[0]
    t0 = time.perf_counter()
    mc = mat.tocoo()
    hdia = DIA.from_coo(COO.from_arrays(mc.row, mc.col, mc.data, mat.shape,
                                        dtype=torch.float32, sort=False))
    del mc
    P32 = ds.pack_psdia(hdia, period=P.period, nrhs=NRHS, device=dev)
    S32 = ds.pack_sdia(hdia, nrhs=NRHS, device=dev)
    del hdia
    print(f"packs for {NRHS} RHS: PSDIA rb={P32.rb} npad={P32.npad}, SDIA "
          f"rb={S32.rb} npad={S32.npad} ({time.perf_counter() - t0:.2f} s)")
    require((P32.rb, P32.L, P32.npad) == (S32.rb, S32.L, S32.npad)
            == (65536, 65536, 16_908_288), "the reference's rb rule for 32 "
            "RHS gives rb 65536 and npad 16,908,288 at 4096^2")
    zero(*counters)
    X = torch.rand(n, NRHS, generator=gen, device=dev)
    t0 = time.perf_counter()
    ref = mat @ X.cpu().double().numpy()
    print(f"scipy f64 reference of A @ X ({n} x {NRHS}) "
          f"{time.perf_counter() - t0:.1f} s")
    rel = rel_err(plan.spmm(X).cpu(), ref)
    print(f"plan.spmm(X) via {plan.strategy} (rb={P.rb}) vs scipy f64: rel "
          f"err {rel:.2e}")
    require(rel <= ORACLE_TOL["float32"], f"4096^2 plan.spmm {rel:.2e}")
    Xt = F.pad(X.T, (P32.L, P32.npad - P32.L - n)).contiguous()
    for kname, A, kern, spmv_kern, k1 in (
            ("psdia_spmm", P32, ds.spmm_psdia_padded_t, ds.spmv_psdia_padded,
             "K2"),
            ("sdia_spmm", S32, ds.spmm_sdia_padded_t, ds.spmv_sdia_padded,
             "K1")):
        Yt = kern(A, Xt)
        rel = rel_err(Yt[:, A.L:A.L + n].T.cpu(), ref)
        pads = bool((Yt[:, :A.L] == 0).all() and (Yt[:, A.L + n:] == 0).all())
        same = all(torch.equal(Yt[q], spmv_kern(A, Xt[q]))
                   for q in range(NRHS))
        require(same, f"{kname} at 4096^2: a column differs from {k1}")
        print(f"{kname} on the {NRHS}-RHS pack, [{NRHS}, {A.npad}] "
              f"({Xt.numel() * 4 / 1e9:.2f} GB): rel err {rel:.2e} | pads "
              f"zero {pads} | every column bitwise {k1}'s {same}")
        require(rel <= ORACLE_TOL["float32"] and pads, f"{kname} at 4096^2")
        del Yt
    del ref

    gX, forced = {}, {}
    for name, m in general.items():
        p = gplans[name]
        Xg = torch.rand(m.shape[1], NRHS, generator=gen, device=dev)
        refg = m @ Xg.cpu().double().numpy()
        rel = rel_err(p.spmm(Xg).cpu(), refg)
        line = f"{name}: plan.spmm via {p.strategy} rel err {rel:.2e}"
        require(rel <= ORACLE_TOL["float32"], line)
        if p.strategy != "gpr":
            forced[name] = gpr.pack_gpr(m, dtype=torch.float32, device=dev)
            relf = rel_err(gpr.spmm_gpr(forced[name], Xg).cpu(), refg)
            line += f" | GPR forced rel err {relf:.2e}"
            require(relf <= ORACLE_TOL["float32"], line)
        print(line)
        gX[name] = Xg

    cgm = {}
    for label, pl, m in (("laplacian_2d(4096)", plan, mat),
                         ("P + P^T + diag", plan_spd, spd)):
        B = torch.tensor(m @ rng.random((m.shape[0], 8)),
                         dtype=torch.float32, device=dev)
        run = cg_multi_runner(pl, iters=50, report_tol=1e-5)
        run(B)                               # warm-up
        start.record()
        res = run(B)
        end.record()
        end.synchronize()
        cgm[label] = start.elapsed_time(end) / 50
        r50 = float((torch.linalg.norm(B - pl.spmm(res.x), dim=0)
                     / torch.linalg.norm(B, dim=0)).max())
        print(f"cg_multi_runner(iters=50) f32, 8 RHS, on {label} via "
              f"{pl.strategy}: {cgm[label]:.4f} ms/iter | max true rel "
              f"residual 1.0 -> {r50:.3e}")
        # the power-law operator converges slowly: the worst of 8 random
        # columns stands near 0.15 after 50 iterations
        require(np.isfinite(r50) and r50 < 0.5, f"{label} cg_multi residual "
                f"did not fall")
        del B, res, run
    del plan_spd

    # tol a decade below the gate on the true residual, as cg's restarts
    for label, pl, m in (("laplacian_2d(256)", plan64, m256),
                         ("bus420.mtx", plan_bus, bus)):
        B64 = rng.random((m.shape[0], 4))
        t0 = time.perf_counter()
        res = cg_multi(pl, torch.tensor(B64, device=dev), tol=1e-11,
                       maxiter=10_000)
        torch.cuda.synchronize()
        true = (np.linalg.norm(B64 - m @ res.x.cpu().numpy(), axis=0)
                / np.linalg.norm(B64, axis=0))
        print(f"cg_multi(tol=1e-11) f64, 4 RHS, {label} via {pl.strategy}: "
              f"{res.iterations} iterations, true rel residuals (scipy) "
              f"{np.array2string(true, precision=3)}, converged="
              f"{res.converged.tolist()} ({time.perf_counter() - t0:.2f} s)")
        require(true.max() <= 1e-10, f"{label} cg_multi true residual "
                f"{true.max():.3e}")

    torch.cuda.synchronize()
    mlaunches = {k: c[k] for c in counters for k in c if k.endswith("_spmm")}
    print(f"launch counts on the multi-RHS path: {mlaunches}")
    for k in ("sdia_spmm", "psdia_spmm", "gpr_spmm", "ell_spmm"):
        require(mlaunches[k] > 0, f"{k} never launched")

    # -- 4d. the distributed path: sharded streaming DIA, GPR, dist_cg -------
    print("== 4d. distributed path (K8a/K8b small checks, then counters "
          "zeroed)")
    meshes = {nd: tdist.make_mesh(nd, device="cuda:0") for nd in (1, 2, 4)}
    for name, m in small.items():
        x64 = rng.random(m.shape[0])
        ref = m @ x64
        for dt in (torch.float32, torch.float64):
            dname = str(dt).removeprefix("torch.")
            dia = convert(COO.from_scipy(m, dtype=dt, device=dev), "dia")
            packs = [("sdia_ring", ds.pack_sdia(dia), tdist.ShardedSDIA,
                      ds.spmv_sdia_padded)]
            if name.startswith("laplacian"):
                packs.append(("psdia_ring", ds.pack_psdia(
                    dia, period=ds.detect_period(dia.to("cpu"))),
                    tdist.ShardedPSDIA, ds.spmv_psdia_padded))
            xt = torch.tensor(x64, dtype=dt, device=dev)
            for kname, pack, cls, single in packs:
                xpad = ds.pad_x(pack, xt)
                ys = single(pack, xpad)
                for nd, mesh in meshes.items():
                    A = tdist.place(cls.build(pack, nd), mesh)
                    xs = tdist.place(A.shard_xpad(xpad), mesh)
                    e_plain, bitwise = 0.0, True
                    for s in range(nd):
                        left = xs.chunks[(s - 1) % nd][-A.halo:]
                        right = xs.chunks[(s + 1) % nd][:A.halo]
                        if kname == "sdia_ring":
                            args = (A.data[s], A.offsets, xs.chunks[s], left,
                                    right)
                            y1, y2 = (dst.spmv_sdia_ring(*args),
                                      dst.spmv_sdia_ring(*args))
                            yr = dst.spmv_sdia_ring_ref(*args)
                        else:
                            args = (A.pattern[s], A.offsets, xs.chunks[s],
                                    left, right)
                            kw = dict(base=s * A.rows_per_shard, L=A.L,
                                      nrow=A.shape[0])
                            y1, y2 = (dst.spmv_psdia_ring(
                                *args, **kw, plan=A.ring_plan),
                                dst.spmv_psdia_ring(*args, **kw,
                                                    plan=A.ring_plan))
                            yr = dst.spmv_psdia_ring_ref(*args, **kw)
                        torch.cuda.synchronize()
                        e_plain = max(e_plain, float(
                            (y1 - yr).abs().max()
                            / max(float(yr.abs().max()), 1e-300)))
                        bitwise &= torch.equal(y1, y2)
                    spmv_sh = (tdist.spmv_sdia_sharded if kname == "sdia_ring"
                               else tdist.spmv_psdia_sharded)
                    flat = torch.cat(spmv_sh(mesh, A, xs).chunks)
                    same = torch.equal(flat[:pack.npad], ys)
                    diff = float((flat[:pack.npad] - ys).abs().max())
                    e1 = rel_err(flat[A.L:A.L + m.shape[0]].cpu(), ref)
                    walk = ""
                    if kname == "psdia_ring":
                        walk = (f", stride walk S={A.ring_plan.stride * 1024}"
                                f"{' reuse' if A.ring_plan.reuse else ''}"
                                if A.ring_plan.stride else ", cluster walk")
                    print(f"{kname:10s} {name:17s} {dname} ndev={nd} "
                          f"(Cp={A.rows_per_shard}, h={A.halo}{walk}): rel vs "
                          f"plain "
                          f"{e_plain:.2e} | vs scipy {e1:.2e} | bitwise "
                          f"{bitwise} | vs single-chip "
                          f"{'bitwise equal' if same else f'max diff {diff:.3e}'}"
                          f" | pads zero {not flat[pack.npad:].any()}")
                    require(e_plain <= PLAIN_TOL[dname], f"{kname} {name} "
                            f"{dname} ndev={nd} vs plain {e_plain:.2e}")
                    require(e1 <= ORACLE_TOL[dname], f"{kname} {name} {dname} "
                            f"ndev={nd} vs scipy {e1:.2e}")
                    require(diff <= PLAIN_TOL[dname] * float(ys.abs().max()),
                            f"{kname} {name} ndev={nd} vs single chip {diff}")
                    # K8b sums K2's values in K2's order: bitwise K2
                    require(same or kname != "psdia_ring", f"{kname} {name} "
                            f"{dname} ndev={nd} not bitwise K2")
                    require(bitwise, f"{kname} {name} not bitwise reproducible")
                    require(not flat[pack.npad:].any(), f"{kname} pads")

    # the main path: the 4096^2 Poisson's packs of phase 4a, sharded (no
    # second planning), through bench_dist_spmv's chain at 1 and 4 shards
    counters = (*counters, dst.LAUNCHES)
    zero(*counters)
    xf = torch.tensor(x_host, dtype=torch.float32, device=dev)
    scale = 1.0 / float(abs(mat).sum(axis=1).max())
    dist1 = {}
    for strategy, pack, cls, single in (
            ("pdia_stream", P, tdist.ShardedPSDIA, ds.spmv_psdia_padded),
            ("dia_stream", S, tdist.ShardedSDIA, ds.spmv_sdia_padded)):
        plain_ms = time_chained(lambda v: single(pack, v) * scale,
                                ds.pad_x(pack, xf)).median_s * 1e3
        for nd in (1, 4):
            A = tdist.place(cls.build(pack, nd), meshes[nd])
            dplan = tdist.DistPlan(A, strategy, A.pad_plan, A.pad_plan,
                                   meshes[nd])
            r = tdist.bench_dist_spmv(mat, meshes[nd], plan=dplan)
            xpad = ds.pad_x(pack, xf)
            flat = torch.cat(dplan.spmv(tdist.place(A.shard_xpad(xpad),
                                                    meshes[nd])).chunks)
            same = torch.equal(flat[:pack.npad], single(pack, xpad))
            require(same, f"{strategy} ndev={nd} at 4096^2 not bitwise the "
                    f"single-chip product")
            walk = ""
            if strategy == "pdia_stream":
                walk = (f", stride walk S={A.ring_plan.stride * 1024}"
                        f"{' reuse' if A.ring_plan.reuse else ''}"
                        if A.ring_plan.stride else ", cluster walk")
            print(f"    {strategy} ndev={nd} (Cp={A.rows_per_shard}, "
                  f"h={A.halo}{walk}): {r['seconds'] * 1e3:.4f} ms per SpMV, "
                  f"bitwise the single-chip product {same} | "
                  f"plain {'K2' if strategy == 'pdia_stream' else 'K1'} "
                  f"chain on the same pack {plain_ms:.4f} ms -> parity "
                  f"{r['seconds'] * 1e3 / plain_ms:.3f} | rel err vs scipy "
                  f"{r['rel_err']:.2e}")
            if nd == 1:
                dist1[strategy] = A
            del A, dplan

    gname = "random_sparse(100000,7e-5)"
    m = general[gname]
    G = tdist.place(tdist.ShardedGPR.build(m, 1, dtype=np.float32), meshes[1])
    gplan = tdist.DistPlan(G, "gpr", G.x_plan, G.row_plan, meshes[1])
    r = tdist.bench_dist_spmv(m, meshes[1], plan=gplan, iters=100)
    dgpr = gpr.LAUNCHES["gpr"]          # the plain chain below adds more
    gscale = 1.0 / float(abs(m).sum(axis=1).max())
    xg = torch.tensor(rng.random(m.shape[1]), dtype=torch.float32, device=dev)
    ys = gplan.spmv(gplan.shard_x(xg)).chunks[0]
    yp = gpr.spmv_gpr(G.gpcsr[0], xg)
    rel_g = float((ys - yp).abs().max() / yp.abs().max())
    gplain_ms = time_chained(lambda v: gpr.spmv_gpr(G.gpcsr[0], v) * gscale,
                             xg, iters=100).median_s * 1e3
    gpr_parity = r["seconds"] * 1e3 / gplain_ms
    print(f"    gpr ndev=1 on {gname}: {r['seconds'] * 1e3:.4f} ms per SpMV, "
          f"plain gpr_spmv chain on the same pack {gplain_ms:.4f} ms -> "
          f"parity {gpr_parity:.3f} | vs plain "
          f"{rel_g:.2e} | rel err vs scipy {r['rel_err']:.2e}")
    require(rel_g <= PLAIN_TOL["float32"], f"sharded GPR vs gpr_spmv {rel_g}")
    del G, gplan, ys, yp

    A = tdist.place(tdist.NeighborCSR.build(m256.tocsr(), 4, square=True),
                    meshes[4])
    b256 = rng.random(m256.shape[0])
    bs = tdist.place(tdist.ShardedVector.from_global(b256, A.row_plan),
                     meshes[4])
    t0 = time.perf_counter()
    res = dist_cg(meshes[4], A, bs, tol=1e-8, maxiter=2000)
    torch.cuda.synchronize()
    dcg_s = time.perf_counter() - t0
    true_rel = float(np.linalg.norm(b256 - m256 @ res.x.to_global())
                     / np.linalg.norm(b256))
    res1 = cg(plan64, torch.tensor(b256, device=dev), tol=1e-8, maxiter=2000)
    print(f"dist_cg(csr_neighbor, ndev=4 on one card, f64) laplacian_2d(256), "
          f"tol 1e-8: {res.iterations} iterations (single-chip cg "
          f"{res1.iterations}), converged={bool(res.converged)}, true rel "
          f"residual {true_rel:.3e} (scipy) ({dcg_s:.2f} s)")
    require(bool(res.converged) and true_rel <= 1e-7,
            f"dist_cg: converged={bool(res.converged)}, true {true_rel:.2e}")
    del A, bs, res

    torch.cuda.synchronize()
    dlaunches = {**dst.LAUNCHES, "gpr": dgpr}
    print(f"launch counts on the distributed path: {dlaunches}")
    for k in ("sdia_ring", "psdia_ring", "gpr"):
        require(dlaunches[k] > 0, f"{k} never launched")

    def ring_extra(A1, S1, xv, xk, left, right, dname):
        """K8a beside its record: in f64 at one shard (from the f32 record
        only; bitwise K1 f64 on the same pack), and the chain of four
        shards on this card (bitwise K1), replayed from a CUDA graph beside
        the one shard and four times one of its quarter shards."""
        t0 = time.perf_counter()
        if dname == "f32":
            S64 = dataclasses.replace(S1, data=S1.data.double())
            A64 = tdist.ShardedSDIA.build(S64, 1)
            xp64 = ds.pad_x(S64, xv.double())
            x64 = A64.shard_xpad(xp64).chunks[0]
            ring64 = (A64.data[0], A64.offsets, x64, x64[-A64.halo:],
                      x64[:A64.halo])
            y64 = dst.spmv_sdia_ring(*ring64)
            same64 = torch.equal(y64[:S64.npad],
                                 ds.spmv_sdia_padded(S64, xp64))
            err64 = float((y64 - dst.spmv_sdia_ring_ref(*ring64)).abs().max())
            require(same64, "K8a f64 at one shard not bitwise K1 f64")
            ms64 = time_fn(dst.spmv_sdia_ring, *ring64,
                           iters=50).median_s * 1e3
            k1_64 = time_fn(ds.spmv_sdia_padded, S64, xp64,
                            iters=50).median_s * 1e3
            b64, by64 = bound(spmv_bytes(A64, torch.float64), 2 * S64.nnz)
            print(f"    K8a f64, one shard: {ms64:.4f} ms | bound {b64:.4f} "
                  f"ms ({by64}, {100 * b64 / ms64:.1f}%) | K1 f64 on the "
                  f"same pack {k1_64:.4f} ms | bitwise K1 f64 {same64} | "
                  f"max abs err vs plain {err64:.3e} ({card})")
            del S64, A64, xp64, x64, ring64, y64
        xp = ds.pad_x(S1, xv)
        A4 = tdist.ShardedSDIA.build(S1, 4)
        xs4 = A4.shard_xpad(xp)
        chain = lambda: tdist.spmv_sdia_sharded(meshes[4], A4, xs4)  # noqa
        same4 = torch.equal(torch.cat(chain().chunks)[:S1.npad],
                            ds.spmv_sdia_padded(S1, xp))
        require(same4, f"K8a {dname}: four shards not bitwise K1")
        h4 = A4.halo
        g = {"chain": graph_ms(chain, 10, 10),
             "one": graph_ms(lambda: dst.spmv_sdia_ring(
                 A1.data[0], A1.offsets, xk, left, right), 10, 10),
             "quarter": graph_ms(lambda: dst.spmv_sdia_ring(
                 A4.data[0], A4.offsets, xs4.chunks[0],
                 xs4.chunks[3][-h4:], xs4.chunks[1][:h4]), 10, 10)}
        b4 = bound(spmv_bytes(A4, torch.float32), 2 * A4.nnz)[0]
        print(f"    K8a {dname}, four shards on one card (Cp="
              f"{A4.rows_per_shard}), replayed from a CUDA graph: "
              f"{g['chain']:.4f} ms a product (bound {b4:.4f}, "
              f"{100 * b4 / g['chain']:.1f}%) | one shard of the whole "
              f"{g['one']:.4f} ms | 4 x a quarter shard "
              f"{4 * g['quarter']:.4f} ms | bitwise K1 {same4} "
              f"({time.perf_counter() - t0:.1f} s; {card})")
        del A4, xs4, xp

    # -- 4e. reorder and operator transforms at full width -----------------
    print("== 4e. reorder, transpose, gradients, screened Poisson (counters "
          "zeroed)")
    import dataclasses

    NB = 4_194_304
    t0 = time.perf_counter()
    bc = utils.banded(NB, 5).tocoo()
    order = np.random.default_rng(3).permutation(NB)
    inv = np.empty_like(order)
    inv[order] = np.arange(NB)
    # the band in a random node order: entry (r, c) moves to (inv[r], inv[c])
    shuffled = sp.csr_matrix((bc.data, (inv[bc.row], inv[bc.col])),
                             shape=bc.shape)
    del bc, order, inv
    print(f"banded({NB},5) in a random node order (seed 3): {shuffled.nnz} "
          f"nnz (host build {time.perf_counter() - t0:.1f} s)")
    require(shuffled.nnz == 46_137_314, f"band nnz {shuffled.nnz}")
    counters = (*counters, pk.LAUNCHES)
    zero(*counters)
    t0 = time.perf_counter()
    direct = plan_spmv(shuffled, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    require(direct.strategy in ("gpr", "pallas_ell"),
            f"shuffled band planned to {direct.strategy}")
    t0 = time.perf_counter()
    rcm_permutation(shuffled)
    rcm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ro = reorder_plan(shuffled, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    ro_s = time.perf_counter() - t0
    print(f"plan_spmv on it: {direct.strategy} ({direct_s:.2f} s) | "
          f"reorder_plan: {ro.strategy}, bandwidth {ro.bandwidth_before} -> "
          f"{ro.bandwidth_after}, {ro.plan.matrix.ndiags} diagonals, rb "
          f"{ro.plan.matrix.rb} ({ro_s:.2f} s, of which RCM alone "
          f"{rcm_s:.2f} s)")
    require(ro.plan.strategy == "dia_stream" and ro.bandwidth_after == 5,
            f"reordered band: {ro.strategy}, bandwidth {ro.bandwidth_after}")
    xs64 = rng.random(NB)
    xs = torch.tensor(xs64, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    perm_plans = (ro.perm_plan, ro.inv_plan)    # planned once, on the card
    torch.cuda.synchronize()
    pplan_s = time.perf_counter() - t0
    require(all(pp.method == "two_pass" for pp in perm_plans),
            f"the shuffled band's perms planned to "
            f"{[pp.method for pp in perm_plans]}")
    before = (pk.LAUNCHES["permute_two_pass"], ds.LAUNCHES["sdia"])
    ys = ro(xs)
    torch.cuda.synchronize()
    spent = (pk.LAUNCHES["permute_two_pass"] - before[0],
             ds.LAUNCHES["sdia"] - before[1])
    rel_ro = rel_err(ys.cpu(), shuffled @ xs64)
    rel_direct = rel_err(direct(xs).cpu(), shuffled @ xs64)
    ro_ms = time_fn(ro, xs, iters=50).median_s * 1e3
    direct_ms = time_fn(direct, xs, iters=50).median_s * 1e3
    print(f"ro(x): its two perms planned to the two-pass gather (chunks of "
          f"{ro.perm_plan.chunk} words, far_share "
          f"{pk.far_share(ro.perm_plan.perm):.3f}) in {pplan_s:.3f} s on "
          f"the card | launches (two-pass gathers, K1) {spent} | rel err vs "
          f"scipy f64 {rel_ro:.2e} (direct {rel_direct:.2e}) | {ro_ms:.4f} "
          f"ms per product (host clock; phase 5 times its perms' forms in "
          f"turns) against the direct {direct.strategy} plan's "
          f"{direct_ms:.4f} ms")
    require(spent == (2, 1), f"ro(x) launched {spent}")
    require(rel_ro <= ORACLE_TOL["float32"], f"ro(x) rel err {rel_ro:.2e}")
    del direct, ys

    name = "shuffled laplacian_2d(2048)"
    msh, plan_sh = general[name], gplans[name]
    t0 = time.perf_counter()
    ro_p = reorder_plan(msh, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    rop_s = time.perf_counter() - t0
    xp64 = rng.random(msh.shape[0])
    xpt = torch.tensor(xp64, dtype=torch.float32, device=dev)
    rel_p = rel_err(ro_p(xpt).cpu(), msh @ xp64)
    rop_ms = time_fn(ro_p, xpt, iters=50).median_s * 1e3
    rop_plan_ms = time_fn(ro_p.plan, xpt, iters=50).median_s * 1e3
    sh_ms = time_fn(plan_sh, xpt, iters=50).median_s * 1e3
    print(f"{name}: reorder_plan -> {ro_p.strategy}, bandwidth "
          f"{ro_p.bandwidth_before} -> {ro_p.bandwidth_after} "
          f"({rop_s:.2f} s) | rel err {rel_p:.2e} | ro(x) {rop_ms:.4f} ms, "
          f"ro.plan alone {rop_plan_ms:.4f} ms, the 4b {plan_sh.strategy} "
          f"plan {sh_ms:.4f} ms")
    require(rel_p <= ORACLE_TOL["float32"], f"reordered Poisson {rel_p:.2e}")
    b64 = msh @ rng.random(msh.shape[0])
    b = torch.tensor(b64, dtype=torch.float32, device=dev)
    run = cg_runner(ro_p.plan, iters=50, report_tol=1e-5)
    bp = pk.apply_permutation(ro_p.perm_plan, b)   # permuted once
    run(bp)                                  # warm-up
    start.record()
    res = run(bp)
    end.record()
    end.synchronize()
    cg_rp_ms = start.elapsed_time(end) / 50
    xsol = pk.apply_permutation(ro_p.inv_plan, res.x).cpu().double().numpy()
    r50 = float(np.linalg.norm(b64 - msh @ xsol) / np.linalg.norm(b64))
    print(f"cg_runner(iters=50) f32 in permuted space via "
          f"{ro_p.plan.strategy}: {cg_rp_ms:.4f} ms/iter (4b, shuffled order: {cg_sh_ms:.4f}) | "
          f"true rel residual (scipy) 1.0 -> {r50:.3e}")
    require(np.isfinite(r50) and r50 < 0.1, "permuted-space CG residual")
    del run, res, b, bp
    XB = torch.rand(NRHS, msh.shape[0], generator=gen, device=dev)
    # the batched gather at full width: the RCM perm's two-pass plan on 32
    # and 8 rows (f32: permute_rows_two_pass; f64: permute_gather_batched)
    # and the same perm planned direct, each bitwise the plain version,
    # index_select and the other form
    rcm_direct = pk._plan(ro_p.perm_plan.perm, dev, "direct", pk.CHUNK)

    def batched_check(label, pplan, X, other=None):
        before = (pk.LAUNCHES["permute_batched"],
                  pk.LAUNCHES["permute_batched_two_pass"])
        Y = pk.apply_permutation_batched(pplan, X)
        same = (torch.equal(Y, pk.apply_permutation_batched_ref(pplan, X))
                and torch.equal(Y, torch.index_select(X, 1,
                                                      pplan.perm.long())))
        if other is not None:
            same = same and torch.equal(
                Y, pk.apply_permutation_batched(other, X))
        torch.cuda.synchronize()
        form = pk.gather_form(pplan.method, X.element_size())
        key = 1 if form == "two_pass" else 0
        spent = (pk.LAUNCHES["permute_batched"] - before[0],
                 pk.LAUNCHES["permute_batched_two_pass"] - before[1])
        print(f"apply_permutation_batched, {label}, X {list(X.shape)} "
              f"{str(X.dtype).removeprefix('torch.')}: {form} form, "
              f"bitwise equal to the plain version, index_select"
              f"{' and the direct form' if other is not None else ''} "
              f"{same}")
        require(same and spent[key] >= 1, f"batched gather {label} "
                f"{X.dtype} {tuple(X.shape)}: {same}, launches {spent}")

    XB64 = XB.double()
    for Xr in (XB, XB[:8], XB64, XB64[:8]):
        batched_check("RCM perm", ro_p.perm_plan, Xr, rcm_direct)
    batched_check("RCM perm planned direct", rcm_direct, XB)
    del XB64
    # the 1M-row band of 4a in its natural order: its RCM perm is local
    # (neighbouring slots read neighbouring sources), so both of ro's
    # perms take the direct gather
    ro_b = reorder_plan(band, dtype=torch.float32, device=dev)
    xr64 = rng.random(band.shape[0])
    before = pk.LAUNCHES["permute"]
    yr = ro_b(torch.tensor(xr64, dtype=torch.float32, device=dev))
    torch.cuda.synchronize()
    rel_b = rel_err(yr.cpu(), band @ xr64)
    spent_b = pk.LAUNCHES["permute"] - before
    print(f"reorder_plan(banded(1000000,5)) in its natural order: "
          f"{ro_b.strategy}, perms {ro_b.perm_plan.method} (far_share "
          f"{pk.far_share(ro_b.perm_plan.perm):.3f}) | direct gathers "
          f"{spent_b} | rel err vs scipy {rel_b:.2e}")
    require(ro_b.perm_plan.method == ro_b.inv_plan.method == "direct"
            and spent_b == 2 and rel_b <= ORACLE_TOL["float32"],
            f"natural band reordered: {ro_b.perm_plan.method}, {spent_b}, "
            f"{rel_b:.2e}")
    nat_plan = ro_b.perm_plan    # the direct gather's input, timed in 5
    del ro_b, yr
    XN = torch.rand(NRHS, nat_plan.n, generator=gen, device=dev)
    batched_check("RCM perm of the natural band", nat_plan, XN)

    xb64 = rng.random(band.shape[0])
    xb = torch.tensor(xb64, dtype=torch.float32, device=dev)
    pt = planb.transpose()
    rel_t = rel_err(pt(xb).cpu(), band.T @ xb64)
    print(f"banded(1000000,5).transpose() -> {pt.strategy} (L={pt.matrix.L}, "
          f"npad={pt.matrix.npad}): rel err vs scipy A^T x {rel_t:.2e}")
    require(pt.strategy == "dia_stream" and rel_t <= ORACLE_TOL["float32"],
            f"transposed band {pt.strategy} {rel_t:.2e}")
    del pt, xb

    # one backward through spmv_psdia on 4a's PSDIA pack (no second planning)
    g64 = rng.random(mat.shape[0])
    gv = torch.tensor(g64, dtype=torch.float32, device=dev)
    Pg = dataclasses.replace(
        P, pattern=P.pattern.detach().clone().requires_grad_(True))
    xg = torch.tensor(x_host, dtype=torch.float32, device=dev,
                      requires_grad=True)
    torch.autograd.backward(ds.spmv_psdia(Pg, xg), gv)
    rel_gx = rel_err(xg.grad.cpu(), mat.T @ g64)
    gp = ds.pad_x(P, gv.double())
    xpd = ds.pad_x(P, xg.detach().double())
    pat_ref = torch.stack([(gp * ds._shift(xpd, off)).reshape(-1, P.rb).sum(0)
                           for off in P.offsets])
    rel_gp = float((Pg.pattern.grad.double() - pat_ref).abs().max()
                   / pat_ref.abs().max())
    fwd_ms = time_fn(ds.spmv_psdia, P, xg.detach(), iters=20).median_s * 1e3
    fb_ms = time_fn(lambda: torch.autograd.grad(
        ds.spmv_psdia(Pg, xg), (Pg.pattern, xg), gv)[1],
        iters=20).median_s * 1e3
    print(f"spmv_psdia backward at {mat.shape[0]} rows: x.grad vs scipy A^T g "
          f"{rel_gx:.2e} | pattern.grad vs the f64 rule {rel_gp:.2e} | "
          f"forward {fwd_ms:.4f} ms, forward + backward {fb_ms:.4f} ms "
          f"(backward {fb_ms - fwd_ms:.4f} ms)")
    require(max(rel_gx, rel_gp) <= ORACLE_TOL["float32"],
            f"psdia backward {rel_gx:.2e}/{rel_gp:.2e}")
    del Pg, xg, gp, xpd, pat_ref

    gname = "power_law(400000,13)"
    pplaw = gplans[gname]
    plan_T = plan_spmv(plaw.T.tocsr(), dtype=torch.float32, device=dev)
    mv = pplaw.matvec_differentiable(plan_T)
    w64 = rng.random(plaw.shape[0])
    xw = torch.tensor(rng.random(plaw.shape[1]), dtype=torch.float32,
                      device=dev, requires_grad=True)
    torch.dot(torch.tensor(w64, dtype=torch.float32, device=dev),
              mv(xw)).backward()
    rel_mv = rel_err(xw.grad.cpu(), plaw.T @ w64)
    print(f"matvec_differentiable on the {gname} {pplaw.strategy} plan, "
          f"plan_T {plan_T.strategy}: x.grad vs scipy P^T w {rel_mv:.2e}")
    require(rel_mv <= ORACLE_TOL["float32"], f"GPR gradient {rel_mv:.2e}")
    del plan_T, mv, xw

    # the screened Poisson (A + I) of the reference's cg16m_ms_iter leg
    PS = shift_diagonal(P, 1.0)
    plan_scr = plan_from_matrix(PS, "pdia_stream")
    bs64 = rng.random(mat.shape[0])
    bs = torch.tensor(bs64, dtype=torch.float32, device=dev)
    run = cg_runner(plan_scr, iters=40, report_tol=1e-5)
    run(bs)                                  # warm-up
    start.record()
    res = run(bs)
    end.record()
    end.synchronize()
    cg_scr_ms = start.elapsed_time(end) / 40
    xsc = res.x.cpu().double().numpy()
    r40 = float(np.linalg.norm(bs64 - (mat @ xsc + xsc))
                / np.linalg.norm(bs64))
    print(f"screened Poisson shift_diagonal(PSDIA, 1.0), cg_runner(iters=40) "
          f"f32: {cg_scr_ms:.4f} ms/iter (4a unshifted: {cg_ms:.4f}) | true "
          f"rel residual (scipy, (A + I) x) {r40:.3e}")
    require(r40 <= 1e-5, f"screened-Poisson CG true residual {r40:.3e}")
    del PS, plan_scr, run, res

    torch.cuda.synchronize()
    elaunches = {**pk.LAUNCHES, "sdia": ds.LAUNCHES["sdia"],
                 "psdia": ds.LAUNCHES["psdia"], "gpr": gpr.LAUNCHES["gpr"]}
    print(f"launch counts on the reorder / transform path: {elaunches}")
    for k in ("permute", "permute_two_pass", "permute_batched",
              "permute_batched_two_pass", "sdia", "psdia", "gpr"):
        require(elaunches[k] > 0, f"{k} never launched in 4e")

    # -- 4f. block formats at full width ----------------------------------
    print("== 4f. block formats: BDIA through the planners, BSR and ELL "
          "forced (counters zeroed)")
    t0 = time.perf_counter()
    blap = utils.block_laplacian(512, bs=8, seed=0)
    print(f"block_laplacian(512, bs=8): {blap.shape[0]} rows, {blap.nnz} nnz "
          f"(scipy build {time.perf_counter() - t0:.1f} s)")
    require(blap.nnz == 83_755_008, f"block_laplacian(512) nnz {blap.nnz}")
    counters = (*counters, pr.LAUNCHES)
    zero(*counters)
    t0 = time.perf_counter()
    plan_b = plan_spmv(blap, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    Bd = plan_b.matrix
    print(f"plan_spmv: strategy={plan_b.strategy} ndiags={Bd.ndiags} "
          f"offsets={Bd.offsets} nbrow={Bd.nbrow} ({Bd.data.numel()} slots, "
          f"{Bd.data.numel() / blap.nnz:.4f} x nnz; host planning "
          f"{time.perf_counter() - t0:.2f} s)")
    require(plan_b.strategy == "bdia", f"block PDE planned to "
            f"{plan_b.strategy}")
    xb64 = rng.random(blap.shape[1])
    xb512 = torch.tensor(xb64, dtype=torch.float32, device=dev)
    rel = verify_against_oracle(Bd, xb512, plan_b(xb512), oracle=blap)
    print(f"plan(x) via bdia vs scipy f64: rel err {rel:.2e}")
    X512 = torch.rand(blap.shape[1], NRHS, generator=gen, device=dev)
    rel = verify_against_oracle(Bd, X512, plan_b.spmm(X512), oracle=blap)
    print(f"plan.spmm(X) via bdia, {NRHS} RHS, vs scipy f64: rel err "
          f"{rel:.2e}")

    t0 = time.perf_counter()
    mc = blap.tocoo()
    hb = COO.from_arrays(mc.row, mc.col, mc.data, blap.shape,
                         dtype=torch.float32, sort=False)
    Bsr = convert(hb, "bsr", block_size=8).to(dev)
    bsr_s = time.perf_counter() - t0
    rel = verify_against_oracle(Bsr, xb512, spmv(Bsr, xb512), oracle=blap)
    print(f"BSR forced: {Bsr.nblocks} blocks of 8x8 ({bsr_s:.2f} s to "
          f"convert): rel err vs scipy {rel:.2e}")
    del hb, mc
    gstrategy = general_strategy(np.diff(blap.indptr), blap.nnz, 4)
    t0 = time.perf_counter()
    Bg = (gpr.pack_gpr if gstrategy == "gpr" else ell.pack_ell)(
        blap, dtype=torch.float32, device=dev)
    gpack_s = time.perf_counter() - t0
    gkern = gpr.spmv_gpr if gstrategy == "gpr" else ell.spmv_ell_packed
    rel = verify_against_oracle(Bg, xb512, gkern(Bg, xb512), oracle=blap)
    bg_ms = time_fn(gkern, Bg, xb512, iters=20).median_s * 1e3
    bd_ms = time_fn(plan_b, xb512, iters=20).median_s * 1e3
    print(f"general arm forced ({gstrategy}, pack {gpack_s:.2f} s): rel err "
          f"vs scipy {rel:.2e} | {bg_ms:.4f} ms per SpMV against the bdia "
          f"plan's {bd_ms:.4f} ms")
    del Bg

    t0 = time.perf_counter()
    bsym = (blap + blap.T).tocsr()
    bspd = (bsym + sp.diags(np.asarray(abs(bsym).sum(axis=1)).ravel()
                            + 1.0)).tocsr()
    del bsym
    plan_bs = plan_spmv(bspd, dtype=torch.float32, device=dev)
    print(f"SPD form B + B^T + diag: {bspd.nnz} nnz -> {plan_bs.strategy} "
          f"({time.perf_counter() - t0:.1f} s to build and plan)")
    require(plan_bs.strategy == "bdia", f"SPD block form planned to "
            f"{plan_bs.strategy}")
    bb = torch.tensor(bspd @ rng.random(bspd.shape[0]), dtype=torch.float32,
                      device=dev)
    run = cg_runner(plan_bs, iters=50, report_tol=1e-5)
    run(bb)                                  # warm-up
    start.record()
    res = run(bb)
    end.record()
    end.synchronize()
    cg_b_ms = start.elapsed_time(end) / 50
    r50 = float(torch.linalg.norm(bb - plan_bs(res.x)) / torch.linalg.norm(bb))
    print(f"cg_runner(iters=50) f32 on the SPD block form via bdia: "
          f"{cg_b_ms:.4f} ms/iter | true rel residual 1.0 -> {r50:.3e}")
    require(np.isfinite(r50) and r50 < 0.1, "block CG residual did not fall")
    del bspd, plan_bs, bb, res, run

    b64m = utils.block_laplacian(64, bs=8)
    p64 = plan_spmv(b64m, dtype=torch.float32, device=dev)
    x64b = torch.tensor(rng.random(b64m.shape[1]), dtype=torch.float32,
                        device=dev)
    rel = verify_against_oracle(p64.matrix, x64b, p64(x64b), oracle=b64m)
    print(f"block_laplacian(64, bs=8) (the reference's bsr_gflops operand): "
          f"{b64m.shape[0]} rows -> {p64.strategy}, rel err vs scipy "
          f"{rel:.2e}")
    require(p64.strategy == "bdia", f"block_laplacian(64) planned to "
            f"{p64.strategy}")
    del p64, x64b

    s32 = utils.block_laplacian(32, bs=8)
    s32 = (s32 + s32.T).tocsr()
    s32 = (s32 + sp.diags(np.asarray(abs(s32).sum(axis=1)).ravel()
                          + 1.0)).tocsr()
    plan_s32 = plan_spmv(s32, dtype=torch.float64, device=dev)
    b32 = rng.random(s32.shape[0])
    res64 = cg(plan_s32, torch.tensor(b32, device=dev), tol=1e-11,
               true_tol=1e-10, maxiter=10_000)
    true_rel = float(np.linalg.norm(b32 - s32 @ res64.x.cpu().numpy())
                     / np.linalg.norm(b32))
    print(f"cg(true_tol=1e-10) f64 on the SPD form of block_laplacian(32) via "
          f"{plan_s32.strategy}: {res64.iterations} iterations, true rel "
          f"residual {true_rel:.3e} (scipy), converged="
          f"{bool(res64.converged)}")
    require(plan_s32.strategy == "bdia" and true_rel <= 1e-10,
            f"block f64 CG: {plan_s32.strategy}, {true_rel:.3e}")

    yb = plan_b(xb512)
    for nd in (1, 4):
        t0 = time.perf_counter()
        dplan = tdist.plan_dist_spmv(blap, meshes[nd], dtype=torch.float32)
        torch.cuda.synchronize()
        dp_s = time.perf_counter() - t0
        require(dplan.strategy == "bdia", f"dist ndev={nd} planned to "
                f"{dplan.strategy}")
        yd = torch.cat(dplan.spmv(dplan.shard_x(xb64.astype(np.float32)))
                       .chunks)[:blap.shape[0]]
        diff = float((yd - yb).abs().max() / yb.abs().max())
        r = tdist.bench_dist_spmv(blap, meshes[nd], plan=dplan, iters=20,
                                  quiet=True)
        print(f"plan_dist_spmv ndev={nd} on one card: {dplan.strategy}, "
              f"Rb={dplan.matrix.blocks_per_shard} ({dp_s:.2f} s to plan): "
              f"vs the single-chip plan "
              f"{'bitwise equal' if torch.equal(yd, yb) else f'rel {diff:.2e}'}"
              f" | {r['seconds'] * 1e3:.4f} ms per SpMV (single-chip plan "
              f"{bd_ms:.4f} ms) | rel err vs scipy {r['rel_err']:.2e}")
        require(diff <= PLAIN_TOL["float32"], f"dist bdia ndev={nd} vs "
                f"single chip {diff:.2e}")
        del dplan, yd
    del yb
    dplan = tdist.plan_dist_spmv(s32, meshes[4], dtype=torch.float64)
    bsh = dplan.shard_x(b32)
    res = dist_cg(meshes[4], dplan.matrix, bsh, tol=1e-12, maxiter=5000)
    true_rel = float(np.linalg.norm(b32 - s32 @ res.x.to_global())
                     / np.linalg.norm(b32))
    print(f"dist_cg({dplan.strategy}, ndev=4 on one card, f64) on the SPD "
          f"form of block_laplacian(32): {res.iterations} iterations, "
          f"converged={bool(res.converged)}, true rel residual "
          f"{true_rel:.3e} (scipy)")
    require(dplan.strategy == "bdia" and bool(res.converged)
            and true_rel <= 1e-10, f"block dist_cg: {dplan.strategy}, "
            f"converged={bool(res.converged)}, true {true_rel:.3e}")
    del dplan, bsh, res, plan_s32, s32

    gname = "random_sparse(100000,7e-5)"
    m = general[gname]
    E = convert(COO.from_scipy(m, dtype=torch.float32), "ell").to(dev)
    K4 = (gplans[gname].matrix if gplans[gname].strategy == "pallas_ell"
          else ell.pack_ell(m, dtype=torch.float32, device=dev))
    xe = gx[gname]
    ye, yk = spmv(E, xe), ell.spmv_ell_packed(K4, xe)
    rel_e = rel_err(ye.cpu(), m @ xe.cpu().double().numpy())
    rel_k = float((ye - yk).abs().max() / yk.abs().max())
    print(f"ELL forced on {gname}: width {E.width}, rel err vs scipy "
          f"{rel_e:.2e}, vs sliced ELL (K4) {rel_k:.2e}")
    require(rel_e <= ORACLE_TOL["float32"] and rel_k <= PLAIN_TOL["float32"],
            f"forced ELL {rel_e:.2e}/{rel_k:.2e}")
    del K4, ye, yk

    torch.cuda.synchronize()
    blaunches = {"gpr": gpr.LAUNCHES["gpr"], "ell": ell.LAUNCHES["ell"]}
    print(f"launch counts on the block-format path: {blaunches} (the block "
          f"products are torch code)")
    require(blaunches["gpr" if gstrategy == "gpr" else "ell"] > 0,
            f"forced general arm ({gstrategy}) never launched in 4f")
    require(blaunches["ell"] > 0, "sliced ELL (K4) never launched in 4f")

    # -- 4g. the solvers behind --solve at full width -----------------------
    print(f"== 4g. solvers on the 4096^2 Poisson of 4a, no second planning of "
          f"its f32 plan (counters zeroed and read around each solver; ms "
          f"per iteration by the host clock, the solvers' host reads "
          f"included; {card})")
    n = mat.shape[0]
    lam_hi = 8 * math.sin(math.pi * GRID / (2 * (GRID + 1))) ** 2
    lam_lo = 8 * math.sin(math.pi / (2 * (GRID + 1))) ** 2
    g_launches = {}
    solver_rows = {}

    def solver_run(label, fn, iters_of):
        """Run one solver with the counters zeroed just before and read
        just after; print its iterations, ms/iteration and launches."""
        zero(ds.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in ds.LAUNCHES.items() if v}
        for k, v in counts.items():
            g_launches[k] = g_launches.get(k, 0) + v
        its = iters_of(out)
        solver_rows[label] = (its, 1e3 * secs / max(its, 1))
        print(f"  {label}: {its} iterations, {1e3 * secs / max(its, 1):.4f} "
              f"ms/iteration ({secs:.3f} s) | launches {counts}")
        return out

    # start vectors drawn on the card (a CUDA generator)
    gen = torch.Generator(device=dev)
    lam, _ = solver_run("power_iteration(iters=50)",
                        lambda: power_iteration(
                            plan, iters=50, generator=gen.manual_seed(0)),
                        lambda out: 51)
    lam = float(lam)
    print(f"    Rayleigh quotient {lam:.7f}, analytic lambda_max "
          f"{lam_hi:.7f}")
    require(np.isfinite(lam) and 0 < lam <= lam_hi * (1 + 1e-6),
            f"power iteration's Rayleigh quotient {lam} above {lam_hi}")
    ends = solver_run("eigsh_lanczos(k=80, full_reorth)",
                      lambda: eigsh_lanczos(plan, k=80,
                                            generator=gen.manual_seed(0)),
                      lambda out: 80)
    print(f"    spectrum estimate [{ends[0]:.6g}, {ends[1]:.7f}] inside the "
          f"analytic [{lam_lo:.6g}, {lam_hi:.7f}] (slack 1e-5 lambda_max)")
    require(lam_lo - 1e-5 * lam_hi <= ends[0] < ends[1]
            <= lam_hi * (1 + 1e-5), f"Lanczos ends {ends} outside "
            f"[{lam_lo}, {lam_hi}]")

    # the screened Poisson A + I (4e's), on 4a's PSDIA pack
    t0 = time.perf_counter()
    PS = shift_diagonal(P, 1.0)
    plan_scr = plan_from_matrix(PS, "pdia_stream")
    mat_scr = (mat + sp.identity(n, dtype=mat.dtype, format="csr")).tocsr()
    bs64 = rng.random(n)
    bs = torch.tensor(bs64, dtype=torch.float32, device=dev)
    inv = safe_dinv(mat_scr.diagonal(), dtype=torch.float32, device=dev)
    color = multicolor(mat_scr)
    print(f"  screened Poisson: host set-up {time.perf_counter() - t0:.2f} s "
          f"(multicolor: {int(color.max()) + 1} colours)")
    t0 = time.perf_counter()
    cheb = chebyshev_preconditioner(plan_scr, dinv=inv, n=n,
                                    generator=gen.manual_seed(0))
    torch.cuda.synchronize()
    print(f"  chebyshev_preconditioner: lmax of D^-1 A by 20 power steps, "
          f"{time.perf_counter() - t0:.3f} s")

    def true_rel(x) -> float:
        xs = x.cpu().double().numpy()
        return float(np.linalg.norm(bs64 - mat_scr @ xs)
                     / np.linalg.norm(bs64))

    for label, fn in (
            ("bicgstab", lambda: bicgstab(plan_scr, bs, tol=1e-6,
                                          maxiter=1000)),
            ("gmres(restart=30)", lambda: gmres(plan_scr, bs, tol=1e-6,
                                                restart=30, maxiter=1000)),
            ("chebyshev([1, 9])", lambda: chebyshev(
                plan_scr, bs, lmin=1.0, lmax=9.0, tol=1e-6, maxiter=1000)),
            ("chebcg (degree 4)", lambda: cg(plan_scr, bs, tol=1e-6,
                                             maxiter=1000, precond=cheb)),
            ("sor (multicolor Gauss-Seidel)", lambda: sor(
                plan_scr, bs, color=color, dinv=inv, tol=1e-6,
                maxiter=1000))):
        res = solver_run(label, fn, lambda out: int(out.iterations))
        tr = true_rel(res.x)
        print(f"    converged={bool(res.converged)}, true rel residual "
              f"(scipy f64) {tr:.3e}")
        require(tr <= 1e-5, f"{label} true residual {tr:.3e}")
        # GMRES restarts while its true residual is above tol and falls
        require(bool(res.converged) or not label.startswith("gmres"),
                f"{label}: its own flag is False at {tr:.3e}")
    del res, color, cheb

    # MG-PCG on the unscreened operator beside plain CG (b = A x_true)
    bm64 = mat @ rng.random(n)
    bm = torch.tensor(bm64, dtype=torch.float32, device=dev)
    mres = solver_run("cg + mg_preconditioner((4096, 4096))", lambda: cg(
        plan, bm, tol=1e-5, maxiter=200,
        precond=mg_preconditioner((GRID, GRID))),
        lambda out: out.iterations)
    mtrue = float(np.linalg.norm(bm64 - mat @ mres.x.cpu().double().numpy())
                  / np.linalg.norm(bm64))
    pres = solver_run("plain cg (same b, tol 1e-5, maxiter 20000)",
                      lambda: cg(plan, bm, tol=1e-5, maxiter=20_000),
                      lambda out: out.iterations)
    print(f"    MG-PCG {mres.iterations} iterations (converged="
          f"{bool(mres.converged)}, true rel residual {mtrue:.3e}) beside "
          f"plain CG's {pres.iterations} (converged={bool(pres.converged)})")
    require(bool(mres.converged) and mtrue <= 1e-4,
            f"MG-PCG: converged={bool(mres.converged)}, true {mtrue:.3e}")
    del bm, mres, pres

    # LSQR on 4a's 1M-row band with its plan's transpose()
    plan_bT = planb.transpose()
    bl = torch.tensor(band @ rng.random(band.shape[0]), dtype=torch.float32,
                      device=dev)
    norms = []
    for k in (10, 20, 30, 40):
        norms.append(float(lsqr(planb, bl, At=plan_bT, tol=0.0,
                                maxiter=k).residual_norm))
    lres = solver_run("lsqr(maxiter=50) on banded(1000000,5)", lambda: lsqr(
        planb, bl, At=plan_bT, tol=0.0, maxiter=50),
        lambda out: out.iterations)
    norms.append(float(lres.residual_norm))
    print(f"    residual norms after 10..50 iterations: "
          f"{', '.join(f'{v:.4e}' for v in norms)}")
    require(all(b_ <= a_ * (1 + 1e-6) for a_, b_ in zip(norms, norms[1:]))
            and norms[-1] < norms[0], f"LSQR residuals rose: {norms}")
    del plan_bT, bl, lres

    # mixed-precision refinement, twice: both plans forced to SDIA (hi K1
    # f32, low K1 bf16: the f32 pack's data cast, which is
    # pack_sdia(data_dtype=bfloat16)'s pack at the same tile), then as
    # plan_spmv picks (hi K2, low K2 on the bf16 pattern widened once)
    hiS = plan_from_matrix(shift_diagonal(S, 1.0), "dia_stream")
    require(ds._auto_rb(S.ndiags, S.offsets, n, itemsize=2) == S.rb,
            "the bf16 SDIA tile differs from the f32 one")
    loS = plan_from_matrix(dataclasses.replace(
        hiS.matrix, data=hiS.matrix.data.to(torch.bfloat16)), "dia_stream")
    t0 = time.perf_counter()
    lo_p = plan_spmv(mat_scr, dtype=torch.bfloat16, device=dev)
    print(f"  plan_spmv(A + I, dtype=bfloat16): strategy={lo_p.strategy} "
          f"pattern {lo_p.matrix.pattern.dtype} rb={lo_p.matrix.rb} (host "
          f"planning {time.perf_counter() - t0:.2f} s)")
    require(lo_p.strategy == "pdia_stream"
            and lo_p.matrix.pattern.dtype == torch.bfloat16
            and lo_p.matrix.rb == PS.rb, "the bf16 plan of A + I")
    for label, hi, lo in (("ir_solve, SDIA (hi K1 f32, low K1 bf16)", hiS,
                           loS),
                          ("ir_solve, as planned (hi K2, low K2 on the "
                           "widened bf16 pattern)", plan_scr, lo_p)):
        ires = solver_run(label, lambda: ir_solve(
            hi, bs, low=lo, inner_iters=16, maxiter=40, tol=1e-6),
            lambda out: out.outer_iterations)
        tr = true_rel(ires.x)
        print(f"    {ires.outer_iterations} outer iterations of 16 inner "
              f"steps, converged={bool(ires.converged)}, true rel residual "
              f"(scipy f64) {tr:.3e}")
        require(tr <= 1e-5, f"{label} true residual {tr:.3e}")
    del hiS, loS, lo_p, ires, PS, plan_scr, mat_scr, inv

    # K1 bf16 on a random-valued band through plan_spmv(dtype=bfloat16),
    # against its plain version on the same bf16 data and scipy float64 of
    # the float32 matrix (the coefficients' rounding: the reference's
    # bf16_data_rel_err)
    p16 = plan_spmv(band, dtype=torch.bfloat16, device=dev)
    A16 = p16.matrix
    require(p16.strategy == "dia_stream"
            and A16.data.dtype == torch.bfloat16, "bf16 band plan")
    x16_64 = rng.random(band.shape[0])
    xp16 = ds.pad_x(A16, torch.tensor(x16_64, dtype=torch.float32,
                                      device=dev))
    yk = ds.spmv_sdia_padded(A16, xp16)
    yp = ds.spmv_sdia_padded_ref(A16, xp16)
    torch.cuda.synchronize()
    rel_p16 = float((yk - yp).abs().max() / yp.abs().max())
    band32 = band.astype(np.float32).astype(np.float64)
    bf16_rel = rel_err(ds.unpad_y(A16, yk).cpu(),
                       band32 @ x16_64.astype(np.float32).astype(np.float64))
    print(f"  K1 bf16 on banded(1000000,5) (rb={A16.rb}): vs plain "
          f"{rel_p16:.2e} | bf16_data_rel_err (scipy f64 of the f32 "
          f"matrix) {bf16_rel:.3e}")
    require(rel_p16 <= 2e-5, f"K1 bf16 vs plain {rel_p16:.2e}")
    require(np.isfinite(bf16_rel) and bf16_rel <= 1e-2,
            f"bf16_data_rel_err {bf16_rel:.3e}")
    del p16, A16, xp16, yk, yp

    print(f"launch counts on the solver path: {g_launches}")
    for k in ("psdia", "sdia", "sdia_bf16"):
        require(g_launches.get(k, 0) > 0, f"{k} never launched in 4g")

    # -- 4h. bf16 general plans, refinement, SpGEMM and checkpoints ---------
    print(f"== 4h. bf16 coefficients on the general arm, mixed-precision "
          f"refinement on general matrices, SpGEMM and checkpoints "
          f"(counters zeroed; {card})")
    t4h = time.perf_counter()

    def bf16_rounded(m):
        """scipy CSR of ``m``'s values rounded to bf16 as the planner
        rounds them (held as float64)."""
        r = m.tocsr().astype(np.float64)
        r.data = torch.from_numpy(r.data).to(torch.bfloat16).double().numpy()
        return r

    lap_n = utils.laplacian_2d(2048)
    zero(*counters)
    # the main path: plan_spmv(dtype=bfloat16) -> plan(x) on the general
    # operands (the natural-order Poisson with sliced ELL forced, as phase
    # 5's K4), then ir_solve with a bf16 low plan, then A^2 by spgemm
    h16 = {}
    for name, m, want in (
            ("random_sparse(2000000,8e-6)",
             general["random_sparse(2000000,8e-6)"], "gpr"),
            ("shuffled laplacian_2d(2048)",
             general["shuffled laplacian_2d(2048)"], "pallas_ell"),
            ("natural laplacian_2d(2048) (forced)", lap_n, "pallas_ell")):
        t0 = time.perf_counter()
        if name.startswith("natural"):
            p16 = plan_from_matrix(ell.pack_ell(
                m, dtype=torch.bfloat16, device=dev), "pallas_ell")
        else:
            p16 = plan_spmv(m, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        ps = time.perf_counter() - t0
        require(p16.strategy == want, f"bf16 {name} planned to "
                f"{p16.strategy}, not {want}")
        A16 = p16.matrix
        require(A16.dtype == torch.bfloat16, f"bf16 {name}: {A16.dtype}")
        xh = gx.get(name)
        if xh is None:
            xh = torch.tensor(rng.random(m.shape[1]), dtype=torch.float32,
                              device=dev)
        y16 = p16(xh)
        r16 = bf16_rounded(m)
        rel_r = verify_against_oracle(A16, xh, y16, oracle=r16, rounded=True)
        rel_u = verify_against_oracle(A16, xh, y16, oracle=m)
        print(f"  plan_spmv(dtype=bfloat16) {name}: {want}, y "
              f"{y16.dtype} | vs scipy f64 of the bf16-rounded matrix "
              f"{rel_r:.2e} (gate 2e-5) | bf16_data_rel_err (unrounded) "
              f"{rel_u:.3e} (gate 2e-2) | host planning {ps:.2f} s")
        h16[name] = (m, A16, xh)
        del y16, r16

    # mixed-precision refinement on general matrices: a float32 plan's
    # true residual, a bf16 plan inside
    def ir_general(label, m, want):
        hi = plan_spmv(m, dtype=torch.float32, device=dev)
        lo = plan_spmv(m, dtype=torch.bfloat16, device=dev)
        require(hi.strategy == lo.strategy == want,
                f"{label}: plans {hi.strategy}/{lo.strategy}")
        b64 = m @ rng.random(m.shape[0])
        bt = torch.tensor(b64, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ires = ir_solve(hi, bt, low=lo, inner_iters=32, maxiter=60,
                        tol=1e-6)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tr = float(np.linalg.norm(b64 - m @ ires.x.cpu().double().numpy())
                   / np.linalg.norm(b64))
        print(f"  ir_solve on {label} (hi {hi.strategy} f32, low "
              f"{lo.strategy} bf16, 32 inner steps): "
              f"{ires.outer_iterations} outer iterations, "
              f"{1e3 * secs / max(ires.outer_iterations, 1):.4f} ms an "
              f"outer cycle (host clock), converged="
              f"{bool(ires.converged)}, true rel residual (scipy f64) "
              f"{tr:.3e}")
        require(tr <= 1e-5, f"ir_solve on {label}: true residual {tr:.3e}")

    ir_general("P + P^T + diag (power law, 4b)", spd, "gpr")
    shs = (general["shuffled laplacian_2d(2048)"]
           + sp.identity(lap_n.shape[0], format="csr")).tocsr()
    ir_general("the shuffled 2048^2 Poisson, screened (A + I)", shs,
               "pallas_ell")
    del shs

    # A^2 of the 4096^2 Poisson by the DIA assembly, packed for K1, against
    # two K2 products on 4a's PSDIA pack
    t0 = time.perf_counter()
    mc = mat.tocoo()
    D = DIA.from_coo(COO.from_arrays(mc.row, mc.col, mc.data, mat.shape,
                                     dtype=torch.float32, sort=False)).to(dev)
    del mc
    torch.cuda.synchronize()
    dia_s = time.perf_counter() - t0
    start.record()
    D2 = spgemm(D, D)
    end.record()
    end.synchronize()
    spgemm_ms = start.elapsed_time(end)
    require(len(D2.offsets) == 13, f"spgemm(A, A): {len(D2.offsets)} "
            f"diagonals")
    S2 = ds.pack_sdia(D2)
    y_sq = ds.spmv_sdia(S2, x)
    y_kk = plan(plan(x))
    torch.cuda.synchronize()
    rel_sq = float((y_sq - y_kk).abs().max() / y_kk.abs().max())
    print(f"  spgemm(A, A), 4096^2 Poisson DIA ({D.ndiags} diagonals, "
          f"host DIA {dia_s:.2f} s): {len(D2.offsets)} diagonals, nnz "
          f"{D2.nnz}, {spgemm_ms:.4f} ms on the card | pack_sdia rb={S2.rb}; "
          f"K1 on A^2 vs K2(K2(x)) rel {rel_sq:.2e} (limit 2e-5)")
    require(rel_sq <= 2e-5, f"spgemm(A, A) vs two K2 {rel_sq:.2e}")
    del D, D2, S2, y_sq, y_kk

    torch.cuda.synchronize()
    h_launches = {k: v for c in counters for k, v in c.items() if v}
    print(f"launch counts on the 4h path: {h_launches}")
    for k in ("gpr_bf16", "ell_bf16", "sdia", "psdia"):
        require(h_launches.get(k, 0) > 0, f"{k} never launched in 4h")

    # each bf16 kernel bitwise its plain version, timed beside the f32
    # kernel of the same matrix (CUDA events, median), its bound and one
    # cuSPARSE call on bf16 data and a bf16 x where torch has one
    bf16_records = []
    for kname, name, f32_pack, kern, plain, src_line in (
            ("gpr_spmv_bf16", "random_sparse(2000000,8e-6)",
             lambda m: gplans["random_sparse(2000000,8e-6)"].matrix,
             gpr.spmv_gpr_rows, gpr.spmv_gpr_ref,
             "tpu_spmv/kernels/gpr.py:712"),
            ("ell_spmv_bf16", "shuffled laplacian_2d(2048)",
             lambda m: gplans["shuffled laplacian_2d(2048)"].matrix,
             ell.spmv_ell_main, ell.spmv_ell_packed_ref,
             "tpu_spmv/kernels/ell_pallas.py:375"),
            ("ell_spmv_bf16", "natural laplacian_2d(2048) (forced)",
             lambda m: ell.pack_ell(m, dtype=torch.float32, device=dev),
             ell.spmv_ell_main, ell.spmv_ell_packed_ref,
             "tpu_spmv/kernels/ell_pallas.py:375")):
        m, A16, xh = h16[name]
        yk, yk2, yp = kern(A16, xh), kern(A16, xh), plain(A16, xh)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        same = torch.equal(yk, yp)
        require(same and torch.equal(yk, yk2), f"{kname} {name}: not "
                f"bitwise its plain version (max abs err {err:.3e})")
        del yk, yk2, yp
        A32 = f32_pack(m)
        ms = time_fn(kern, A16, xh, iters=50).median_s * 1e3
        ms32 = time_fn(kern, A32, xh, iters=50).median_s * 1e3
        plain_ms = time_fn(plain, A16, xh, iters=3).median_s * 1e3
        nbytes = spmv_bytes(A16, torch.float32)
        bound_ms, bound_by = bound(nbytes, 2 * A16.nnz)
        bound32 = bound(spmv_bytes(A32, torch.float32), 2 * A32.nnz)[0]
        try:
            lib_ms = library_ms(m, xh.to(torch.bfloat16))
            lib_txt = f"cuSPARSE bf16 torch.mv {lib_ms:.4f} ms"
        except RuntimeError as e:
            lib_ms = None
            lib_txt = (f"library: none (torch.mv on a bf16 sparse CSR "
                       f"tensor refused: {str(e).splitlines()[0][:120]})")
        print(f"{kname} {name}: {ms:.4f} ms | bound {bound_ms:.4f} ms "
              f"({bound_by}, {100 * bound_ms / ms:.1f}%; {nbytes} B) | f32 "
              f"kernel {ms32:.4f} ms (bound {bound32:.4f}, "
              f"{100 * bound32 / ms32:.1f}%; bf16/f32 {ms / ms32:.3f}) | "
              f"plain {plain_ms:.4f} ms | {lib_txt} | bitwise plain "
              f"{same} | launches in 4h "
              f"{h_launches.get(kname.replace('_spmv', ''), 0)} ({card})")
        if name.startswith("natural"):
            continue                   # a side line, not the kernel's record
        bf16_records.append({
            "name": kname, "route": "cuda",
            "source": "tpu_spmv_torch/csrc/general.cu",
            "replaces": src_line,
            "launches": h_launches.get(kname.replace("_spmv", ""), 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
        del A32
    del h16

    # spgemm_csr: the host symbolic phase, then the device numeric phase
    # (timed alone), twice for the bits, against scipy A @ A
    for label, m, dt, tol in (
            ("random_sparse(100000,7e-5)^2",
             general["random_sparse(100000,7e-5)"], torch.float32, 2e-5),
            ("bus420.mtx^2", bus, torch.float64, 1e-12)):
        As = m.tocsr()
        As.sort_indices()
        t0 = time.perf_counter()
        pa, pb, seg, _, _, _ = _symbolic(As, As, 200_000_000)
        sym_s = time.perf_counter() - t0
        args_n = (torch.tensor(As.data, dtype=dt, device=dev),) * 2 + tuple(
            torch.from_numpy(a).to(dev) for a in (pa, pb, seg))
        num_ms = time_fn(_numeric, *args_n, iters=20).median_s * 1e3
        C1 = spgemm_csr(m, m, dtype=dt, device=dev)
        C2 = spgemm_csr(m, m, dtype=dt, device=dev)
        ref = (As @ As).tocsr()
        ref.sort_indices()
        same_pat = (np.array_equal(C1.indptr.cpu().numpy(), ref.indptr)
                    and np.array_equal(C1.indices.cpu().numpy(),
                                       ref.indices))
        rel_c = rel_err(C1.data.cpu(), ref.data)
        print(f"  spgemm_csr {label} {str(dt)[6:]}: {len(pa)} pairs -> "
              f"{C1.nnz} entries; host symbolic {sym_s:.3f} s, device "
              f"numeric {num_ms:.4f} ms | pattern equal scipy {same_pat} | "
              f"rel err vs scipy {rel_c:.2e} (limit {tol:.0e}) | bitwise "
              f"twice {torch.equal(C1.data, C2.data)}")
        require(same_pat and rel_c <= tol and torch.equal(C1.data, C2.data),
                f"spgemm_csr {label}")
        del C1, C2, args_n

    # checkpoints: the power-law GPR plan of 4b and 4a's PSDIA plan, saved
    # and reloaded; each reloaded product bitwise the original's
    ckdir = ROOT / "build" / "chip_smoke_checkpoints"
    ckdir.mkdir(parents=True, exist_ok=True)
    for label, pl, xk in (
            ("power_law(400000,13)", gplans["power_law(400000,13)"],
             gx["power_law(400000,13)"]),
            ("4096^2 PSDIA", plan, x)):
        f = ckdir / f"{pl.strategy}.npz"
        t0 = time.perf_counter()
        save_matrix(f, pl.matrix, extra={"strategy": pl.strategy})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        A_l, extra = load_matrix(f, with_extra=True, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        pl2 = plan_from_matrix(A_l, extra["strategy"])
        same = torch.equal(pl(xk), pl2(xk))
        print(f"  checkpoint {label} ({pl.strategy}, "
              f"{f.stat().st_size / 2**20:.1f} MiB): pack "
              f"{pack_s[label]:.2f} s "
              f"| save {save_s:.3f} s | cache_load_s {load_s:.3f} | "
              f"reloaded product bitwise {same}")
        require(same, f"reloaded {label} differs")
        f.unlink()
        del A_l, pl2

    # the CLI on the user path of this slice: --auto --dtype bfloat16
    # --cache twice (the second run reloads, and writes a profile)
    cli = [sys.executable, "-m", "tpu_spmv_torch", "--synthetic",
           "powerlaw:400000,13", "--auto", "--dtype", "bfloat16", "--cache",
           str(ckdir), "--iters", "10"]
    for f in ckdir.glob("plan_*.npz"):
        f.unlink()
    prof_dir = ckdir / "profile"
    outs = []
    for k, extra in enumerate(([], ["--profile", str(prof_dir)])):
        t0 = time.perf_counter()
        out = subprocess.run(cli + extra, cwd=ROOT, capture_output=True,
                             text=True)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith(("planner:", "###", "    GPR",
                                   "profile:"))]
        print(f"  CLI run {k + 1} ({time.perf_counter() - t0:.1f} s, exit "
              f"{out.returncode}): " + " | ".join(ln.strip() for ln in lines))
        require(out.returncode == 0, f"CLI run {k + 1} failed:\n"
                f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
        outs.append(out.stdout)
    require("cached pack to" in outs[0] and "reloaded gpr pack" in outs[1],
            "the second --cache run did not reload the pack")
    trace = prof_dir / "trace.json"
    require(trace.exists() and trace.stat().st_size > 0,
            "--profile wrote no trace")
    print(f"  --profile: {trace.relative_to(ROOT)} "
          f"{trace.stat().st_size / 2**20:.1f} MiB")
    shutil.rmtree(ckdir)
    print(f"  (phase 4h {time.perf_counter() - t4h:.1f} s)")

    # -- 4i. bf16 data on the SpMMs and the distributed path ---------------
    print(f"== 4i. bf16 data on the SpMMs, cg_multi and the distributed "
          f"planner, the distributed SpMMs, the CLI (counters zeroed; "
          f"{card})")
    t4i = time.perf_counter()
    lap_name, big = "shuffled laplacian_2d(2048)", "random_sparse(2000000,8e-6)"
    zero(*counters)
    # the main path: plan_spmv(dtype=bfloat16) -> plan.spmm(X) on every
    # arm with a kernel (K3b on the widened pattern, K3a bf16, gpr_spmm
    # bf16, ell_spmm bf16), cg_multi_runner on a bf16 plan,
    # plan_dist_spmv(dtype=bfloat16) at 4 shards, the distributed SpMMs
    t0 = time.perf_counter()
    plan16 = plan_spmv(mat, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    p16_s = time.perf_counter() - t0
    require(plan16.strategy == "pdia_stream"
            and plan16.matrix.pattern.dtype == torch.bfloat16
            and plan16.matrix.rb == P.rb, "the bf16 plan of the Poisson")
    # the 32-RHS SDIA pack of 4c at bf16: pack_sdia(data_dtype=bfloat16,
    # nrhs=32)'s pack at the same tile (its data are the f32 pack's, cast)
    require(ds._auto_rb(S32.ndiags, S32.offsets, n, nrhs=NRHS, itemsize=2)
            == S32.rb, "the bf16 SDIA tile for 32 RHS differs from f32's")
    S16 = dataclasses.replace(S32, data=S32.data.to(torch.bfloat16))
    sdia16 = plan_from_matrix(S16, "dia_stream")
    ys = {"K3b (pdia_stream, widened pattern)": plan16.spmm(X),
          "K3a bf16 (dia_stream forced)": sdia16.spmm(X)}
    t0 = time.perf_counter()
    gp16 = {name: plan_spmv(general[name], dtype=torch.bfloat16, device=dev)
            for name in (big, lap_name)}
    gp16["natural laplacian_2d(2048) (forced)"] = plan_from_matrix(
        ell.pack_ell(lap_n, dtype=torch.bfloat16, device=dev), "pallas_ell")
    torch.cuda.synchronize()
    g16_s = time.perf_counter() - t0
    Xn = torch.rand(lap_n.shape[1], NRHS, generator=gen, device=dev)
    gX16 = {big: gX[big], lap_name: gX[lap_name],
            "natural laplacian_2d(2048) (forced)": Xn}
    for name, p in gp16.items():
        require(p.strategy == ("gpr" if name == big else "pallas_ell")
                and p.matrix.dtype == torch.bfloat16, f"bf16 {name}")
        ys[name] = p.spmm(gX16[name])
    # cg_multi_runner with 8 RHS on the bf16 plan of the screened Poisson
    # (4e's shift_diagonal on the bf16 pattern: 5 is exact in bf16)
    scr16 = plan_from_matrix(shift_diagonal(plan16.matrix, 1.0),
                             "pdia_stream")
    scr32 = plan_from_matrix(shift_diagonal(P, 1.0), "pdia_stream")
    B8 = torch.rand(n, 8, generator=gen, device=dev)
    run = cg_multi_runner(scr16, iters=40, report_tol=1e-5)
    run(B8)                                  # warm-up
    start.record()
    res8 = run(B8)
    end.record()
    end.synchronize()
    cgm16_ms = start.elapsed_time(end) / 40
    r40 = float((torch.linalg.norm(B8 - scr32.spmm(res8.x), dim=0)
                 / torch.linalg.norm(B8, dim=0)).max())
    # plan_dist_spmv(dtype=bfloat16) at 4 shards on the one card
    t0 = time.perf_counter()
    dplans = {"pdia_stream": tdist.plan_dist_spmv(mat, meshes[4],
                                                  dtype=torch.bfloat16),
              "dia_stream": tdist.plan_dist_spmv(mat, meshes[4],
                                                 dtype=torch.bfloat16,
                                                 strategy="dia_stream"),
              "gpr": tdist.plan_dist_spmv(general[big], meshes[4],
                                          dtype=torch.bfloat16)}
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t0
    dres = {}
    for strategy, dplan in dplans.items():
        require(dplan.strategy == strategy, f"bf16 dist plan picked "
                f"{dplan.strategy}, not {strategy}")
        host = general[big] if strategy == "gpr" else mat
        dres[strategy] = tdist.bench_dist_spmv(
            host, meshes[4], dtype=torch.bfloat16, plan=dplan, iters=20,
            quiet=True)
    # the distributed SpMMs at 4 shards, 8 RHS, on the shuffled Poisson
    msh = general[lap_name].astype(np.float32)   # float32 values and X
    X8h = rng.random((msh.shape[1], 8)).astype(np.float32)
    t0 = time.perf_counter()
    dspmm = {}
    for strategy, cls, fn in (
            ("csr_allgather", tdist.ShardedCSR, tdist.spmm_allgather),
            ("csr_halo", tdist.HaloCSR, tdist.spmm_halo),
            ("csr_neighbor", tdist.NeighborCSR, tdist.spmm_neighbor)):
        Ad = tdist.place(cls.build(msh, 4, square=True), meshes[4])
        Xs = tdist.place(tdist.ShardedVector.from_global(X8h, Ad.col_plan),
                         meshes[4])
        dspmm[strategy] = (Ad, Xs, fn, fn(meshes[4], Ad, Xs))
    torch.cuda.synchronize()
    dspmm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    i_launches = {k: v for c in counters for k, v in c.items() if v}
    print(f"launch counts on the 4i path: {i_launches}")
    for k in ("psdia_spmm", "sdia_spmm_bf16", "gpr_spmm_bf16",
              "ell_spmm_bf16", "sdia_ring_bf16", "psdia_ring", "gpr_bf16"):
        require(i_launches.get(k, 0) > 0, f"{k} never launched in 4i")
    print(f"  host planning: plan_spmv(4096^2 Poisson, bfloat16) "
          f"{p16_s:.2f} s (pattern {plan16.matrix.pattern.dtype}, rb "
          f"{plan16.matrix.rb}); the general bf16 plans {g16_s:.2f} s; "
          f"plan_dist_spmv(bfloat16) x 3 at 4 shards {dp_s:.2f} s; the "
          f"three CSR containers (host builds) and SpMMs {dspmm_s:.2f} s")

    # each product: against scipy float64 on the bf16-rounded matrix
    # (2e-5) and the unrounded one (2e-2) on two columns (the Poisson's
    # values are exact in bf16, so its two oracles are one); the
    # streaming SpMMs also bitwise the f32 plan's on exact values
    yf = plan.spmm(X)
    require(torch.equal(ys["K3b (pdia_stream, widened pattern)"], yf),
            "K3b on the bf16 plan differs from the f32 plan's product")
    e3a = float((ys["K3a bf16 (dia_stream forced)"] - yf).abs().max()
                / yf.abs().max())
    require(e3a <= PLAIN_TOL["float32"], f"K3a bf16 vs K3b f32 {e3a:.2e}")
    del yf
    for name, Y in ys.items():
        m = (general.get(name) if name in general else
             lap_n if name.startswith("natural") else mat)
        Xh = (X if name.startswith("K3") else gX16[name])
        cols = [0, NRHS - 1]
        Xc = Xh[:, cols].cpu().double().numpy()
        e_r = rel_err(Y[:, cols].cpu(), bf16_rounded(m) @ Xc)
        e_u = rel_err(Y[:, cols].cpu(), m @ Xc)
        print(f"  plan.spmm({NRHS} RHS) on the bf16 plan, {name}: y "
              f"{Y.dtype} | columns 0 and {NRHS - 1} vs scipy f64 of the "
              f"bf16-rounded matrix {e_r:.2e} (gate 2e-5), of the unrounded "
              f"one {e_u:.3e} (gate 2e-2)")
        require(Y.dtype == torch.float32 and e_r <= 2e-5 and e_u <= 2e-2,
                f"bf16 plan.spmm {name}: {e_r:.2e} / {e_u:.2e}")
    del ys
    tr8 = float(res8.residual_norm.max())
    print(f"  cg_multi_runner(iters=40) on the bf16 plan of the screened "
          f"4096^2 Poisson, 8 RHS (float32 B): {cgm16_ms:.4f} ms/iteration "
          f"(4c's f32 plan of the unscreened operator: "
          f"{cgm['laplacian_2d(4096)']:.4f}) | max true rel residual (the "
          f"f32 plan's product) {r40:.3e} (limit 1e-5)")
    require(np.isfinite(r40) and r40 <= 1e-5 and np.isfinite(tr8),
            f"cg_multi on the bf16 plan: {r40:.3e}")
    del B8, res8, run, scr16, scr32
    # the distributed bf16 plans: the chain's product bitwise the
    # single-card bf16 plan's, and its time beside that plan's chain
    # (parity), each checked by bench_dist_spmv's bf16 gate
    single = {"pdia_stream": (plan16.matrix, ds.spmv_psdia_padded),
              "dia_stream": (dataclasses.replace(
                  S, data=S.data.to(torch.bfloat16)), ds.spmv_sdia_padded),
              "gpr": (gp16[big].matrix, gpr.spmv_gpr)}
    dist_bf16_ms = {}
    for strategy, dplan in dplans.items():
        A1, fn1 = single[strategy]
        host = general[big] if strategy == "gpr" else mat
        xh = rng.random(host.shape[1]).astype(np.float32)
        xd = torch.from_numpy(xh).to(dev)
        x1 = ds.pad_x(A1, xd) if strategy != "gpr" else xd
        y1 = fn1(A1, x1)
        yd = dplan.spmv(dplan.shard_x(xh))
        flat = torch.cat([c.to(dev) for c in yd.chunks])
        same = torch.equal(flat[:y1.shape[0]], y1)
        sc = 1.0 / float(abs(host).sum(axis=1).max())
        one_ms = time_chained(lambda v: fn1(A1, v) * sc, x1,
                              iters=20).median_s * 1e3
        r = dres[strategy]
        dist_bf16_ms[strategy] = (r["seconds"] * 1e3, one_ms)
        kern = {"pdia_stream": "K8b on the widened pattern",
                "dia_stream": "K8a bf16", "gpr": "gpr_spmv bf16"}[strategy]
        print(f"  plan_dist_spmv(dtype=bfloat16), 4 shards on one card, "
              f"{'4096^2 Poisson' if strategy != 'gpr' else big} -> "
              f"{strategy} ({kern}): {r['seconds'] * 1e3:.4f} ms per SpMV | "
              f"the single-card bf16 plan's chain {one_ms:.4f} ms -> parity "
              f"{r['seconds'] * 1e3 / one_ms:.3f} | bitwise the single-card "
              f"product {same} | rel err vs scipy (unrounded, gate 2e-2) "
              f"{r['rel_err']:.3e}")
        require(same or strategy == "gpr", f"bf16 {strategy} at 4 shards "
                f"not bitwise the single-card product")
        del xd, x1, y1, yd, flat
    ref8 = msh @ X8h.astype(np.float64)
    for strategy, (Ad, Xs, fn, Y) in dspmm.items():
        e8 = rel_err(Y.to_global(), ref8)
        ms8 = time_fn(lambda: fn(meshes[4], Ad, Xs).chunks[0],
                      iters=10).median_s * 1e3
        x0 = tdist.place(tdist.ShardedVector.from_global(
            np.ascontiguousarray(X8h[:, 0]), Ad.col_plan), meshes[4])
        spmv_fn = {"csr_allgather": tdist.spmv_allgather,
                   "csr_halo": tdist.spmv_halo,
                   "csr_neighbor": tdist.spmv_neighbor}[strategy]
        c0 = rel_err(Y.to_global()[:, 0], spmv_fn(meshes[4], Ad,
                                                 x0).to_global())
        print(f"  {fn.__name__} ({strategy}), 4 shards on one card, 8 RHS, "
              f"{lap_name} (torch code): {ms8:.4f} ms | vs scipy f64 "
              f"{e8:.2e} | column 0 vs the SpMV {c0:.2e}")
        require(e8 <= ORACLE_TOL["float32"] and c0 <= PLAIN_TOL["float32"],
                f"{fn.__name__}: {e8:.2e} / {c0:.2e}")
    del dspmm, dplans, dres, ref8

    # the four bf16-data forms at the main path's shapes: bitwise their
    # plain versions, timed beside the f32 kernel of the same matrix, the
    # bound and cuSPARSE on bf16 data where torch has one call
    def lib_bf16(m, v):
        try:
            return library_ms(m, v.to(torch.bfloat16)), "cuSPARSE bf16"
        except RuntimeError as e:
            return None, (f"library: none (refused: "
                          f"{str(e).splitlines()[0][:100]})")

    def plain_rows(fn, A, V, chunk):
        """The plain version over chunks of the RHS (the bf16-data SpMMs'
        plain versions hold float64 temporaries)."""
        return torch.cat([fn(A, V[:, i:i + chunk]) for i in
                          range(0, V.shape[1], chunk)], dim=1)

    S1 = single["dia_stream"][0]
    A1 = tdist.ShardedSDIA.build(S1, 1)
    xk1 = A1.shard_xpad(ds.pad_x(S1, x)).chunks[0]
    l1, r1 = xk1[-A1.halo:], xk1[:A1.halo]
    F32 = dist1["dia_stream"]
    Xe = gX16["natural laplacian_2d(2048) (forced)"]
    bf16_spmm_records = []
    for kname, A16, A32, kern, plain, v, m, lib_v, nrhs, key, src, line in (
            ("sdia_spmm_bf16", S16, S32, ds.spmm_sdia_padded_t,
             lambda A, V: torch.cat([ds.spmm_sdia_padded_t_ref(
                 A, V[i:i + 8]) for i in range(0, V.shape[0], 8)]),
             Xt, mat, X, NRHS, "sdia_spmm_bf16",
             "tpu_spmv_torch/csrc/dia_stream.cu",
             "tpu_spmv/kernels/dia_stream.py:339"),
            ("gpr_spmm_bf16", gp16[big].matrix, gplans[big].matrix,
             gpr.spmm_gpr_rows,
             lambda A, V: plain_rows(gpr.spmm_gpr_ref, A, V, 8),
             gX16[big], general[big], gX16[big], NRHS, "gpr_spmm_bf16",
             "tpu_spmv_torch/csrc/general.cu",
             "tpu_spmv/kernels/gpr.py:964"),
            ("ell_spmm_bf16", gp16[lap_name].matrix, gplans[lap_name].matrix,
             ell.spmm_ell_main,
             lambda A, V: plain_rows(ell.spmm_ell_packed_ref, A, V, 8),
             gX16[lap_name], general[lap_name], gX16[lap_name], NRHS,
             "ell_spmm_bf16", "tpu_spmv_torch/csrc/general.cu",
             "tpu_spmv/kernels/ell_pallas.py:407"),
            ("ell_spmm_bf16", gp16["natural laplacian_2d(2048) (forced)"]
             .matrix, ell.pack_ell(lap_n, dtype=torch.float32, device=dev),
             ell.spmm_ell_main,
             lambda A, V: plain_rows(ell.spmm_ell_packed_ref, A, V, 8),
             Xe, lap_n, Xe, NRHS, None, "", "natural order"),
            ("sdia_ring_bf16", A1, F32,
             lambda A, v: dst.spmv_sdia_ring(A.data[0], A.offsets, v, l1,
                                             r1),
             lambda A, v: dst.spmv_sdia_ring_ref(A.data[0], A.offsets, v, l1,
                                                 r1),
             xk1, mat, x, 0, "sdia_ring_bf16",
             "tpu_spmv_torch/csrc/dist_stream.cu",
             "tpu_spmv/dist/planned.py:342")):
        yk, yk2, yp = kern(A16, v), kern(A16, v), plain(A16, v)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        same = torch.equal(yk, yp)
        require(same and torch.equal(yk, yk2), f"{kname} ({line}): not "
                f"bitwise its plain version (max abs err {err:.3e})")
        if kname == "sdia_ring_bf16":
            k1 = ds.spmv_sdia_padded(S1, ds.pad_x(S1, x))
            require(torch.equal(yk[:S1.npad], k1), "K8a bf16 at one shard "
                    "not bitwise K1 bf16")
            del k1
            ring_extra(A1, S1, x, xk1, l1, r1, "bf16")
        del yk, yk2, yp
        ms = time_fn(kern, A16, v, iters=20).median_s * 1e3
        ms32 = time_fn(kern, A32, v, iters=20).median_s * 1e3
        plain_ms = time_fn(plain, A16, v, iters=1, warmup=1,
                           repeats=2).median_s * 1e3
        nbytes = (spmm_bytes(A16, nrhs, torch.float32) if nrhs
                  else spmv_bytes(A16, torch.float32))
        nnz = A16.nnz
        bound_ms, bound_by = bound(nbytes, 2 * nnz * max(nrhs, 1))
        b32 = bound(spmm_bytes(A32, nrhs, torch.float32) if nrhs
                    else spmv_bytes(A32, torch.float32),
                    2 * nnz * max(nrhs, 1))[0]
        lib_ms, lib_txt = lib_bf16(m, lib_v)
        if lib_ms is not None:
            lib_txt = f"{lib_txt} {lib_ms:.4f} ms"
        print(f"{kname} ({line}, {nrhs or 1} RHS): {ms:.4f} ms | bound "
              f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%; "
              f"{nbytes} B) | f32 kernel {ms32:.4f} ms (bound {b32:.4f}, "
              f"{100 * b32 / ms32:.1f}%; bf16/f32 {ms / ms32:.3f}) | plain "
              f"{plain_ms:.4f} ms | {lib_txt} | bitwise plain {same} | "
              f"launches in 4i {i_launches.get(key, 0) if key else '-'} "
              f"({card})")
        if key is None:
            continue                   # a side line, not the kernel's record
        bf16_spmm_records.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": line, "launches": i_launches.get(key, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    del S16, sdia16, gp16, gX16, Xn, plan16, single, A1, xk1, l1, r1, F32

    # the CLI as a subprocess at bf16: --spmm, --dist (all shards on this
    # card) and --solve cg --solve-nrhs on a 1024^2 Poisson
    cli16 = [sys.executable, "-m", "tpu_spmv_torch", "--synthetic",
             "laplacian:1024", "--auto", "--dtype", "bfloat16", "--spmm",
             str(NRHS), "--dist", "4", "--solve", "cg", "--solve-nrhs", "8",
             "--tol", "1e-5", "--formats", "csr", "--iters", "10",
             "--device", "cuda:0"]
    t0 = time.perf_counter()
    out = subprocess.run(cli16, cwd=ROOT, capture_output=True, text=True)
    lines = [ln.strip() for ln in out.stdout.splitlines()
             if ln.startswith(("planner:", "###", "    DIST", "    CG x"))]
    print(f"  CLI {' '.join(cli16[3:])} ({time.perf_counter() - t0:.1f} s, "
          f"exit {out.returncode}): " + " | ".join(lines))
    require(out.returncode == 0, f"the bf16 CLI failed:\n"
            f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    for want in (f"### PSDIA SPMM{NRHS} GFLOPS", f"### CSR SPMM{NRHS} GFLOPS",
                 "DIST4: strategy=pdia_stream", "CG x8 (pdia_stream)",
                 "converged=True"):
        require(want in out.stdout, f"the bf16 CLI printed no {want!r}")
    print(f"  (phase 4i {time.perf_counter() - t4i:.1f} s)")

    # -- 4j. the distributed solvers at full width --------------------------
    j4 = dist_solvers_phase(card, counters)

    # -- 5. kernels vs plain at the main paths' shapes, timed ---------------
    print("== 5. kernels vs plain versions at the main paths' shapes")
    # the probe path first (its bandwidth probes set the roofline's peak),
    # counters zeroed just before it and read just after
    zero(pr.LAUNCHES)
    probe_ms = pr.run_probes(dev)
    torch.cuda.synchronize()
    plaunches = dict(pr.LAUNCHES)
    print(f"launch counts on the probe path: {plaunches}")
    for k, c in plaunches.items():
        require(c > 0, f"{k} never launched on the probe path")
    breakdown = host_breakdown(dev)
    print(f"host breakdown of one launch, us per call by the host clock over "
          f"10,000 calls each ({card}):")
    for label, us in breakdown.items():
        print(f"    {us:8.3f} us  {label}")
    m256f = utils.laplacian_2d(256)
    plan256 = plan_spmv(m256f, dtype=torch.float32, device=dev)
    # b = A x_true, as in 4a: its residual falls from the first iterations
    b256f = torch.tensor(m256f @ rng.random(m256f.shape[0]),
                         dtype=torch.float32, device=dev)
    run = cg_runner(plan256, iters=200, report_tol=1e-5)
    run(b256f)                                       # warm-up
    zero(ds.LAUNCHES)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    res = run(b256f)
    end.record()
    end.synchronize()
    cg256_ms = start.elapsed_time(end) / 200
    k2_256 = ds.LAUNCHES["psdia"]
    r256 = float(torch.linalg.norm(b256f - plan256(res.x))
                 / torch.linalg.norm(b256f))
    print(f"cg_runner(iters=200) f32 on laplacian_2d(256) via "
          f"{plan256.strategy}: {cg256_ms:.4f} ms/iteration | K2 launches "
          f"{k2_256} | true rel residual {r256:.3e}")
    require(plan256.strategy == "pdia_stream" and k2_256 > 0,
            "the 256^2 CG did not run through K2")
    require(np.isfinite(r256) and r256 < 0.1, "256^2 CG residual did not fall")
    del plan256, b256f, run, res
    copy_gbps = measured_copy_gbps(dev)
    print(f"bandwidth probes over 256 MiB: copy_scale (K9) "
          f"{probe_ms['copy_scale_gbps']:.1f} GB/s, torch copy_ "
          f"{probe_ms['copy__gbps']:.1f} GB/s -> roofline peak (the higher) "
          f"{copy_gbps:.1f} GB/s = {100 * copy_gbps * 1e9 / PEAK_BYTES_S:.1f}% "
          f"of 3.35 TB/s ({card})")
    records = []
    spmv_ms = {}

    def timed(kname, A, kern, plain, xk, m, label, nrhs=0, lib_x=None):
        """Time one kernel, its plain version and the cuSPARSE yardstick
        at one shape (an SpMM with ``nrhs`` right-hand sides; ``lib_x``
        the unpadded operand for cuSPARSE); returns the record's
        numbers."""
        yk, yp = kern(A, xk), plain(A, xk)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        rel_p = err / float(yp.abs().max())
        require(rel_p <= PLAIN_TOL["float32"], f"{kname} {label} vs plain "
                f"at full size {rel_p:.2e}")
        del yk, yp
        ms = time_fn(kern, A, xk, iters=20 if nrhs else 50).median_s * 1e3
        plain_ms = time_fn(plain, A, xk, iters=2 if nrhs else 5).median_s * 1e3
        if lib_x is None:
            lib_x = (xk if xk.shape[0] == m.shape[1] else
                     xk[A.L:A.L + m.shape[1]])
        lib_ms = library_ms(m, lib_x)
        nbytes = (spmm_bytes(A, nrhs, torch.float32) if nrhs
                  else spmv_bytes(A, torch.float32))
        flops = 2 * A.nnz * max(nrhs, 1)
        bound_ms, bound_by = bound(nbytes, flops)
        copy_ms = nbytes / (copy_gbps * 1e9) * 1e3
        print(f"{kname} {label} f32: {ms:.4f} ms "
              f"({flops / (ms * 1e-3) / 1e9:.1f} GFLOP/s, model "
              f"{nbytes / ms / 1e6:.1f} GB/s) | bound {bound_ms:.4f} ms "
              f"({bound_by}, {100 * bound_ms / ms:.1f}%) | copy-rate bound "
              f"{copy_ms:.4f} ms ({100 * copy_ms / ms:.1f}%) | plain "
              f"{plain_ms:.4f} ms | cuSPARSE {lib_ms:.4f} ms "
              f"(kernel/cuSPARSE {ms / lib_ms:.2f}) | max abs err "
              f"{err:.3e} (rel {rel_p:.2e})")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "copy_bound_ms": copy_ms, "library_ms": lib_ms}

    # K2 runs the walk of csrc/psdia_walk.cuh that its host plan picks
    k2_plan = ds.psdia_walk_plan(P.offsets, P.period, 4)
    k2_label = (f"{mat.shape[0]} rows, psdia_walk_stride S="
                f"{k2_plan.stride * ds.WALK_TILE}"
                f"{', coefficients once a segment' if k2_plan.reuse else ''}"
                f", bulk copies, {k2_plan.ahead} windows in flight"
                if k2_plan.stride else
                f"{mat.shape[0]} rows, psdia_walk_clusters")
    for kname, A, kern, plain, src_line, key, src, label in (
            ("psdia_spmv", P, ds.spmv_psdia_padded, ds.spmv_psdia_padded_ref,
             "tpu_spmv/kernels/dia_stream.py:733", "psdia",
             "tpu_spmv_torch/csrc/psdia_walk.cuh", k2_label),
            ("sdia_spmv", S, ds.spmv_sdia_padded, ds.spmv_sdia_padded_ref,
             "tpu_spmv/kernels/dia_stream.py:221", "sdia",
             "tpu_spmv_torch/csrc/dia_stream.cu", f"{mat.shape[0]} rows")):
        nums = timed(kname, A, kern, plain, ds.pad_x(A, x), mat, label)
        spmv_ms[kname, "4096^2"] = nums["ms"]
        records.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": src_line, "launches": launches[key],
                        **nums})
    # K1 on bf16 data on 4a's SDIA pack (its data cast to bf16: the pack
    # pack_sdia(data_dtype=bfloat16) makes at the same tile, checked in
    # 4g); no library call computes bf16 data with f32 sums
    S16 = dataclasses.replace(S, data=S.data.to(torch.bfloat16))
    xp16 = ds.pad_x(S16, x)
    yk, yp = ds.spmv_sdia_padded(S16, xp16), ds.spmv_sdia_padded_ref(S16, xp16)
    torch.cuda.synchronize()
    err16 = float((yk - yp).abs().max())
    rel16 = err16 / float(yp.abs().max())
    same16 = torch.equal(yk, yp)
    require(same16, f"K1 bf16 not bitwise its plain version ({rel16:.2e})")
    del yk, yp
    ms16 = time_fn(ds.spmv_sdia_padded, S16, xp16, iters=50).median_s * 1e3
    plain16 = time_fn(ds.spmv_sdia_padded_ref, S16, xp16,
                      iters=5).median_s * 1e3
    bytes16 = (2 * S16.ndiags + 8) * S16.npad
    bound16, by16 = bound(bytes16, 2 * S16.nnz)
    k1 = next(r for r in records if r["name"] == "sdia_spmv")
    try:
        lib16 = library_ms(mat, x.to(torch.bfloat16))
        lib16_txt = f"cuSPARSE bf16 torch.mv {lib16:.4f} ms"
    except RuntimeError as e:
        lib16, lib16_txt = None, (f"library: none (torch.mv on a bf16 "
                                  f"sparse CSR tensor refused: "
                                  f"{str(e).splitlines()[0][:100]})")
    print(f"sdia_spmv_bf16 (K1 on bf16 data) {mat.shape[0]} rows: "
          f"{ms16:.4f} ms ({bytes16 / ms16 / 1e6:.1f} GB/s model) | bound "
          f"{bound16:.4f} ms ({by16}, {100 * bound16 / ms16:.1f}%; "
          f"(2 ndiags + 8) npad = {bytes16} B) | plain {plain16:.4f} ms | K1 "
          f"f32 {k1['ms']:.4f} ms (bound {k1['bound_ms']:.4f}, cuSPARSE "
          f"{k1['library_ms']:.4f}; bf16/f32 {ms16 / k1['ms']:.3f}) | "
          f"{lib16_txt} | bitwise plain {same16} | "
          f"launches in 4g {g_launches.get('sdia_bf16', 0)} ({card})")
    records.append({"name": "sdia_spmv_bf16", "route": "cuda",
                    "source": "tpu_spmv_torch/csrc/dia_stream.cu",
                    "replaces": "tpu_spmv/kernels/dia_stream.py:269",
                    "launches": g_launches.get("sdia_bf16", 0),
                    "max_abs_err": err16, "ms": ms16, "plain_ms": plain16,
                    "bound_ms": bound16, "bound_by": by16,
                    "library_ms": lib16})
    del S16, xp16
    plan_ms = time_fn(plan, x, iters=50).median_s * 1e3
    print(f"plan(x) end to end (pad + K2 + unpad): {plan_ms:.4f} ms")
    # K8b and K8a on the one shard of the 4096^2 packs (phase 4d, ndev=1):
    # the kernel's shape on the main path; the bound counts the pack, x and
    # y (at one shard no value crosses between shards: K2's / K1's count)
    dist_records = []
    for kname, A, src_line, key in (
            ("psdia_ring_spmv", dist1["pdia_stream"],
             "tpu_spmv/dist/planned.py:545", "psdia_ring"),
            ("sdia_ring_spmv", dist1["dia_stream"],
             "tpu_spmv/dist/planned.py:342", "sdia_ring")):
        xk = A.shard_xpad(ds.pad_x(A, x)).chunks[0]
        left, right = xk[-A.halo:], xk[:A.halo]
        if key == "psdia_ring":
            kw = dict(base=0, L=A.L, nrow=A.shape[0])
            kern = lambda A_, v: dst.spmv_psdia_ring(    # noqa: E731
                A_.pattern[0], A_.offsets, v, left, right, **kw,
                plan=A_.ring_plan)
            plain = lambda A_, v: dst.spmv_psdia_ring_ref(   # noqa: E731
                A_.pattern[0], A_.offsets, v, left, right, **kw)
        else:
            kern = lambda A_, v: dst.spmv_sdia_ring(     # noqa: E731
                A_.data[0], A_.offsets, v, left, right)
            plain = lambda A_, v: dst.spmv_sdia_ring_ref(    # noqa: E731
                A_.data[0], A_.offsets, v, left, right)
        nums = timed(kname, A, kern, plain, xk, mat,
                     f"{mat.shape[0]} rows, one shard (Cp={A.rows_per_shard},"
                     f" h={A.halo})")
        dist_records.append({"name": kname, "route": "cuda",
                             "source": ("tpu_spmv_torch/csrc/psdia_walk.cuh"
                                        if key == "psdia_ring" else
                                        "tpu_spmv_torch/csrc/dist_stream.cu"),
                             "replaces": src_line, "launches": dlaunches[key],
                             **nums})
        if key == "sdia_ring":
            ring_extra(A, S, x, xk, left, right, "f32")
        if key == "psdia_ring":
            # the walks of K8b on the one shard and of K2 on the pack, in
            # turns: the plan's pick (bulk copies), the stride walk with
            # the coefficients staged per tile, the cluster walk; every one
            # bitwise K2's plan
            walks = {"plan": A.ring_plan,
                     "per tile": ds.psdia_walk_plan(A.offsets, A.rb, 4),
                     "clusters": ds.psdia_cluster_walk(A.offsets, 4)}
            xp_ = ds.pad_x(P, x)
            k2 = ds.spmv_psdia_padded(P, xp_)
            for wname, wplan in walks.items():
                same = (torch.equal(dst.spmv_psdia_ring(
                    A.pattern[0], A.offsets, xk, left, right, **kw,
                    plan=wplan)[:P.npad], k2)
                    and torch.equal(ds._spmv_psdia_launch(P, xp_, wplan), k2))
                require(same, f"K8b's or K2's {wname} walk at 4096^2 not "
                        f"bitwise K2")
            t = interleaved_ms({
                **{f"K8b {w}": (lambda wp: lambda: dst.spmv_psdia_ring(
                    A.pattern[0], A.offsets, xk, left, right, **kw,
                    plan=wp))(wp) for w, wp in walks.items()},
                **{f"K2 {w}": (lambda wp: lambda: ds._spmv_psdia_launch(
                    P, xp_, wp))(wp) for w, wp in walks.items()}},
                50, rounds=5)
            bk = nums["bound_ms"]
            print(f"    K8b's and K2's walks in turns ({card}): "
                  + " | ".join(f"{w} {v:.4f} ms ({100 * bk / v:.1f}% of the "
                               f"bound)" for w, v in t.items())
                  + " | every walk bitwise K2 True")
            for w, wp in walks.items():
                print(f"      {w}: {wp}")
            del xp_, k2
    del dist1
    spmm_records = []
    # each SpMM beside the SpMV kernel it is compared with (K3b beside K2,
    # K3a beside K1): NRHS launches of that kernel, timed at 4096^2 above
    for kname, A, kern, plain, src_line, compared_spmv in (
            ("psdia_spmm", P32, ds.spmm_psdia_padded_t,
             ds.spmm_psdia_padded_t_ref,
             "tpu_spmv/kernels/dia_stream.py:875", "psdia_spmv"),
            ("sdia_spmm", S32, ds.spmm_sdia_padded_t,
             ds.spmm_sdia_padded_t_ref,
             "tpu_spmv/kernels/dia_stream.py:339", "sdia_spmv")):
        nums = timed(kname, A, kern, plain, Xt, mat,
                     f"{n} rows, {NRHS} RHS (rb {A.rb})", nrhs=NRHS, lib_x=X)
        print(f"    {NRHS} x {compared_spmv} at 4096^2: "
              f"{NRHS * spmv_ms[compared_spmv, '4096^2']:.4f} ms")
        spmm_records.append({"name": kname, "route": "cuda",
                             "source": "tpu_spmv_torch/csrc/dia_stream.cu",
                             "replaces": src_line,
                             "launches": mlaunches[kname], **nums})
    # K3b's and K3a's two walks on the same pack, timed in turns: the
    # plan's pick (the stride walk at 4096^2) and the cluster walk (one
    # window per cluster of offsets a tile); K3b also at cg_multi_runner's
    # shape, 8 RHS on the plan's own pack (4c), beside 8 launches of K2,
    # and K3a at 8 RHS on its 32-RHS pack
    X8 = F.pad(X[:, :8].T, (P.L, P.npad - P.L - n)).contiguous()
    x8 = [X8[q] for q in range(8)]
    libs = {}
    for kname, A, Xk, extra in (
            ("psdia_spmm", P32, Xt, {}),
            ("psdia_spmm", P, X8, {"8 x K2": lambda: [
                ds.spmv_psdia_padded(P, v) for v in x8]}),
            ("sdia_spmm", S32, Xt, {}),
            ("sdia_spmm", S32, Xt[:8], {})):
        k = Xk.shape[0]
        pick = ds.psdia_spmm_plan(A.offsets, k, 4)
        clusters = ds._cluster_walk(A.offsets, k, 4)
        walks = interleaved_ms({
            "pick": lambda: ds._spmm_launch(A, Xk, pick),
            "clusters": lambda: ds._spmm_launch(A, Xk, clusters),
            **extra}, 5 if k == NRHS else 10)
        bk, _ = bound(spmm_bytes(A, k, torch.float32), 2 * A.nnz * k)
        same = torch.equal(ds._spmm_launch(A, Xk, pick),
                           ds._spmm_launch(A, Xk, clusters))
        if k not in libs:
            libs[k] = library_ms(mat, X[:, :k].contiguous())
        lib = libs[k]
        print(f"{kname} {n} rows, {k} RHS (rb {A.rb}) f32, in turns: "
              f"the plan's walk (stride {pick.stride}) {walks['pick']:.4f} "
              f"ms ({100 * bk / walks['pick']:.1f}% of {bk:.4f}) | cluster "
              f"walk ({clusters.nclusters} windows) {walks['clusters']:.4f} "
              f"ms ({100 * bk / walks['clusters']:.1f}%)"
              + (f" | 8 x K2 {walks['8 x K2']:.4f} ms" if extra else "")
              + f" | cuSPARSE {lib:.4f} ms | equal {same}")
        print(f"    plan {pick}")
        print(f"    cluster walk {clusters}")
        require(same, f"{kname}'s two walks differ at {k} RHS")
    del X8, x8
    pms = time_fn(plan.spmm, X, iters=10).median_s * 1e3
    print(f"plan.spmm(X) end to end ({NRHS} RHS: transpose and pad, K3b at "
          f"rb {P.rb}, slice and transpose): {pms:.4f} ms")
    del P, S, plan, x, P32, S32, X, Xt

    # both general kernels on every general operand: the planner's pick
    # and the other one forced, so the byte rule's choice can be judged
    recorded = {"gpr_spmv": "random_sparse(2000000,8e-6)",
                "ell_spmv": "shuffled laplacian_2d(2048)"}

    def embedding_bag(m):
        """One ``embedding_bag`` call of ``m @ X`` (the per-row sum of
        ``data[j] * X[indices[j]]``; a yardstick the port never calls),
        its int64 bags made once, outside the timed calls."""
        csr = m.tocsr()
        idx = torch.from_numpy(csr.indices.astype(np.int64)).to(dev)
        off = torch.from_numpy(csr.indptr[:-1].astype(np.int64)).to(dev)
        w = torch.from_numpy(csr.data).to(dev, torch.float32)
        return lambda X: F.embedding_bag(idx, X, off, mode="sum",
                                         per_sample_weights=w)

    for name, m in general.items():
        p, xg = gplans[name], gx[name]
        bag = embedding_bag(m)
        lib_A = csr_tensor(m, torch.float32, dev)
        for kname, strategy, pack, kern, plain in (
                ("gpr_spmv", "gpr", gpr.pack_gpr, gpr.spmv_gpr_rows,
                 gpr.spmv_gpr_ref),
                ("ell_spmv", "pallas_ell", ell.pack_ell, ell.spmv_ell_main,
                 ell.spmv_ell_packed_ref)):
            A = (p.matrix if p.strategy == strategy
                 else pack(m, dtype=torch.float32, device=dev))
            tag = "pick" if p.strategy == strategy else "forced"
            if kname == "gpr_spmv":
                print(f"    GPR rows per width class {gpr.CLASS_W}: "
                      f"{A.class_rows} (+{A.nv} virtual)")
            nums = timed(kname, A, kern, plain, xg, m, f"{name} ({tag})")
            spmv_ms[kname, name] = nums["ms"]
            if kname == "gpr_spmv":
                # embedding_bag (X of one column) in turns with the kernel
                xcol = xg[:, None]
                t = interleaved_ms({
                    "kernel": lambda: kern(A, xg),
                    "embedding_bag": lambda: bag(xcol)},
                    20 if name.startswith("random_sparse(1") else 5)
                nums["embedding_bag_ms"] = t["embedding_bag"]
                print(f"    gpr_spmv in turns with embedding_bag: "
                      f"{t['kernel']:.4f} ms | embedding_bag "
                      f"{t['embedding_bag']:.4f} ms")
            if recorded[kname] == name:
                records.append({
                    "name": kname, "route": "cuda",
                    "source": "tpu_spmv_torch/csrc/general.cu",
                    "replaces": ("tpu_spmv/kernels/gpr.py:684"
                                 if strategy == "gpr" else
                                 "tpu_spmv/kernels/ell_pallas.py:299"),
                    # 4b's launches and the distributed solvers' (4j),
                    # dist_bench's sweep also apart
                    "launches": sum(d.get("gpr" if strategy == "gpr"
                                          else "ell", 0)
                                    for d in (glaunches, j4["launches"])),
                    **({"dist_bench_launches":
                        j4["bench_launches"].get("gpr", 0)}
                       if strategy == "gpr" else {}),
                    **nums})
            del A
        pms = time_fn(p, xg, iters=20).median_s * 1e3
        print(f"plan(x) {name} via {p.strategy} end to end: {pms:.4f} ms")
        # the SpMMs at the 4c shapes: GPR on every operand (forced on the
        # shuffled Poisson), sliced ELL where the planner picks it
        Xg = gX[name]
        for kname, strategy, kern, plain, src_line in (
                ("gpr_spmm", "gpr", gpr.spmm_gpr_rows, gpr.spmm_gpr_ref,
                 "tpu_spmv/kernels/gpr.py:964"),
                ("ell_spmm", "pallas_ell", ell.spmm_ell_main,
                 ell.spmm_ell_packed_ref,
                 "tpu_spmv/kernels/ell_pallas.py:407")):
            if strategy == "pallas_ell" and p.strategy != strategy:
                continue
            A = p.matrix if p.strategy == strategy else forced[name]
            tag = "pick" if p.strategy == strategy else "forced"
            nums = timed(kname, A, kern, plain, Xg, m,
                         f"{name} ({tag}), {NRHS} RHS", nrhs=NRHS)
            if kname == "gpr_spmm":
                # embedding_bag and cuSPARSE in turns with the kernel, and
                # the kernel's rate of X lines (one line of NRHS values per
                # entry)
                t = interleaved_ms({
                    "kernel": lambda: kern(A, Xg),
                    "embedding_bag": lambda: bag(Xg),
                    "cuSPARSE": lambda: torch.sparse.mm(lib_A, Xg)}, 2)
                nums["embedding_bag_ms"] = t["embedding_bag"]
                line_gbs = m.nnz * NRHS * 4 / (nums["ms"] * 1e-3) / 1e9
                print(f"    gpr_spmm in turns: {t['kernel']:.4f} ms | "
                      f"embedding_bag {t['embedding_bag']:.4f} ms | cuSPARSE "
                      f"{t['cuSPARSE']:.4f} ms | X lines {m.nnz} x "
                      f"{NRHS * 4} B at {line_gbs:.1f} GB/s ({card})")
            spmv_name = kname.replace("spmm", "spmv")
            print(f"    {NRHS} x {spmv_name} on {name}: "
                  f"{NRHS * spmv_ms[spmv_name, name]:.4f} ms")
            if recorded[spmv_name] == name:
                spmm_records.append({
                    "name": kname, "route": "cuda",
                    "source": "tpu_spmv_torch/csrc/general.cu",
                    "replaces": src_line, "launches": mlaunches[kname],
                    **nums})
        pms = time_fn(p.spmm, Xg, iters=10).median_s * 1e3
        print(f"plan.spmm(X) {name} via {p.strategy} end to end, {NRHS} RHS: "
              f"{pms:.4f} ms")
        del bag, lib_A
    # K4 on the 2048x2048-grid Poisson in its natural order beside the
    # shuffled one above: the same slots and bytes, local x gathers
    lap_n = utils.laplacian_2d(2048)
    An = ell.pack_ell(lap_n, dtype=torch.float32, device=dev)
    xn = torch.tensor(rng.random(lap_n.shape[1]), dtype=torch.float32,
                      device=dev)
    nums_n = timed("ell_spmv", An, ell.spmv_ell_main, ell.spmv_ell_packed_ref,
                   xn, lap_n, "natural laplacian_2d(2048) (forced)")
    print(f"    ell_spmv on the 2048^2 Poisson, natural / shuffled order: "
          f"{nums_n['ms']:.4f} / "
          f"{spmv_ms['ell_spmv', 'shuffled laplacian_2d(2048)']:.4f} ms")
    # ell_spmm with 32 RHS on the same natural-order operand (local X
    # lines), in turns with gpr_spmm and cuSPARSE on the same X
    Gn = gpr.pack_gpr(lap_n, dtype=torch.float32, device=dev)
    Xn = torch.rand(lap_n.shape[1], NRHS, generator=gen, device=dev)
    libn = csr_tensor(lap_n, torch.float32, dev)
    rel = rel_err(ell.spmm_ell_packed(An, Xn).cpu(),
                  lap_n @ Xn.cpu().double().numpy())
    require(rel <= ORACLE_TOL["float32"], f"ell_spmm natural 2048^2 {rel:.2e}")
    t = interleaved_ms({
        "ell_spmm": lambda: ell.spmm_ell_main(An, Xn),
        "gpr_spmm": lambda: gpr.spmm_gpr_rows(Gn, Xn),
        "cuSPARSE": lambda: torch.sparse.mm(libn, Xn)}, 5)
    bn, _ = bound(spmm_bytes(An, NRHS, torch.float32), 2 * An.nnz * NRHS)
    print(f"ell_spmm natural laplacian_2d(2048), {NRHS} RHS f32, in turns "
          f"({card}): {t['ell_spmm']:.4f} ms ({100 * bn / t['ell_spmm']:.1f}% "
          f"of {bn:.4f}) | gpr_spmm {t['gpr_spmm']:.4f} ms | cuSPARSE "
          f"{t['cuSPARSE']:.4f} ms | rel err vs scipy {rel:.2e}")
    del An, Gn, xn, Xn, libn, lap_n
    # the gathers of 4e at their shapes.  A record is timed on the input
    # the main path gives its kernel -- the direct gather on the RCM perm
    # of the 1M band in its natural order, the two passes on ro(x)'s RCM
    # perm of the shuffled band -- rotating copies of its inputs that hold
    # four times the card's L2 and keeping every output, so that each call
    # reads from and writes to device memory, replayed from one CUDA graph;
    # the same calls repeated on one input (which then stays in L2) are
    # printed beside.  The identity and a random perm are side lines.
    l2_bytes = getattr(torch.cuda.get_device_properties(dev),
                       "L2_cache_size", 50 << 20)

    def copies(pplan, xk, nbytes):
        """``(plan, x)`` pairs with their own tensors, enough that their
        bytes (``nbytes`` a call) hold four times the L2."""
        count = max(2, -(-4 * l2_bytes // nbytes))
        return [(dataclasses.replace(pplan, **{
                    f: getattr(pplan, f).clone() for f in
                    ("perm", "src_off", "dst_off", "bucket_ptr")
                    if getattr(pplan, f) is not None}), xk.clone())
                for _ in range(count)]

    def rotated_ms(fn, sets, graph=True):
        """ms per call of ``fn(*s)``, ``s`` cycling through ``sets``:
        replayed from one CUDA graph of two rounds that keeps every
        output, or (``graph=False``, or a call that cannot be captured)
        two rounds a timing on the host's loop."""
        keep, turn = [], itertools.cycle(sets)
        if graph:
            try:
                return graph_ms(lambda: keep.append(fn(*next(turn))),
                                calls=2 * len(sets), replays=5)
            except RuntimeError as e:
                print(f"    (not captured: {str(e)[:80]})")
            finally:
                keep.clear()
        return time_fn(lambda: fn(*next(turn)),
                       iters=2 * len(sets)).median_s * 1e3

    def timed_gather(kname, pplan, xk, label):
        batched = xk.dim() == 2
        kern, plain = ((pk.apply_permutation_batched,
                        pk.apply_permutation_batched_ref) if batched else
                       (pk.apply_permutation, pk.apply_permutation_ref))
        idx = pplan.perm.long()       # no don't-care slots on these paths
        staged = pk._staged(pplan, xk)
        direct_plan = (pk._plan(idx, dev, "direct", pk.CHUNK) if staged
                       else pplan)
        yk, yp = kern(pplan, xk), plain(pplan, xk)
        yd = kern(direct_plan, xk)
        yl = torch.index_select(xk, xk.dim() - 1, idx)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        require(torch.equal(yk, yp) and torch.equal(yk, yl)
                and torch.equal(yk, yd),
                f"{kname} {label} vs plain / direct / index_select")
        del yk, yp, yl, yd
        nrhs = xk.shape[0] if batched else 1
        # x read once and out written once per row, the index read once
        nbytes = (2 * nrhs * pplan.n * xk.element_size()
                  + pplan.n * pplan.perm.element_size())
        bound_ms, bound_by = bound(nbytes, 0)
        form = f"{'two-pass' if staged else 'direct'} form "
        if batched:       # its rows outgrow the L2 in one call
            iters = 10
            ms = time_fn(kern, pplan, xk, iters=iters).median_s * 1e3
            plain_ms = time_fn(plain, pplan, xk, iters=iters).median_s * 1e3
            lib_ms = time_fn(torch.index_select, xk, 1, idx,
                             iters=iters).median_s * 1e3
            # one apply_permutation a row, each row its own memory (so no
            # row is served from L2 by the call before)
            rows = [xk[q] for q in range(nrhs)]
            loop_ms = time_fn(lambda: [pk.apply_permutation(pplan, v)
                                       for v in rows][-1],
                              iters=iters).median_s * 1e3
            beside = ""
            if staged:
                dms = time_fn(kern, direct_plan, xk,
                              iters=iters).median_s * 1e3
                beside = f" | direct form {dms:.4f} ms"
            print(f"{kname} {label}: {form}{ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.1f} GB/s){beside} | bound "
                  f"{bound_ms:.4f} ms ({bound_by}, "
                  f"{100 * bound_ms / ms:.1f}%) | plain {plain_ms:.4f} ms | "
                  f"index_select {lib_ms:.4f} ms (kernel/index_select "
                  f"{ms / lib_ms:.2f}) | {nrhs} x apply_permutation "
                  f"{loop_ms:.4f} ms | bitwise equal True (per call)")
            del rows
        else:
            sets = copies(pplan, xk, nbytes)
            ms = rotated_ms(kern, sets)
            plain_ms = rotated_ms(plain, sets)
            lib_ms = rotated_ms(lambda v, at: torch.index_select(v, 0, at),
                                [(v, q.perm.long()) for q, v in sets])
            warm = {"kernel": graph_ms(lambda: kern(pplan, xk)),
                    "index_select": graph_ms(
                        lambda: torch.index_select(xk, 0, idx))}
            if staged:
                dsets = [(pk._plan(q.perm, dev, "direct", pk.CHUNK), v)
                         for q, v in sets]
                warm["direct"] = graph_ms(lambda: kern(direct_plan, xk))
                dms = rotated_ms(kern, dsets)
                del dsets
            del sets
            beside = (f" | direct gather {dms:.4f} ms" if staged else "")
            print(f"{kname} {label}: {form.replace('form', 'gather')}"
                  f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s){beside} | "
                  f"bound {bound_ms:.4f} ms ({bound_by}, "
                  f"{100 * bound_ms / ms:.1f}%) | plain {plain_ms:.4f} ms | "
                  f"index_select {lib_ms:.4f} ms (kernel/index_select "
                  f"{ms / lib_ms:.2f}) | bitwise equal True | max abs err "
                  f"{err:.3e} (rotated inputs, replayed)")
            print("    repeated on one input (in L2), replayed: " + " | ".join(
                f"{k} {v:.4f} ms" for k, v in warm.items()))
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    def timed_pass(which, pplan, xk):
        """One pass of the two-pass gather alone on rotated inputs, beside
        its plain version (the plan's pairs, then one index_select or
        index_copy_) and one library call on the pairs precomputed;
        bitwise equal to both."""
        m, w = pplan.src_off.numel(), xk.element_size()
        # x or out once, the stage once, the pairs' 2-byte offsets once,
        # the bucket table once
        nbytes = (pplan.n + m) * w + 2 * m + 4 * (pplan.nchunks ** 2 + 1)
        sets = copies(pplan, xk, nbytes)
        if which == 2:        # each copy's stage, filled by pass 1
            sets = [(q, pk._one_pass(q, v, 1)) for q, v in sets]
        pairs = [pk.two_pass_pairs(q)[which - 1] for q, _ in sets]
        if which == 1:
            def plain(q, v):
                return torch.index_select(v, 0, pk.two_pass_pairs(q)[0])

            def lib(q, v, at):
                return torch.index_select(v, 0, at)
        else:
            def plain(q, v):
                return torch.zeros(q.n, dtype=v.dtype, device=v.device
                                   ).index_copy_(0, pk.two_pass_pairs(q)[1],
                                                 v)

            def lib(q, v, at):
                return torch.zeros(q.n, dtype=v.dtype,
                                   device=v.device).index_copy_(0, at, v)

        def kern(q, v):
            return pk._one_pass(q, v, which)

        q0, v0 = sets[0]
        yk, yp, yl = kern(q0, v0), plain(q0, v0), lib(q0, v0, pairs[0])
        torch.cuda.synchronize()
        require(torch.equal(yk, yp) and torch.equal(yk, yl),
                f"permute pass {which} vs its plain version")
        err = float((yk - yp).abs().max())
        del yk, yp, yl
        ms = rotated_ms(kern, sets)
        # the plain version sizes its pairs on the host: not capturable
        plain_ms = rotated_ms(plain, sets, graph=False)
        lib_ms = rotated_ms(lib, [(q, v, at) for (q, v), at in
                                  zip(sets, pairs)])
        warm_ms = graph_ms(lambda: kern(q0, v0))
        del sets, pairs
        bound_ms, bound_by = bound(nbytes, 0)
        print(f"    permute_pass{which} alone: {ms:.4f} ms | bound "
              f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%) | "
              f"plain {plain_ms:.4f} ms | "
              f"{'index_select' if which == 1 else 'index_copy_'} "
              f"{lib_ms:.4f} ms | bitwise equal True (rotated inputs, "
              f"replayed; repeated on one input {warm_ms:.4f} ms)")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    xs = torch.tensor(xs64, dtype=torch.float32, device=dev)
    xnat = torch.tensor(rng.random(nat_plan.n), dtype=torch.float32,
                        device=dev)
    require(nat_plan.method == "direct", f"natural band: {nat_plan.method}")
    perm_records = [{
        "name": "permute_gather", "route": "cuda",
        "source": "tpu_spmv_torch/csrc/permute.cu",
        "replaces": "tpu_spmv/kernels/permute.py:888",
        "launches": elaunches["permute"],
        **timed_gather("permute_gather", nat_plan, xnat,
                       f"n={nat_plan.n} f32, RCM perm of the natural band")}]
    id_plan = pk.plan_permutation(torch.arange(NB, device=dev), device=dev)
    require(id_plan.method == "direct", f"identity: {id_plan.method}")
    timed_gather("permute_gather", id_plan, xs, f"n={NB} f32, identity perm")
    timed_gather("permute_gather", ro.perm_plan, xs,
                 f"n={NB} f32, RCM perm of the shuffled band")
    for which in (1, 2):
        perm_records.append({
            "name": f"permute_pass{which}", "route": "cuda",
            "source": "tpu_spmv_torch/csrc/permute.cu",
            "replaces": ("tpu_spmv/kernels/permute.py:888" if which == 1
                         else "tpu_spmv/kernels/permute.py:892"),
            "launches": elaunches["permute_two_pass"],
            **timed_pass(which, ro.perm_plan, xs)})
    rand_plan = pk.plan_permutation(np.random.default_rng(5).permutation(NB),
                                    device=dev)
    timed_gather("permute_gather", rand_plan, xs, f"n={NB} f32, random perm")
    # the batched gather (K7d/K7e) at 4e's shapes: the two-pass form on
    # the RCM perm of the shuffled Poisson, the direct form on the RCM
    # perm of the natural band; side lines: 8 rows, f64 (the direct form)
    # and the RCM perm planned direct
    rcm = f"{msh.shape[0]}] f32, RCM perm of the shuffled Poisson"
    perm_records.append({
        "name": "permute_rows_two_pass", "route": "cuda",
        "source": "tpu_spmv_torch/csrc/permute.cu",
        "replaces": "tpu_spmv/kernels/permute.py:945",
        "launches": elaunches["permute_batched_two_pass"],
        **timed_gather("permute_rows_two_pass", ro_p.perm_plan, XB,
                       f"[{NRHS}, {rcm}")})
    perm_records.append({
        "name": "permute_gather_batched", "route": "cuda",
        "source": "tpu_spmv_torch/csrc/permute.cu",
        "replaces": "tpu_spmv/kernels/permute.py:939",
        "launches": elaunches["permute_batched"],
        **timed_gather("permute_gather_batched", nat_plan, XN,
                       f"[{NRHS}, {nat_plan.n}] f32, RCM perm of the "
                       f"natural band")})
    timed_gather("permute_rows_two_pass", ro_p.perm_plan, XB[:8],
                 f"[8, {rcm}")
    timed_gather("permute_gather_batched", rcm_direct, XB,
                 f"[{NRHS}, {rcm}, planned direct")
    XB64 = XB.double()
    for Xr in (XB64, XB64[:8]):
        timed_gather("permute_gather_batched", ro_p.perm_plan, Xr,
                     f"[{Xr.shape[0]}, {msh.shape[0]}] f64, RCM perm of the "
                     f"shuffled Poisson")
    del XB64
    for r in perm_records:
        require(r["ms"] >= r["bound_ms"], f"{r['name']}: {r['ms']:.4f} ms "
                f"under its bound {r['bound_ms']:.4f} ms")
    # ro(x) with both of its perms planned to each form, in turns (the
    # plan's rule picks the two-pass form for them)
    ro_forms = {f: (pk._plan(ro.perm, dev, f, pk.CHUNK),
                    pk._plan(ro.inv_perm, dev, f, pk.CHUNK))
                for f in ("direct", "two_pass")}

    def ro_x(form):
        p_, q_ = ro_forms[form]
        return lambda: pk.apply_permutation(q_, ro.plan(
            pk.apply_permutation(p_, xs)))

    ro_t = interleaved_ms({"plan's forms": lambda: ro(xs),
                           **{f"both {f}": ro_x(f) for f in ro_forms}}, 50)
    print("ro(x) on the shuffled band, CUDA events, timed in turns: "
          + " | ".join(f"{k} {v:.4f} ms" for k, v in ro_t.items())
          + f" ({card})")
    del ro_forms
    del ro, ro_p, XB, XN, rand_plan, xs, id_plan, nat_plan, xnat, rcm_direct
    print(f"cg_multi_runner f32, 8 RHS, ms/iteration: {cgm}")

    # the probe kernels at the probes' shapes: the probe path's times,
    # each beside its plain version, one library call and its bound
    def probe_record(kname, key, kern, plain, args, libs, nbytes, flops,
                     label, src_line, iters=0):
        """The record of one probe kernel; with ``libs`` (name -> one
        PyTorch call of the same function; the first is the record's
        library) the kernel and the calls are timed in turns (``iters``
        calls a round), else the kernel's time is the probe path's."""
        graph_ms = probe_ms[f"{key}:graph"]
        yk, yp = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        require(torch.equal(yk, yp), f"{kname} {label} vs plain")
        del yk, yp
        plain_ms = time_fn(plain, *args, iters=20).median_s * 1e3
        lib_ms, lib_txt, ms = None, "none", probe_ms[key]
        if libs:
            t = interleaved_ms({kname: lambda: kern(*args), **libs}, iters)
            ms, lib_ms = t.pop(kname), t[next(iter(libs))]
            paired[kname] = t
            lib_txt = "(timed in turns with the kernel) " + ", ".join(
                f"{n} {v:.4f} ms" for n, v in t.items())
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"{kname} {label}: {ms:.4f} ms (probe path "
              f"{probe_ms[key]:.4f} ms; {graph_ms:.4f} ms replayed from a "
              f"CUDA graph) | bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}%; {100 * bound_ms / graph_ms:.1f}% "
              f"of the replayed time) | plain {plain_ms:.4f} ms | library "
              f"{lib_txt} | max abs err {err:.3e}")
        return {"name": kname, "route": "cuda",
                "source": "tpu_spmv_torch/csrc/probes.cu",
                "replaces": src_line, "launches": plaunches[kname],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    probe_records, paired = [], {}
    xp = torch.rand(1 << 26, device=dev)
    buf = torch.empty_like(xp)
    probe_records.append(probe_record(
        "copy_scale", "copy_scale", pr.copy_scale,
        pr.copy_scale_ref, (xp,),
        {"torch.mul": lambda: torch.mul(xp, pr.SCALE, out=buf)},
        2 * xp.numel() * 4, xp.numel(), "2^26 f32 (256 MiB)", "bench.py:999",
        iters=20))
    del xp, buf
    tile = torch.rand(pr.Q, pr.Q, device=dev)
    tdst_ = torch.empty_like(tile)
    probe_records.append(probe_record(
        "launch_probe", "launch_probe", pr.launch_probe,
        pr.launch_probe_ref, (tile,),
        {"copy_": lambda: tdst_.copy_(tile), "clone()": tile.clone},
        2 * tile.numel() * 4, 0, "[128, 128] f32, one launch",
        "tools/profile_gpr.py:110", iters=400))
    x4, x4g = probe_ms["launch_probe_x4"], probe_ms["launch_probe_x4:graph"]
    print(f"    four launches in a row {x4:.4f} ms ({x4g:.4f} ms replayed): "
          f"marginal {(x4 - probe_ms['launch_probe']) / 3:.4f} ms per launch "
          f"({(x4g - probe_ms['launch_probe:graph']) / 3:.4f} ms replayed); "
          f"gpr_spmv at 100k rows (4b) "
          f"{spmv_ms['gpr_spmv', 'random_sparse(100000,7e-5)']:.4f} ms")
    clone_ms = paired["launch_probe"]["clone()"]
    del tile, tdst_
    v2 = torch.from_numpy(pr.t2_operand()).to(dev)
    probe_records.append(probe_record(
        "segsum8", "segsum8", pr.segsum8, pr.segsum8_ref, (v2,),
        {"sum": lambda: v2.view(-1, 16, 8).sum(-1)},
        v2.numel() * 4 + v2.numel() // 8 * 4, v2.numel() // 8 * 7,
        "[16, 512, 128] f32", "tools/profile_reduce.py:35", iters=300))
    del v2
    # every tile_permute variant beside its own bound (the loaded rows,
    # the output, the index tiles, rowsrc, lidx and mul once each:
    # bench/roofline.py:tile_permute_bytes) and its launches on the probe
    # path; the record's row is S's
    t3, t4 = pr.t3_operands(), pr.t4_operands()
    for vname, (prog, src, mul, psum8) in pr.tile_variants(t3, t4,
                                                           dev).items():
        out_elems = (src.numel() if prog.rowsrc is None
                     else prog.ntiles * pr.Q * pr.Q)
        if psum8:
            out_elems //= 8
        libs = None
        if vname == "S":
            gl = prog.idx[0].long()
            libs = {"take_along_dim":
                    lambda: torch.take_along_dim(src, gl, dim=1)}
        elif not psum8:
            # a variant without sums is one gather of its flat source: the
            # index composed by the plain version on the source's
            # positions (+ 1; 0, a row not loaded, reads a zero put past
            # the source's end), built outside the timed call
            pos = torch.arange(1, src.numel() + 1, dtype=torch.float64,
                               device=dev).reshape(src.shape)
            cidx = pr.tile_permute_ref(prog, pos).reshape(-1).long() - 1
            cidx[cidx < 0] = src.numel()
            flat = torch.cat([src.reshape(-1), src.new_zeros(1)])
            require(torch.equal(
                torch.take_along_dim(flat, cidx, dim=0),
                pr.tile_permute(prog, src).reshape(-1)),
                f"tile_permute {vname}: the composed index")
            libs = {"take_along_dim (composed index)":
                    lambda flat=flat, cidx=cidx:
                    torch.take_along_dim(flat, cidx, dim=0)}
            del pos
        key = f"tile_permute:{vname}"
        rec = probe_record(
            "tile_permute", key,
            pr.tile_permute, pr.tile_permute_ref, (prog, src, mul, psum8),
            libs, tile_permute_bytes(prog, src, mul, psum8),
            out_elems * 8 if psum8 else 0,
            f"{vname} {tuple(src.shape)}",
            "tools/prof_tgtg_mxu.py:63" if vname == "TGTG"
            else "tools/profile_sublane.py:47", iters=100)
        mode = ("whole tile", "row slabs", "column slabs")[prog.mode]
        print(f"    {vname}: {probe_ms[key + ':launches']} launches on the "
              f"probe path | mode {mode}, staged index slots "
              f"{prog.staged:#b}")
        if vname == "S":
            probe_records.append(rec)

    # the block products at full width (torch code, no launch counter):
    # each beside its bound and one cuSPARSE call of the same function
    def bsr_library(Bk, xk):
        """One cuSPARSE call of ``A @ xk``: BSR through
        ``torch.sparse_bsr_tensor`` (``torch.mv`` / ``torch.matmul``), or
        the CSR product where torch refuses BSR on CUDA.  Returns the kind,
        the ms and the product."""
        fn = torch.mv if xk.dim() == 1 else torch.matmul
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_bsr_tensor(Bk.indptr, Bk.indices, Bk.data,
                                        size=Bk.shape)
            try:
                y = fn(A, xk)
                torch.cuda.synchronize()
                return ("BSR", time_fn(fn, A, xk, iters=20).median_s * 1e3,
                        y)
            except (RuntimeError, NotImplementedError) as e:
                print(f"    torch refuses BSR x dense on CUDA ({e}); "
                      f"the yardstick is the CSR product")
        return "CSR", library_ms(blap, xk), None

    for pname, fn, A, xk, nrhs in (("spmv_bdia", spmv, Bd, xb512, 0),
                                   ("spmv_bsr", spmv, Bsr, xb512, 0),
                                   ("spmm_bdia", spmm, Bd, X512, NRHS)):
        yk = fn(A, xk)
        torch.cuda.synchronize()
        ms = time_fn(fn, A, xk, iters=5 if nrhs else 20).median_s * 1e3
        nbytes = (spmm_bytes(A, nrhs, torch.float32) if nrhs
                  else spmv_bytes(A, torch.float32))
        bound_ms, bound_by = bound(nbytes, 2 * A.nnz * max(nrhs, 1))
        lib_kind, lib_ms, yl = bsr_library(Bsr, xk)
        agree = ("" if yl is None else f" | vs cuSPARSE rel "
                 f"{float((yk - yl).abs().max() / yl.abs().max()):.2e}")
        rhs = f", {nrhs} RHS" if nrhs else ""
        print(f"{pname} at {A.shape[0]} rows{rhs} f32 (torch code): "
              f"{ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s model) | bound "
              f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f}%) | "
              f"copy-rate bound {nbytes / (copy_gbps * 1e9) * 1e3:.4f} ms | "
              f"cuSPARSE {lib_kind} {lib_ms:.4f} ms (product/cuSPARSE "
              f"{ms / lib_ms:.2f}){agree}")
        del yk, yl
    del Bd, Bsr, X512, xb512, plan_b
    pk_ = {r["name"]: r for r in probe_records}
    print(f"launch-bound rows ({card}): launch_probe "
          f"{pk_['launch_probe']['ms']:.4f} ms (copy_ "
          f"{pk_['launch_probe']['library_ms']:.4f}, clone() "
          f"{clone_ms:.4f}) | segsum8 {pk_['segsum8']['ms']:.4f} ms (sum "
          f"{pk_['segsum8']['library_ms']:.4f}) | tile_permute S "
          f"{pk_['tile_permute']['ms']:.4f} ms (take_along_dim "
          f"{pk_['tile_permute']['library_ms']:.4f}) | gpr_spmv at 100k "
          f"rows {spmv_ms['gpr_spmv', 'random_sparse(100000,7e-5)']:.4f} ms "
          f"| sharded GPR parity at 100k rows {gpr_parity:.3f} | CG "
          f"laplacian_2d(256) {cg256_ms:.4f} ms/iteration")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": records + bf16_records + bf16_spmm_records
                      + spmm_records + dist_records + perm_records
                      + probe_records}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
