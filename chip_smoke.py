"""Chip smoke test: drive the port's main paths once on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. toolchain — Python, torch and CUDA versions, ``nvcc --version``, the
   card's name and power limit;
2. build — ``nvcc`` compiles ``tpu_spmv_torch/csrc/dia_stream.cu``,
   ``general.cu``, ``dist_stream.cu`` and ``permute.cu`` for ``sm_90a``
   (one process each, started together) into one library under
   ``build/tpu_spmv_torch/``;
3. kernels against their plain PyTorch versions on small operands, f32 and
   f64, each against the plain version (rel 1e-6 f32, 1e-13 f64), against
   scipy float64 (2e-5 f32, 1e-10 f64) and for bitwise reproducibility:
   K1 (SDIA) and K2 (PSDIA), pads exactly zero; ``gpr_spmv`` and
   ``ell_spmv`` on ``bus420.mtx``, ``powerlaw800.mtx`` and
   ``random_sparse(2000, 200000)``, the planner's pick and the other one
   forced, with the virtual-row fold checked against a host fold; the
   SpMM kernels K3a (``sdia_spmm``), K3b (``psdia_spmm``), ``gpr_spmm`` and
   ``ell_spmm`` on the same operands with 1, 3, 32 and 40 right-hand
   sides, each column also against the SpMV kernel; K1/K2 on the
   transposed packs (``transpose_sdia`` / ``transpose_psdia``) against
   scipy ``A^T x``, and the backward of ``spmv_sdia`` / ``spmv_psdia``
   (``x.grad`` against scipy ``A^T g``, the coefficient gradient against
   the same rule on the CPU); the permutation gathers ``permute_gather``
   (``apply_permutation`` at n = 1000, 16384, 60000, 99991 and
   ``apply_tile_permutation``) and ``permute_gather_batched`` (1, 3, 32, 40
   RHS), bitwise against their plain versions and ``x[perm]``, with and
   without don't-care slots, and reproducible;
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
      built for 32 RHS, each against scipy float64; 50 fixed
      ``cg_multi_runner`` iterations with 8 RHS on the Poisson and on the
      power-law SPD operator; f64 ``cg_multi`` with 4 RHS on the 256x256
      Poisson and ``bus420.mtx``, every column's true residual <= 1e-10;
   d. distributed (shards on the one card): first, on the small operands
      of phase 3, K8a (``sdia_ring``) and K8b (``psdia_ring``) per shard at
      1, 2 and 4 shards, f32 and f64, against their plain versions, scipy
      and (the concatenated shards) the single-chip K1/K2 on the same pack;
      then, counters zeroed, the 4096x4096 Poisson's packs of phase 4a
      sharded (no second planning) through ``bench_dist_spmv``'s chain at 1
      and 4 shards, each beside the plain K2/K1 chain on the same pack (the
      reference's ``dist1_psdia_parity`` and ``dist1_parity``);
      ``ShardedGPR`` at one shard on ``random_sparse(100000, 100000,
      7e-5)`` beside the plain ``gpr_spmv`` chain (``dist1_gpr_parity``);
      f64 ``dist_cg`` over ``csr_neighbor`` at 4 shards on the 256x256
      Poisson, converged, its true residual against scipy;
   e. reorder and operator transforms: ``banded(4194304, 5)`` in a random
      node order (seed 3; 46,137,314 nonzeros) through ``plan_spmv`` (a
      general kernel) and ``reorder_plan`` (RCM, then ``dia_stream`` at
      bandwidth 5: ``ro(x)`` launches the gather twice and K1 once),
      against scipy; the shuffled 2048x2048 Poisson of 4b through
      ``reorder_plan``, 50 fixed CG iterations in permuted space, and
      ``apply_permutation_batched`` with its RCM perm on 32 rows of
      4,194,304; ``plan.transpose()`` of 4a's 1M-row band (K1 on the
      transposed SDIA); one backward through ``spmv_psdia`` on 4a's PSDIA
      pack and ``matvec_differentiable`` on the power-law GPR plan with
      ``plan_spmv(P.T)``, against scipy; the screened Poisson
      ``shift_diagonal(PSDIA, 1.0)`` with 40 CG iterations, true residual
      <= 1e-5 (the reference's ``cg16m_ms_iter`` leg);
5. each kernel at the main paths' shapes against its plain version, timed
   (CUDA events, median) beside its bound and one library call of the
   same function, a yardstick the port never calls (cuSPARSE:
   ``torch.sparse_csr_tensor @ x``, ``torch.sparse.mm`` for the SpMMs;
   ``torch.index_select`` for the gathers); each SpMM also beside
   ``plan.spmm`` end to end and 32 times its SpMV kernel.

The last lines are the kernels' JSON record, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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


def library_ms(mat, x) -> float:
    """One cuSPARSE call of the same product in the type of ``x``:
    ``torch.mv`` of a ``torch.sparse_csr_tensor`` for a vector,
    ``torch.sparse.mm`` for an ``[n, nrhs]`` block (a yardstick; the port
    never calls it)."""
    import warnings

    import torch

    from tpu_spmv_torch.bench.harness import time_fn

    csr = mat.tocsr()
    itype = torch.int32 if csr.nnz < 2**31 else torch.int64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # "beta state"
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr).to(itype),
            torch.from_numpy(csr.indices).to(itype),
            torch.from_numpy(csr.data).to(x.dtype),
            size=csr.shape).to(x.device)
    fn = torch.mv if x.dim() == 1 else torch.sparse.mm
    return time_fn(fn, A, x, iters=20).median_s * 1e3


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
    from tpu_spmv_torch.bench.harness import (time_chained, time_fn,
                                              verify_against_oracle)
    from tpu_spmv_torch.bench.roofline import (measured_copy_gbps,
                                               spmm_bytes, spmv_bytes)
    from tpu_spmv_torch.formats import COO, DIA, convert
    from tpu_spmv_torch.kernels import _build
    from tpu_spmv_torch.kernels import dia_stream as ds
    from tpu_spmv_torch.kernels import dist_stream as dst
    from tpu_spmv_torch.kernels import ell_packed as ell
    from tpu_spmv_torch.kernels import gpr
    from tpu_spmv_torch.kernels import permute as pk
    from tpu_spmv_torch.ops.auto import plan_from_matrix, plan_spmv
    from tpu_spmv_torch.ops.shift import shift_diagonal
    from tpu_spmv_torch.ops.spmm import spmm_coo
    from tpu_spmv_torch.reorder import rcm_permutation, reorder_plan
    from tpu_spmv_torch.solvers import (cg, cg_multi, cg_multi_runner,
                                        cg_runner, dist_cg)
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
    t0 = time.perf_counter()
    _build.load()
    print(f"nvcc {' '.join(_build.NVCC_FLAGS)} -c, one process per source "
          f"of tpu_spmv_torch/csrc/{{{','.join(_build._SOURCES)}}}, then "
          f"-shared -> {_build.library_path().relative_to(ROOT)} "
          f"in {time.perf_counter() - t0:.2f} s")

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
            for nrhs in (1, 3, 32, 40):
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
    require(gpr.pack_gpr(general_small["powerlaw800.mtx"], device=dev).nv > 0,
            "powerlaw800 has no virtual rows")

    # K7: the gathers, bitwise against their plain versions and x[perm],
    # with and without don't-care slots (written as zero), reproducible
    for n_p in (1000, 16384, 60000, 99991):
        p_full = rng.permutation(n_p)
        p_dc = p_full.copy()
        p_dc[rng.random(n_p) < 0.1] = -1
        X64 = rng.random((40, n_p))
        for label, p_host in (("perm", p_full), ("perm with -1 slots", p_dc)):
            pplan = pk.plan_permutation(p_host, device=dev)
            real = p_host >= 0
            src = np.where(real, p_host, 0)
            for dt in (torch.float32, torch.float64):
                cases = [(pk.apply_permutation, pk.apply_permutation_ref,
                          torch.tensor(X64[0], dtype=dt, device=dev))]
                cases += [(pk.apply_permutation_batched,
                           pk.apply_permutation_batched_ref,
                           torch.tensor(X64[:k], dtype=dt, device=dev))
                          for k in (1, 3, 32, 40)]
                for kern, plain, xk in cases:
                    y1, y2, yr = kern(pplan, xk), kern(pplan, xk), plain(
                        pplan, xk)
                    torch.cuda.synchronize()
                    yh, xh = y1.cpu().numpy(), xk.cpu().numpy()
                    require(torch.equal(y1, y2) and torch.equal(y1, yr)
                            and np.array_equal(yh[..., real],
                                               xh[..., src][..., real])
                            and not yh[..., ~real].any(),
                            f"{kern.__name__} n={n_p} {label} {dt} "
                            f"{tuple(xk.shape)}")
            print(f"permute_gather(_batched) n={n_p} {label}: f32 and f64, "
                  f"1 vector and 1, 3, 32, 40 rows, bitwise equal to the "
                  f"plain versions and x[perm], reproducible, don't-care "
                  f"slots zero")
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
    for kname, A, kern in (("psdia_spmm", P32, ds.spmm_psdia_padded_t),
                           ("sdia_spmm", S32, ds.spmm_sdia_padded_t)):
        Yt = kern(A, Xt)
        rel = rel_err(Yt[:, A.L:A.L + n].T.cpu(), ref)
        pads = bool((Yt[:, :A.L] == 0).all() and (Yt[:, A.L + n:] == 0).all())
        print(f"{kname} on the {NRHS}-RHS pack, [{NRHS}, {A.npad}] "
              f"({Xt.numel() * 4 / 1e9:.2f} GB): rel err {rel:.2e} | pads "
              f"zero {pads}")
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
                            y1, y2 = (dst.spmv_psdia_ring(*args, **kw),
                                      dst.spmv_psdia_ring(*args, **kw))
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
                    print(f"{kname:10s} {name:17s} {dname} ndev={nd} "
                          f"(Cp={A.rows_per_shard}, h={A.halo}): rel vs plain "
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
            print(f"    {strategy} ndev={nd} (Cp={A.rows_per_shard}, "
                  f"h={A.halo}): {r['seconds'] * 1e3:.4f} ms per SpMV, "
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
    print(f"    gpr ndev=1 on {gname}: {r['seconds'] * 1e3:.4f} ms per SpMV, "
          f"plain gpr_spmv chain on the same pack {gplain_ms:.4f} ms -> "
          f"parity {r['seconds'] * 1e3 / gplain_ms:.3f} | vs plain "
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
    before = (pk.LAUNCHES["permute"], ds.LAUNCHES["sdia"])
    ys = ro(xs)
    torch.cuda.synchronize()
    spent = (pk.LAUNCHES["permute"] - before[0],
             ds.LAUNCHES["sdia"] - before[1])
    rel_ro = rel_err(ys.cpu(), shuffled @ xs64)
    rel_direct = rel_err(direct(xs).cpu(), shuffled @ xs64)
    ro_ms = time_fn(ro, xs, iters=50).median_s * 1e3
    direct_ms = time_fn(direct, xs, iters=50).median_s * 1e3
    print(f"ro(x): launches (permute_gather, K1) {spent} | rel err vs scipy "
          f"f64 {rel_ro:.2e} (direct {rel_direct:.2e}) | {ro_ms:.4f} ms per "
          f"product against the direct {direct.strategy} plan's "
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
    YB = pk.apply_permutation_batched(ro_p.perm_plan, XB)
    same = torch.equal(YB, pk.apply_permutation_batched_ref(ro_p.perm_plan,
                                                            XB))
    torch.cuda.synchronize()
    print(f"apply_permutation_batched, RCM perm, X [{NRHS}, {msh.shape[0]}] "
          f"f32: bitwise equal to the plain version {same}")
    require(same, "batched gather at full width")
    del YB

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
    for k in ("permute", "permute_batched", "sdia", "psdia", "gpr"):
        require(elaunches[k] > 0, f"{k} never launched in 4e")

    # -- 5. kernels vs plain at the main paths' shapes, timed ---------------
    print("== 5. kernels vs plain versions at the main paths' shapes")
    copy_gbps = measured_copy_gbps(dev)
    print(f"measured copy bandwidth: {copy_gbps:.1f} GB/s ({card})")
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

    for kname, A, kern, plain, src_line, key in (
            ("psdia_spmv", P, ds.spmv_psdia_padded, ds.spmv_psdia_padded_ref,
             "tpu_spmv/kernels/dia_stream.py:733", "psdia"),
            ("sdia_spmv", S, ds.spmv_sdia_padded, ds.spmv_sdia_padded_ref,
             "tpu_spmv/kernels/dia_stream.py:221", "sdia")):
        nums = timed(kname, A, kern, plain, ds.pad_x(A, x), mat,
                     f"{mat.shape[0]} rows")
        spmv_ms[kname, "4096^2"] = nums["ms"]
        records.append({"name": kname, "route": "cuda",
                        "source": "tpu_spmv_torch/csrc/dia_stream.cu",
                        "replaces": src_line, "launches": launches[key],
                        **nums})
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
                A_.pattern[0], A_.offsets, v, left, right, **kw)
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
                             "source": "tpu_spmv_torch/csrc/dist_stream.cu",
                             "replaces": src_line, "launches": dlaunches[key],
                             **nums})
    del dist1
    spmm_records = []
    for kname, A, kern, plain, src_line, spmv_name in (
            ("psdia_spmm", P32, ds.spmm_psdia_padded_t,
             ds.spmm_psdia_padded_t_ref,
             "tpu_spmv/kernels/dia_stream.py:875", "psdia_spmv"),
            ("sdia_spmm", S32, ds.spmm_sdia_padded_t,
             ds.spmm_sdia_padded_t_ref,
             "tpu_spmv/kernels/dia_stream.py:339", "sdia_spmv")):
        nums = timed(kname, A, kern, plain, Xt, mat,
                     f"{n} rows, {NRHS} RHS (rb {A.rb})", nrhs=NRHS, lib_x=X)
        print(f"    {NRHS} x {spmv_name} at 4096^2: "
              f"{NRHS * spmv_ms[spmv_name, '4096^2']:.4f} ms")
        spmm_records.append({"name": kname, "route": "cuda",
                             "source": "tpu_spmv_torch/csrc/dia_stream.cu",
                             "replaces": src_line,
                             "launches": mlaunches[kname], **nums})
    pms = time_fn(plan.spmm, X, iters=10).median_s * 1e3
    print(f"plan.spmm(X) end to end ({NRHS} RHS: transpose and pad, K3b at "
          f"rb {P.rb}, slice and transpose): {pms:.4f} ms")
    del P, S, plan, x, P32, S32, X, Xt

    # both general kernels on every general operand: the planner's pick
    # and the other one forced, so the byte rule's choice can be judged
    recorded = {"gpr_spmv": "random_sparse(2000000,8e-6)",
                "ell_spmv": "shuffled laplacian_2d(2048)"}
    for name, m in general.items():
        p, xg = gplans[name], gx[name]
        for kname, strategy, pack, kern, plain in (
                ("gpr_spmv", "gpr", gpr.pack_gpr, gpr.spmv_gpr_rows,
                 gpr.spmv_gpr_ref),
                ("ell_spmv", "pallas_ell", ell.pack_ell, ell.spmv_ell_main,
                 ell.spmv_ell_packed_ref)):
            A = (p.matrix if p.strategy == strategy
                 else pack(m, dtype=torch.float32, device=dev))
            tag = "pick" if p.strategy == strategy else "forced"
            nums = timed(kname, A, kern, plain, xg, m, f"{name} ({tag})")
            spmv_ms[kname, name] = nums["ms"]
            if recorded[kname] == name:
                records.append({
                    "name": kname, "route": "cuda",
                    "source": "tpu_spmv_torch/csrc/general.cu",
                    "replaces": ("tpu_spmv/kernels/gpr.py:684"
                                 if strategy == "gpr" else
                                 "tpu_spmv/kernels/ell_pallas.py:299"),
                    "launches": glaunches["gpr" if strategy == "gpr"
                                          else "ell"],
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
    # the gathers of 4e at their shapes: ro(x)'s RCM perm and a random
    # perm on 4,194,304 f32 values, the batched gather on 32 rows
    def timed_gather(kname, pplan, xk, label):
        batched = xk.dim() == 2
        kern, plain = ((pk.apply_permutation_batched,
                        pk.apply_permutation_batched_ref) if batched else
                       (pk.apply_permutation, pk.apply_permutation_ref))
        idx = pplan.perm.long()       # no don't-care slots on these paths
        yk, yp = kern(pplan, xk), plain(pplan, xk)
        yl = torch.index_select(xk, xk.dim() - 1, idx)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        require(torch.equal(yk, yp) and torch.equal(yk, yl),
                f"{kname} {label} vs plain / index_select")
        del yk, yp, yl
        iters = 20 if batched else 100
        ms = time_fn(kern, pplan, xk, iters=iters).median_s * 1e3
        plain_ms = time_fn(plain, pplan, xk, iters=iters).median_s * 1e3
        lib_ms = time_fn(torch.index_select, xk, xk.dim() - 1, idx,
                         iters=iters).median_s * 1e3
        nrhs = xk.shape[0] if batched else 1
        # x read once and out written once per row, the index read once
        nbytes = (2 * nrhs * pplan.n * xk.element_size()
                  + pplan.n * pplan.perm.element_size())
        bound_ms, bound_by = bound(nbytes, 0)
        print(f"{kname} {label}: {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s) "
              f"| bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f}%) | plain {plain_ms:.4f} ms | "
              f"index_select {lib_ms:.4f} ms (kernel/index_select "
              f"{ms / lib_ms:.2f}) | max abs err {err:.3e}")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    xs = torch.tensor(xs64, dtype=torch.float32, device=dev)
    perm_records = [{
        "name": "permute_gather", "route": "cuda",
        "source": "tpu_spmv_torch/csrc/permute.cu",
        "replaces": "tpu_spmv/kernels/permute.py:888",
        "launches": elaunches["permute"],
        **timed_gather("permute_gather", ro.perm_plan, xs,
                       f"n={NB} f32, RCM perm of the shuffled band")}]
    rand_plan = pk.plan_permutation(np.random.default_rng(5).permutation(NB),
                                    device=dev)
    timed_gather("permute_gather", rand_plan, xs, f"n={NB} f32, random perm")
    perm_records.append({
        "name": "permute_gather_batched", "route": "cuda",
        "source": "tpu_spmv_torch/csrc/permute.cu",
        "replaces": "tpu_spmv/kernels/permute.py:939",
        "launches": elaunches["permute_batched"],
        **timed_gather("permute_gather_batched", ro_p.perm_plan, XB,
                       f"[{NRHS}, {msh.shape[0]}] f32, RCM perm of the "
                       f"shuffled Poisson")})
    one_ms = time_fn(pk.apply_permutation, rand_plan, xs).median_s * 1e3
    print(f"    {NRHS} x permute_gather (random perm): {NRHS * one_ms:.4f} ms")
    del ro, ro_p, XB, rand_plan, xs
    print(f"cg_multi_runner f32, 8 RHS, ms/iteration: {cgm}")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": records + spmm_records + dist_records
                      + perm_records}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
