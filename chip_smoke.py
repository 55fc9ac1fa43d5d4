"""Chip smoke test: drive the port's main path once on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. toolchain — Python, torch and CUDA versions, ``nvcc --version``, the
   card's name and power limit;
2. build — ``nvcc`` compiles ``tpu_spmv_torch/csrc/dia_stream.cu`` for
   ``sm_90a`` into ``build/tpu_spmv_torch/``;
3. kernels against their plain PyTorch versions on small operands, f32 and
   f64: K1 (SDIA) and K2 (PSDIA) against the plain version (rel 1e-6 f32,
   1e-13 f64), against scipy float64 (2e-5 f32, 1e-10 f64), bitwise
   reproducible, pads exactly zero;
4. main path at full size, with the launch counters zeroed just before
   and read just after: the 4096x4096-grid 2-D Poisson (16,777,216 rows,
   83,869,696 nonzeros, float32) through ``plan_spmv`` to PSDIA, checked
   against scipy float64; 50 fixed CG iterations on it; the same operand
   forced to SDIA; the 128^3 7-point Poisson and a 1M-row 11-diagonal band
   through the planner; f64 CG with the true-residual gate on the
   256x256-grid Poisson;
5. each kernel at the main path's shapes against its plain version, both
   timed (CUDA events, median).

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


#: kernel-vs-plain limits (same summation order; FMA rounding may differ)
PLAIN_TOL = {"float32": 1e-6, "float64": 1e-13}
#: scipy float64 oracle gates
ORACLE_TOL = {"float32": 2e-5, "float64": 1e-10}


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

    from tpu_spmv_torch import utils
    from tpu_spmv_torch.bench.harness import time_fn, verify_against_oracle
    from tpu_spmv_torch.bench.roofline import measured_copy_gbps, spmv_bytes
    from tpu_spmv_torch.formats import COO, DIA, convert
    from tpu_spmv_torch.kernels import _build
    from tpu_spmv_torch.kernels import dia_stream as ds
    from tpu_spmv_torch.ops.auto import plan_spmv
    from tpu_spmv_torch.solvers.cg import cg, cg_runner

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()

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
    print(f"nvcc {' '.join(_build.NVCC_FLAGS)} tpu_spmv_torch/csrc/"
          f"dia_stream.cu -> {_build.library_path().relative_to(ROOT)} "
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

    # -- 4. main path at full size ------------------------------------------
    print("== 4. main path (counters zeroed)")
    GRID = 4096
    t0 = time.perf_counter()
    mat = utils.laplacian_2d(GRID)
    print(f"laplacian_2d({GRID}): {mat.shape[0]} rows, {mat.nnz} nnz "
          f"(scipy build {time.perf_counter() - t0:.1f} s)")
    x_host = rng.random(mat.shape[0])
    # b = A·x_true: a right-hand side whose residual CG shrinks from the
    # first iterations (for a random b the 2-norm residual rises first)
    b_host = mat @ rng.random(mat.shape[0])
    for k in ds.LAUNCHES:
        ds.LAUNCHES[k] = 0

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

    band = utils.banded(1_000_000, 5, seed=1)
    planb = plan_spmv(band, dtype=torch.float32, device=dev)
    require(planb.strategy == "dia_stream", f"band strategy {planb.strategy}")
    xb = torch.tensor(rng.random(band.shape[0]), dtype=torch.float32,
                      device=dev)
    relb = verify_against_oracle(planb.matrix, xb, planb(xb), oracle=band)
    print(f"banded(1000000,5) -> {planb.strategy} rb={planb.matrix.rb}: "
          f"rel err {relb:.2e}")

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
    print(f"launch counts on the main path: {launches}")
    require(launches["psdia"] > 0, "K2 (psdia) never launched")
    require(launches["sdia"] > 0, "K1 (sdia) never launched")

    # -- 5. kernels vs plain at the main path's shapes, timed ---------------
    print("== 5. kernels vs plain versions at the main path's shapes")
    copy_gbps = measured_copy_gbps(dev)
    print(f"measured copy bandwidth: {copy_gbps:.1f} GB/s ({card})")
    records = []
    for kname, A, kern, plain, src_line in (
            ("psdia_spmv", P, ds.spmv_psdia_padded, ds.spmv_psdia_padded_ref,
             "tpu_spmv/kernels/dia_stream.py:733"),
            ("sdia_spmv", S, ds.spmv_sdia_padded, ds.spmv_sdia_padded_ref,
             "tpu_spmv/kernels/dia_stream.py:221")):
        xp = ds.pad_x(A, x)
        yk, yp = kern(A, xp), plain(A, xp)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        rel_p = err / float(yp.abs().max())
        require(rel_p <= PLAIN_TOL["float32"], f"{kname} vs plain at full "
                f"size {rel_p:.2e}")
        ms = time_fn(kern, A, xp, iters=50).median_s * 1e3
        plain_ms = time_fn(plain, A, xp, iters=10).median_s * 1e3
        nbytes = spmv_bytes(A, torch.float32)
        gbps = nbytes / (ms * 1e-3) / 1e9
        print(f"{kname} {mat.shape[0]} rows f32: {ms:.4f} ms "
              f"({2 * A.nnz / (ms * 1e-3) / 1e9:.1f} GFLOP/s, model "
              f"{gbps:.1f} GB/s = {100 * gbps / copy_gbps:.1f}% of copy) | "
              f"plain {plain_ms:.4f} ms | max abs err {err:.3e} "
              f"(rel {rel_p:.2e})")
        records.append({"name": kname, "route": "cuda",
                        "source": "tpu_spmv_torch/csrc/dia_stream.cu",
                        "replaces": src_line,
                        "launches": launches[kname.split("_")[0]],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    plan_ms = time_fn(plan, x, iters=50).median_s * 1e3
    print(f"plan(x) end to end (pad + K2 + unpad): {plan_ms:.4f} ms")

    print(json.dumps({"kernels": records}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
