"""CPU tests of the benchmark: every cell at a tiny size through the CPU
rehearsal, the reference against planted faults, the frozen byte counts,
the generators, ``BENCHMARK.json`` against its contract, and the modules a
run loads.

    python -m pytest gpu_bench/tests -q
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gpu_bench.harness import bench
from gpu_bench.reference import products as ref

ROOT = Path(__file__).resolve().parents[2]
BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
#: tiny sizes of each configuration for the CPU
SHRINK = {"poisson2d_4096": {"grid": [48, 40]}, "rmat_s24": {"scale": 11}}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def shrink_of(cell):
    return SHRINK[bench.load_cell(cell).cell["config"]]


def rehearse(cell, trace, cwd=ROOT, extra="pass"):
    """The CLI's ``main`` on the CPU at a tiny size, in a fresh process;
    ``extra`` runs after it in the same process."""
    code = (f"import sys; sys.path.insert(0, {str(cwd / 'gpu_bench')!r}); "
            f"import run; rc = run.main(['--workload', {cell!r}, '--seed', "
            f"'2147483653', '--seconds', '0.3', '--trace', '{trace}'], "
            f"device='cpu', shrink={shrink_of(cell)!r}); {extra}; "
            f"sys.exit(rc)")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_prints_a_correct_line(cell, trace):
    proc = rehearse(cell, trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["kind"] == "cpu"
    group = "per_layer" if trace else "end_to_end"
    for name, m in line["metrics"].items():
        entry = next(e for e in BENCHMARK[group] if e["name"] == name)
        assert m["unit"] == entry["unit"] and m["value"] > 0
    if not trace:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    else:
        assert "plan_s" in line["metrics"]
        # a CPU run never fills a device metric
        assert not {"product_roofline", "device_idle.product",
                    "device_idle.solve", "vcycle_ms.solve"} & set(
                        line["metrics"])
    stderr_tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), stderr_tail):
        assert text == f"check {name} {c['value']!r} limit {c['limit']!r}"


def test_run_loads_no_jax_and_no_jax_package():
    proc = rehearse("poisson2d_4096.mgpcg", 0, extra=(
        "import json; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "tpu_spmv_torch" in tops          # the port, compared whole
    assert not tops & {"jax", "jaxlib", "flax", "tpu_spmv"}


def test_forbidden_modules_compares_whole_top_level_names():
    assert bench.forbidden_modules(["tpu_spmv_torch.ops.auto", "tpu_spmvx",
                                    "jaxtyping", "numpy"]) == []
    assert bench.forbidden_modules(["tpu_spmv.ops", "jax.numpy", "flax",
                                    "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "tpu_spmv"]


def test_cli_without_a_card_exits_nonzero_and_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "gpu_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_alone_without_the_program_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpu_bench", tmp_path / "gpu_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.json.gz"))
    proc = rehearse(CELLS[0], 0, cwd=tmp_path)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


# -- the reference against planted faults ---------------------------------

def _run(monkeypatch, cell, patch):
    """A whole run of ``cell`` on the CPU with ``patch`` applied to the
    program underneath the timed path."""
    patch(monkeypatch)
    return bench.run_cell(cell, 2147483653, 0.2, False, "cpu", 0.0,
                          shrink_of(cell))


def _alter_output(monkeypatch):
    from tpu_spmv_torch.ops.auto import SpmvPlan

    def altered(fn):
        def call(self, x, *a):
            y = fn(self, x, *a).clone()
            y.view(-1)[y.numel() // 3] *= 1.001
            return y
        return call

    monkeypatch.setattr(SpmvPlan, "__call__", altered(SpmvPlan.__call__))
    monkeypatch.setattr(SpmvPlan, "spmm", altered(SpmvPlan.spmm))


def _alter_solve(monkeypatch):
    from tpu_spmv_torch import solvers
    real = solvers.cg

    def cg(*a, **k):
        res = real(*a, **k)
        x = res.x.clone()
        x[x.numel() // 2] += 1e-2 * float(x.abs().max())
        return res._replace(x=x)

    monkeypatch.setattr(solvers, "cg", cg)


def _unchanged_solve(monkeypatch):
    from tpu_spmv_torch import solvers
    real = solvers.cg

    def cg(A, b, **k):
        res = real(A, b, **k)
        return res._replace(x=torch.zeros_like(res.x))

    monkeypatch.setattr(solvers, "cg", cg)


@pytest.mark.parametrize("cell", [c for c in CELLS if "mgpcg" not in c])
def test_an_altered_product_is_not_correct(monkeypatch, cell):
    line = _run(monkeypatch, cell, _alter_output)
    assert line["correct"] is False and line["failed"] > 0


@pytest.mark.parametrize("fault", [_alter_solve, _unchanged_solve])
def test_a_wrong_solve_is_not_correct(monkeypatch, fault):
    line = _run(monkeypatch, "poisson2d_4096.mgpcg", fault)
    assert line["correct"] is False and line["failed"] > 0


def test_sound_runs_pass_in_process():
    for cell in CELLS:
        line = bench.run_cell(cell, 7, 0.2, False, "cpu", 0.0,
                              shrink_of(cell))
        assert line["correct"] is True, (cell, line["checks"])


# -- the controls ---------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(cell):
    """Each control of the mix's kind (the reference in bfloat16 in the
    program's place, the program's bfloat16 path, a solve stopped at
    1e-3, an answer held in bfloat16), put in the program's place, makes
    a whole run of the cell come out not correct through its own
    comparison; the control each limit names is one of them."""
    spec = bench.load_cell(cell)
    controls = spec.kind.CONTROLS
    assert {c["control"] for c in spec.checks.values()} <= set(controls)
    for control in controls:
        line = bench.run_cell(cell, 5, 0.2, False, "cpu", 0.0,
                              shrink_of(cell), control=control)
        exact = (control == "program_bf16"
                 and spec.cell["config"] == "poisson2d_4096")
        # the program's bf16 path holds the stencil's 4 and -1 exactly
        assert line["correct"] is exact, (control, line["checks"])


# -- frozen byte counts and generators -------------------------------------

def _config(name):
    spec = bench.load_cell(next(w["name"] for w in BENCHMARK["workloads"]
                                if w["config"] == name))
    return spec.config, spec.config_module


def test_poisson_frozen_bytes_match_the_hand_count():
    cfg, mod = _config("poisson2d_4096")
    A = ref.HostCSR(np.zeros(16_777_217, np.int64), None, None,
                    (16_777_216, 16_777_216))
    got = mod.bytes_moved(cfg, A, 1)
    assert got == 2 * 16_777_216 * 4 + 5 * 4096 * 4 == 134_299_648
    assert got / 3.35e12 == pytest.approx(0.0401e-3, rel=1e-3)


@pytest.mark.parametrize("nrhs,expected,ms", [(1, 4_367_468_436, 1.3037),
                                              (32, 8_528_218_004, 2.5457)])
def test_rmat_frozen_bytes_match_the_hand_count(nrhs, expected, ms):
    cfg, mod = _config("rmat_s24")
    n = 16_777_216
    indptr = np.zeros(n + 1, np.int64)
    indptr[-1] = 520_767_730
    A = ref.HostCSR(indptr, None, None, (n, n))
    assert mod.bytes_moved(cfg, A, nrhs) == expected
    assert expected / 3.35e12 == pytest.approx(ms * 1e-3, rel=1e-4)
    assert cfg["rows"] == n and cfg["nnz"] == 520_767_730


def test_poisson_generator_is_the_5_point_laplacian():
    cfg, mod = _config("poisson2d_4096")
    A, info = mod.build({**cfg, "grid": [6, 5]}, 0, torch.device("cpu"))
    T = [sp.diags([-np.ones(g - 1), 2 * np.ones(g), -np.ones(g - 1)],
                  [-1, 0, 1]) for g in (6, 5)]
    want = sp.kronsum(T[1], T[0], format="csr")
    got = sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)
    assert (got != want).nnz == 0 and info["grid"] == (6, 5)
    assert cfg["nnz"] == 5 * 4096 * 4096 - 4 * 4096
    assert cfg["rows"] == 4096 * 4096


def test_rmat_generator_is_one_fixed_relabelled_graph():
    cfg, mod = _config("rmat_s24")
    cfg = {**cfg, "scale": 10}
    cpu = torch.device("cpu")
    A1, _ = mod.build(cfg, 1, cpu)
    A2, _ = mod.build(cfg, 2, cpu)
    other, _ = mod.build({**cfg, "instance_seed": 1}, 1, cpu)
    # every seed multiplies the same graph; another instance differs
    assert all(np.array_equal(getattr(A1, k), getattr(A2, k))
               for k in ("indptr", "indices", "data"))
    assert not np.array_equal(A1.indices[:50], other.indices[:50])
    M = sp.csr_matrix((A1.data, A1.indices, A1.indptr), shape=A1.shape)
    # relabelled: the hubs are not the low vertex ids R-MAT favours
    assert np.argmax(np.diff(M.indptr)) != 0
    colsum = np.asarray(M.sum(axis=0)).ravel()
    nonempty = np.diff(M.tocsc().indptr) > 0
    assert np.allclose(colsum[nonempty], 1.0)
    # undirected, as Graph500's Kernel 1 and GAP's kron: each edge both
    # ways, duplicates merged, no self loops
    assert M.nnz <= 2 * (16 << 10)
    M.sum_duplicates()
    assert M.nnz == A1.nnz
    P = (M != 0).astype(np.int8)
    assert (P != P.T).nnz == 0 and M.diagonal().sum() == 0
    deg = np.diff(M.indptr)
    assert np.allclose(M.data, 1.0 / deg[M.indices])


def test_reference_matmul_and_errors():
    rng = np.random.default_rng(0)
    M = sp.random(300, 200, density=0.05, random_state=1, format="lil")
    M[17, :] = 0                              # an empty row
    M = M.tocsr()
    M.eliminate_zeros()
    A = ref.HostCSR(M.indptr.astype(np.int64), M.indices.astype(np.int32),
                    M.data, M.shape)
    X = torch.from_numpy(rng.random((200, 3)))
    Y, Yabs = ref.matmul(A, X)
    assert np.allclose(Y.numpy(), M @ X.numpy(), rtol=1e-14, atol=0)
    y, _ = ref.matmul(A, X[:, 0])
    assert np.allclose(y.numpy(), Y[:, 0].numpy(), rtol=1e-15, atol=0)
    assert ref.componentwise_error(Y.float(), Y, Yabs) < 1e-6
    bad = Y.clone()
    bad[17] = 1e-30
    assert ref.componentwise_error(bad, Y, Yabs) == float("inf")


# -- BENCHMARK.json against its contract ------------------------------------

def test_benchmark_json_names_files_and_limits():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gpu_bench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpu_bench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert (ROOT / "gpu_bench" / "configs" / f"{c['name']}.py").exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (ROOT / "gpu_bench" / "traffic" / f"{w['traffic']}.json"
                ).exists()
        assert (ROOT / "gpu_bench" / "checks" / f"{w['name']}.json").exists()
        reported = {m["name"] for m in b["end_to_end"]
                    if bench.applies(m, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
        mix = json.loads((ROOT / "gpu_bench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "gpu_bench" / "kinds" / f"{mix['kind']}.py").exists()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "gpu_bench" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["workloads"] and m["moves"] in e2e
        assert "\n" not in m["layer"]
        assert all(m["moves"] in {e["name"] for e in b["end_to_end"]
                                  if bench.applies(e, w)}
                   for w in m["workloads"])


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_at_a_small_size(card, cell):
    line = bench.run_cell(cell, 11, 0.5, True, card, 0.0, shrink_of(cell))
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
