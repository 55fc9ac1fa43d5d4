"""The CLI's ``--cache``, ``--dtype bfloat16``, ``--profile`` and ``--solve
ir`` on a general matrix, run in process on the CPU (``--device cpu``, the
plain versions).

``--cache`` keeps the reference's key (the source and the dtype, SHA-1,
16 hex digits) and file name, its messages, and its re-pack of a file it
cannot read."""

import hashlib
import json
from pathlib import Path

import pytest

from tpu_spmv_torch import cli

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _run(capsys, *argv):
    assert cli.main([*argv, "--device", "cpu", "--iters", "2"]) == 0
    return capsys.readouterr().out


def _lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _cache_file(tmp_path, spec, dtype):
    key = hashlib.sha1(f"{spec}|{dtype}".encode()).hexdigest()[:16]
    return tmp_path / f"plan_{key}.npz"


def test_cache_twice_reloads(tmp_path, capsys):
    """The first run plans and caches the pack under the reference's key;
    the second reloads it (no analysis) and gives the same product."""
    argv = ("--synthetic", "powerlaw:1000,8", "--auto", "--dtype",
            "bfloat16", "--cache", str(tmp_path))
    first = _run(capsys, *argv)
    f = _cache_file(tmp_path, "powerlaw:1000,8", "bfloat16")
    assert f"planner: cached pack to {f}" in first
    assert f.exists()
    second = _run(capsys, *argv)
    assert (f"planner: reloaded gpr pack from {f} (no re-analysis)"
            in second)
    assert "cached pack" not in second
    errs = [out.split("rel_err=")[1].split()[0] for out in (first, second)]
    assert errs[0] == errs[1]


def test_corrupted_cache_repacks(tmp_path, capsys):
    """A cache file that cannot be read is stale: the run plans again and
    overwrites it."""
    f = _cache_file(tmp_path, "laplacian:30", "float32")
    f.write_bytes(b"not a checkpoint")
    out = _run(capsys, "--synthetic", "laplacian:30", "--auto", "--cache",
               str(tmp_path))
    assert "planner: cache stale (" in out and "re-packing" in out
    assert f"planner: cached pack to {f}" in out
    assert "reloaded" in _run(capsys, "--synthetic", "laplacian:30",
                              "--auto", "--cache", str(tmp_path))


def test_dtype_bfloat16_sweep(capsys):
    """--dtype bfloat16: every format of the sweep checked against the
    unrounded float64 oracle within the reference's 2e-2 gate (the
    product rounded to bf16), and the planner's pick too; with --spmm the
    planner's SpMM and the sweep's, X float32 (rounded to bf16 first)."""
    out = _run(capsys, "--synthetic", "random:600", "--dtype", "bfloat16",
               "--json")
    lines = _lines(out)
    assert [r["format"] for r in lines] == ["COO", "CSR", "CSC", "ELL",
                                            "DIA", "BSR"]
    assert all(2e-5 < r["rel_err"] <= 2e-2 for r in lines)
    auto = _lines(_run(capsys, "--synthetic", "random:600", "--dtype",
                       "bfloat16", "--auto", "--json"))
    assert auto[0]["format"] == "GPR" and auto[0]["rel_err"] <= 2e-2
    spmm = [r for r in _lines(_run(capsys, "--synthetic", "random:600",
                                   "--dtype", "bfloat16", "--auto",
                                   "--spmm", "4", "--formats", "csr",
                                   "--json"))
            if r["mode"] == "SPMM4"]
    assert [r["format"] for r in spmm] == ["GPR", "CSR"]
    assert all(2e-5 < r["rel_err"] <= 2e-2 for r in spmm)


def test_profile_writes_a_trace(tmp_path, capsys):
    """--profile DIR writes the run's torch.profiler trace, a Chrome trace
    with the sweep's ops in it."""
    out = _run(capsys, "--synthetic", "laplacian:10", "--formats", "csr",
               "--profile", str(tmp_path / "prof"))
    trace = tmp_path / "prof" / "trace.json"
    assert f"profile: trace written to {trace}" in out
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("segment_reduce" in e.get("name", "") for e in events)


def test_solve_ir_on_a_general_spd_matrix(capsys):
    """--solve ir on bus420.mtx (general arm): a float32 GPR plan outside,
    its bf16 plan inside; converges to the tolerance."""
    line = _lines(_run(capsys, str(FIXTURES / "bus420.mtx"), "--auto",
                       "--solve", "ir", "--tol", "1e-6", "--json"))[-1]
    assert line["solver"] == "ir" and line["strategy"] == "gpr"
    assert line["converged"] and line["rel_residual"] <= 1e-6
