"""Port streaming DIA (K1 SDIA, K2 PSDIA) against the JAX reference package.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port runs the plain PyTorch versions that its wrappers take for
CPU tensors.  Both compute on identical packs: the port's own packs are
checked field for field against the JAX packs, and JAX packs carried over
with ``from_reference`` give the same products.

Limits, rel = max|y - ref| / max|ref|: 1e-6 in float32 (at most 7 terms per
row in the same order; rounding may still differ), 1e-13 in float64.
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_spmv as ts
from tpu_spmv import utils
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv_torch import convert as t_convert
from tpu_spmv_torch import COO as TCOO
from tpu_spmv_torch.interop import from_reference
from tpu_spmv_torch.kernels import _build
from tpu_spmv_torch.kernels import dia_stream as tds

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "float64": 1e-13}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}
MATS = {
    "laplacian_2d(32)": lambda: utils.laplacian_2d(32),
    "laplacian_3d(8)": lambda: utils.laplacian_3d(8),
    "banded(777,5)": lambda: utils.banded(777, 5, seed=5),
}
RB = 256


def _rel(y, ref) -> float:
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(y - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _dias(name, dname="float32"):
    m = MATS[name]()
    tdt, jdt = DTYPES[dname]
    return (m, ts.convert(ts.COO.from_scipy(m, dtype=jdt), "dia"),
            t_convert(TCOO.from_scipy(m, dtype=tdt), "dia"))


def _packs(kind, dia_j, dia_t, rb):
    if kind == "sdia":
        return jds.pack_sdia(dia_j, rb=rb), tds.pack_sdia(dia_t, rb=rb)
    return jds.pack_psdia(dia_j, rb=rb), tds.pack_psdia(dia_t, rb=rb)


CASES = [("laplacian_2d(32)", "sdia"), ("laplacian_2d(32)", "psdia"),
         ("laplacian_3d(8)", "sdia"), ("laplacian_3d(8)", "psdia"),
         ("banded(777,5)", "sdia")]


@pytest.mark.parametrize("rb", [RB, None])
@pytest.mark.parametrize("name,kind", CASES)
def test_packs_match_reference(name, kind, rb):
    _, dia_j, dia_t = _dias(name)
    assert tds.detect_period(dia_t) == jds.detect_period(dia_j)
    A_j, A_t = _packs(kind, dia_j, dia_t, rb)
    assert (A_t.L, A_t.rb, A_t.npad) == (A_j.L, A_j.rb, A_j.npad)
    for f in dataclasses.fields(A_t):
        got, ref = getattr(A_t, f.name), getattr(A_j, f.name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        else:
            assert got == ref, f.name


def test_nonperiodic_rejected():
    _, dia_j, dia_t = _dias("banded(777,5)")
    assert tds.detect_period(dia_t) is None and jds.detect_period(dia_j) is None
    with pytest.raises(ValueError, match="periodic"):
        tds.pack_psdia(dia_t, period=100, rb=200)
    with pytest.raises(ValueError, match="no periodic"):
        tds.pack_psdia(dia_t)
    assert not tds.supports_sdia((-300,), (1000, 1000), 256)
    assert tds.supports_sdia((-4096, 0, 4096), (10**6, 10**6))
    with pytest.raises(ValueError, match="square"):
        tds.pack_sdia(t_convert(TCOO.from_scipy(
            utils.random_sparse(40, 60, 0.2, seed=1)), "dia"), rb=256)


@pytest.mark.parametrize("dname", DTYPES)
@pytest.mark.parametrize("name,kind", CASES)
def test_spmv_matches_interpret(name, kind, dname):
    m, dia_j, dia_t = _dias(name, dname)
    A_j, A_t = _packs(kind, dia_j, dia_t, RB)
    padded_j = jds.spmv_psdia_padded if kind == "psdia" else jds.spmv_sdia_padded
    padded_t, plain_t = ((tds.spmv_psdia_padded, tds.spmv_psdia)
                         if kind == "psdia"
                         else (tds.spmv_sdia_padded, tds.spmv_sdia))
    rng = np.random.default_rng(11)
    x = rng.random(m.shape[0]).astype(dname)
    y0 = rng.random(m.shape[0]).astype(dname)
    yp_j = np.asarray(padded_j(A_j, jds.pad_x(A_j, jnp.asarray(x)),
                               interpret=True))
    y_j = yp_j[A_j.L:A_j.L + m.shape[0]]
    for A in (A_t, from_reference(A_j, device="cpu")):
        xt = torch.from_numpy(x)
        yp = padded_t(A, tds.pad_x(A, xt))
        assert yp.dtype == DTYPES[dname][0] and yp.shape == (A.npad,)
        assert _rel(yp, yp_j) <= TOL[dname]
        assert _rel(plain_t(A, xt), y_j) <= TOL[dname]
        assert _rel(plain_t(A, xt, torch.from_numpy(y0)),
                    y0.astype(np.float64) + y_j) <= TOL[dname]
    assert _rel(y_j, m @ x.astype(np.float64)) <= (
        2e-5 if dname == "float32" else 1e-10)


@pytest.mark.parametrize("kind", ["sdia", "psdia"])
def test_chained_padded_keeps_pads_zero(kind):
    m, _, dia_t = _dias("laplacian_2d(32)")
    A = (tds.pack_sdia(dia_t, rb=RB) if kind == "sdia"
         else tds.pack_psdia(dia_t, rb=RB))
    kern = tds.spmv_sdia_padded if kind == "sdia" else tds.spmv_psdia_padded
    n = m.shape[0]
    x = np.random.default_rng(0).random(n).astype(np.float32)
    yp = kern(A, tds.pad_x(A, torch.from_numpy(x)))
    assert bool((yp[:A.L] == 0).all() and (yp[A.L + n:] == 0).all())
    y2 = tds.unpad_y(A, kern(A, yp * 0.125))
    ref = m @ ((m @ x.astype(np.float64)) * 0.125)
    assert _rel(y2, ref) < 2e-5


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, _, dia_t = _dias("laplacian_2d(32)")
    A = tds.pack_psdia(dia_t, rb=RB)
    x = torch.zeros(A.npad, dtype=torch.float32)
    launches = dict(tds.LAUNCHES)
    with pytest.raises(TypeError, match="float64"):
        tds.spmv_psdia_padded(A, x.double())
    with pytest.raises(ValueError, match="npad"):
        tds.spmv_psdia_padded(A, x[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        tds.spmv_psdia_padded(dataclasses.replace(
            A, pattern=A.pattern.t().contiguous().t()), x)
    # a device with no kernel raises: the wrapper never falls back to the
    # plain version for a tensor that is not on the CPU
    with pytest.raises(ValueError, match="no kernel for meta"):
        tds.spmv_psdia_padded(A.to("meta"), x.to("meta"))
    S = tds.pack_sdia(dia_t, rb=RB)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tds.spmv_sdia_padded(S.to("meta"), x[:S.npad].to("meta"))
    assert tds.LAUNCHES == launches     # nothing launched, nothing counted


def test_failed_build_and_launch_error_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            _build.load()
    finally:
        _build.load.cache_clear()
    assert list(tmp_path.iterdir()) == []

    class FakeLib:
        @staticmethod
        def tsp_error_string(code):
            return ctypes.c_char_p(b"invalid configuration argument").value

    _build.check(FakeLib, "psdia_spmv", 0)
    with pytest.raises(RuntimeError, match="invalid configuration"):
        _build.check(FakeLib, "psdia_spmv", 9)

