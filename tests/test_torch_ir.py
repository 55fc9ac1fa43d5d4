"""Port bf16 coefficient storage, K1/K2 on bf16 data and mixed-precision
iterative refinement against the JAX reference (the JAX plans run Pallas
in interpret mode; vectors float32).

Limits: the bf16 packs and their strategy equal the reference's bit for
bit (built by the port, and carried over with ``from_reference``); the
bf16-data SpMV within 1e-6 relative of the reference's interpret-mode
kernel on the same bf16 coefficients; ``ir_solve`` outer iterations
within +-1 and the same ``converged``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_spmv.solvers as J
from tpu_spmv import utils
from tpu_spmv.kernels import dia_stream as jds
from tpu_spmv_torch import solvers as T
from tpu_spmv_torch.interop import from_reference
from tpu_spmv_torch.kernels import dia_stream as tds
from tpu_spmv_torch.ops.auto import plan_spmv
from tpu_spmv_torch.solvers.ir import _paired_spaces

from _solver_reference import reference_planning, rel, rhs, screened

torch.set_num_threads(1)

#: operand -> the strategy both planners pick for it
OPERANDS = {"screened_poisson": (lambda: screened(24), "pdia_stream"),
            "band": (lambda: utils.banded(3000, 5, seed=2), "dia_stream")}


@pytest.fixture(scope="module")
def case():
    """Each operand's bf16 and f32 plans in both packages, and the
    reference's products and refinement solves, computed once."""
    out = {}
    with reference_planning() as jauto:
        for name, (make, _) in OPERANDS.items():
            m = make()
            if name == "band":       # SPD, for the refinement solve
                m = (m + m.T + 12.0 * np.abs(m).sum(1).max()
                     * sp.identity(m.shape[0])).tocsr()
            n = m.shape[0]
            x = np.random.default_rng(4).random(n).astype(np.float32)
            b = rhs(n, 5).astype(np.float32)
            lo_j = jauto.plan_spmv(m, dtype=jnp.bfloat16)
            hi_j = jauto.plan_spmv(m, dtype=np.float32)
            A_j = lo_j.matrix
            kern = (jds.spmv_psdia_padded if lo_j.strategy == "pdia_stream"
                    else jds.spmv_sdia_padded)
            y_j = np.asarray(kern(A_j, jds.pad_x(A_j, jnp.asarray(x)),
                                  interpret=True))
            ir_j = J.ir_solve(hi_j, jnp.asarray(b), low=lo_j, inner_iters=8,
                              tol=1e-6)
            out[name] = dict(m=m, x=x, b=b, lo_j=lo_j, y_j=y_j, ir_j=ir_j)
    return out


@pytest.mark.parametrize("name", OPERANDS)
def test_bf16_packs_equal_reference(case, name):
    c = case[name]
    lo = plan_spmv(c["m"], dtype=torch.bfloat16, device="cpu")
    assert lo.strategy == c["lo_j"].strategy == OPERANDS[name][1]
    carried = from_reference(c["lo_j"], device="cpu")
    for pack in (lo.matrix, carried.matrix):
        for f in dataclasses.fields(pack):
            got, ref = getattr(pack, f.name), getattr(c["lo_j"].matrix,
                                                      f.name)
            if isinstance(got, torch.Tensor):
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(),
                    np.asarray(ref).view(np.int16))
            else:
                assert got == ref, f.name


def test_pack_sdia_data_dtype_picks_the_narrow_tile():
    """pack_sdia(data_dtype=bfloat16) from a float32 DIA: the tile the
    reference picks for 2-byte data (wider than for 4-byte data here),
    and the same bf16 values."""
    from tpu_spmv_torch import COO, convert
    import tpu_spmv as ts

    m = utils.banded(100_000, 15, seed=3)
    dia_t = convert(COO.from_scipy(m, dtype=torch.float32), "dia")
    dia_j = ts.convert(ts.COO.from_scipy(m, dtype=jnp.float32), "dia")
    A_t = tds.pack_sdia(dia_t, data_dtype=torch.bfloat16)
    A_j = jds.pack_sdia(dia_j, data_dtype=jnp.bfloat16)
    assert (A_t.rb, A_t.L, A_t.npad) == (A_j.rb, A_j.L, A_j.npad)
    assert A_t.rb > tds.pack_sdia(dia_t).rb
    np.testing.assert_array_equal(A_t.data.view(torch.int16).numpy(),
                                  np.asarray(A_j.data).view(np.int16))


@pytest.mark.parametrize("name", OPERANDS)
def test_bf16_spmv_matches_interpret_kernel(case, name):
    """K1 / K2 on bf16 coefficients against float32 x (the plain versions
    here) against the reference's interpret-mode kernel on the same
    pack."""
    c = case[name]
    lo = plan_spmv(c["m"], dtype=torch.bfloat16, device="cpu")
    A = lo.matrix
    xp = tds.pad_x(A, torch.from_numpy(c["x"]))
    kern = (tds.spmv_psdia_padded if lo.strategy == "pdia_stream"
            else tds.spmv_sdia_padded)
    y = kern(A, xp)
    assert y.dtype == torch.float32 and y.shape == (A.npad,)
    assert rel(y, c["y_j"]) <= 1e-6
    assert rel(lo(torch.from_numpy(c["x"])),
               c["y_j"][A.L:A.L + c["m"].shape[0]]) <= 1e-6
    # the coefficients' rounding is the only loss against scipy float64
    assert rel(tds.unpad_y(A, y), c["m"] @ c["x"].astype(np.float64)) \
        <= 1e-2


@pytest.mark.parametrize("name", OPERANDS)
def test_ir_solve_matches_reference(case, name):
    c = case[name]
    hi = plan_spmv(c["m"], dtype=torch.float32, device="cpu")
    lo = plan_spmv(c["m"], dtype=torch.bfloat16, device="cpu")
    enc, _, _, _ = _paired_spaces(hi, lo)
    assert enc(torch.zeros(c["m"].shape[0])).shape == (hi.matrix.npad,)
    res = T.ir_solve(hi, torch.from_numpy(c["b"]), low=lo, inner_iters=8,
                     tol=1e-6)
    ref = c["ir_j"]
    assert abs(res.outer_iterations - int(ref.outer_iterations)) <= 1
    assert bool(res.converged) == bool(ref.converged)
    b64 = c["b"].astype(np.float64)
    true = np.linalg.norm(b64 - c["m"] @ res.x.double().numpy())
    assert true <= 2e-6 * np.linalg.norm(b64)


def test_bf16_plan_refuses_the_other_arms():
    with pytest.raises(ValueError, match="'gpr' arm"):
        plan_spmv(utils.power_law(3000, 3000, 8), dtype=torch.bfloat16,
                  device="cpu")
    with pytest.raises(ValueError, match="'bdia' arm"):
        plan_spmv(utils.block_laplacian(6, bs=8), dtype=torch.bfloat16,
                  device="cpu")


def test_bf16_kernels_take_float32_x_only():
    """bf16 coefficients pair with a float32 x and nothing else; the SpMMs
    take no bf16 data; K2's widened pattern is made once per pattern and
    again after an in-place change."""
    lo = plan_spmv(screened(16), dtype=torch.bfloat16, device="cpu")
    A = lo.matrix
    xp = torch.zeros(A.npad, dtype=torch.float64)
    with pytest.raises(TypeError, match="bfloat16"):
        tds.spmv_psdia_padded(A, xp)
    with pytest.raises(TypeError, match="bfloat16"):
        tds.spmm_psdia_padded_t(A, torch.zeros(2, A.npad))
    wide = tds._widened(A.pattern)
    assert wide.dtype == torch.float32 and wide is tds._widened(A.pattern)
    assert torch.equal(wide, A.pattern.float())
    A.pattern.mul_(2)
    again = tds._widened(A.pattern)
    assert again is not wide and torch.equal(again, A.pattern.float())
