"""bf16 coefficients on every arm of the port's planner against the JAX
reference (its XLA arms on the CPU, the vectors float32), the general
packs at bf16 against the float32 packs of the rounded matrix, the bf16
plain versions against the kernels' order, and the oracle's bf16 gate.

Limits: each bf16 plan's product within 1e-6 relative of the reference's
bf16 plan of the same matrix (float32 sums of the same float32 products,
in another order); packs equal field for field; the plain versions equal,
bit for bit, a scalar emulation of the kernels' loops."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_spmv import utils
from tpu_spmv.ops import auto as jauto
from tpu_spmv_torch.bench.harness import verify_against_oracle
from tpu_spmv_torch.kernels import ell_packed as tell
from tpu_spmv_torch.kernels import gpr as tgpr
from tpu_spmv_torch.ops.auto import plan_spmv

from _solver_reference import rel

torch.set_num_threads(1)


def _shuffled_poisson(g: int) -> sp.csr_matrix:
    m = utils.laplacian_2d(g)
    perm = np.random.default_rng(3).permutation(m.shape[0])
    return m[perm][:, perm].tocsr()


def _wide_band(n: int = 300_000, off: int = 140_000) -> sp.csr_matrix:
    """Three diagonals too far apart for any streaming tile: plain DIA."""
    rng = np.random.default_rng(4)
    return sp.diags([rng.standard_normal(n - off), rng.standard_normal(n),
                     rng.standard_normal(n - off)], [-off, 0, off],
                    shape=(n, n), format="csr")


#: operand -> the port's strategy at bf16 (values float32 first, so both
#: packages round them to bf16 once, alike)
OPERANDS = {"gpr": lambda: utils.power_law(3000, 3000, 8, seed=1),
            "pallas_ell": lambda: _shuffled_poisson(40),
            "dia": _wide_band,
            "bdia": lambda: utils.block_laplacian(6, bs=8, seed=0),
            "csr": lambda: sp.csr_matrix((500, 500))}


@pytest.fixture(scope="module")
def case():
    """Each operand, a float32 x and the reference's bf16 plan's product,
    computed once."""
    out = {}
    for name, make in OPERANDS.items():
        m = make().astype(np.float32).tocsr()
        x = np.random.default_rng(7).random(m.shape[1]).astype(np.float32)
        pj = jauto.plan_spmv(m, dtype=jnp.bfloat16)
        y_j = jax.jit(lambda v: pj(v))(jnp.asarray(x))   # one compile
        out[name] = dict(m=m, x=x, y_j=np.asarray(y_j, np.float64))
    return out


@pytest.mark.parametrize("name", OPERANDS)
def test_bf16_plans_match_reference(case, name):
    """Every arm takes bf16 data: the strategy, float32 sums (the
    torch-code arms by type promotion), the product against the
    reference's bf16 plan and against scipy on the rounded matrix."""
    c = case[name]
    plan = plan_spmv(c["m"], dtype=torch.bfloat16, device="cpu")
    assert plan.strategy == name
    assert plan.matrix.dtype == torch.bfloat16
    y = plan(torch.from_numpy(c["x"]))
    assert y.dtype == torch.float32
    assert rel(y, c["y_j"]) <= 1e-6
    if name != "csr":
        r = c["m"].astype(np.float64)
        r.data = torch.from_numpy(r.data).to(torch.bfloat16).double().numpy()
        verify_against_oracle(plan.matrix, torch.from_numpy(c["x"]), y,
                              oracle=r, rounded=True)


@pytest.mark.parametrize("pack", [tgpr.pack_gpr, tell.pack_ell])
def test_bf16_packs_equal_float32_packs_of_the_rounded_matrix(case, pack):
    """pack_gpr / pack_ell at bf16 (hub rows, a side COO) equal, field for
    field, the float32 packs of the bf16-rounded matrix; the values the
    same numbers in bf16."""
    m = case["gpr"]["m"]
    r = m.copy()
    r.data = torch.from_numpy(r.data).to(torch.bfloat16).float().numpy()
    A16 = pack(m, dtype=torch.bfloat16, device="cpu")
    A32 = pack(r, dtype=torch.float32, device="cpu")

    def fields(A):
        for f in dataclasses.fields(A):
            v = getattr(A, f.name)
            if dataclasses.is_dataclass(v):
                yield from ((f"{f.name}.{k}", w) for k, w in fields(v))
            else:
                yield f.name, v

    n16 = 0
    for (k, a), (_, b) in zip(fields(A16), fields(A32)):
        if isinstance(a, torch.Tensor):
            if a.dtype == torch.bfloat16:
                n16 += 1
                assert b.dtype == torch.float32 and torch.equal(a.float(),
                                                                b), k
            else:
                assert torch.equal(a, b), k
        else:
            assert a == b, k
    assert n16 == (1 if pack is tgpr.pack_gpr else 2)
    assert pack is tgpr.pack_gpr or A16.side.nnz > 0


def _every_width(seed: int = 0) -> sp.csr_matrix:
    """Rows of every length 0 to 300: every GPR width class, hub rows;
    every sliced-ELL width and a side COO."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([np.arange(301), np.zeros(7, int)])
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = np.concatenate([rng.choice(2000, k, replace=False) for k in lens])
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(len(lens), 2000))


def test_bf16_plain_versions_sum_in_the_kernels_order():
    """The plain versions on bf16 data equal, bit for bit, a scalar
    emulation of the kernels' loops: each product rounded to float32;
    GPR lane l of a class's W/4 lanes adds entries l, l + W/4, ... then
    the butterfly (lane l plus lane l + h); sliced ELL adds a row's slots
    in order over the slice's width."""
    m = _every_width()
    x = np.random.default_rng(1).standard_normal(2000).astype(np.float32)
    xt = torch.from_numpy(x)
    f32 = np.float32

    A = tgpr.pack_gpr(m, dtype=torch.bfloat16, device="cpu")
    assert A.nv > 0 and all(A.class_rows)
    data, ind = A.data.float().numpy(), A.indices.numpy()
    ptr, rows = A.indptr.numpy(), A.rows.numpy()
    want = np.empty(A.nrow_internal, f32)
    first = 0
    for lanes, n in zip(tgpr.CLASS_LANES, A.class_rows):
        for r in range(first, first + n):
            acc = []
            for lane in range(lanes):
                a = f32(0)
                for j in range(ptr[r] + lane, ptr[r + 1], lanes):
                    a = f32(a + f32(data[j] * x[ind[j]]))
                acc.append(a)
            while len(acc) > 1:
                h = len(acc) // 2
                acc = [f32(acc[i] + acc[i + h]) for i in range(h)]
            want[rows[r]] = acc[0]
        first += n
    assert np.array_equal(tgpr.spmv_gpr_ref(A, xt).numpy(), want)

    E = tell.pack_ell(m, dtype=torch.bfloat16, device="cpu")
    vals, cols = E.vals.float().numpy(), E.cols.numpy()
    sptr = E.slice_ptr.numpy()
    want = np.empty(m.shape[0], f32)
    for row in range(m.shape[0]):
        s, a = row // 32, f32(0)
        for j in range((sptr[s + 1] - sptr[s]) // 32):
            k = sptr[s] + 32 * j + row % 32
            a = f32(a + f32(vals[k] * x[cols[k]]))
        want[row] = a
    assert np.array_equal(tell.spmv_ell_packed_ref(E, xt).numpy(), want)


def test_bf16_oracle_gate():
    """A bf16 product passes the reference's 2e-2 gate against the
    unrounded matrix and fails the float32 gate there (``rounded=True``
    claims the oracle is the rounded matrix); against the rounded matrix
    it passes 2e-5."""
    m = utils.random_sparse(2000, 2000, 0.005, seed=3).tocsr()
    plan = plan_spmv(m, dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).random(2000).astype(
        np.float32))
    y = plan(x)
    err = verify_against_oracle(plan.matrix, x, y, oracle=m)
    assert 2e-5 < err <= 2e-2
    with pytest.raises(AssertionError, match="verification failed"):
        verify_against_oracle(plan.matrix, x, y, oracle=m, rounded=True)
    r = m.copy()
    r.data = torch.from_numpy(r.data).to(torch.bfloat16).double().numpy()
    assert verify_against_oracle(plan.matrix, x, y, oracle=r,
                                 rounded=True) <= 2e-5
    # a bf16 output (the CLI's result type) takes the same gate
    assert verify_against_oracle(plan.matrix, x, y.to(torch.bfloat16),
                                 oracle=m) <= 2e-2
