"""The JAX reference's GPR products that ``test_torch_gpr.py`` (SpMV) and
``test_torch_spmm.py`` (SpMM) hold the port's against.

The reference runs its Pallas kernels in interpret mode here, which costs
about ten seconds per distinct pack and kernel (tracing and compiling the
pipeline), so one call serves every operand and both files: the reference's
``spmm_gpr`` (K6 and the RHS-batched K5b) on the block-diagonal stack of
the operands, computed once per process.  Column 0 of its right-hand
sides is the SpMV's x over the whole stack, so each operand's SpMV product
is its block of rows of column 0; columns 1 to ``SPMM_NRHS`` hold the
SpMM test's X in powerlaw800's block of columns and zeros elsewhere, so
powerlaw800's SpMM product is its block of rows of those columns.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import scipy.io as sio
import scipy.sparse as sp

from tpu_spmv import utils
from tpu_spmv.kernels import gpr as jgpr

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
#: random_sparse is uniform (no hub rows); the power-law fixture has 4 rows
#: over 128 entries, so the hub split and the fold engage on both sides
OPERANDS = {
    "random_sparse(300,20000)":
        lambda: utils.random_sparse(300, 20000, 8 / 20000, seed=7),
    "powerlaw800": lambda: sio.mmread(os.path.join(
        FIX, "powerlaw800.mtx")).tocsr(),
}
#: right-hand sides of the SpMM test (on powerlaw800)
SPMM_NRHS = 3


def spmm_x(n: int) -> np.ndarray:
    """The SpMM test's float32 X ``[n, SPMM_NRHS]``."""
    return np.random.default_rng(1).random((n, SPMM_NRHS)).astype(
        np.float32)


@functools.cache
def stacked_product():
    """``(x, Y, offsets)``: float32 ``x`` over the stack, ``Y`` the
    reference's float32 ``spmm_gpr`` of ``[x | X]`` (module docstring),
    and each operand's (row, column) offset in the stack."""
    mats = [OPERANDS[name]() for name in OPERANDS]
    stack = sp.block_diag(mats, format="csr")
    x = np.random.default_rng(5).random(stack.shape[1]).astype(np.float32)
    offsets = dict(zip(OPERANDS, (tuple(o) for o in np.cumsum(
        [(0, 0)] + [m.shape for m in mats], axis=0))))
    X = np.zeros((stack.shape[1], 1 + SPMM_NRHS), np.float32)
    X[:, 0] = x
    c0, ncol = offsets["powerlaw800"][1], mats[1].shape[1]
    X[c0:c0 + ncol, 1:] = spmm_x(ncol)
    A_j = jgpr.pack_gpr(stack, dtype=np.float32)
    Y = np.asarray(jgpr.spmm_gpr(A_j, jnp.asarray(X), interpret=True))
    return x, Y, offsets


def block(name):
    """``(matrix, x, y)`` of one operand: its columns of the stack's x and
    its rows of the stacked product's column 0."""
    m = OPERANDS[name]()
    x, Y, offsets = stacked_product()
    r0, c0 = offsets[name]
    return m, x[c0:c0 + m.shape[1]], Y[r0:r0 + m.shape[0], 0]


def spmm_block():
    """``(matrix, X, Y)`` of powerlaw800's SpMM: the SpMM test's X and its
    rows of the stacked product's columns 1 to ``SPMM_NRHS``."""
    m = OPERANDS["powerlaw800"]()
    _, Y, offsets = stacked_product()
    r0 = offsets["powerlaw800"][0]
    return m, spmm_x(m.shape[1]), Y[r0:r0 + m.shape[0], 1:]
