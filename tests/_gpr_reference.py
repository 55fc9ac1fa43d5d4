"""The JAX reference's GPR SpMV products that ``test_torch_gpr.py`` holds
the port's against.

The reference runs its Pallas kernels in interpret mode here, which costs
about ten seconds per distinct pack (tracing and compiling the pipeline),
so one pack serves every operand: the block-diagonal stack of the
operands, whose ``spmv_gpr`` (K5) is computed once per process; each
operand's product is its block of rows.
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


@functools.cache
def stacked_product():
    """``(x, y, offsets)``: float32 ``x`` over the stack, ``y`` the
    reference's float32 ``spmv_gpr`` of it, and each operand's (row,
    column) offset in the stack."""
    mats = [OPERANDS[name]() for name in OPERANDS]
    stack = sp.block_diag(mats, format="csr")
    x = np.random.default_rng(5).random(stack.shape[1]).astype(np.float32)
    A_j = jgpr.pack_gpr(stack, dtype=np.float32)
    y = np.asarray(jgpr.spmv_gpr(A_j, jnp.asarray(x), interpret=True))
    offsets = np.cumsum([(0, 0)] + [m.shape for m in mats], axis=0)
    return x, y, dict(zip(OPERANDS, (tuple(o) for o in offsets)))


def block(name):
    """``(matrix, x, y)`` of one operand: its columns of the stack's x and
    its rows of the stacked product."""
    m = OPERANDS[name]()
    x, y, offsets = stacked_product()
    r0, c0 = offsets[name]
    return m, x[c0:c0 + m.shape[1]], y[r0:r0 + m.shape[0]]
