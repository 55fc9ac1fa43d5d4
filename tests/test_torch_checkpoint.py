"""Checkpoints of the port's formats: every format round-trips through
``save_matrix`` / ``load_matrix`` field for field, bf16 values included,
and its reloaded product is bitwise the original's; vectors round-trip;
a stale field raises, as in the JAX reference."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_spmv as ts
from tpu_spmv import utils
from tpu_spmv.io import checkpoint as jck
from tpu_spmv_torch import COO, convert, spmv
from tpu_spmv_torch.io import checkpoint as ck

torch.set_num_threads(1)


def assert_same(a, b, where="matrix"):
    """Two port objects equal field for field: tensors bitwise, with the
    same type and device; statics equal; nested dataclasses alike."""
    assert type(a) is type(b), where
    for f in dataclasses.fields(a):
        u, v = getattr(a, f.name), getattr(b, f.name)
        at = f"{where}.{f.name}"
        if isinstance(u, torch.Tensor):
            assert isinstance(v, torch.Tensor), at
            assert u.dtype == v.dtype and u.device == v.device, at
            assert u.shape == v.shape and torch.equal(u, v), at
        elif dataclasses.is_dataclass(u):
            assert_same(u, v, at)
        else:
            assert u == v and type(u) is type(v), at


@pytest.mark.parametrize("fmt", ["coo", "csr", "csc", "ell", "dia", "bsr",
                                 "bdia"])
def test_format_roundtrip(tmp_path, fmt):
    """Each basic format, float64 and bf16, round-trips exactly; the
    reloaded product is the original's bit for bit."""
    m = utils.random_sparse(300, 300, 0.03, seed=1)
    x = torch.from_numpy(np.random.default_rng(0).random(300).astype(
        np.float32))
    for dtype in (torch.float64, torch.bfloat16):
        A = convert(COO.from_scipy(m, dtype=dtype, device="cpu"), fmt)
        f = tmp_path / f"{fmt}.npz"
        ck.save_matrix(f, A, extra={"strategy": fmt})
        B, extra = ck.load_matrix(f, with_extra=True, device="cpu")
        assert extra == {"strategy": fmt}
        assert_same(A, B)
        xv = x.to(torch.float64) if dtype == torch.float64 else x
        assert torch.equal(spmv(A, xv), spmv(B, xv))


def test_vector_roundtrip(tmp_path):
    """save_vector / load_vector keep a tensor's type and bits (bf16 by
    its words); a host array comes back as its tensor."""
    rng = np.random.default_rng(2)
    for v in (torch.from_numpy(rng.standard_normal(77)),
              torch.from_numpy(rng.standard_normal(77)).to(torch.bfloat16),
              torch.arange(9, dtype=torch.int32)):
        ck.save_vector(tmp_path / "v.npz", v)
        w = ck.load_vector(tmp_path / "v.npz", device="cpu")
        assert w.dtype == v.dtype and torch.equal(w, v)
    ck.save_vector(tmp_path / "h.npz", np.arange(5.0))
    assert torch.equal(ck.load_vector(tmp_path / "h.npz", device="cpu"),
                       torch.arange(5.0, dtype=torch.float64))


def test_stale_checkpoint_raises_like_the_reference(tmp_path):
    """A field the class no longer has makes the checkpoint stale, in the
    port as in the reference (a ValueError the CLI takes as re-pack); an
    unknown object refuses to save."""
    m = utils.laplacian_2d(6)

    def tamper(path):
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(bytes(arrays.pop("__meta__")).decode())
        meta["spec"]["static"]["b1"] = 3
        np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                              np.uint8), **arrays)

    ours, ref = tmp_path / "t.npz", tmp_path / "j.npz"
    ck.save_matrix(ours, COO.from_scipy(m, device="cpu"))
    jck.save_matrix(ref, ts.COO.from_scipy(m.tocoo(), dtype=jnp.float64))
    for path, load in ((ours, lambda p: ck.load_matrix(p, device="cpu")),
                       (ref, jck.load_matrix)):
        tamper(path)
        with pytest.raises(ValueError, match=r"stale checkpoint: COO no "
                           r"longer has field\(s\) \['b1'\]"):
            load(path)
    with pytest.raises(TypeError, match="not a serializable"):
        ck.save_matrix(tmp_path / "x.npz", dataclasses.make_dataclass(
            "Other", [("a", int)])(1))
