"""The probe kernels' plain versions against numpy: K9's scale, T1's copy,
T2's width-8 lane sum and every ``tile_permute`` variant of T3 and T4 at
the probes' shapes, each against the numpy composition of the Pallas
kernel body it replaces (``bench.py:_pallas_copy``,
``tools/profile_gpr.py``, ``tools/profile_reduce.py``,
``tools/profile_sublane.py``, ``tools/prof_tgtg_mxu.py``).

The probes move words, multiply once and add in a fixed order, so every
comparison is bitwise, except ``segsum8`` against numpy's own ``sum``
(another order; rel 1e-6).  On the CPU the wrappers take the plain
versions and count no launch."""

import numpy as np
import pytest
import torch

from tpu_spmv_torch.bench import probes as pr

torch.set_num_threads(1)

Q = pr.Q


def _seq_sum8(a: np.ndarray) -> np.ndarray:
    """The width-8 lane sum, left to right in float32."""
    a = a.reshape(*a.shape[:-1], Q // 8, 8)
    s = a[..., 0].copy()
    for k in range(1, 8):
        s = (s + a[..., k]).astype(np.float32)
    return s


def _tak(z, idx, axis):
    return np.take_along_axis(z, idx.astype(np.int64), axis=axis)


def _numpy_variant(name: str, t3: dict, t4: dict) -> np.ndarray:
    """The Pallas kernel bodies of the tools, per tile, in numpy."""
    z, g = t3["z"], t3["g"]
    T = z.shape[0]
    if name == "S":                                  # k_sub1
        return _tak(z, g, 1)
    if name == "G-S-G":                              # k_gsg
        return _tak(_tak(_tak(z, g, 2), g, 1), g, 2)
    if name.startswith("exchange"):                  # k_exch_sg(_red)
        rows = z.reshape(T * Q, Q)[t3["rowsrc"]].reshape(T, Q, Q)
        zz = _tak(_tak(rows, g, 1), g, 2)
        if name.endswith("psum8"):
            return _seq_sum8(zz * z)
        return zz
    if name == "s1v2":                               # k_s1v2
        rows = _tak(t3["x2d"][t3["gseg"]], t3["glidx"], 1).reshape(T, 88, Q)
        zz = np.concatenate([rows, np.zeros((T, Q - 88, Q), np.float32)], 1)
        return _tak(_tak(zz, g, 1), g, 2)
    assert name == "TGTG"                            # prof_tgtg_mxu tgtg
    Z = t4["Z"]
    g2 = np.broadcast_to(t4["g2"], Z.shape)
    g3 = np.broadcast_to(t4["g3"], Z.shape)
    zz = _tak(np.swapaxes(Z, -1, -2), g2, -1)
    return _tak(np.swapaxes(zz, -1, -2), g3, -1)


@pytest.fixture(scope="module")
def operands():
    """T3 at its 91 tiles; T4 cut from 100 x 5 tiles to 4 x 5 (the same
    shared index tiles and per-tile program)."""
    return pr.t3_operands(), pr.t4_operands(T=4)


@pytest.mark.parametrize("name", ["S", "G-S-G", "exchange + S-G",
                                  "exchange + S-G + psum8", "s1v2", "TGTG"])
def test_tile_permute_variant_matches_numpy(operands, name):
    t3, t4 = operands
    before = pr.LAUNCHES["tile_permute"]
    prog, src, mul, psum8 = pr.tile_variants(t3, t4, "cpu")[name]
    got = pr.tile_permute(prog, src, mul, psum8)
    want = _numpy_variant(name, t3, t4)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, pr.tile_permute_ref(prog, src, mul, psum8))
    assert pr.LAUNCHES["tile_permute"] == before


def test_copy_scale_is_float32_scale():
    x = np.random.default_rng(0).random(1000).astype(np.float32)
    want = x * np.float32(0.9999999)
    got = pr.copy_scale(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert pr.LAUNCHES["copy_scale"] == 0
    with pytest.raises(TypeError, match="float32"):
        pr.copy_scale(torch.zeros(4, dtype=torch.float64))


def test_launch_probe_copies_one_tile():
    t = torch.rand(Q, Q)
    out = pr.launch_probe(t)
    assert torch.equal(out, t) and out.data_ptr() != t.data_ptr()
    with pytest.raises(ValueError, match="128"):
        pr.launch_probe(torch.rand(64, Q))
    assert pr.LAUNCHES["launch_probe"] == 0


def test_segsum8_at_the_probe_shape():
    """T2's [16, 512, 128] values: bitwise the left-to-right float32 sum,
    within 1e-6 of numpy's float64 sum."""
    v = pr.t2_operand()
    got = pr.segsum8(torch.from_numpy(v))
    assert tuple(got.shape) == (16, 512, 16)
    np.testing.assert_array_equal(got.numpy(), _seq_sum8(v))
    exact = v.astype(np.float64).reshape(16, 512, 16, 8).sum(-1)
    assert np.max(np.abs(got.numpy() - exact)) <= 1e-6 * np.max(exact)
    assert torch.equal(got, pr.segsum8(torch.from_numpy(v)))
    assert pr.LAUNCHES["segsum8"] == 0


def test_tile_program_checks_on_the_host():
    g = np.zeros((Q, Q), np.int8)
    prog = pr.plan_tile_program("TG0TG1", np.stack([g, g])[:, None],
                                device="cpu")
    assert prog.steps == (("T", 0), ("G", 0), ("T", 0), ("G", 1))
    assert prog.code == 0x6 << 12 | 0x3 << 8 | 0x2 << 4 | 0x3
    with pytest.raises(ValueError, match="step string"):
        pr.plan_tile_program("SX", g, device="cpu")
    with pytest.raises(ValueError, match=r"\[0, 128\)"):
        pr.plan_tile_program("S", g + np.int8(-1), device="cpu")
    with pytest.raises(ValueError, match="slot"):
        pr.plan_tile_program("G1", g, device="cpu")
    with pytest.raises(TypeError, match="int8 or int32"):
        pr.plan_tile_program("S", g.astype(np.int64), device="cpu")
    with pytest.raises(ValueError, match="lidx needs rowsrc"):
        pr.plan_tile_program("S", g, lidx=np.zeros((Q, Q), np.int8),
                             device="cpu")
    per_tile = pr.plan_tile_program("S", np.zeros((3, Q, Q), np.int8),
                                    device="cpu")
    with pytest.raises(ValueError, match="tiles per slot"):
        pr.tile_permute(per_tile, torch.rand(2, Q, Q))
    rows = pr.plan_tile_program("S", g, rowsrc=np.arange(2 * Q) + 5,
                                device="cpu")
    assert rows.ntiles == 2 and rows.src_rows == 2 * Q + 5
    with pytest.raises(ValueError, match="src must be"):
        pr.tile_permute(rows, torch.rand(2 * Q, Q))


def test_probe_path_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        pr.run_probes("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        pr.copy_bandwidths("cpu")
