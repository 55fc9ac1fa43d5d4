"""The port's one launch path (``tpu_spmv_torch/kernels/_build.py``:
``launcher``) on the CPU: its table of C signatures against the CUDA
sources, that no other module launches by itself, and the launcher's own
rules (device check before the library loads, names resolved once, the
stream read on every call, the device switched only when it must be),
driven through a fake library.  The launches themselves run on the card
(``tests/test_torch_cuda.py``)."""

import contextlib
import ctypes
import re
from pathlib import Path

import pytest
import torch

from tpu_spmv_torch import utils
from tpu_spmv_torch.bench import probes as pr
from tpu_spmv_torch.kernels import _build
from tpu_spmv_torch.kernels import gpr as tgpr

torch.set_num_threads(1)

PKG = Path(_build.__file__).resolve().parent.parent

#: C parameter type -> the ctypes type its argtypes entry must be
_CTYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
           "int64_t": ctypes.c_int64, "unsigned": ctypes.c_uint32,
           "uint32_t": ctypes.c_uint32}


def _extern_c_blocks(text: str):
    """The bodies of the ``extern "C" { ... }`` blocks (braces matched)."""
    for m in re.finditer(r'extern "C"\s*\{', text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        yield text[m.end():i - 1]


def _exported() -> dict:
    """Every ``int tsp_*(...)`` inside an ``extern "C"`` block of
    ``csrc/*.cu``: name -> the ctypes types of its parameters."""
    found = {}
    for src in sorted((PKG / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for block in _extern_c_blocks(text):
            for name, params in re.findall(r"\bint\s+(tsp_\w+)\s*\(([^)]*)\)",
                                           block):
                kinds = []
                for p in params.split(","):
                    words = p.replace("*", " * ").split()[:-1]   # drop name
                    words = [w for w in words if w != "const"]
                    key = "void*" if "*" in words else " ".join(words)
                    kinds.append(_CTYPES[key])
                assert name not in found, f"{name} exported twice"
                found[name] = kinds
    return found


EXPORTED = _exported()


def test_signatures_name_every_exported_function():
    assert len(EXPORTED) >= 26
    assert set(_build._SIGNATURES) == set(EXPORTED)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_the_source(name):
    """Pointers are ``c_void_p`` (a bare int is cut to 32 bits), each
    ``int64_t`` length ``c_int64`` (a ``c_int`` wraps past 2^31)."""
    assert _build._SIGNATURES[name] == EXPORTED[name]


def test_only_the_launcher_enters_a_device_or_reads_a_stream():
    """Every wrapper launches through ``_build.launcher``: no other module
    of the package switches device, reads a stream handle, loads the
    library or names a C function."""
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        if path == PKG / "kernels" / "_build.py":
            continue
        text = path.read_text()
        for pattern in ("torch.cuda.device(", ".cuda_stream", "_build.load(",
                        "_cuda_getCurrentRawStream", '"tsp_'):
            if pattern in text:
                offenders.append(f"{path.relative_to(PKG)}: {pattern}")
    assert offenders == []


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything loads (or builds) the kernel library."""
    def load():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", load)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_launcher_refuses_a_tensor_off_the_card(no_library, device):
    x = torch.zeros(4, device=device)
    launch = _build.launcher("copy_scale")
    with pytest.raises(ValueError,
                       match=f"copy_scale: no kernel for {device}"):
        launch(x, x.data_ptr(), x.data_ptr(), 4)


@pytest.mark.parametrize("fn", [pr.launch_probe, pr.segsum8, pr.copy_scale])
def test_probe_wrappers_raise_on_meta_without_a_launch(no_library, fn):
    before = dict(pr.LAUNCHES)
    with pytest.raises(ValueError, match="no kernel for meta"):
        fn(torch.zeros(pr.Q, pr.Q, device="meta"))
    assert pr.LAUNCHES == before


def test_launcher_resolves_names_once_without_the_library(no_library):
    assert _build.symbol("sdia_spmv", torch.float64) == "tsp_sdia_spmv_f64"
    assert _build.symbol("permute_gather") == "tsp_permute_gather"
    launch = _build.launcher("sdia_spmv", torch.float64)
    assert launch.symbol == "tsp_sdia_spmv_f64"
    assert _build.launcher("sdia_spmv", torch.float64) is launch
    assert _build.launcher("gpr_spmv", torch.float32).symbol == \
        "tsp_gpr_spmv_f32"
    with pytest.raises(TypeError, match="float16"):
        _build.launcher("sdia_spmv", torch.float16)
    with pytest.raises(ValueError, match="no tsp_no_such_kernel"):
        _build.launcher("no_such_kernel")
    with pytest.raises(ValueError, match="tsp_sdia_spmv"):
        _build.launcher("sdia_spmv")            # built per value type
    with pytest.raises(ValueError, match="tsp_launch_probe_f32"):
        _build.launcher("launch_probe", torch.float32)


class _CardTensor:
    """Stands in for a tensor on ``cuda:<index>``."""

    is_cuda = True

    def __init__(self, index):
        self.index = index

    def get_device(self):
        return self.index


def test_launcher_reads_the_stream_each_call_and_switches_only_off_device(
        monkeypatch):
    """Through a fake library: the current stream is read anew on every
    call (a cached handle would launch outside a graph capture), the
    device is entered only for a tensor off the current card, and a code
    other than 0 raises with CUDA's message."""
    calls, entered = [], []
    streams = {"now": 7000}

    class FakeLib:
        @staticmethod
        def tsp_launch_probe(*args):
            calls.append(args)
            return 0 if args[0] != 666 else 9

        @staticmethod
        def tsp_error_string(code):
            return b"invalid configuration argument"

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    monkeypatch.setattr(_build, "load", lambda: FakeLib)
    monkeypatch.setattr(_build, "_cuda_hooks", lambda: (
        lambda: 0, lambda index: streams["now"] + index))
    monkeypatch.setattr(torch.cuda, "device", device)
    launch = _build.launcher.__wrapped__("launch_probe")   # a fresh binding
    launch(_CardTensor(0), 1, 2)
    streams["now"] = 8000
    launch(_CardTensor(0), 3, 4)
    launch(_CardTensor(1), 5, 6)
    assert calls == [(1, 2, 7000), (3, 4, 8000), (5, 6, 8001)]
    assert entered == [1]
    with pytest.raises(RuntimeError, match="launch_probe: CUDA launch "
                       "failed \\(9\\): invalid configuration"):
        launch(_CardTensor(0), 666, 0)


def test_gpr_wrapper_counts_nothing_it_does_not_launch(no_library):
    m = utils.power_law(200, 200, 8, seed=1)
    A = tgpr.pack_gpr(m, dtype=torch.float32, device="cpu")
    before = dict(tgpr.LAUNCHES)
    with pytest.raises(ValueError, match="gpr_spmv: no kernel for meta"):
        tgpr.spmv_gpr_rows(A.to("meta"), torch.zeros(200, device="meta"))
    assert tgpr.LAUNCHES == before


def test_launch_ab_needs_a_card(monkeypatch):
    """The A/B timing script refuses to run without a card (it never
    times the CPU under the name of a kernel)."""
    import sys

    from tpu_spmv_torch.bench import launch_ab

    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        launch_ab.main(["--root", str(PKG.parent)])
