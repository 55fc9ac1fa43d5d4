"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and are compiled with ``nvcc`` into
one shared library, loaded with :mod:`ctypes` — no PyTorch headers, so a
build takes seconds.  The build runs at first use, into
``build/tpu_spmv_torch/`` beside the package, keyed by a hash of the
sources, their headers and the flags: a changed source rebuilds, an
unchanged one loads the library already built.  A failed build raises; nothing falls back.

Every kernel wrapper launches through :func:`launcher`: one callable per C
function, bound to its ctypes function when the library loads, that reads
the current stream of the tensor's card on every call and raises with
CUDA's message when a launch is refused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["NVCC_FLAGS", "build_dir", "library_path", "declare", "load",
           "check", "symbol", "launcher"]

#: compile flags; ``sm_90a`` is Hopper with its architecture-specific
#: features (wgmma, setmaxnreg) available to later kernels.  The link adds
#: ``-shared``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = ("dia_stream.cu", "general.cu", "dist_stream.cu", "permute.cu",
            "probes.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
#: C signature of every exported function: name -> argtypes (restype int)
_SIGNATURES = {
    "tsp_sdia_spmv_f32": [_P, _P, _I, _P, _P, _I64, _P],
    "tsp_sdia_spmv_f64": [_P, _P, _I, _P, _P, _I64, _P],
    "tsp_sdia_spmv_bf16f32": [_P, _P, _I, _P, _P, _I64, _P],
    "tsp_psdia_spmv_f32": [_P] * 4 + [_I64] * 3 + [_P],
    "tsp_psdia_spmv_f64": [_P] * 4 + [_I64] * 3 + [_P],
    "tsp_gpr_spmv_f32": [_P] * 6 + [_I64] * 5 + [_P],
    "tsp_gpr_spmv_f64": [_P] * 6 + [_I64] * 5 + [_P],
    "tsp_ell_spmv_f32": [_P] * 5 + [_I64, _P],
    "tsp_ell_spmv_f64": [_P] * 5 + [_I64, _P],
    "tsp_gpr_spmv_bf16f32": [_P] * 6 + [_I64] * 5 + [_P],
    "tsp_ell_spmv_bf16f32": [_P] * 5 + [_I64, _P],
    "tsp_sdia_spmm_f32": [_P, _P, _I, _P] + [_I] * 6 + [_I64, _P, _P,
                                                          _I64, _I64, _I64,
                                                          _I, _P],
    "tsp_sdia_spmm_f64": [_P, _P, _I, _P] + [_I] * 6 + [_I64, _P, _P,
                                                          _I64, _I64, _I64,
                                                          _I, _P],
    "tsp_sdia_spmm_bf16f32": [_P, _P, _I, _P] + [_I] * 6 + [_I64, _P, _P,
                                                              _I64, _I64,
                                                              _I64, _I, _P],
    "tsp_psdia_spmm_f32": [_P, _P, _I, _P] + [_I] * 6 + [_I64, _P, _P,
                                                           _I64, _I64, _I64,
                                                           _I, _P],
    "tsp_psdia_spmm_f64": [_P, _P, _I, _P] + [_I] * 6 + [_I64, _P, _P,
                                                           _I64, _I64, _I64,
                                                           _I, _P],
    "tsp_gpr_spmm_f32": [_P] * 6 + [_I64, _I, _P],
    "tsp_gpr_spmm_f64": [_P] * 6 + [_I64, _I, _P],
    "tsp_gpr_spmm_bf16f32": [_P] * 6 + [_I64, _I, _P],
    "tsp_ell_spmm_f32": [_P] * 5 + [_I64, _I, _P],
    "tsp_ell_spmm_f64": [_P] * 5 + [_I64, _I, _P],
    "tsp_ell_spmm_bf16f32": [_P] * 5 + [_I64, _I, _P],
    "tsp_sdia_ring_f32": [_P, _P, _I] + [_P] * 4 + [_I64] * 4 + [_P],
    "tsp_sdia_ring_f64": [_P, _P, _I] + [_P] * 4 + [_I64] * 4 + [_P],
    "tsp_sdia_ring_bf16f32": [_P, _P, _I] + [_P] * 4 + [_I64] * 4 + [_P],
    "tsp_psdia_ring_f32": [_P] * 6 + [_I64] * 5 + [_P],
    "tsp_psdia_ring_f64": [_P] * 6 + [_I64] * 5 + [_P],
    "tsp_permute_gather": [_P, _P, _I, _P, _I64, _I, _P],
    "tsp_permute_two_pass": [_P] * 6 + [_I64, _I, _I, _P],
    "tsp_permute_pass1": [_P] * 4 + [_I64, _I, _I, _P],
    "tsp_permute_pass2": [_P] * 4 + [_I64, _I, _I, _P],
    "tsp_permute_gather_batched": [_P, _P, _I, _P, _I64, _I, _I, _I, _P],
    "tsp_permute_rows_two_pass": [_P] * 7 + [_I64, _I64] + [_I] * 4 + [_P],
    "tsp_copy_scale": [_P, _P, _I64, _P],
    "tsp_launch_probe": [_P, _P, _P],
    "tsp_segsum8": [_P, _P, _I64, _P],
    "tsp_tile_permute": [_P, _P, _P, _I, _P, _I64, _P],
}


def build_dir() -> Path:
    """``build/tpu_spmv_torch/`` at the root of the checkout."""
    return _PKG.parent / "build" / "tpu_spmv_torch"


def _sources() -> list[Path]:
    return [_PKG / "csrc" / name for name in _SOURCES]


def library_path() -> Path:
    """Where the library for the current sources (and the headers they
    include) and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*_sources(), *sorted((_PKG / "csrc").glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libtpu_spmv_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME); the CUDA kernels cannot be built")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands at the same time; raise with the first failure's
    stderr after all have ended."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    errs = [proc.communicate()[1] for proc in procs]
    for cmd, proc, err in zip(cmds, procs, errs):
        code = proc.returncode
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n"
                               f"{err}")


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    # one nvcc per source, all started together, then one link; everything
    # goes to a temporary directory and the library is renamed into place,
    # so a concurrent build never loads a half-written library
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for obj, src in zip(objs, _sources())])
        lib = os.path.join(tmp, out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set ``argtypes`` and ``restype`` of every exported function of a
    handle on the library."""
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tsp_error_string.argtypes = [ctypes.c_int]
    lib.tsp_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load() -> ctypes.PyDLL:
    """Build (if needed) and load the kernel library; raises on failure.

    Loaded as ``PyDLL``: a call keeps the GIL, which costs nothing because
    every function only enqueues work and returns, and skips the release
    and re-acquire of ``CDLL`` (no slower on the H100's host, up to 0.13
    µs a call faster: ``chip_smoke.py``'s host breakdown)."""
    path = library_path()
    if not path.exists():
        _compile(path)
    return declare(ctypes.PyDLL(str(path)))


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.tsp_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def symbol(name: str, dtype: torch.dtype | None = None) -> str:
    """The C function of kernel ``name``: ``tsp_<name>``, or
    ``tsp_<name>_f32`` / ``_f64`` for a kernel built once per value type
    (``dtype``).  Raises for a type or a name that has no function."""
    if dtype is None:
        sym = f"tsp_{name}"
    elif dtype in _SUFFIX:
        sym = f"tsp_{name}_{_SUFFIX[dtype]}"
    else:
        raise TypeError(f"{name}: no kernel for {dtype}")
    if sym not in _SIGNATURES:
        raise ValueError(f"{name}: the library exports no {sym}")
    return sym


def _cuda_hooks():
    # PyTorch's private bindings (torch.cuda.current_device's own, and the
    # raw stream Triton and Inductor launch on): the current device, and a
    # device's current cudaStream_t as an int
    return torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream


@functools.cache
def launcher(name: str, dtype: torch.dtype | None = None):
    """The launch of kernel ``name`` (:func:`symbol`): ``launch(t, *args)``
    calls the C function with ``args`` and the current stream of ``t``'s
    card, from that card.

    ``t`` not on a CUDA device raises ``ValueError`` before the library is
    loaded; a launch that returns an error code raises with CUDA's
    message.  The stream is read on every call, so a launch goes to
    whatever stream is current then (a side stream, a graph capture).  The
    device is switched only when ``t``'s card is not the current one."""
    sym = symbol(name, dtype)
    fn = current = stream_of = None

    def launch(t: torch.Tensor, *args) -> None:
        nonlocal fn, current, stream_of
        if not t.is_cuda:
            raise ValueError(f"{name}: no kernel for {t.device}")
        if fn is None:
            fn = getattr(load(), sym)
            current, stream_of = _cuda_hooks()
        index = t.get_device()
        if index == current():
            code = fn(*args, stream_of(index))
        else:
            with torch.cuda.device(index):
                code = fn(*args, stream_of(index))
        if code:
            check(load(), name, code)

    launch.symbol = sym
    return launch
