"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and are compiled with ``nvcc`` into
one shared library, loaded with :mod:`ctypes` — no PyTorch headers, so a
build takes seconds.  The build runs at first use, into
``build/tpu_spmv_torch/`` beside the package, keyed by a hash of the
sources and flags: a changed source rebuilds, an unchanged one loads the
library already built.  A failed build raises; nothing falls back.
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

__all__ = ["NVCC_FLAGS", "build_dir", "library_path", "load", "check"]

#: compile flags; ``sm_90a`` is Hopper with its architecture-specific
#: features (wgmma, setmaxnreg) available to later kernels.  The link adds
#: ``-shared``.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = ("dia_stream.cu", "general.cu", "dist_stream.cu", "permute.cu")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
#: C signature of every exported function: name -> argtypes (restype int)
_SIGNATURES = {
    "tsp_sdia_spmv_f32": [_P, _P, _I, _P, _P, _I64, _P],
    "tsp_sdia_spmv_f64": [_P, _P, _I, _P, _P, _I64, _P],
    "tsp_psdia_spmv_f32": [_P, _P, _I, _I64, _P, _P, _I64, _I64, _I64, _P],
    "tsp_psdia_spmv_f64": [_P, _P, _I, _I64, _P, _P, _I64, _I64, _I64, _P],
    "tsp_gpr_spmv_f32": [_P] * 6 + [_I64] * 5 + [_P],
    "tsp_gpr_spmv_f64": [_P] * 6 + [_I64] * 5 + [_P],
    "tsp_ell_spmv_f32": [_P] * 5 + [_I64, _P],
    "tsp_ell_spmv_f64": [_P] * 5 + [_I64, _P],
    "tsp_sdia_spmm_f32": [_P, _P, _I, _P, _P, _I64, _I, _P],
    "tsp_sdia_spmm_f64": [_P, _P, _I, _P, _P, _I64, _I, _P],
    "tsp_psdia_spmm_f32": [_P, _P, _I, _I64, _P, _P, _I64, _I64, _I64, _I,
                           _P],
    "tsp_psdia_spmm_f64": [_P, _P, _I, _I64, _P, _P, _I64, _I64, _I64, _I,
                           _P],
    "tsp_gpr_spmm_f32": [_P] * 6 + [_I64, _I, _P],
    "tsp_gpr_spmm_f64": [_P] * 6 + [_I64, _I, _P],
    "tsp_ell_spmm_f32": [_P] * 5 + [_I64, _I, _P],
    "tsp_ell_spmm_f64": [_P] * 5 + [_I64, _I, _P],
    "tsp_sdia_ring_f32": [_P, _P, _I, _P, _P, _P, _P, _I64, _I64, _P],
    "tsp_sdia_ring_f64": [_P, _P, _I, _P, _P, _P, _P, _I64, _I64, _P],
    "tsp_psdia_ring_f32": [_P, _P, _I, _I64] + [_P] * 4 + [_I64] * 5 + [_P],
    "tsp_psdia_ring_f64": [_P, _P, _I, _I64] + [_P] * 4 + [_I64] * 5 + [_P],
    "tsp_permute_gather": [_P, _P, _I, _P, _I64, _I, _P],
    "tsp_permute_gather_batched": [_P, _P, _I, _P, _I64, _I, _I, _P],
}


def build_dir() -> Path:
    """``build/tpu_spmv_torch/`` at the root of the checkout."""
    return _PKG.parent / "build" / "tpu_spmv_torch"


def _sources() -> list[Path]:
    return [_PKG / "csrc" / name for name in _SOURCES]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
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


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tsp_error_string.argtypes = [ctypes.c_int]
    lib.tsp_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.tsp_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({code}): {msg}")
