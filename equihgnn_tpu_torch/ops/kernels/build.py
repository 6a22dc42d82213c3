"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `.cu` file under `equihgnn_tpu_torch/csrc/` is compiled for Hopper
(`sm_90a`) into one shared library with a plain C interface. The library
lands in `equihgnn_tpu_torch/_build/` (ignored by git) under a name that
hashes the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. The build happens at the first CUDA call of a
kernel wrapper, never at import.
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

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# C entry points: name -> argument types (each returns a cudaError_t as int)
SIGNATURES = {
    "sorted_segment_sum_f32": (_P, _P, _P, _I64, _I64, _I64, _P),
    "edge_mlp_fwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
            "equihgnn_tpu_torch cannot be built"
        )
    return path


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libequihgnn_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.equihgnn_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.equihgnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.equihgnn_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
