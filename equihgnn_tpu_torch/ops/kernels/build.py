"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `.cu` file under `equihgnn_tpu_torch/csrc/` is compiled for Hopper
(`sm_90a`) into one shared library with a plain C interface. The library
lands in `equihgnn_tpu_torch/_build/` (ignored by git) under a name that
hashes the sources, the headers they share (`*.cuh`) and the flags, so
an edited source is rebuilt and an unchanged one is reused. The build happens at the first CUDA call of a
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
NVCC_FLAGS = (  # per source, compiled to an object file
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I64, _I, _U32, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float)
# C entry points: name -> argument types (each returns a cudaError_t as int)
SIGNATURES = {
    "sorted_segment_sum_f32": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P),
    "edge_mlp_fwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P),
    "edge_mlp_bwd_workspace_f32": (_I, _I, _I, _I, _I, ctypes.POINTER(_I64)),
    "edge_mlp_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P),
    "frame_swiglu_fwd_f32": (_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _U32, _F, _U32, _P),
    "frame_swiglu_bwd_workspace_f32": (_I64, _I, _I, ctypes.POINTER(_I64)),
    "frame_swiglu_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _U32, _F, _U32,
                             _P),
    "vis_vec_agg_fwd_f32": (_P, _P, _I64, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "vis_vec_agg_bwd_f32": (_P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _P),
    "vis_wdot_fwd_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "vis_wdot_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "pooled_conv_fwd_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "pooled_conv_bwd_workspace_f32": (_I, _I, _I, ctypes.POINTER(_I64)),
    "pooled_conv_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "pooled_m_fwd_bf16": (_P, _P, _P, _I64, _I, _I, _I, _P),
    "pooled_m_fwd_f32": (_P, _P, _P, _I64, _I, _I, _I, _P),
    "pooled_m_bwd_bf16": (_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P),
    "pooled_m_bwd_f32": (_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P),
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
    for src in sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libequihgnn_kernels-{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise on the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]  # wait for all before raising
    for cmd, proc, (stdout, stderr) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stdout}\n{stderr}"
            )


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists: one
    nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
              for src, obj in zip(sources(), objs)])
        lib = os.path.join(tmp, "lib.so")
        _run([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)  # atomic: a concurrent build sees all or none
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
