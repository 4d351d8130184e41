"""Build the hand-written CUDA kernels and bind them through ``ctypes``.

The sources under ``src/repro_torch/csrc/`` have a plain C interface (no
PyTorch headers), so ``nvcc`` compiles each in seconds.  At first use,
:func:`library` starts one ``nvcc -c`` per source, all at once, links the
objects into one shared library for ``sm_90a`` and loads it.  The build
directory is ``src/repro_torch/_build/`` (listed in ``.gitignore``); the
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused by a later process.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("dilate.cu", "matmul.cu", "knn.cu", "hbm_blas.cu",
           "flash_attention.cu", "flash_attention_sm90.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class LaunchCounter:
    """How many times a wrapper launched its kernel (and nothing else)."""

    name: str
    count: int = 0


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """One build (or reuse) of the kernel library."""

    path: Path
    seconds: float        # wall time of this build; 0.0 when reused
    built: bool           # False when an existing library was loaded
    log: str              # nvcc's output (ptxas -v lines), "" when reused


# One library per process: ctypes keeps it loaded for the process's life.
_LOADED: Dict[str, object] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "repro_torch CUDA kernels are built from source at first use")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands concurrently; raise with the output of any that
    fails, else return all their output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(outs)


def build() -> BuildInfo:
    """Compile and link the library unless this source hash is built."""
    lib_path = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if lib_path.exists():
        return BuildInfo(lib_path, 0.0, False, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    log = _run_all([[nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c",
                     str(CSRC_DIR / s), "-o", str(o)]
                    for s, o in zip(SOURCES, objs)])
    tmp = BUILD_DIR / f"{lib_path.stem}.{tag}.tmp.so"
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    os.replace(tmp, lib_path)     # atomic: a concurrent build loses nothing
    for o in objs:
        o.unlink()
    return BuildInfo(lib_path, time.perf_counter() - t0, True, log)


_VP, _INT = ctypes.c_void_p, ctypes.c_int
_I64, _F32 = ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "repro_dilate_f32": [_VP, _VP, _INT, _INT, _INT, _VP],
    "repro_matmul_f32": [_VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "repro_matmul_narrow_f32": [_VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP],
    "repro_knn_f32": [_VP, _VP, _VP, _VP, _VP, _VP,
                      _INT, _INT, _INT, _INT, _INT, _INT, _VP],
    "repro_knn_tile": [],
    "repro_axpy_f32": [_F32, _VP, _VP, _VP, _I64, _VP],
    "repro_dot_chunk": [],
    "repro_dot_partials_f32": [_VP, _VP, _VP, _VP, _INT, _I64, _VP],
    "repro_gemv_f32": [_VP, _VP, _VP, _INT, _I64, _INT, _VP],
    "repro_flash_attention": [_INT, _VP, _VP, _VP, _VP, _VP,
                              _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                              _F32, _F32, _INT, _INT, _INT, _VP],
    "repro_flash_attention_sm90": [_VP, _VP, _VP, _VP, _VP, _VP,
                                   _INT, _INT, _INT, _INT, _INT, _INT, _INT,
                                   _F32, _F32, _INT, _INT, _VP, _VP],
}


def library():
    """The loaded kernel library, built on first use (see :func:`build`)."""
    lib = _LOADED.get("lib")
    if lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LOADED["lib"] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the C interface takes it."""
    return torch.cuda.current_stream(device).cuda_stream
