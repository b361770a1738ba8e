"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library of its own
with a plain C interface (no PyTorch headers, so a build takes seconds), and
is loaded with ctypes.  Libraries are built at first use into ``_build/``
beside the package (listed in .gitignore), named by a hash of the source and
flags so that an edited kernel is rebuilt.  ``build()`` compiles several
sources at once, one nvcc process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["KERNEL_SOURCES", "BUILD_DIR", "build", "load", "check",
           "stream_ptr"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("affine_w4_matmul", "flash_attn_fwd", "int_kv_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ with the CUDA toolkit's nvcc")
    return path


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, dict]:
    """Compile every library of ``names`` that is not built yet, all nvcc
    processes started together.  Returns {name: {"seconds", "log"}} for the
    sources compiled by this call (the log holds ptxas' register and spill
    report); raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        src, out = _paths(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _, out = _paths(name)
        if not out.exists():
            build((name,))
        lib = ctypes.CDLL(str(out))
        lib.qt_error_string.argtypes = [ctypes.c_int]
        lib.qt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = lib.qt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
