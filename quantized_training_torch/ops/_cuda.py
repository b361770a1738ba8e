"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library of its own
with a plain C interface (no PyTorch headers, so a build takes seconds), and
is loaded with ctypes.  Libraries are built at first use into ``_build/``
beside the package (listed in .gitignore), named by a hash of the source,
every shared header ``csrc/*.cuh`` and the flags, so that an edited kernel
or header is rebuilt.  ``build()`` compiles several sources at once, one
nvcc process each.  :class:`QtFormat` is the rounding descriptor that the
kernels of ``csrc/qt_round.cuh`` take by value.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["KERNEL_SOURCES", "BUILD_DIR", "QtFormat", "build", "load",
           "check", "qt_format", "stream_ptr"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNEL_SOURCES = ("affine_w4_matmul", "flash_attn_fwd", "int_kv_decode",
                  "quantize_elemwise", "quantized_matmul")
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
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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


class QtFormat(ctypes.Structure):
    """``struct QtFormat`` of ``csrc/qt_round.cuh``."""
    _fields_ = [("kind", ctypes.c_int), ("a", ctypes.c_int),
                ("b", ctypes.c_int), ("flags", ctypes.c_int),
                ("hi", ctypes.c_float), ("lo", ctypes.c_float),
                ("zero", ctypes.c_float)]


def qt_format(fmt) -> QtFormat:
    """The kernels' descriptor of a :class:`numerics.RoundFormat`; ``None``
    is no rounding."""
    if fmt is None:
        return QtFormat(0, 0, 0, 0, 0.0, 0.0, 0.0)
    if fmt.kind == "posit":
        nbits, es = fmt.a, fmt.b
        max_scale = (nbits - 2) << es
        zero = 2.0 ** math.floor(-(nbits - 1) * (1 << es) + 2 ** (es - 1))
        return QtFormat(1, nbits, es, 0, 2.0 ** max_scale, 2.0 ** -max_scale,
                        zero)
    if fmt.kind == "fp8":
        mbits = fmt.b
        return QtFormat(2, math.floor(math.log2(fmt.min_norm)), mbits, 0,
                        fmt.max_norm, fmt.min_norm,
                        fmt.min_norm * 2.0 ** -(mbits + 1))
    if fmt.kind == "fp":
        return QtFormat(3, fmt.a, fmt.b, int(fmt.unsigned), fmt.max_norm,
                        0.0, 0.0)
    if fmt.kind == "int":
        lo, hi = ((0, 2 ** fmt.a - 1) if fmt.unsigned
                  else (-(2 ** (fmt.a - 1)), 2 ** (fmt.a - 1) - 1))
        return QtFormat(4, fmt.a, 0, int(fmt.unsigned), float(hi), float(lo),
                        0.0)
    raise ValueError(f"no kernel rounding for {fmt}")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
