"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launch
functions that take raw pointers and a stream and return the launch's
``cudaError_t``). ``nvcc`` compiles each into its own shared library under
``build/torch_kernels/`` at the repository root, all files at once in
parallel, and ``ctypes`` loads them. Nothing includes PyTorch's headers,
so a build takes seconds. Libraries are named by a hash of their source and
flags, so an unchanged source is not rebuilt within a checkout.

Builds happen at first use (``library``), never at import: the CPU tests
import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_PACKAGE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build", "torch_kernels")
SOURCES = ("nms_sweep", "round_sweep")
# sm_90a: Hopper's arch-specific target. --fmad=false keeps every a*b+c two
# roundings, as the element-wise PyTorch ops of the plain versions do; no
# --use_fast_math, so division stays div.rn.
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "--fmad=false", "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                           "kernels are built on the machine that has the card")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source that has no current library (one ``nvcc`` per
    file, all started together), then load them all. Raises with the
    compiler's output if any build fails."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        t0 = time.monotonic()
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = {}
        for name in SOURCES:
            target = _target(name)
            if os.path.exists(target):
                continue
            tmp = f"{target}.{os.getpid()}.tmp"
            log = open(f"{target[:-3]}.log", "w")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                          tmp, target, log)
        failed = []
        for name, (proc, tmp, target, log) in jobs.items():
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, target)
            else:
                with open(log.name) as f:
                    failed.append(f"{name} (nvcc rc={rc}):\n{f.read()}")
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(_target(name))
        build_seconds = time.monotonic() - t0
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building all of them first
    if this process has not yet."""
    libs = _libs if len(_libs) == len(SOURCES) else build_all()
    return libs[name]


def check(err: int, what: str):
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
