"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface (``extern "C"`` launch
functions that take raw pointers and a stream and return the launch's
``cudaError_t``). ``nvcc`` compiles each into its own shared library under
``build/torch_kernels/`` at the repository root, all files at once in
parallel, and ``ctypes`` loads them. Nothing includes PyTorch's headers,
so a build takes seconds. Libraries are named by a hash of their source, of
the ``csrc/*.cuh`` headers it includes (an edit to a shared header rebuilds
every kernel that uses it) and of the flags, so an unchanged source is not
rebuilt within a checkout.

Builds happen at first use (``library``), never at import: the CPU tests
import every module on a machine without ``nvcc``. When a library is loaded,
each of its launch functions gets its ``argtypes`` and ``restype`` once, from
``SIGNATURES``; a wrapper fetches the function with ``function`` and calls it
through ``launch``, which hands it the current stream of the tensors' device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_PACKAGE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build", "torch_kernels")
SOURCES = ("nms_sweep", "round_sweep", "conv1x1_int8", "conv_int8", "resblock_int8",
           "bn_stats", "bn_leaky", "bias_act")
# sm_90a: Hopper's arch-specific target. --fmad=false keeps every a*b+c two
# roundings, as the element-wise PyTorch ops of the plain versions do; no
# --use_fast_math, so division stays div.rn.
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "--fmad=false", "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# source -> {launch function: argument types}; every pointer and the stream
# (always the last argument) are c_void_p, or ctypes would cut them to 32 bits.
# Every launch function returns the cudaError_t of its launch as an int.
SIGNATURES = {
    "nms_sweep": {"nms_sweep_launch": [_P] * 3 + [_I] * 2 + [_P]},
    "round_sweep": {"round_sweep_launch": [_P] * 4 + [_I] * 6 + [_F] * 2 + [_P]},
    "conv1x1_int8": {"conv1x1_int8_launch": [_P] * 6 + [_I] * 5 + [_P]},
    "conv_int8": {"conv_int8_launch": [_P] * 6 + [_I] * 13 + [_P]},
    "resblock_int8": {"resblock_int8_launch": [_P] * 13 + [_I] * 11 + [_P]},
    "bn_stats": {"bn_moments_launch": [_P] * 3 + [_I] * 9 + [_F] + [_P],
                 "bn_moments_dx_launch": [_P] * 5 + [_I] * 6 + [_F] * 2 + [_P]},
    "bn_leaky": {"bn_leaky_launch": [_P] * 6 + [_I] * 11 + [_F] * 2 + [_P],
                 "bn_leaky_dx_launch": [_P] * 10 + [_I] * 11 + [_F] * 2 + [_P]},
    "bias_act": {"bias_act_launch": [_P] * 4 + [_I] * 9 + [_P],
                 "bias_act_mish_table_launch": [_P] * 2},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                           "kernels are built on the machine that has the card")
    return path


def _with_headers(filename: str, seen: dict[str, bytes]) -> dict[str, bytes]:
    """``filename`` of ``csrc/`` and, recursively, every ``csrc`` header it
    includes with quotes → their contents."""
    if filename not in seen:
        with open(os.path.join(CSRC, filename), "rb") as f:
            seen[filename] = f.read()
        for header in re.findall(rb'^\s*#\s*include\s*"([^"]+)"', seen[filename], re.M):
            _with_headers(header.decode(), seen)
    return seen


def _target(name: str) -> str:
    files = _with_headers(f"{name}.cu", {})
    digest = hashlib.sha256(b"".join(files[f] for f in sorted(files))
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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
            lib = ctypes.CDLL(_target(name))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _libs[name] = lib
        build_seconds = time.monotonic() - t0
        return _libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building all of them first
    if this process has not yet."""
    libs = _libs if len(_libs) == len(SOURCES) else build_all()
    return libs[name]


def function(name: str, fn_name: str):
    """Launch function ``fn_name`` of source ``name``, its signature set at load."""
    return getattr(_libs[name] if len(_libs) == len(SOURCES) else library(name), fn_name)


def launch(call, device, what: str, *args):
    """Run ``call(*args, stream)`` — the argument order of every launch
    function — where ``stream`` is the raw handle of ``device``'s current
    stream, and raise if it returns a CUDA error. The device context is
    entered only when ``device`` is not the current one."""
    index = device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        err = call(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            err = call(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
