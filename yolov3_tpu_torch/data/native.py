"""ctypes binding for the native data-loader core (native/yolodata.cc).

Provides hardware-CRC TFRecord scanning and fused JPEG-decode+resize in
C++ (GIL-free → a Python thread pool scales it across cores). Builds the
shared library lazily with the repo's Makefile on first use; every entry
point has a pure-Python fallback, so the framework works without a
compiler — the native path is a performance tier, not a dependency.

Framework-neutral copy of ``yolov3_tpu/data/native.py`` (host code in numpy; the port
imports nothing of the JAX package). tests/test_torch_data.py pins it to its original.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libyolodata.so")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True, timeout=120)
            lib = ctypes.CDLL(_LIB_PATH)
            lib.yolodata_crc32c.restype = ctypes.c_uint32
            lib.yolodata_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.yolodata_masked_crc.restype = ctypes.c_uint32
            lib.yolodata_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.yolodata_scan_tfrecord.restype = ctypes.c_int64
            lib.yolodata_scan_tfrecord.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_int64, ctypes.c_int,
            ]
            lib.yolodata_decode_resize.restype = ctypes.c_int
            lib.yolodata_decode_resize.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
            ]
            _lib = lib
        except Exception:
            _load_failed = True
            _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


_scratch_local = threading.local()

MAX_PIXELS = 8192 * 8192  # decode scratch cap (256 MB RGB)


def _scratch(size: int) -> np.ndarray:
    buf = getattr(_scratch_local, "buf", None)
    if buf is None or buf.size < size:
        buf = np.empty(size, np.uint8)
        _scratch_local.buf = buf
    return buf


def decode_resize_jpeg_into(data: bytes, out: np.ndarray,
                            scale: float = 1.0 / 255.0) -> bool:
    """JPEG bytes → decode+resize straight into a caller-provided float32
    (H, W, 3) C-contiguous array (e.g. one slot of a preallocated batch —
    the zero-copy streaming path writes each image's pixels exactly once).
    Returns False if the native library is unavailable or decode fails."""
    lib = _load()
    if lib is None:
        return False
    if out.dtype != np.float32 or out.ndim != 3 or out.shape[2] != 3 \
            or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("decode_resize_jpeg_into needs a C-contiguous "
                         f"float32 (H, W, 3) output, got {out.dtype} "
                         f"{out.shape}")
    out_h, out_w = out.shape[0], out.shape[1]
    size = 1024 * 1024 * 3  # grow-on-demand keeps per-thread scratch small
    while size <= MAX_PIXELS * 3:
        scratch = _scratch(size)
        rc = lib.yolodata_decode_resize(
            data, len(data),
            scratch.ctypes.data_as(ctypes.c_void_p), scratch.size,
            out_h, out_w, ctypes.c_float(scale),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc == 0:
            return True
        if rc != -2:  # decode error (not a too-small scratch)
            return False
        size = max(size * 4, scratch.size * 4)
    return False


def decode_resize_jpeg(data: bytes, out_h: int, out_w: int, scale: float = 1.0 / 255.0):
    """JPEG bytes → float32 (out_h, out_w, 3), TF bilinear semantics.
    Returns None if the native library is unavailable or decode fails
    (caller falls back to the PIL path)."""
    out = np.empty((out_h, out_w, 3), np.float32)
    return out if decode_resize_jpeg_into(data, out, scale) else None


def scan_tfrecord(buf: bytes, validate: bool = True, chunk_records: int = 1 << 20):
    """TFRecord byte buffer → list of (offset, length); None if unavailable.

    The native scanner fills at most ``chunk_records`` spans per call — loop
    until the buffer is exhausted so huge shards are never silently
    truncated. Buffers are sized by the 16-byte/record floor (8 len +
    4+4 CRCs), not the chunk cap, so small files don't allocate 16 MB.
    """
    lib = _load()
    if lib is None:
        return None
    results = []
    base = 0
    view = buf
    while len(view) > 0:
        cap = min(chunk_records, max(1, len(view) // 16))
        offsets = np.empty(cap, np.uint64)
        lengths = np.empty(cap, np.uint64)
        count = lib.yolodata_scan_tfrecord(
            view, len(view),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            cap, 1 if validate else 0,
        )
        if count < 0:
            raise IOError(f"corrupt tfrecord buffer (native scan error {count})")
        results.extend(
            (base + int(offsets[i]), int(lengths[i])) for i in range(count))
        if count < cap:
            break
        consumed = int(offsets[count - 1]) + int(lengths[count - 1]) + 4
        base += consumed
        view = view[consumed:]
    return results


def crc32c(data: bytes):
    lib = _load()
    if lib is None:
        return None
    return int(lib.yolodata_crc32c(data, len(data)))
