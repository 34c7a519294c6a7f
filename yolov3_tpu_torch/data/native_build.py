"""Build the native data-loader core (``native/libyolodata.so``) once, and say
which decode tier a process runs on.

``data/native.py`` (a pinned copy of the JAX package's loader) builds the
library lazily with ``make`` in place and drops any error: several processes
that reach it at once (the ranks of a ``multihost`` run, the per-run processes
of ``tools/qat_ab.py`` and ``tools/augment_ab.py``) can open the file while
another writes it, and a failed build leaves the process on the Python decode
tier with no word of why. ``ensure_native_library`` builds it first, so that
``native.py`` only ever loads a finished file:

1. an exclusive ``flock`` on ``native/yolodata.cc`` serialises the builders;
2. ``make -C native TARGET=.libyolodata-<pid>.so .libyolodata-<pid>.so``
   writes a name of this process's own (named as the goal too: GNU make
   never takes a target whose name starts with a period as its default
   goal, and would run ``clean`` instead);
3. ``os.replace`` puts it on ``native/libyolodata.so`` in one step.

A failed build leaves no temporary file behind. The result names the tier
(``native`` where the library loads, else ``python``) and the reason: the
build's return code and the last lines of its stderr, or the tool that is
missing. The first call in a process logs ``decode tier: <tier> (<reason>)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import logging
import os
import shutil
import subprocess
import time

NATIVE_DIR = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "native"))
LIB_NAME = "libyolodata.so"
STDERR_LINES = 8

log = logging.getLogger(__name__)
_logged = False


@dataclasses.dataclass(frozen=True)
class NativeBuild:
    """The decode tier a process runs on and why."""

    tier: str                       # "native" or "python"
    reason: str
    returncode: int | None = None   # make's, where it ran
    compiler: str | None = None     # the C++ compiler found on PATH
    stderr: str = ""                # the last lines of make's stderr

    def line(self) -> str:
        return f"decode tier: {self.tier} ({self.reason})"


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX") or "g++")


def _loads(lib_path: str) -> str | None:
    """None where the library loads, else the loader's error."""
    try:
        ctypes.CDLL(lib_path)
    except OSError as e:
        return str(e)
    return None


def _build(native_dir: str, timeout: float) -> NativeBuild:
    lib_path = os.path.join(native_dir, LIB_NAME)
    compiler = _compiler()
    if os.path.exists(lib_path):
        error = _loads(lib_path)
        if error is None:
            return NativeBuild("native", f"{LIB_NAME} present", compiler=compiler)
        return NativeBuild("python", f"{LIB_NAME} does not load: {error}", compiler=compiler)
    if shutil.which("make") is None:
        return NativeBuild("python", "no `make`", compiler=compiler)
    if compiler is None:
        return NativeBuild("python", f"no `{os.environ.get('CXX') or 'g++'}`")
    tmp = f".libyolodata-{os.getpid()}.so"
    tmp_path = os.path.join(native_dir, tmp)
    t0 = time.monotonic()
    try:
        done = subprocess.run(["make", "-C", native_dir, f"TARGET={tmp}", tmp],
                              capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        return NativeBuild("python", f"make timed out after {timeout:.0f} s", compiler=compiler)
    stderr = "\n".join(done.stderr.strip().splitlines()[-STDERR_LINES:])
    if done.returncode != 0:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        return NativeBuild("python", f"make failed, rc {done.returncode}: {stderr or 'no stderr'}",
                           done.returncode, compiler, stderr)
    if not os.path.exists(tmp_path):
        return NativeBuild("python", f"make exited 0 but wrote no {tmp}", done.returncode,
                           compiler, stderr)
    os.replace(tmp_path, lib_path)
    error = _loads(lib_path)
    if error is not None:
        return NativeBuild("python", f"built, but {LIB_NAME} does not load: {error}",
                           done.returncode, compiler, stderr)
    return NativeBuild("native", f"built in {time.monotonic() - t0:.1f} s with {compiler}",
                       done.returncode, compiler, stderr)


def ensure_native_library(native_dir: str = NATIVE_DIR, timeout: float = 300.0) -> NativeBuild:
    """Build ``<native_dir>/libyolodata.so`` if it is missing (see the module
    docstring) → the decode tier and its reason. Logs the tier on the first
    call in a process."""
    global _logged
    with open(os.path.join(native_dir, "yolodata.cc"), "rb") as source:
        fcntl.flock(source, fcntl.LOCK_EX)
        try:
            result = _build(native_dir, timeout)
        finally:
            fcntl.flock(source, fcntl.LOCK_UN)
    if not _logged:
        _logged = True
        log.info(result.line())
    return result
