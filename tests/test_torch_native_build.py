"""The native decode tier's build step (yolov3_tpu_torch/data/native_build.py),
on copies of ``native/``.

  * four processes that build one fresh copy at once all get ``native``, the
    library loads in each, and no ``.libyolodata-*.so`` is left behind;
  * a copy whose Makefile fails gives ``python`` with the build's return code
    and stderr as the reason, and leaves nothing behind;
  * without ``make`` or the C++ compiler the reason names the missing tool;
  * the loader itself, ``data/native.py``, stays the JAX package's copy
    (tests/test_torch_data.py pins it).
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from yolov3_tpu_torch.data import native_build

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

NATIVE = os.path.join(REPO, "native")


def _copy(tmp_path, makefile=None):
    """``native/``'s sources in a directory of their own, optionally with
    another Makefile."""
    out = tmp_path / "native"
    out.mkdir()
    shutil.copy(os.path.join(NATIVE, "yolodata.cc"), out)
    if makefile is None:
        shutil.copy(os.path.join(NATIVE, "Makefile"), out)
    else:
        (out / "Makefile").write_text(makefile)
    return str(out)


@pytest.mark.skipif(shutil.which("make") is None or shutil.which("g++") is None,
                    reason="no make or g++ here")
def test_four_processes_build_one_copy_once(tmp_path):
    native_dir = _copy(tmp_path)
    code = ("import ctypes, dataclasses, json, os, sys\n"
            "from yolov3_tpu_torch.data.native_build import ensure_native_library\n"
            "b = ensure_native_library(sys.argv[1])\n"
            "ctypes.CDLL(os.path.join(sys.argv[1], 'libyolodata.so')).yolodata_crc32c\n"
            "print(json.dumps(dataclasses.asdict(b)))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, native_dir], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert [r["tier"] for r in results] == ["native"] * 4
    built = [r for r in results if r["reason"].startswith("built")]
    assert len(built) == 1 and built[0]["returncode"] == 0
    assert sorted(os.listdir(native_dir)) == ["Makefile", "libyolodata.so", "yolodata.cc"]


def test_a_failed_build_gives_the_reason_and_leaves_nothing(tmp_path):
    native_dir = _copy(tmp_path, makefile=(
        "TARGET := libyolodata.so\n"
        "$(TARGET): yolodata.cc\n"
        "\ttouch $@\n"
        "\t@echo 'yolodata.cc:1: error: no headers here' >&2; exit 3\n"))
    result = native_build.ensure_native_library(native_dir)
    assert result.tier == "python"
    assert result.returncode == 2  # make's, for a recipe that failed
    assert "no headers here" in result.stderr and "no headers here" in result.reason
    assert result.line().startswith("decode tier: python (make failed, rc 2:")
    assert sorted(os.listdir(native_dir)) == ["Makefile", "yolodata.cc"]


def test_a_missing_tool_is_named(tmp_path, monkeypatch):
    native_dir = _copy(tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    result = native_build.ensure_native_library(native_dir)
    assert (result.tier, result.reason) == ("python", "no `no-such-compiler-here`")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    result = native_build.ensure_native_library(native_dir)
    assert (result.tier, result.reason) == ("python", "no `make`")
    assert sorted(os.listdir(native_dir)) == ["Makefile", "yolodata.cc"]
