"""The port's host-side data code (yolov3_tpu_torch/data/) and transfer
helpers (models/transfer.py) pinned to the JAX package's originals.

The data modules are framework-neutral numpy code: the port keeps its own
copies (it imports nothing of the JAX package), each with one paragraph added
to its docstring. The sources must otherwise be identical, and both
pipelines must give identical batches from the in-repo toy dataset.
Tolerance: none.

Both packages decode through ``data/native.py``: the C++ core
(``native/libyolodata.so``, built from ``native/yolodata.cc``) where it
loads, else the Python path. The two tiers scale pixels in ways that differ by
one ulp (``·(1/255)`` against ``/255``), so the parity test pins both packages
to one tier at a time. The library is gitignored and each package builds it
lazily with ``make`` in place, which races when several test processes start
at once: one process can open the file while another writes it and then
stays on the Python tier. This module therefore builds it once at import
(collection runs in every test process before any test starts) with the port's
``data/native_build.py::ensure_native_library``: under a lock, into a
temporary name that is renamed over the real one."""

import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from yolov3_tpu.data import native as jnative
from yolov3_tpu.data import pipeline as jpipe
from yolov3_tpu.models import transfer as jtransfer
from yolov3_tpu_torch.data import native as tnative
from yolov3_tpu_torch.data import pipeline as tpipe
from yolov3_tpu_torch.data.native_build import ensure_native_library
from yolov3_tpu_torch.models import transfer as ttransfer

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

NATIVE_DIR = os.path.join(REPO, "native")
NATIVE_LIB = os.path.join(NATIVE_DIR, "libyolodata.so")


ensure_native_library(NATIVE_DIR)

NOTE = ("\n\nFramework-neutral copy of ``yolov3_tpu/data/{name}`` (host code in numpy; the port\n"
        "imports nothing of the JAX package). tests/test_torch_data.py pins it to its original.\n")


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


@pytest.mark.parametrize("name", ["tfrecord.py", "native.py", "coco_json.py", "voc.py"])
def test_neutral_data_copies_match_originals(name):
    copy = _read("yolov3_tpu_torch", "data", name)
    note = NOTE.format(name=name)
    assert copy.count(note) == 1
    original = _read("yolov3_tpu", "data", name)
    # the note sits at the end of the docstring, whose closing quotes the
    # original keeps on the last text line or on a line of their own
    assert copy.replace(note, "", 1) in (original, original.replace('\n"""', '"""', 1))
    assert "import jax" not in copy and "from jax" not in copy


def test_pipeline_host_half_matches_original():
    """``Dataset`` … ``Batcher`` are the original's text; ``DevicePrefetcher``
    and ``DeviceDataset`` are the port's own."""
    original, copy = _read("yolov3_tpu", "data", "pipeline.py"), _read(
        "yolov3_tpu_torch", "data", "pipeline.py")
    host = original[original.index("class Dataset:"):original.index("class DeviceDataset:")]
    assert host in copy
    assert "import jax" not in copy


def _toy_config():
    return {"input_data_source": "tfrecords",
            "tfrecords": {"train": os.path.join(REPO, "datasets/shapes_toy/tfrecords/train"),
                          "valid": os.path.join(REPO, "datasets/shapes_toy/tfrecords/val")},
            "data_files": {split: {
                "images_dir": os.path.join(REPO, "datasets/shapes_toy/coco/images"),
                "annotations": os.path.join(REPO, "datasets/shapes_toy/coco/annotations.json")}
                for split in ("train", "valid")}}


@contextlib.contextmanager
def native_decode_tier():
    """Both packages' ``native`` modules on the native decode tier while the
    block runs: each loads afresh the one library built above. Every test
    that decodes TFRecords through both packages and compares what they
    compute holds them so. The two tiers differ by an ulp, and without the pin
    each package's tier depends on the build race above: one test process
    kept the JAX package on the Python tier and gave the port the native one,
    and a whole ``Train`` run's epoch losses came out 1–2% apart (the JAX
    package's ``[58.964, 106.0662]`` on the Python tier against
    ``[60.1824, 107.0742]`` on the native one)."""
    ensure_native_library(NATIVE_DIR)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jnative, tnative):
            mp.setattr(mod, "_lib", None)
            mp.setattr(mod, "_load_failed", False)
        if not (jnative.available() and tnative.available()):
            pytest.fail(f"{NATIVE_LIB} did not build or load (make and a C++ compiler are "
                        "needed)")
        yield


@pytest.fixture(params=["python", "native"])
def decode_tier(request, monkeypatch):
    """Both packages' ``native`` modules on one decode tier: ``python`` marks
    the library as failed to load, ``native`` resets both modules and loads
    the one library built above."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_load_failed", request.param == "python")
    if request.param == "native" and not (jnative.available() and tnative.available()):
        pytest.skip("native core not built (no compiler?)")
    return request.param


@pytest.mark.parametrize("source,shuffle", [("tfrecords", None), ("tfrecords", 8),
                                            ("data_files", None), ("data_files", 8)])
def test_batches_equal_the_jax_pipelines(source, shuffle, decode_tier):
    for mod in (jnative, tnative):
        assert mod.available() == (decode_tier == "native")
    cfg = dict(_toy_config(), input_data_source=source)
    names = os.path.join(REPO, "datasets/shapes_toy/class.names")
    (jtrain, _), jsizes = jpipe.create_dataset(cfg, 64, 20, names)
    (ttrain, _), tsizes = tpipe.create_dataset(cfg, 64, 20, names)
    assert jsizes == tsizes
    jb = list(jpipe.batched(jtrain, 8, shuffle_buffer=shuffle, seed=3, num_workers=2))
    tb = list(tpipe.batched(ttrain, 8, shuffle_buffer=shuffle, seed=3, num_workers=2))
    assert len(jb) == len(tb) == 4
    for (ji, jl), (ti, tl) in zip(jb, tb):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


def test_device_prefetcher_yields_every_batch_in_order_on_the_cpu():
    batches = [(np.full((2, 4, 4, 3), i, np.float32), np.full((2, 5, 6), -i, np.float32))
               for i in range(5)]
    out = list(tpipe.DevicePrefetcher(iter(batches), "cpu"))
    assert len(out) == 5
    for i, (images, labels) in enumerate(out):
        assert isinstance(images, torch.Tensor) and images.device.type == "cpu"
        assert float(images.mean()) == i and float(labels.mean()) == -i


def test_device_prefetcher_propagates_errors_and_survives_abandonment():
    def broken():
        yield np.zeros((1, 2, 2, 3), np.float32), np.zeros((1, 1, 6), np.float32)
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(tpipe.DevicePrefetcher(broken(), "cpu"))
    endless = ((np.zeros((1, 2, 2, 3), np.float32), np.zeros((1, 1, 6), np.float32))
               for _ in iter(int, 1))
    it = iter(tpipe.DevicePrefetcher(endless, "cpu"))
    next(it)
    it.close()  # the worker must let go instead of blocking on a full queue


@pytest.mark.parametrize("store_uint8", [False, True])
@pytest.mark.parametrize("shuffle_seed", [None, 1000004, 7 * 1000003 + 2])
def test_device_dataset_batches_equal_the_jax_ones(store_uint8, shuffle_seed):
    """The whole split staged once, batches gathered through the same
    per-epoch permutation as the JAX package's: the batch order identical;
    f32 pixels identical, uint8 pixels within 1/510 of the host's f32 ones
    (the half step of the 1/255 lattice, plus 1e-7 for the f32 rounding of
    the two values compared) and within one f32 ulp of JAX's, which
    multiplies by 1/255 where the port divides."""
    cfg = _toy_config()
    names = os.path.join(REPO, "datasets/shapes_toy/class.names")
    (train, _), _ = tpipe.create_dataset(cfg, 64, 20, names)
    host = list(train)
    jdd = jpipe.DeviceDataset(host, 5, store_uint8=store_uint8)
    tdd = tpipe.DeviceDataset(host, 5, "cpu", store_uint8=store_uint8)
    assert (tdd.n, tdd.nbatches, tdd.nbytes) == (jdd.n, jdd.nbatches, jdd.nbytes) == (
        32, 6, tdd.nbytes)
    jb = list(jdd.batches(shuffle_seed))
    tb = list(tdd.batches(shuffle_seed))
    assert len(tb) == len(jb) == 6
    order = (np.arange(32) if shuffle_seed is None
             else np.random.RandomState(shuffle_seed & 0x7FFFFFFF).permutation(32))
    for b, ((ji, jl), (ti, tl)) in enumerate(zip(jb, tb)):
        assert ti.dtype == torch.float32 and ti.device.type == "cpu"
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        idx = order[b * 5:(b + 1) * 5]
        np.testing.assert_array_equal(tl.numpy(), np.stack([host[i][1] for i in idx]))
        want = np.stack([host[i][0] for i in idx])
        if store_uint8:
            np.testing.assert_allclose(ti.numpy(), want, rtol=0, atol=1 / 510 + 1e-7)
            np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=6e-8)
        else:
            np.testing.assert_array_equal(ti.numpy(), want)
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_device_dataset_of_an_empty_split_yields_nothing():
    dd = tpipe.DeviceDataset([], 4, "cpu", store_uint8=True)
    assert dd.n == dd.nbytes == 0 and list(dd.batches(3)) == []


def _params():
    return {name: {"layer0": {"kernel": np.full((1,), i, np.float32),
                              "bn": {"gamma": np.ones(1, np.float32)}}}
            for i, name in enumerate(["backbone", "neck0", "neck1", "head0"])}


@pytest.mark.parametrize("selectors", [None, [], ["none"], ["backbone"], ["neck"],
                                       ["backbone", "head"], ["", "neck1"]])
def test_transfer_helpers_match_originals(selectors):
    assert ttransfer.expand_transfer_list(selectors) == jtransfer.expand_transfer_list(selectors)
    assert ttransfer.bn_frozen_selectors(selectors) == jtransfer.bn_frozen_selectors(selectors)
    jmask, tmask = (m.trainable_mask(_params(), selectors) for m in (jtransfer, ttransfer))
    assert (jmask is None) == (tmask is None)
    if jmask is not None:
        assert jax.tree.leaves(tmask) == jax.tree.leaves(jmask)
        assert jax.tree.structure(tmask) == jax.tree.structure(jmask)


def test_do_transfer_learning_matches_original():
    cfg = {"transfer_list": ["neck"], "freeze_train_list": ["backbone"],
           "batch_norm_freeze_list": ["backbone", "none"]}
    ref = {k: {"layer0": {"kernel": v["layer0"]["kernel"] + 10}} for k, v in _params().items()
           if k != "head0"}
    ref_state = {"backbone": {"layer0": {"mean": np.ones(1, np.float32)}}}
    results = []
    for mod in (jtransfer, ttransfer):
        stages = []
        params, state, mask, frozen = mod.do_transfer_learning(
            None, _params(), {}, cfg, lambda stage: (stages.append(stage), (ref, ref_state))[1])
        results.append((jax.tree.map(lambda x: np.asarray(x).tolist(), params), list(state),
                        jax.tree.leaves(mask), frozen, stages))
    assert results[0] == results[1]
    assert results[1][4] == ["neck"] and results[1][3] == ("backbone",)
