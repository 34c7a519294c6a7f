"""The port's custom-dataset host tools (yolov3_tpu_torch/tools/
{create_tfrecords, create_yolov3_anchors, visualize_assignment, eval_plots}.py)
against the JAX package's ``tools/create_tfrecords.py``,
``utilities/create_yolov3_anchors.py``, ``tools/visualize_assignment.py`` and
root ``eval_plots.py``, on the CPU, and the no-JAX import of all six tools of
the custom-dataset workflow.

Tolerances: none. The shards, ``.names`` files and anchors files are compared
byte for byte (the anchors on both k-means branches: sklearn's ``KMeans``, and
the numpy fallback with sklearn blocked on both sides); the assignment cubes
bit for bit; ``eval_plots`` by the arrays, labels and names it hands to
``barh_multiple_plots``, exactly."""

import importlib.util
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import yaml

import yolov3_tpu.eval.plots
import yolov3_tpu.ops.assign
from tools import create_tfrecords as jax_tfrecords
from tools import visualize_assignment as jax_visualize
from yolov3_tpu_torch.config import load_yaml
from yolov3_tpu_torch.tools import (create_tfrecords, create_yolov3_anchors, eval_plots,
                                    visualize_assignment)

from .conftest import REPO
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

UTILITIES = os.path.join(REPO, "utilities")
TOOLS = ("create_tfrecords", "create_yolov3_anchors", "visualize_assignment", "pets_transfer",
         "scale_matrix", "eval_plots")
SOURCES = {
    "pets_mini": ("datasets/pets_mini/train",
                  "datasets/pets_mini/train/_annotations.coco.json", "7"),
    "shapes_toy": ("datasets/shapes_toy/coco/images",
                   "datasets/shapes_toy/coco/annotations.json", "10"),
}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _jax_anchors_module():
    """The JAX utility, imported from its file (``utilities/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_create_yolov3_anchors", os.path.join(UTILITIES, "create_yolov3_anchors.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- create_tfrecords ---

@pytest.fixture(scope="module")
def tfrecords(tmp_path_factory):
    """Each source converted by both tools (shards of 7 / 10 examples, so
    several shards and a short last one) → {source: {"port"|"jax": dir}}."""
    base = tmp_path_factory.mktemp("tfrecords")
    out = {}
    for source, (images, annotations, shard) in SOURCES.items():
        out[source] = {}
        for side, tool in (("port", create_tfrecords), ("jax", jax_tfrecords)):
            d = str(base / source / side)
            tool.main(["--images_dir", os.path.join(REPO, images),
                       "--annotations", os.path.join(REPO, annotations), "--out_dir", d,
                       "--shard_size", shard, "--names_out", os.path.join(d, "class.names")])
            out[source][side] = d
    return out


@pytest.mark.parametrize("source", list(SOURCES))
def test_create_tfrecords_writes_the_jax_tools_bytes(tfrecords, source):
    port, ref = (tfrecords[source][k] for k in ("port", "jax"))
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(port))
    assert len([n for n in names if n.endswith(".tfrec")]) >= 3 and "class.names" in names
    for name in names:
        assert _read(os.path.join(port, name)) == _read(os.path.join(ref, name)), name


def test_create_tfrecords_max_examples_and_default_shard(tmp_path):
    images, annotations, _ = SOURCES["pets_mini"]
    argv = ["--images_dir", os.path.join(REPO, images),
            "--annotations", os.path.join(REPO, annotations), "--max_examples", "5"]
    got = create_tfrecords.main(argv + ["--out_dir", str(tmp_path / "port")])
    jax_tfrecords.main(argv + ["--out_dir", str(tmp_path / "jax")])
    assert got["images"] == 5 and got["shards"] == 1
    assert (_read(tmp_path / "port" / "file_00.tfrec")
            == _read(tmp_path / "jax" / "file_00.tfrec"))


# --- create_yolov3_anchors ---

@pytest.mark.parametrize("branch", ["sklearn", "numpy"])
@pytest.mark.parametrize("source", ["tfrecords", "data_files"])
def test_anchors_file_equals_the_jax_utilitys(tfrecords, tmp_path, monkeypatch, source, branch):
    """Both run from ``utilities/`` on one config whose data paths are
    relative to it (``../datasets/...``, as the bundled config's): the
    tfrecords source is the pets_mini shards converted above (38 classes of
    real photos), the data_files source shapes_toy's COCO JSON."""
    jax_anchors = _jax_anchors_module()
    calls = []
    for module in (create_yolov3_anchors, jax_anchors):
        fallback = module.kmeans
        monkeypatch.setattr(module, "kmeans",
                            lambda *a, f=fallback, **k: calls.append(1) or f(*a, **k))
    if branch == "numpy":
        monkeypatch.setitem(sys.modules, "sklearn", None)
        monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    outs = {side: str(tmp_path / f"{side}_anchors.txt") for side in ("port", "jax")}
    configs = {}
    for side, out in outs.items():
        configs[side] = str(tmp_path / f"{side}.yaml")
        with open(configs[side], "w") as f:
            yaml.safe_dump({
                "n_clusters": 9, "input_data_source": source,
                "tfrecords": {"tfrecords_dir": os.path.relpath(
                    tfrecords["pets_mini"]["jax"], UTILITIES)},
                "data_files": {"annotations": "../datasets/shapes_toy/coco/annotations.json"},
                "limit": "None", "anchors_out_file": out}, f)
    monkeypatch.chdir(UTILITIES)
    got = create_yolov3_anchors.main(["--config", configs["port"]])
    monkeypatch.setattr(sys, "argv", ["create_yolov3_anchors.py", "--config", configs["jax"]])
    jax_anchors.main()
    assert len(calls) == (2 if branch == "numpy" else 0)
    assert got.shape == (9, 2) and np.all(np.diff(got[:, 0] * got[:, 1]) >= 0)
    assert _read(outs["port"]) == _read(outs["jax"])


def test_anchors_limit_and_degenerate_boxes(tmp_path):
    """The same filter and ``limit`` as the JAX utility's collectors."""
    jax_anchors = _jax_anchors_module()
    tfdir = os.path.join(REPO, "datasets/shapes_toy/tfrecords/train")
    ann = os.path.join(REPO, "datasets/pets_mini/train/_annotations.coco.json")
    for limit in (None, 5):
        np.testing.assert_array_equal(create_yolov3_anchors.collect_wh_tfrecords(tfdir, limit),
                                      jax_anchors.collect_wh_tfrecords(tfdir, limit))
        np.testing.assert_array_equal(create_yolov3_anchors.collect_wh_data_files(ann, limit),
                                      jax_anchors.collect_wh_data_files(ann, limit))
    coco = {"images": [{"id": 1, "width": 100, "height": 50}],
            "annotations": [{"image_id": 1, "bbox": b} for b in
                            ([1, 2, 30, 20], [5, 5, 0, 10], [5, 5, 10, 0], [0, 0, 100, 50])]}
    path = tmp_path / "degenerate.json"
    path.write_text(json.dumps(coco))
    got = create_yolov3_anchors.collect_wh_data_files(str(path))
    np.testing.assert_array_equal(got, jax_anchors.collect_wh_data_files(str(path)))
    assert got.tolist() == [[0.30000001192092896, 0.4000000059604645], [1.0, 1.0]]


# --- visualize_assignment ---

def _pets_config(tmp_path):
    """``config/train_config_pets.yaml`` with its ``${PETS_DATA_ROOT:-…}``
    paths expanded (both tools read their config with ``yaml.safe_load``)."""
    cfg = load_yaml(os.path.join(REPO, "config/train_config_pets.yaml"))
    path = tmp_path / "pets.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("config", ["train_config", "pets"])
def test_visualize_assignment_cubes_are_the_jax_tools(tmp_path, monkeypatch, config):
    """shapes_toy's TFRecords on the tiny's two heads, and pets_mini's
    COCO JSON (mixed-size photos) on YOLOv3's three, at 416."""
    path = (os.path.join(REPO, "config/train_config.yaml") if config == "train_config"
            else _pets_config(tmp_path))
    captured = []
    assign = yolov3_tpu.ops.assign.assign_targets
    monkeypatch.setattr(yolov3_tpu.ops.assign, "assign_targets",
                        lambda *a: captured.append(assign(*a)) or captured[-1])
    monkeypatch.chdir(REPO)
    outs = {side: str(tmp_path / f"{side}.png") for side in ("port", "jax")}
    cubes = visualize_assignment.main(["--config", path, "--out", outs["port"],
                                       "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["visualize_assignment.py", "--config", path,
                                      "--out", outs["jax"]])
    jax_visualize.main()
    want = [np.asarray(g)[0] for g in captured[0]]
    assert len(cubes) == len(want) == (2 if config == "train_config" else 3)
    for got, ref in zip(cubes, want):
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert sum(int((c[..., 4] == 1).sum()) for c in cubes) > 0
    for out in outs.values():
        assert _read(out)[:8] == b"\x89PNG\r\n\x1a\n"


def test_visualize_assignment_raises_without_a_card_unless_cpu_is_asked(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        visualize_assignment.main(["--config", str(tmp_path / "never_read.yaml"),
                                   "--out", str(tmp_path / "never_written.png")])
    assert not os.path.exists(tmp_path / "never_written.png")


# --- eval_plots ---

def test_eval_plots_hands_the_jax_scripts_arrays_to_the_plot(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    names = os.path.join(REPO, "datasets/pets_breed.names")
    nclasses = sum(1 for _ in open(names))
    for counter in eval_plots.COUNTERS:
        np.save(tmp_path / f"{counter}_0.3.npy", rng.randint(0, 9, (12, nclasses)))
    calls = {}
    for side, module in (("port", eval_plots), ("jax", yolov3_tpu.eval.plots)):
        monkeypatch.setattr(module, "barh_multiple_plots",
                            lambda *a, s=side, **k: calls.setdefault(s, (a, k)))
    monkeypatch.chdir(tmp_path)
    argv = ["--threshold", "0.3", "--classes_name_file", names, "--out", "plot.png"]
    eval_plots.main(argv)
    monkeypatch.setattr(sys, "argv", ["eval_plots.py"] + argv)
    runpy.run_path(os.path.join(REPO, "eval_plots.py"), run_name="__main__")
    (got, got_kw), (want, want_kw) = calls["port"], calls["jax"]
    assert got_kw == want_kw == {"title": "evaluation @ score>0.3", "out_path": "plot.png"}
    assert got[1:] == want[1:] and len(got[2]) == nclasses
    assert len(got[0]) == len(want[0]) == 5
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    eval_plots.main(argv)  # the real plot
    assert _read(tmp_path / "plot.png")[:8] == b"\x89PNG\r\n\x1a\n"


# --- the six tools import without JAX ---

def test_tools_import_without_jax():
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'yolov3_tpu', 'tools'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "for m in ('jax', 'jaxlib', 'yolov3_tpu', 'tools'):\n"
        "    sys.modules[m] = None\n"
        f"for tool in {TOOLS!r}:\n"
        "    __import__('yolov3_tpu_torch.tools.' + tool)\n"
        "bad = [m for m, v in sys.modules.items()\n"
        "       if v is not None and m.split('.')[0] in ('jax', 'yolov3_tpu', 'tools')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
