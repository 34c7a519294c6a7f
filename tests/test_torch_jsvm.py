"""The browser port's path in the port (yolov3_tpu_torch/jsvm/,
tools/run_js_pipeline.py), on the CPU, against the JAX package's jsvm.

  * ``jsvm/{lexer,parser,interp}.py`` are copies of the JAX package's: their
    code, everything after the module docstring, is pinned to the original;
    ``jsvm/tfshim.py`` too, apart from ``GraphModelHost``, which runs the
    graph-model in the port's executor instead of TensorFlow;
  * ``runInference`` (js/src/inference.js) through the port's jsvm, with the
    trained YOLOv3-tiny exported by the port and run by ``GraphModelHost`` on
    the CPU, gives the JAX jsvm's detections and draw calls on the same image
    and heads, bit for bit;
  * the crafted-heads and empty-detections cases of tests/test_js_execution.py
    through the port: the crafted heads' detections equal the port's Python
    pipeline (``ops/decode.py``, ``ops/nms.py``) within 2e-5 and the JAX
    jsvm's exactly, no tensor left live;
  * ``tools/run_js_pipeline.py --compare --device cpu`` prints the JAX tool's
    detection lines (TensorFlow running the same files there) and reports
    its count, deltas and class match;
  * ``jsvm``, ``export`` and ``tools.run_js_pipeline`` import with ``jax``,
    ``yolov3_tpu`` and ``tensorflow`` blocked.
"""

import functools
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from yolov3_tpu_torch import jsvm as tjsvm
from yolov3_tpu_torch.tools import export_tfjs, run_js_pipeline

from .conftest import REPO, has_tf
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

JS = os.path.join(REPO, "js", "src")
TOY = os.path.join(REPO, "datasets", "shapes_toy")
TOY_IMAGE = os.path.join(TOY, "coco", "images", "img_000.jpg")
TOY_NAMES = os.path.join(TOY, "class.names")
TOY_ANCHORS = os.path.join(TOY, "anchors", "anchors_tiny.txt")
needs_tf = pytest.mark.skipif(not has_tf(), reason="tensorflow unavailable")


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def _body(src):
    """A module's source after its docstring."""
    return src[src.index('"""', 3) + 3:]


def _without_graph_model_host(src):
    return src[:src.index("class GraphModelHost:")] + src[src.index("class TfShim:"):]


@pytest.mark.parametrize("name", ["lexer.py", "parser.py", "interp.py"])
def test_jsvm_copies_match_originals(name):
    copy = _read("yolov3_tpu_torch", "jsvm", name)
    assert f"copy of ``yolov3_tpu/jsvm/{name}``" in copy
    assert _body(copy) == _body(_read("yolov3_tpu", "jsvm", name))


def test_tfshim_matches_original_apart_from_graph_model_host():
    copy = _read("yolov3_tpu_torch", "jsvm", "tfshim.py")
    original = _read("yolov3_tpu", "jsvm", "tfshim.py")
    assert _without_graph_model_host(_body(copy)) == _without_graph_model_host(_body(original))
    host = copy[copy.index("class GraphModelHost:"):copy.index("class TfShim:")]
    assert "tfjs_runtime import GraphModel" in host and "tensorflow" not in host


@pytest.fixture(scope="module")
def tiny_export(tmp_path_factory):
    """The trained YOLOv3-tiny exported at 416 by the port's tool."""
    out_dir = str(tmp_path_factory.mktemp("tfjs") / "tiny")
    export_tfjs.main(["--model_config_file",
                      os.path.join(REPO, "config/models/yolov3_tiny/model.yaml"),
                      "--weights_path",
                      os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf"),
                      "--classes_name_file", TOY_NAMES, "--tfjs_out_dir", out_dir])
    return out_dir


def _run_inference(jsvm, loader, model_url, image, class_names, **request):
    shim = jsvm.TfShim(model_loader=loader)
    interp = jsvm.Interpreter({"tf": shim})
    mod = interp.load_module(os.path.join(JS, "inference.js"))
    overlay = jsvm.RecordingCanvas()
    dets = interp.call(mod["runInference"], dict(
        modelUrl=model_url, image=jsvm.JsImage(image), overlay=overlay,
        classNames=class_names, **request))
    return dets, shim.num_live(), overlay.ctx.calls


def _toy_image():
    from yolov3_tpu_torch.data.image import decode_image

    with open(TOY_IMAGE, "rb") as f:
        return decode_image(f.read())


class ExecutorForJaxShim:
    """The JAX jsvm's ``tf.loadGraphModel`` on the port's executor (CPU), so
    that both interpreters read the same heads; the executor against
    TensorFlow's run is tests/test_torch_tfjs_export.py's."""

    def __init__(self, jsvm, shim, url):
        from yolov3_tpu_torch.export import GraphModel

        self._jsvm, self._shim = jsvm, shim
        self.model = GraphModel(url, device="cpu")

    def executeAsync(self, input_tensor):
        return self._jsvm.JSPromise([self._jsvm.TfTensor(self._shim, o)
                                     for o in self.model.run_numpy(input_tensor._np())])


def test_run_inference_matches_the_jax_jsvm(tiny_export):
    """The same page, image and graph-model through both interpreters: the
    same detections and draw calls, bit for bit."""
    from yolov3_tpu import jsvm as jjsvm

    names = [ln.strip() for ln in open(TOY_NAMES) if ln.strip()]
    anchors = np.loadtxt(TOY_ANCHORS, delimiter=",", dtype=np.float32).reshape(-1, 3, 2)
    image = _toy_image()
    port = _run_inference(tjsvm, functools.partial(tjsvm.GraphModelHost, device="cpu"),
                          tiny_export, image, names, anchors=anchors.tolist())
    jax = _run_inference(jjsvm, functools.partial(ExecutorForJaxShim, jjsvm), tiny_export,
                         image, names, anchors=anchors.tolist())
    (p_dets, p_live, p_calls), (j_dets, j_live, j_calls) = port, jax
    assert p_live == j_live == 0
    assert len(p_dets) > 0
    assert p_dets == j_dets and p_calls == j_calls


def _crafted_heads(nclasses=4):
    """The crafted heads of tests/test_js_execution.py: two tiny-416-shaped
    heads (13² and 26²) with well-separated objects."""
    g13 = np.full((1, 13, 13, 3, 5 + nclasses), 0.0, np.float32)
    g26 = np.full((1, 26, 26, 3, 5 + nclasses), 0.0, np.float32)
    g13[..., 4] = -12.0
    g26[..., 4] = -12.0
    anchors13 = np.array([[116, 90], [156, 198], [373, 326]], np.float32) / 416.0

    def put(grid, row, col, a, obj, cls, nc, wh=(0.0, 0.0)):
        grid[0, row, col, a, 0:2] = 0.0
        grid[0, row, col, a, 2:4] = wh
        grid[0, row, col, a, 4] = obj
        grid[0, row, col, a, 5:5 + nc] = -6.0
        grid[0, row, col, a, 5 + cls] = 6.0

    put(g13, 3, 4, 0, 5.0, 1, nclasses)
    put(g13, 8, 10, 2, 4.0, 3, nclasses)
    put(g13, 3, 4, 1, 1.0, 1, nclasses,
        wh=(math.log(anchors13[0, 0] / anchors13[1, 0]),
            math.log(anchors13[0, 1] / anchors13[1, 1])))
    put(g26, 5, 5, 1, 3.0, 0, nclasses)
    put(g26, 20, 6, 0, 2.0, 2, nclasses)
    return g13, g26


class FakeGraphModel:
    """executeAsync returns preset head grids, 26-first (inference.js sorts)."""

    def __init__(self, jsvm, shim, grids):
        self._jsvm, self._shim, self._grids = jsvm, shim, grids

    def executeAsync(self, input_tensor):
        assert input_tensor.shape == [1, 416, 416, 3]
        return self._jsvm.JSPromise([self._jsvm.TfTensor(self._shim, g) for g in self._grids])


def _crafted_run(jsvm, image, **request):
    g13, g26 = _crafted_heads()
    return _run_inference(jsvm, lambda s, url: FakeGraphModel(jsvm, s, [g26, g13]),
                          "fake://model", image, ["cat", "dog", "bird", "fish"], **request)


def test_run_inference_crafted_heads_through_the_port():
    import torch

    from yolov3_tpu import jsvm as jjsvm
    from yolov3_tpu_torch.ops.decode import yolo_decode
    from yolov3_tpu_torch.ops.nms import gather_detections, yolo_nms_exact

    image = np.random.default_rng(11).integers(0, 256, size=(100, 80, 3), dtype=np.uint8)
    dets, live, calls = _crafted_run(tjsvm, image)
    assert live == 0
    j_dets, _, j_calls = _crafted_run(jjsvm, image)
    assert dets == j_dets and calls == j_calls

    anchors = np.loadtxt(os.path.join(REPO, "datasets/coco2012/anchors.txt"), delimiter=",",
                         dtype=np.float32).reshape(3, 3, 2)[:2]
    g13, g26 = _crafted_heads()
    pb, pc, pp = yolo_decode([torch.from_numpy(g13), torch.from_numpy(g26)], anchors, 4)
    kept = yolo_nms_exact(pb, pc, pp)
    gb, gc, gs, _ = gather_detections(*kept)
    n = int(kept[4][0])
    assert len(dets) == n == 4
    np.testing.assert_allclose([d["box"] for d in dets], gb[0, :n].numpy(), atol=2e-5)
    np.testing.assert_allclose([d["score"] for d in dets], gs[0, :n].numpy(), atol=2e-5)
    names = ["cat", "dog", "bird", "fish"]
    assert [d["className"] for d in dets] == [names[c] for c in gc[0, :n].tolist()]
    assert len([c for c in calls if c["op"] == "strokeRect"]) == len(dets)


def test_run_inference_empty_detections_through_the_port():
    image = np.random.default_rng(11).integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    dets, live, calls = _crafted_run(tjsvm, image, scoreThreshold=0.9999)
    assert dets == [] and live == 0
    assert [c for c in calls if c["op"] != "clearRect"] == []


@needs_tf
def test_run_js_pipeline_compare_matches_the_jax_tool(tiny_export, capsys, monkeypatch):
    argv = ["--model_dir", tiny_export, "--image", TOY_IMAGE, "--classes", TOY_NAMES,
            "--anchors", TOY_ANCHORS, "--compare"]
    result = run_js_pipeline.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import run_js_pipeline as jax_tool

    assert jax_tool.main(argv) == 0
    jax_out = capsys.readouterr().out

    def detection_lines(out):
        return [ln for ln in out.splitlines() if ln.startswith("  ")]

    assert detection_lines(port_out) == detection_lines(jax_out)
    assert len(detection_lines(port_out)) == len(result["detections"]) > 0
    cmp = result["compare"]
    assert cmp["classes_match"] and cmp["n_python"] == len(result["detections"])
    assert cmp["box_delta"] <= 1e-5 and cmp["score_delta"] <= 1e-5
    summary = next(ln for ln in jax_out.splitlines() if ln.startswith("python pipeline:"))
    assert summary.startswith(f"python pipeline: {cmp['n_python']} detections;")
    assert result["leaked_tensors"] == 0 and result["device"] == "cpu"


def test_run_js_pipeline_raises_without_a_card_unless_cpu_is_asked(tiny_export):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_js_pipeline.main(["--model_dir", tiny_export])


def test_browser_path_imports_without_jax_or_tensorflow():
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'yolov3_tpu', 'tensorflow'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import yolov3_tpu_torch.jsvm, yolov3_tpu_torch.export, yolov3_tpu_torch.tools.run_js_pipeline\n"
        "import yolov3_tpu_torch.export.tfjs_runtime, yolov3_tpu_torch.tools.export_tfjs\n"
        "import yolov3_tpu_torch.data.native_build\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'yolov3_tpu', 'tensorflow')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
