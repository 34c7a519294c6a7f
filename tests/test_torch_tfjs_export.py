"""The port's TFJS graph-model export and executor (yolov3_tpu_torch/export/
tfjs_graph.py, export/tfjs_runtime.py, tools/export_tfjs.py), on the CPU,
against the JAX package's TensorFlow-built export.

  * the writer needs no TensorFlow, and its files equal those of the JAX
    package's ``build_tf_graph`` + ``write_graph_model`` (TensorFlow) on the
    same folded numpy weights: model.json equal as parsed JSON apart from
    ``modelTopology.versions`` (the TensorFlow build there, a fixed producer
    here), and the shards byte-identical, for YOLOv3-tiny at 96 px, YOLOv3
    and YOLOv3-SPP at 64 px, in float32, uint8 and uint16;
  * the port's executor runs those files as TensorFlow runs them (the JAX
    package's ``run_graph_model``, on the tiny and YOLOv3-SPP, whose ops
    include YOLOv3's): heads within 1e-4, and its dequantized
    weight map bit-equal to the Consts TensorFlow materializes for uint8 and
    uint16;
  * a port checkpoint exported by the port's tool gives those same files,
    and the executor's run of them matches the port's fp32 forward within
    2e-5 (the tolerance of the JAX package's export test,
    tests/test_tfjs_export.py) and TensorFlow's run within 1e-4;
  * the ``uint8`` manifest round trip dequantizes exactly as an independent
    quantize → dequantize and still tracks the fp forward;
  * a spec rewritten by ``ops/s2d.py`` and int8-quantized params are rejected.

Each model's checkpoint, TensorFlow graph, written directories and
TensorFlow run are made once for the module (``_Model``).
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.models import apply_model, fold_batch_norm, init_model, parse_model_config
from yolov3_tpu_torch.tools import export_tfjs

from .conftest import REPO, has_tf
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

needs_tf = pytest.mark.skipif(not has_tf(), reason="tensorflow unavailable")
NCLASSES = 3
MODELS = [("yolov3_tiny", 96), ("yolov3", 64), ("yolov3_spp", 64)]
# the models whose float32 export TensorFlow runs: between them every op the
# graphs hold (YOLOv3's are a subset of YOLOv3-SPP's), the tiny's 2×2
# stride-1 SAME pool, whose pad TensorFlow puts after, among them
TF_RUN = ("yolov3_tiny", "yolov3_spp")


def _checkpoint(tmp_path, model, seed=1):
    """A seeded port checkpoint (BN state + 0.25, so folding matters) →
    (spec, params, state, checkpoint path, class names file)."""
    from yolov3_tpu_torch.io.resolve import save_weights

    model_file = os.path.join(REPO, f"config/models/{model}/model.yaml")
    spec = parse_model_config(model_file, NCLASSES)
    params, state = init_model(spec, torch.Generator().manual_seed(seed))
    state = {sm: {k: {n: v + 0.25 for n, v in e.items()} for k, e in s.items()}
             for sm, s in state.items()}
    ckpt = str(tmp_path / "w.tf")
    save_weights(spec, params, state, ckpt)
    names = tmp_path / "c.names"
    names.write_text("a\nb\nc\n")
    return model_file, spec, params, state, ckpt, str(names)


def _port_forward(spec, params, state, x):
    with torch.inference_mode():
        outs = apply_model(spec, fold_batch_norm(params, state), {}, torch.from_numpy(x))
    return sorted((o.numpy() for o in outs), key=lambda o: o.shape[1])


class _Model:
    """One model's seeded checkpoint (``_checkpoint``), its folded weights,
    the JAX package's TensorFlow graph of them and the port's topology, with
    each writer's directories and TensorFlow's run of the float32 export
    made once, when first asked for."""

    def __init__(self, tmp, model, size):
        from yolov3_tpu.export import build_tf_graph
        from yolov3_tpu_torch.export import build_graph_topology
        from yolov3_tpu_torch.models.convert import params_to_jax
        from yolov3_tpu_torch.models.network import head_grid_sizes

        self.tmp, self.size = tmp, size
        (self.model_file, self.spec, self.params, self.state, self.ckpt,
         self.names) = _checkpoint(tmp, model)
        self.folded, _ = params_to_jax(fold_batch_norm(self.params, self.state), {})
        folded = self.folded
        self.shapes = [(1, g, g, 3, 5 + NCLASSES) for g in head_grid_sizes(self.spec, size)]
        self.tf = build_tf_graph(self.spec, folded, size)
        self.port = build_graph_topology(self.spec, folded, size)
        self.x = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
        self._dirs, self._tf_heads = {}, None

    def written(self, writer, quantize):
        """The directory ``writer`` ("jax" or "port") writes in ``quantize``."""
        from yolov3_tpu.export import write_graph_model as tf_write
        from yolov3_tpu_torch.export import write_graph_model

        key = (writer, quantize)
        if key not in self._dirs:
            out = str(self.tmp / f"{writer}_{quantize}")
            graph, write = (self.tf, tf_write) if writer == "jax" else (self.port,
                                                                       write_graph_model)
            write(graph[0], out, graph[1], graph[2], (1, self.size, self.size, 3), self.shapes,
                  quantize=quantize)
            self._dirs[key] = out
        return self._dirs[key]

    def tf_heads(self):
        """The JAX package's TensorFlow run of the float32 export."""
        from yolov3_tpu.export import run_graph_model as tf_run

        if self._tf_heads is None:
            self._tf_heads = tf_run(self.written("jax", None), self.x)
        return self._tf_heads


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return {model: _Model(tmp_path_factory.mktemp(model), model, size) for model, size in MODELS}


def _same_files(got_dir, want_dir):
    """model.json equal as parsed JSON, apart from ``modelTopology.versions``
    (the port writes ``GRAPH_DEF_PRODUCER``), and the shards byte-identical."""
    from yolov3_tpu_torch.export.tfjs_graph import GRAPH_DEF_PRODUCER

    with open(os.path.join(want_dir, "model.json")) as f:
        want = json.load(f)
    with open(os.path.join(got_dir, "model.json")) as f:
        got = json.load(f)
    assert got["modelTopology"].pop("versions") == {"producer": GRAPH_DEF_PRODUCER}
    want["modelTopology"].pop("versions")
    assert got == want
    shards = sorted(n for n in os.listdir(want_dir) if n.endswith(".bin"))
    assert shards and shards == sorted(n for n in os.listdir(got_dir) if n.endswith(".bin"))
    for name in shards:
        assert filecmp.cmp(os.path.join(want_dir, name), os.path.join(got_dir, name),
                           shallow=False), name


@needs_tf
@pytest.mark.parametrize("quantize", [None, "uint8", "uint16"])
@pytest.mark.parametrize("model", [m for m, _ in MODELS])
def test_writer_equals_the_jax_tf_writer(models, model, quantize):
    """The port's writer against the JAX package's TensorFlow writer on the
    same folded weights; in float32 the executor's heads against
    TensorFlow's run of the same files within 1e-4 (``TF_RUN``)."""
    from yolov3_tpu_torch.export import run_graph_model

    m = models[model]
    _same_files(m.written("port", quantize), m.written("jax", quantize))
    if quantize is None and model in TF_RUN:
        got = run_graph_model(m.written("port", None), m.x, device="cpu")
        assert [o.shape for o in got] == [o.shape for o in m.tf_heads()]
        for a, b in zip(got, m.tf_heads()):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@needs_tf
@pytest.mark.parametrize("quantize", ["uint8", "uint16"])
def test_executor_weight_map_is_tf_materialization(models, quantize):
    from tensorflow.python.framework import tensor_util

    from yolov3_tpu.export import read_graph_model as tf_read
    from yolov3_tpu_torch.export import GraphModel

    out_dir = models["yolov3_tiny"].written("port", quantize)
    tf_consts = {n.name: tensor_util.MakeNdarray(n.attr["value"].tensor)
                 for n in tf_read(out_dir)[0].node if n.op == "Const"}
    weight_map = GraphModel(out_dir, device="cpu").weight_map
    assert set(weight_map) == set(tf_consts)
    for name, arr in weight_map.items():
        want = tf_consts[name].reshape(arr.shape)
        assert arr.dtype == want.dtype
        np.testing.assert_array_equal(arr, want)


@needs_tf
@pytest.mark.parametrize("model,size", MODELS)
def test_export_runs_in_tf_like_the_port_forward(models, tmp_path, model, size):
    """``tools/export_tfjs.py`` on the checkpoint: its files are the JAX
    package's TensorFlow export of the same weights, and the executor's run
    of them is the port's fp32 forward within 2e-5 (and TensorFlow's run
    within 1e-4 for ``TF_RUN``)."""
    from yolov3_tpu_torch.export import TFJS_SUPPORTED_OPS, run_graph_model

    m = models[model]
    out_dir = str(tmp_path / "port")
    export_tfjs.main(["--model_config_file", m.model_file, "--weights_path", m.ckpt,
                      "--classes_name_file", m.names, "--image_size", str(size),
                      "--tfjs_out_dir", out_dir])
    with open(os.path.join(out_dir, "model.json")) as f:
        port_json = json.load(f)
    assert {n["op"] for n in port_json["modelTopology"]["node"]} <= TFJS_SUPPORTED_OPS
    _same_files(out_dir, m.written("jax", None))

    outs = run_graph_model(out_dir, m.x, device="cpu")
    want = _port_forward(m.spec, m.params, m.state, m.x)
    assert len(outs) == len(want) == (2 if model == "yolov3_tiny" else 3)
    for t, w in zip(outs, want):
        assert t.shape == w.shape
        np.testing.assert_allclose(t, w, rtol=0, atol=2e-5)
    if model in TF_RUN:
        for t, tf_out in zip(outs, m.tf_heads()):
            np.testing.assert_allclose(t, tf_out, rtol=0, atol=1e-4)


@needs_tf
def test_uint8_manifest_roundtrip(tmp_path):
    from yolov3_tpu.export import run_graph_model as tf_run
    from yolov3_tpu_torch.export import (GraphModel, build_graph_topology, quantize_weight,
                                         read_graph_model)

    model_file, spec, params, state, ckpt, names = _checkpoint(tmp_path, "yolov3_tiny", seed=2)
    size, q_dir = 96, str(tmp_path / "q8")
    export_tfjs.export_tfjs_graph_model(model_file, ckpt, names, size, q_dir, quantize="uint8")
    with open(os.path.join(q_dir, "model.json")) as f:
        manifest = json.load(f)["weightsManifest"][0]["weights"]
    quantized = [w for w in manifest if "quantization" in w]
    assert quantized and all(w["quantization"]["dtype"] == "uint8" and w["dtype"] == "float32"
                             for w in quantized)

    graph, _, _ = build_graph_topology(*export_tfjs.load_folded_model(model_file, ckpt, names),
                                       size)
    _, by_name = read_graph_model(q_dir)
    for name, orig in graph.weights.items():
        got = by_name[name]
        if orig.dtype == np.float32:
            q, meta = quantize_weight(np.ascontiguousarray(orig), "uint8")
            expect = q.astype(np.float32) * np.float32(meta["scale"]) + np.float32(meta["min"])
            np.testing.assert_array_equal(got, expect.reshape(got.shape))
        else:
            np.testing.assert_array_equal(got, orig)

    x = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
    outs = GraphModel(q_dir, device="cpu").run_numpy(x)
    for t, w, tf_out in zip(outs, _port_forward(spec, params, state, x), tf_run(q_dir, x)):
        assert t.shape == w.shape and np.isfinite(t).all()
        assert np.corrcoef(t.ravel(), w.ravel())[0, 1] > 0.98
        np.testing.assert_allclose(t, tf_out, rtol=0, atol=1e-4)


@needs_tf
def test_export_rejects_transformed_specs(models):
    from yolov3_tpu_torch.export import build_graph_topology
    from yolov3_tpu_torch.ops.s2d import s2d_stem_train

    spec, folded = models["yolov3"].spec, models["yolov3"].folded
    s2d_spec = s2d_stem_train(spec, image_size=64)
    assert s2d_spec is not spec  # the rewrite must actually trigger
    with pytest.raises(ValueError, match="un-rewritten"):
        build_graph_topology(s2d_spec, folded, 64)

    bad = {sm: dict(layers) for sm, layers in folded.items()}
    first_sm = spec.sub_models[0].name
    first_key = next(iter(bad[first_sm]))
    entry = dict(bad[first_sm][first_key])
    entry["kernel_q"] = entry.pop("kernel")
    bad[first_sm][first_key] = entry
    with pytest.raises(ValueError, match="quantiz"):
        build_graph_topology(spec, bad, 64)
