"""The port's TFJS graph-model export (yolov3_tpu_torch/export/tfjs_graph.py,
tools/export_tfjs.py), on the CPU.

  * ``export/tfjs_graph.py`` is a copy of the JAX package's: its code, all
    after the module docstring, is pinned to the original;
  * a port checkpoint exported by the port's tool for YOLOv3-tiny at 96 px,
    YOLOv3 and YOLOv3-SPP at 64 px, read back and run in TF, matches the
    port's fp32 forward within 2e-5 (the tolerance of the JAX package's
    export test, tests/test_tfjs_export.py), and its ``model.json`` topology
    is identical to the JAX package's export of the same checkpoint;
  * the ``uint8`` manifest round trip dequantizes exactly as an independent
    quantize → dequantize and still tracks the fp forward;
  * a spec rewritten by ``ops/s2d.py`` and int8-quantized params are rejected.
"""

import json
import os

import numpy as np
import pytest
import torch

from yolov3_tpu_torch.models import apply_model, fold_batch_norm, init_model, parse_model_config
from yolov3_tpu_torch.tools import export_tfjs

from .conftest import REPO, has_tf

needs_tf = pytest.mark.skipif(not has_tf(), reason="tensorflow unavailable")
NCLASSES = 3
NOTE = ("Framework-neutral copy of ``yolov3_tpu/export/tfjs_graph.py`` (the port imports "
        "nothing\nof the JAX package). tests/test_torch_tfjs_export.py pins its code")


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


def test_tfjs_graph_copy_pinned_to_original():
    copy, original = (_read(pkg, "export", "tfjs_graph.py")
                      for pkg in ("yolov3_tpu_torch", "yolov3_tpu"))
    body = lambda src: src[src.index('"""', 3) + 3:]  # noqa: E731 — after the docstring
    assert copy.count(NOTE) == 1
    assert body(copy) == body(original)


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


@needs_tf
@pytest.mark.parametrize("model,size", [("yolov3_tiny", 96), ("yolov3", 64), ("yolov3_spp", 64)])
def test_export_runs_in_tf_like_the_port_forward(tmp_path, model, size, monkeypatch):
    from yolov3_tpu_torch.export import TFJS_SUPPORTED_OPS, run_graph_model

    model_file, spec, params, state, ckpt, names = _checkpoint(tmp_path, model)
    out_dir = str(tmp_path / "port")
    export_tfjs.main(["--model_config_file", model_file, "--weights_path", ckpt,
                      "--classes_name_file", names, "--image_size", str(size),
                      "--tfjs_out_dir", out_dir])
    with open(os.path.join(out_dir, "model.json")) as f:
        port_json = json.load(f)
    assert {n["op"] for n in port_json["modelTopology"]["node"]} <= TFJS_SUPPORTED_OPS

    x = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
    tf_outs = run_graph_model(out_dir, x)
    want = _port_forward(spec, params, state, x)
    assert len(tf_outs) == len(want) == (2 if model == "yolov3_tiny" else 3)
    for t, w in zip(tf_outs, want):
        assert t.shape == w.shape
        np.testing.assert_allclose(t, w, rtol=0, atol=2e-5)

    # the JAX package's export of the same checkpoint: the same topology
    monkeypatch.syspath_prepend(os.path.join(REPO, "utilities"))
    from convert_model_to_tfjs import export_tfjs_graph_model as jax_export

    jax_dir = str(tmp_path / "jax")
    jax_export(model_file, ckpt, names, size, jax_dir)
    with open(os.path.join(jax_dir, "model.json")) as f:
        jax_json = json.load(f)
    assert port_json["modelTopology"] == jax_json["modelTopology"]
    assert port_json["signature"] == jax_json["signature"]


@needs_tf
def test_uint8_manifest_roundtrip(tmp_path):
    from tensorflow.python.framework import tensor_util

    from yolov3_tpu_torch.export import (build_tf_graph, quantize_weight, read_graph_model,
                                         run_graph_model)

    model_file, spec, params, state, ckpt, names = _checkpoint(tmp_path, "yolov3_tiny", seed=2)
    size, q_dir = 96, str(tmp_path / "q8")
    export_tfjs.export_tfjs_graph_model(model_file, ckpt, names, size, q_dir, quantize="uint8")
    with open(os.path.join(q_dir, "model.json")) as f:
        manifest = json.load(f)["weightsManifest"][0]["weights"]
    quantized = [w for w in manifest if "quantization" in w]
    assert quantized and all(w["quantization"]["dtype"] == "uint8" and w["dtype"] == "float32"
                             for w in quantized)

    graph_def, _, _ = build_tf_graph(*export_tfjs.load_folded_model(model_file, ckpt, names),
                                     size)
    by_name = {n.name: n for n in read_graph_model(q_dir)[0].node}
    for node in graph_def.node:
        if node.op == "Const":
            orig = tensor_util.MakeNdarray(node.attr["value"].tensor)
            got = tensor_util.MakeNdarray(by_name[node.name].attr["value"].tensor)
            if orig.dtype == np.float32:
                q, meta = quantize_weight(np.ascontiguousarray(orig), "uint8")
                expect = q.astype(np.float32) * np.float32(meta["scale"]) + np.float32(
                    meta["min"])
                np.testing.assert_array_equal(got, expect.reshape(got.shape))

    x = np.random.RandomState(0).rand(1, size, size, 3).astype(np.float32)
    for t, w in zip(run_graph_model(q_dir, x), _port_forward(spec, params, state, x)):
        assert t.shape == w.shape and np.isfinite(t).all()
        assert np.corrcoef(t.ravel(), w.ravel())[0, 1] > 0.98


@needs_tf
def test_export_rejects_transformed_specs(tmp_path):
    from yolov3_tpu_torch.export import build_tf_graph
    from yolov3_tpu_torch.ops.s2d import s2d_stem_train

    model_file, spec, _, _, ckpt, names = _checkpoint(tmp_path, "yolov3")
    _, folded = export_tfjs.load_folded_model(model_file, ckpt, names)
    s2d_spec = s2d_stem_train(spec, image_size=64)
    assert s2d_spec is not spec  # the rewrite must actually trigger
    with pytest.raises(ValueError, match="un-rewritten"):
        build_tf_graph(s2d_spec, folded, 64)

    bad = {sm: dict(layers) for sm, layers in folded.items()}
    first_sm = spec.sub_models[0].name
    first_key = next(iter(bad[first_sm]))
    entry = dict(bad[first_sm][first_key])
    entry["kernel_q"] = entry.pop("kernel")
    bad[first_sm][first_key] = entry
    with pytest.raises(ValueError, match="quantiz"):
        build_tf_graph(spec, bad, 64)
