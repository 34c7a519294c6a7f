"""The port's transfer and scale tools (yolov3_tpu_torch/tools/
{pets_transfer, scale_matrix}.py) against the JAX package's
``tools/pets_transfer.py`` and ``tools/scale_matrix.py``, on the CPU.

``pets_transfer`` runs both tools as shipped (bf16 ``mixed_precision``, the
splits staged as uint8, mosaic + HSV, cosine LR, early stopping on) on the
bundled ``datasets/pets_mini`` with ``config/train_config_pets.yaml`` read
through a patched ``load_yaml`` that swaps in the tiny model and its anchors
and keeps 16 images a split; 64², B=8, one epoch, from the in-repo tiny
checkpoint as ``--backbone_ckpt`` (3 classes → the 38 of
``pets_breed.names``, so the heads are fresh). Both start from JAX's seeded
init (the two packages' own inits draw differently): the port's trainer
loads it in place of its own.

Tolerances:
  * the frozen leaves (backbone params, backbone and neck BN statistics) of
    both tools' checkpoints bit-equal to each other and to the backbone
    checkpoint; the neck's params moved;
  * epoch 1's train and val loss within 5e-2 relative. The regime is bf16
    on both sides (the tool's own), whose 8-bit mantissa rounds the two
    libraries' convolutions apart; measured on the CPU: train 1.8e-2 (the
    epoch's last step, one augmented batch after one Adam update), val
    6.7e-4 (printed by ``-s``);
  * the int8 gate's keys equal, its mAPs within 0.01;
  * ``scale_matrix``: with every variant missing the JSON equal to the JAX
    tool's; a present variant's cells equal to ``evaluate_map50`` called
    directly (held against the JAX tool's since the recipe tools' tests)."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import yolov3_tpu.config
import yolov3_tpu.utils.compile_cache
from tools import pets_transfer as jax_pets
from tools import scale_matrix as jax_scale
from yolov3_tpu.io.resolve import save_weights as jax_save_weights
from yolov3_tpu.models import network as jnet
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu_torch import config as tconfig
from yolov3_tpu_torch.apps import train_app
from yolov3_tpu_torch.io.checkpoint import _flatten, load_checkpoint
from yolov3_tpu_torch.io.resolve import load_weights, save_weights
from yolov3_tpu_torch.models import init_model, parse_model_config
from yolov3_tpu_torch.tools import pets_transfer, scale_matrix, train_convergence

from .conftest import REPO, SUITE_XLA_CACHE
from .test_torch_data import native_decode_tier
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

TINY = "config/models/yolov3_tiny/model.yaml"
BACKBONE = os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf")
PETS = ["--epochs", "1", "--batch_size", "8", "--image_size", "64",
        "--backbone_ckpt", BACKBONE, "--eval_max_images", "8"]
LOSS_RTOL = 5e-2


def _tiny_pets(load):
    def patched(path):
        cfg = load(path)
        if os.path.basename(path) == "train_config_pets.yaml":
            cfg.update(model_config_file=TINY, max_dataset_examples=16,
                       anchors_file="datasets/shapes_toy/anchors/anchors_tiny.txt")
        return cfg
    return patched


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """JAX's trainer init for the 38-class tiny (``PRNGKey(0)``), saved."""
    path = str(tmp_path_factory.mktemp("init") / "jax_init.tf")
    spec = jax_parse(os.path.join(REPO, TINY), 38)
    jax_save_weights(spec, *jnet.init_model(jax.random.PRNGKey(0), spec), path)
    return path


def _port_pets(out_dir, jax_init, *extra):
    """The port's tool on the patched config, its trainer started from
    ``jax_init`` → the result dict."""
    init = train_app.init_model

    def init_from_jax(spec, generator):
        return load_weights(spec, *init(spec, generator), jax_init)

    cwd = os.getcwd()
    with native_decode_tier(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tconfig, "load_yaml", _tiny_pets(tconfig.load_yaml))
        mp.setattr(train_app, "init_model", init_from_jax)
        result = pets_transfer.main(PETS + ["--out_dir", out_dir, "--device", "cpu", *extra])
    assert os.getcwd() == cwd  # the tool gives the caller its directory back
    return result


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, jax_init):
    out = str(tmp_path_factory.mktemp("port"))
    return _port_pets(out, jax_init), out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax"))
    cwd = os.getcwd()
    try:
        with native_decode_tier(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(yolov3_tpu.config, "load_yaml", _tiny_pets(yolov3_tpu.config.load_yaml))
            # the tool asks for a compilation cache: keep it in the suite's
            mp.setattr(yolov3_tpu.utils.compile_cache, "DEFAULT_DIR", SUITE_XLA_CACHE)
            mp.setattr(sys, "argv", ["pets_transfer.py"] + PETS + ["--out_dir", out])
            jax_pets.main()
    finally:
        os.chdir(cwd)
    with open(os.path.join(out, "result.json")) as f:
        return json.load(f), out


def _leaves(out_dir):
    return _flatten(load_checkpoint(os.path.join(out_dir, "yolov3_pets.tf.npz"))[0])


def _sub_model(key):
    return key.split("/")[1]


def test_port_run_freezes_the_backbone_and_moves_the_neck(port_run):
    result, out = port_run
    got, start = _leaves(out), _flatten(load_checkpoint(BACKBONE + ".npz")[0])
    frozen = [k for k in got if _sub_model(k) == "backbone"
              or (k.startswith("bn_state/") and _sub_model(k).startswith("neck"))]
    neck = [k for k in got if k.startswith("params/") and _sub_model(k).startswith("neck")]
    assert len(frozen) > 20 and len(neck) > 5
    for k in frozen:
        assert got[k].tobytes() == start[k].tobytes(), k
    assert any(got[k].tobytes() != start[k].tobytes() for k in neck)
    assert result["recipe"] == {"freeze": "config", "patience": 12,
                                "augment": pets_transfer.AUGMENT}
    assert result["config"]["device"] == "cpu" and result["config"]["mixed_precision"] is True
    assert sorted(result["train_loss"]) == [1] and np.isfinite(result["val_loss"][1])
    with open(os.path.join(out, "result.json")) as f:
        assert json.load(f)["int8_gate"] == result["int8_gate"]


def test_frozen_leaves_equal_the_jax_tools(port_run, jax_run):
    port, ref = _leaves(port_run[1]), _leaves(jax_run[1])
    assert sorted(port) == sorted(ref)
    frozen = [k for k in ref if _sub_model(k) == "backbone"
              or (k.startswith("bn_state/") and _sub_model(k).startswith("neck"))]
    assert len(frozen) > 20
    for k in frozen:
        assert port[k].tobytes() == ref[k].tobytes(), k


def test_epoch_one_losses_match_the_jax_tool(port_run, jax_run):
    port, ref = port_run[0], jax_run[0]
    got = [port["train_loss"][1], port["val_loss"][1]]
    want = [ref["train_loss"]["1"], ref["val_loss"]["1"]]
    print(f"epoch 1 train, val loss: port {got} jax {want} "
          f"rel {[abs(a - b) / abs(b) for a, b in zip(got, want)]}")
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_gate_matches_the_jax_tool(port_run, jax_run):
    got, want = port_run[0]["int8_gate"], jax_run[0]["int8_gate"]
    print(f"gate: port {got}\n jax {want}")
    assert sorted(got) == sorted(want)
    assert got["images"] == want["images"] == 8
    for key in ("map50_bf16", "map50_int8"):
        assert abs(got[key] - want[key]) <= 0.01, key
    assert got["gate_pass"] == (abs(got["map50_int8"] - got["map50_bf16"]) <= 0.01)


def test_freeze_none_trains_every_sub_model(tmp_path, jax_init):
    result = _port_pets(str(tmp_path), jax_init, "--freeze", "none", "--no_augment",
                        "--patience", "0")
    got, start = _leaves(str(tmp_path)), _flatten(load_checkpoint(BACKBONE + ".npz")[0])
    backbone = [k for k in got if _sub_model(k) == "backbone"]
    assert all(k in start for k in backbone)
    for prefix in ("params/", "bn_state/"):
        assert any(got[k].tobytes() != start[k].tobytes() for k in backbone
                   if k.startswith(prefix)), prefix
    tlc = result["config"]["transfer_learning_config"]
    assert tlc["freeze_train_list"] == tlc["batch_norm_freeze_list"] == ["none"]
    assert result["config"]["early_stopping"] is False and "augmentation" not in result["config"]


def test_pets_transfer_needs_its_backbone(tmp_path):
    cwd = os.getcwd()
    with pytest.raises(SystemExit):
        pets_transfer.main(["--backbone_ckpt", str(tmp_path / "absent.tf"),
                            "--out_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert os.getcwd() == cwd and not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("tool", [pets_transfer, scale_matrix])
def test_tools_raise_without_a_card_unless_cpu_is_asked(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(["--out_dir" if tool is pets_transfer else "--out",
                   str(tmp_path / "never_written")])
    assert not os.path.exists(tmp_path / "never_written")


# --- scale_matrix ---

def test_missing_rows_equal_the_jax_tools(tmp_path, monkeypatch):
    variants = {"single_scale_416": str(tmp_path / "absent/yolov3.tf"),
                "ms_interval10_cal608": str(tmp_path / "absent/yolov3.tf.cal608")}
    for module in (scale_matrix, jax_scale):
        monkeypatch.setattr(module, "VARIANTS", variants)
    outs = {side: str(tmp_path / f"{side}.json") for side in ("port", "jax")}
    got = scale_matrix.main(["--out", outs["port"], "--device", "cpu"])
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", ["scale_matrix.py", "--out", outs["jax"]])
    jax_scale.main()
    with open(outs["port"]) as a, open(outs["jax"]) as b:
        port, ref = json.load(a), json.load(b)
    assert port == ref == json.loads(json.dumps(got))
    assert all(row["missing"] for row in port["rows"].values())
    assert port["evals"] == {k: {"data_root": v[0], "image_size": v[1]}
                             for k, v in scale_matrix.EVALS.items()}


def test_present_row_equals_evaluate_map50(tmp_path):
    """A seeded 3-class YOLOv3 at 64² on a generated corpus of 8 val images:
    each cell is ``evaluate_map50`` of the same inputs, rounded as the JAX
    tool rounds; a corpus without a val split is a ``null`` cell."""
    corpus = str(tmp_path / "shapes_conv64")
    train_convergence.ensure_dataset(corpus, 8, 8, 64, 11, 0.15)
    spec = parse_model_config(os.path.join(REPO, scale_matrix.MODEL_CONFIG), 3)
    ckpt = str(tmp_path / "yolov3.tf")
    save_weights(spec, *init_model(spec, torch.Generator().manual_seed(3)), ckpt)
    variants = {"single_scale_416": ckpt, "ms_per_epoch": str(tmp_path / "absent.tf")}
    evals = {"64": (corpus, 64), "608": (str(tmp_path / "no_corpus"), 608)}
    out = scale_matrix.main(["--out", str(tmp_path / "m.json"), "--device", "cpu"],
                            variants=variants, evals=evals)
    row = out["rows"]["single_scale_416"]
    want = train_convergence.evaluate_map50(os.path.join(REPO, scale_matrix.MODEL_CONFIG),
                                            ckpt, corpus, 64, device="cpu")
    assert row["map50_at_64"] == round(want["map50"], 4)
    assert row["map50_at_608"] is None and row["eval_64_wall_s"] >= 0
    assert out["rows"]["ms_per_epoch"] == {"checkpoint": variants["ms_per_epoch"],
                                           "missing": True}
