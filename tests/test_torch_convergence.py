"""The port's training-quality recipes (yolov3_tpu_torch/tools/
{make_toy_dataset, train_convergence, qat_ab, augment_ab}.py) against the JAX
package's tools, on the CPU at a small size (yolov3_tiny at 96², 64 train /
16 val images, B=8), and the port's NMS matrix bound read from
``YOLOV3_NMS_MATRIX_MAX_K``.

Tolerances:
  * the generator: every file byte for byte, against the bundled
    ``datasets/shapes_toy`` (its draws from one stream, as that corpus was
    made) and against the JAX tool (defaults, and ``max_overlap`` 0.15);
  * the recipe against the JAX tool, both from JAX's seeded init in fp32
    and on one decode tier: the first three steps' losses 1e-4 relative;
    each epoch's train and val loss 0.1 relative (see the test: in fp32 Adam
    turns an ulp of the init into percents of the loss within the 16 steps);
  * ``evaluate_map50``'s bf16 mAP@0.5 against the JAX tool's on the same
    checkpoint: the same ``val_images``, within 0.01 (bf16 orders differ
    between XLA:CPU and PyTorch);
  * the int8 and ``int8_chain`` tiers within 0.01 of the port's bf16 (the
    int8 gate's bound; calibration is not bit-portable, so no JAX parity);
  * ``qat_ab`` and ``augment_ab``: their JSON holds every row."""

import glob
import importlib
import json
import logging
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import PIL
import pytest
import torch

from tools import make_toy_dataset as jax_toy
from tools import train_convergence as jax_conv
from yolov3_tpu.io.resolve import save_weights as jax_save_weights
from yolov3_tpu.models import network as jnet
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu_torch.data.tfrecord import encode_example, write_tfrecord
from yolov3_tpu_torch.io.resolve import load_weights, save_weights
from yolov3_tpu_torch.models import init_model, parse_model_config
from yolov3_tpu_torch.tools import augment_ab, make_toy_dataset, qat_ab, train_convergence
from yolov3_tpu_torch.tree import tree_map

from .conftest import REPO
from .test_torch_data import native_decode_tier
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

SMALL = ["--n_train", "64", "--n_val", "16", "--image_size", "96", "--epochs", "2",
         "--batch_size", "8"]
SEED, OVERLAP = 11, 0.15
TINY = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
IN_REPO_CKPT = os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf")


def _files(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(f"{root}/**/*", recursive=True)
                  if os.path.isfile(p))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# --- the corpus generator ---

def test_draws_reproduce_the_bundled_shapes_toy(tmp_path):
    """``draw_example`` → ``jpeg_bytes`` → the port's ``encode_example`` /
    ``write_tfrecord`` rebuild every bundled TFRecord and COCO image byte for
    byte. The bundled corpus was drawn from one ``RandomState(7)`` through
    train, val and test; ``main`` now gives each split its own stream (as
    the JAX tool does, held below)."""
    root = os.path.join(REPO, "datasets/shapes_toy")
    rng = np.random.RandomState(7)
    for split, count in (("train", 32), ("val", 16), ("test", 8)):
        records = []
        for i in range(count):
            img, boxes, classes = make_toy_dataset.draw_example(rng)
            encoded = make_toy_dataset.jpeg_bytes(img)
            b = np.asarray(boxes, np.float32)
            records.append(encode_example({
                "image/encoded": [encoded],
                "image/object/class/text": [make_toy_dataset.CLASSES[c] for c in classes],
                "image/object/bbox/xmin": b[:, 0].tolist(),
                "image/object/bbox/ymin": b[:, 1].tolist(),
                "image/object/bbox/xmax": b[:, 2].tolist(),
                "image/object/bbox/ymax": b[:, 3].tolist()}))
            if split == "train":
                assert encoded == _read(f"{root}/coco/images/img_{i:03d}.jpg"), (split, i)
        path = str(tmp_path / f"{split}.tfrec")
        write_tfrecord(path, records)
        assert _read(path) == _read(f"{root}/tfrecords/{split}/file_00.tfrec"), split


@pytest.mark.parametrize("case", ["defaults", "max_overlap_0.15"])
def test_generator_equals_the_jax_tool(tmp_path, case):
    kwargs = {} if case == "defaults" else dict(n_train=16, n_val=8, n_test=0, seed=SEED,
                                                img_size=96, max_overlap=OVERLAP)
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    make_toy_dataset.main(port, **kwargs)
    jax_toy.main(ref, **kwargs)
    names = _files(ref)
    assert names == _files(port) and len(names) > 10
    for name in names:
        assert _read(os.path.join(port, name)) == _read(os.path.join(ref, name)), name
    print(f"PIL {PIL.__version__}: {len(names)} files byte-identical")


# --- the recipe against the JAX tool ---

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus") / "shapes_conv96")
    train_convergence.ensure_dataset(root, 64, 16, 96, SEED, OVERLAP)
    return root


class _StepLosses(logging.Handler):
    """Each train step's total loss, from the trainers' per-step lines
    (``training_mode: eager_tf`` in both packages)."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        m = re.match(r"\d+_train_\d+_lr:\S+, totLoss:(\S+),", record.getMessage())
        if m:
            self.losses.append(float(m.group(1)))


def _recipe(run, *args):
    steps = _StepLosses()
    logging.getLogger().addHandler(steps)
    try:
        return run(*args), steps.losses
    finally:
        logging.getLogger().removeHandler(steps)


@pytest.fixture(scope="module")
def trained(tmp_path_factory, corpus):
    """The port's and the JAX tool's ``main`` on one corpus, both from JAX's
    seeded init (the two packages' own inits draw differently) in fp32, on
    one decode tier, and the port again from that init with every weight
    moved by 1e-7 of itself (its own fp32 spread) → dict of the three runs'
    results and step losses, and the port's out_dir."""
    base = tmp_path_factory.mktemp("recipe")
    jspec = jax_parse(TINY, 3)
    init, nudged = str(base / "init.tf"), str(base / "nudged.tf")
    jax_save_weights(jspec, *jnet.init_model(jax.random.PRNGKey(0), jspec), init)
    tspec = parse_model_config(TINY, 3)
    params, state = load_weights(tspec, *init_model(tspec, torch.Generator().manual_seed(0)),
                                 init)
    rng = np.random.RandomState(1)
    save_weights(tspec, tree_map(lambda t: t * (1 + 1e-7 * torch.from_numpy(
        rng.randn(*t.shape).astype(np.float32))), params), state, nudged)

    def args(weights):
        extra = {"mixed_precision": False, "compilation_cache": False,
                 "training_mode": "eager_tf",
                 "transfer_learning_config": {"transfer_list": ["all"],
                                              "input_weights_path": weights}}
        return SMALL + ["--data_root", corpus, "--extra", json.dumps(extra), "--skip_eval"]

    out = str(base / "port" / "yolov3_tiny")
    runs = {}
    cwd = os.getcwd()
    try:
        with native_decode_tier(), pytest.MonkeyPatch.context() as mp:
            runs["port"] = _recipe(train_convergence.main,
                                   args(init) + ["--out_dir", out, "--device", "cpu"])
            runs["nudged"] = _recipe(train_convergence.main, args(nudged) + [
                "--out_dir", str(base / "nudged"), "--device", "cpu"])
            mp.chdir(REPO)
            mp.setattr(sys, "argv", ["train_convergence.py"] + args(init)
                       + ["--out_dir", str(base / "jax")])
            _, steps = _recipe(jax_conv.main)
            with open(base / "jax" / "result.json") as f:
                runs["jax"] = ({k: {int(e): v for e, v in series.items()}
                                for k, series in json.load(f).items()
                                if k in ("train_loss", "val_loss")}, steps)
    finally:
        os.chdir(cwd)
    for done in ("nudged", "jax"):  # only their losses are read
        shutil.rmtree(base / done)
    return runs, out


def test_recipe_epoch_losses_match_the_jax_tool(trained):
    """The first three steps' losses (the recipe's config reaching the same
    math) within 1e-4 relative; each epoch's train and val loss within 0.1.
    1e-3 is below what two fp32 runs of this recipe share: Adam turns an ulp
    into percents of the loss within its 16 steps. The port against itself
    from the init moved by 1e-7 of each weight (the nudged run, printed)
    reached 1.8% at the last step on the CPU, the JAX tool 5.1%; the epoch
    train loss is the last step's, one batch."""
    runs, _ = trained
    (port, port_steps), (nudged, nudged_steps), (ref, ref_steps) = (
        runs[k] for k in ("port", "nudged", "jax"))
    assert len(port_steps) == len(nudged_steps) == len(ref_steps) == 16
    print(f"steps: port {port_steps}\n jax {ref_steps}\n nudged port {nudged_steps}")
    np.testing.assert_allclose(port_steps[:3], ref_steps[:3], rtol=1e-4)
    for key in ("train_loss", "val_loss"):
        got = [port[key][e] for e in (1, 2)]
        want = [ref[key][e] for e in (1, 2)]
        print(f"{key}: port {got} jax {want} nudged port {[nudged[key][e] for e in (1, 2)]}")
        np.testing.assert_allclose(got, want, rtol=0.1)
    assert port["wall_seconds"] > 0 and port["device"] == "cpu"
    assert sorted(port["img_per_sec"]) == [1, 2]


@pytest.mark.parametrize("which", ["in_repo", "port_trained"])
def test_evaluate_map50_matches_the_jax_tool(trained, corpus, which, monkeypatch):
    ckpt = IN_REPO_CKPT if which == "in_repo" else os.path.join(trained[1], "yolov3_tiny.tf")
    got = train_convergence.evaluate_map50(TINY, ckpt, corpus, 96, device="cpu")
    monkeypatch.chdir(REPO)
    want = jax_conv.evaluate_map50(TINY, ckpt, corpus, 96)
    gap = abs(got["map50"] - want["map50"])
    print(f"{which}: bf16 mAP@0.5 port {got['map50']:.6f} jax {want['map50']:.6f} gap {gap:.6f}")
    assert got["val_images"] == want["val_images"] == 16
    assert gap <= 0.01


@pytest.mark.parametrize("tier", ["int8", "int8_chain"])
def test_int8_tiers_stay_within_the_gate_of_bf16(trained, corpus, tier):
    ckpt = os.path.join(trained[1], "yolov3_tiny.tf")
    bf16 = train_convergence.evaluate_map50(TINY, ckpt, corpus, 96, device="cpu")
    got = train_convergence.evaluate_map50(TINY, ckpt, corpus, 96, quantize=tier,
                                           device="cpu")
    print(f"{tier}: mAP@0.5 {got['map50']:.6f} against bf16 {bf16['map50']:.6f}")
    assert got["val_images"] == 16
    assert abs(got["map50"] - bf16["map50"]) <= 0.01


# --- the A/B tools ---

def test_qat_ab_writes_every_row(trained, corpus):
    """The plain row reuses the recipe's checkpoint (its regime matches), the
    QAT rows train in processes of their own."""
    out_root = os.path.dirname(trained[1])
    out = qat_ab.main(SMALL + ["--data_root", corpus, "--out_root", out_root,
                               "--device", "cpu"])
    with open(os.path.join(out_root, "qat_ab_yolov3_tiny.json")) as f:
        saved = json.load(f)
    assert saved == out
    assert sorted(saved["matrix"]) == ["plain", "qat_full", "qat_weights"]
    for row in saved["matrix"].values():
        assert sorted(row) == ["bf16", "int8", "int8_chain", "int8_chain_delta", "int8_delta"]
    for mode in ("qat_weights", "qat_full"):
        assert os.path.exists(os.path.join(out_root, f"yolov3_tiny_{mode}", "yolov3_tiny.tf.npz"))
        shutil.rmtree(os.path.join(out_root, f"yolov3_tiny_{mode}"))


def test_augment_ab_writes_every_row(trained, corpus, tmp_path):
    """The variants evaluated on their weights hold a completed run of this
    regime (the recipe's checkpoint and result.json), which the tool reuses;
    ``ema`` and ``all`` train, each in a process of its own, and are
    evaluated on the sibling EMA checkpoint their trainer wrote."""
    variants = augment_ab.variants([96])
    names = [name for name, _, _ in variants]
    for name, _, sibling in variants:
        if sibling is None:
            os.makedirs(tmp_path / name)
            for f in ("yolov3_tiny.tf.npz", "result.json"):
                shutil.copy(os.path.join(trained[1], f), tmp_path / name)
    out = augment_ab.main(SMALL[:-2] + ["--batch_size", "8", "--data_root", corpus,
                                        "--out_root", str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "augment_ab.json") as f:
        saved = json.load(f)
    assert saved == out
    assert list(saved["rows"]) == names
    for row in saved["rows"].values():
        assert np.isfinite(row["map50"]) and "delta_vs_plain" in row
    for name in ("ema", "all"):
        assert os.path.exists(tmp_path / name / "yolov3_tiny.tf.ema.npz")
    assert saved["rows"]["sgd"]["map50"] == saved["rows"]["plain"]["map50"]  # reused as seeded


@pytest.mark.parametrize("tool", [train_convergence, qat_ab, augment_ab])
def test_tools_raise_without_a_card_unless_cpu_is_asked(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(SMALL + ["--data_root", str(tmp_path / "never_written")])
    assert not os.path.exists(tmp_path / "never_written")


def test_tools_import_without_jax():
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'yolov3_tpu', 'tools'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import yolov3_tpu_torch.tools.make_toy_dataset, yolov3_tpu_torch.tools.train_convergence\n"
        "import yolov3_tpu_torch.tools.qat_ab, yolov3_tpu_torch.tools.augment_ab\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'yolov3_tpu', 'tools')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --- the NMS matrix bound ---

@pytest.fixture
def reload_nms(monkeypatch):
    """``ops/nms.py`` imported afresh under a ``YOLOV3_NMS_MATRIX_MAX_K``
    (``None``: unset), and afresh again without it after the test (a
    reload runs in the module's own namespace, so every holder of its
    functions sees the bound it reads)."""
    from yolov3_tpu_torch.ops import nms

    def load(env):
        if env is None:
            monkeypatch.delenv("YOLOV3_NMS_MATRIX_MAX_K", raising=False)
        else:
            monkeypatch.setenv("YOLOV3_NMS_MATRIX_MAX_K", env)
        return importlib.reload(nms)

    yield load
    monkeypatch.undo()
    importlib.reload(nms)


@pytest.mark.parametrize("env,bound,branch", [(None, 512, "matrix"), ("128", 128, "round"),
                                              ("2048", 2048, "matrix")])
def test_nms_matrix_bound_follows_the_environment(reload_nms, monkeypatch, env, bound, branch):
    """``YOLOV3_NMS_MATRIX_MAX_K`` sets the port's matrix bound as it sets the
    JAX package's (default 512 here): at K=256 the branch taken follows it.
    On the card a bound above K1's 1,300 makes K1 raise (the card test
    ``test_cuda_matrix_bound_override_above_k1_raises``)."""
    nms = reload_nms(env)
    taken = []
    sweep, rounds = nms.suppression_sweep, nms.round_sweep
    monkeypatch.setattr(nms, "suppression_sweep", lambda *a: taken.append("matrix") or sweep(*a))
    monkeypatch.setattr(nms, "round_sweep",
                        lambda *a, **k: taken.append("round") or rounds(*a, **k))
    g = torch.Generator().manual_seed(0)
    xy = torch.rand(1, 400, 2, generator=g)
    nms.yolo_nms(torch.cat([xy, xy + 0.1], -1), torch.rand(1, 400, 1, generator=g),
                 torch.ones(1, 400, 1), num_candidates=256)
    assert (nms._MATRIX_SWEEP_MAX_K, taken) == (bound, [branch])
