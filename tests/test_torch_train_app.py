"""The port's trainer (yolov3_tpu_torch/apps/train_app.py, apps/cli.py) on the
CPU: YOLOv3-tiny on the in-repo shapes_toy TFRecords at 96 px.

  * one epoch through the command line with ``--device cpu``: log lines,
    the three checkpoint files, model_summary.txt; then resume;
  * the JAX package loads the port's ``.npz`` and ``.train_state.npz``
    (every leaf bit-equal), and the port resumes a state the JAX trainer
    wrote;
  * lr_schedule, transfer learning with a frozen backbone;
  * ``spatial_partitioning`` keeps the JAX trainer's checks and trains;
    ``multihost`` over a group of one process is the plain trainer.

Tolerance: none — checkpoints carry bits."""

import contextlib
import logging
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.apps.train_app import Train as JaxTrain
from yolov3_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from yolov3_tpu.io.resolve import load_weights as jax_load_weights
from yolov3_tpu.models import network as jnet
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu.parallel import train_step as jts
from yolov3_tpu_torch.apps import cli
from yolov3_tpu_torch.apps.train_app import Train
from yolov3_tpu_torch.io.checkpoint import checkpoint_keys, load_train_state
from yolov3_tpu_torch.io.resolve import load_weights
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.models.convert import params_to_jax, train_state_to_jax
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.parallel import train_step as tts
from yolov3_tpu_torch.tree import tree_leaves

from .conftest import REPO, absolutize_run_config
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

LR = 0.001


def _config(out_dir, **overrides):
    with open(os.path.join(REPO, "config/train_config.yaml")) as f:
        cfg = absolutize_run_config(yaml.safe_load(f))
    cfg.update(image_size=96, batch_size=8, epochs=1, learning_rate=LR, ema=True,
               output_checkpoints_path=os.path.join(str(out_dir), "tiny.tf"))
    cfg.update(overrides)
    return cfg


@contextlib.contextmanager
def _captured_logs():
    lines = []

    class Handler(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Handler(level=logging.INFO)
    logging.getLogger().addHandler(handler)
    try:
        yield lines
    finally:
        logging.getLogger().removeHandler(handler)


def _specs():
    model = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
    return jax_parse(model, 3), parse_model_config(model, 3)


def _load_port_state(ckpt, ema=True, optimizer=None):
    _, tspec = _specs()
    optimizer = optimizer or tts.make_adam(LR)
    params, state = tnet.init_model(tspec, torch.Generator().manual_seed(0))
    like = tts.init_train_state(params, state, optimizer, ema=ema)
    return load_train_state(ckpt + ".train_state.npz", like, optimizer)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """One epoch through ``python -m yolov3_tpu_torch.apps.cli train --device cpu``."""
    out = tmp_path_factory.mktemp("port_train")
    cfg = _config(out)
    path = out / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with _captured_logs() as lines:
        cli.main(["train", "--config", str(path), "--device", "cpu"])
    return cfg, list(lines)


def test_one_epoch_writes_checkpoints_and_logs(port_run):
    cfg, lines = port_run
    ckpt = cfg["output_checkpoints_path"]
    for suffix in (".npz", ".train_state.npz", ".ema.npz"):
        assert os.path.exists(ckpt + suffix), suffix
    text = "\n".join(lines)
    assert "epoch 1: 4 steps in" in text and "epoch 1: train_loss" in text
    assert "epoch 1: val_loss" in text and "ema: decay 0.9999" in text
    summary = open(os.path.join(os.path.dirname(ckpt), "model_summary.txt")).read()
    assert "backbone" in summary and "Head grids @ 96: (3, 6)" in summary
    assert "3x3 3→16 s1 +bn leaky" in summary
    state, epoch = _load_port_state(ckpt)
    assert epoch == 1 and int(state["step"]) == 4 and int(state["opt_state"]["count"]) == 4
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state["params"]))


def test_resume_continues_at_the_next_epoch(port_run, tmp_path):
    cfg, _ = port_run
    import shutil

    work = tmp_path / "resume"
    shutil.copytree(os.path.dirname(cfg["output_checkpoints_path"]), work)
    cfg2 = dict(cfg, output_checkpoints_path=str(work / "tiny.tf"), resume=True, epochs=2,
                device="cpu")
    with _captured_logs() as lines:
        state = Train()(**cfg2)
    text = "\n".join(lines)
    assert "resumed full train state from" in text and "at epoch 2" in text
    assert "epoch 2: train_loss" in text and "epoch 1: train_loss" not in text
    assert int(state["step"]) == 8
    # without `resume` the same call starts over at epoch 1
    with _captured_logs() as lines:
        Train()(**dict(cfg2, resume=False, epochs=1, max_dataset_examples=8))
    assert "epoch 1: train_loss" in "\n".join(lines)


def test_jax_package_loads_the_ports_checkpoints(port_run):
    cfg, _ = port_run
    ckpt = cfg["output_checkpoints_path"]
    jspec, tspec = _specs()
    state, _ = _load_port_state(ckpt)
    want = train_state_to_jax(state, tts.make_adam(LR))
    # weights, by the JAX package's own loader
    zp, zs = jnet.init_model(jax.random.PRNGKey(0), jspec)
    for path, tree in ((ckpt, (want["params"], want["bn_state"])),
                       (ckpt + ".ema.npz", (want["ema"]["params"], want["ema"]["bn_state"]))):
        lp, ls = jax_load_weights(jspec, zp, zs, path)
        for a, b in zip(jax.tree.leaves((lp, ls)), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), b)
    # the full train state, strictly, into the JAX trainer's own template
    like = jts.init_train_state(zp, zs, jts.make_adam(LR), ema=True)
    restored, epoch = jax_load_checkpoint(ckpt + ".train_state.npz", like=like)
    assert epoch == 1 and int(restored["step"]) == 4
    assert int(restored["opt_state"][0].count) == 4
    got, expect = jax.tree.leaves(restored), jax.tree.leaves(want)
    assert len(got) == len(expect)
    for a, b in zip(got, expect):
        np.testing.assert_array_equal(np.asarray(a), b)
    # and the port's own weight loader reads back what it wrote
    params, bn = load_weights(tspec, *tnet.init_model(tspec, torch.Generator().manual_seed(1)),
                              ckpt)
    for a, b in zip(jax.tree.leaves(params_to_jax(params, bn)),
                    jax.tree.leaves((want["params"], want["bn_state"]))):
        np.testing.assert_array_equal(a, b)


def test_port_resumes_a_state_the_jax_trainer_wrote(tmp_path):
    cfg = _config(tmp_path)
    with _captured_logs():
        jax_state = JaxTrain()(**cfg)
    ckpt = cfg["output_checkpoints_path"]
    state, epoch = _load_port_state(ckpt)
    assert epoch == 1 and int(state["step"]) == 4
    want = jax.tree.map(np.asarray, jax_state)
    back = train_state_to_jax(state, tts.make_adam(LR))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with _captured_logs() as lines:
        resumed = Train()(**dict(cfg, resume=True, epochs=2, device="cpu"))
    text = "\n".join(lines)
    assert "resumed full train state from" in text and "at epoch 2" in text
    assert int(resumed["step"]) == 8 and int(resumed["opt_state"]["count"]) == 8
    moved = (resumed["params"]["head0"]["layer2"]["kernel"]
             - state["params"]["head0"]["layer2"]["kernel"]).abs().max()
    assert 0 < float(moved) < 4 * LR * 1.01  # four Adam steps from the JAX weights


def test_lr_schedule_and_sgd_keep_the_rate_in_the_state(tmp_path):
    cfg = _config(tmp_path, ema=None, epochs=2, max_dataset_examples=8, device="cpu",
                  lr_schedule={"type": "cosine", "warmup_epochs": 1},
                  optimizer={"type": "sgd", "momentum": 0.9, "nesterov": True},
                  grad_clip_norm=10.0, training_mode="eager_tf")
    with _captured_logs() as lines:
        state = Train()(**cfg)
    text = "\n".join(lines)
    assert "epoch 1: learning_rate 0.001" in text and "epoch 2: learning_rate 0.001" in text
    assert "1_train_0_lr:0.001000, totLoss:" in text and "perGridPerSource:" in text
    assert "2_val_0_lr:" in text
    keys = checkpoint_keys(cfg["output_checkpoints_path"] + ".train_state.npz")
    assert "opt_state/1/learning_rate" in keys and "opt_state/0" in keys
    assert any(k.startswith("opt_state/3/1/0/0/") for k in keys)  # clip → sgd trace
    assert float(state["opt_state"]["learning_rate"]) == pytest.approx(
        tts.epoch_learning_rate(LR, 2, 2, cfg["lr_schedule"]))


def test_transfer_learning_freezes_the_backbone(port_run, tmp_path):
    cfg, _ = port_run
    tlc = {"transfer_list": ["backbone"], "freeze_train_list": ["backbone"],
           "batch_norm_freeze_list": ["backbone"],
           "input_weights_path": cfg["output_checkpoints_path"]}
    cfg2 = _config(tmp_path, ema=None, max_dataset_examples=8, device="cpu",
                   transfer_learning_config=tlc, seed=5)
    state = Train()(**cfg2)
    source, _ = _load_port_state(cfg["output_checkpoints_path"])
    for key, entry in state["params"]["backbone"].items():
        assert torch.equal(entry["kernel"], source["params"]["backbone"][key]["kernel"])
        assert torch.equal(state["bn_state"]["backbone"][key]["mean"],
                           source["bn_state"]["backbone"][key]["mean"])
    # the heads were neither transferred (seed 5 init) nor frozen
    assert not torch.equal(state["params"]["head0"]["layer2"]["kernel"],
                           source["params"]["head0"]["layer2"]["kernel"])


@pytest.mark.parametrize("key", ["multihost", "spatial_partitioning"])
def test_keys_of_later_slices_raise_by_name(tmp_path, key):
    """Both keys are ported. ``spatial_partitioning``: a factor that does
    not divide the image size raises the JAX trainer's message and writes
    nothing, and ``spatial_partitioning: 2`` trains (its math is
    tests/test_torch_spatial.py's). ``multihost``: the ``multihost`` dict
    joins a process group, and a group of one process is the plain trainer
    (as a one-device mesh is in the JAX package), bit for bit; the
    data-parallel run itself is tests/test_torch_multihost.py's."""
    if key == "spatial_partitioning":
        with pytest.raises(ValueError, match=r"image sizes \[96\] not divisible by "
                                             r"spatial_partitioning \(5\)"):
            Train()(**_config(tmp_path, device="cpu", **{key: 5}))
        assert not os.path.exists(os.path.join(str(tmp_path), "tiny.tf.npz"))
        Train()(**_config(tmp_path, device="cpu", ema=None, max_dataset_examples=8, **{key: 2}))
        assert os.path.exists(os.path.join(str(tmp_path), "tiny.tf.npz"))
        return
    import torch.distributed as dist

    from .test_torch_multihost import free_port

    kw = dict(device="cpu", ema=None, max_dataset_examples=8)
    try:
        joined = Train()(**_config(tmp_path / "mh", **kw, multihost={
            "coordinator_address": f"127.0.0.1:{free_port()}", "num_processes": 1,
            "process_id": 0, "backend": "gloo"}))
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    plain = Train()(**_config(tmp_path / "plain", **kw))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(joined), tree_leaves(plain)))
    assert os.path.exists(os.path.join(str(tmp_path / "mh"), "tiny.tf.npz"))


def test_trainer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Train()(**_config(tmp_path))
