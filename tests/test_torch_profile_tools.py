"""The port's training-side measurement tools on the CPU against the JAX
package: ``profile_train``'s step, ``bench_input_pipeline.bench_stream`` and
``multihost_smoke`` (yolov3_tpu_torch/tools/); every new tool importing
with ``jax``, ``yolov3_tpu`` and the root ``tools/`` blocked; and
``parallel/mesh.py::make_mesh``'s default, which raises without a card.

Tolerances: the first two fp32 steps' ``total_loss`` of YOLOv3-tiny at 96²
(Adam 1e-3, JAX's weights carried across) 1e-4 relative; ``bench_stream``'s
image count and checksum equal to the JAX tool's on ``datasets/shapes_toy``
(both packages on the native decode tier); the two-process loss identical
on both ranks and within 1e-5 of one process's over the global batch."""

import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.io.resolve import load_weights as jax_load_weights
from yolov3_tpu.models import network as jnet
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu.parallel import train_step as jts
from yolov3_tpu_torch.models.convert import params_from_jax
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.parallel import mesh as tmesh
from yolov3_tpu_torch.tools import _measure as M
from yolov3_tpu_torch.tools import bench_input_pipeline, multihost_smoke, profile_train

from .conftest import REPO
from .test_torch_data import native_decode_tier
from .test_torch_multihost import free_port, run_ranks
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

TINY = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
TOY = os.path.join(REPO, "datasets/shapes_toy")
CKPT = os.path.join(REPO, "checkpoints/output/yolov3_train_tiny.tf")
NEW_TOOLS = ("_measure", "bench", "latency_bench", "profile_inference", "mfu_table",
             "profile_eval", "profile_train", "bench_resblock", "bench_input_pipeline",
             "multihost_smoke")


def _jax_tool(name):
    """A root ``tools/<name>.py`` of the JAX package, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_profile_train_first_two_steps_match_jax():
    """The tool's step from the in-repo trained checkpoint, JAX's load of it
    carried across. From the seeded init the second loss is 1.6e-4 apart
    (117.5 → 541.0 in one step): Adam's first update is ±lr whatever the
    gradient's size, and 62 of the 8.8 million gradients, near zero, differ
    in sign between the two libraries (measured); from the trained weights
    the same flips move it 2.8e-6."""
    size, batch, nc = 96, 2, 3
    jspec, tspec = jax_parse(TINY, nc), parse_model_config(TINY, nc)
    jp, js = jax.tree.map(np.asarray, jax_load_weights(
        jspec, *jnet.init_model(jax.random.PRNGKey(0), jspec), CKPT))
    tp, ts = params_from_jax(jp, js)
    step, state = profile_train.build_step(tspec, tp, ts, batch, size, "cpu", fp32=True)
    images, labels = profile_train.train_inputs(batch, size, "cpu")
    got = []
    for _ in range(2):
        state, m = step(state, images, labels)
        got.append(float(m["total_loss"]))

    anchors = M.seeded_anchors(2)
    opt = jts.make_adam(1e-3)
    jstep = jts.make_train_step(jspec, anchors, jnet.head_grid_sizes(jspec, size),
                                batch_size=batch, optimizer=opt, compute_dtype=None)
    jstate = jts.init_train_state(jp, js, opt)
    want = []
    for _ in range(2):
        jstate, jm = jstep(jstate, jnp.asarray(images.numpy()), jnp.asarray(labels.numpy()))
        want.append(float(jm["total_loss"]))
    assert want[1] != want[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_profile_train_main_on_the_cpu(capsys):
    tiny = ["--model_config_file", "config/models/yolov3_tiny/model.yaml", "--nclasses", "3"]
    r = profile_train.main(tiny + ["--batch", "2", "--image_size", "64", "--steps", "2",
                                   "--trace", "--device", "cpu"])
    out = capsys.readouterr().out
    assert re.match(r"wall: [\d.]+ ms/step  [\d.]+ img/s \(host clock", out)
    assert "peak memory: not measured; device: cpu" in out
    assert "(--trace: no device trace on the CPU)" in out
    assert r["device"] == "cpu" and len(r["losses"]) == 2 and np.isfinite(r["loss"])
    assert "phases (host ms, median a step): {'steps': 2, 'S|step': " in out
    assert list(r["phases"]) == ["steps", "S|step", "S|anchors", "S|assign", "S|forward",
                                 "S|loss", "S|backward", "S|optimizer"]
    # the tiny's 11 BN convs train; on the CPU none of their tails takes K7
    assert "bn tails fused 0 of 11 a step (fell back: {'not cuda': 11.0})" in out
    assert r["bn_tails"] == {"not cuda": 11.0}
    with pytest.raises(ValueError, match="--dump_hlo"):
        profile_train.main(tiny + ["--dump_hlo", "x.txt", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profile_train.main(tiny)


@pytest.mark.parametrize("batched", [False, True])
def test_bench_stream_matches_the_jax_tool(monkeypatch, batched):
    """Image count and checksum of one pass over the shapes_toy train split,
    the JAX tool's checksum read where it checks it (``np.isfinite``)."""
    seen = []
    real = np.isfinite
    monkeypatch.setattr(np, "isfinite", lambda v: (seen.append(v), real(v))[1])
    jtool = _jax_tool("bench_input_pipeline")
    args = (TOY, 128, 4, 2, 16)
    with native_decode_tier():
        _, n_img, checksum = bench_input_pipeline.bench_stream(*args, batched=batched)
        seen.clear()
        _, j_n_img = jtool.bench_stream(*args, batched=batched)
        j_checksum = seen[-1]
    assert n_img == j_n_img == 16
    assert checksum == j_checksum and checksum != 0.0


def test_bench_input_pipeline_main(capsys):
    r = bench_input_pipeline.main(["--data_root", "datasets/shapes_toy", "--image_size", "96",
                                   "--batch", "4", "--workers", "1", "2", "--max_images", "8"])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(ln) for ln in lines]
    assert [row["workers"] for row in rows[:2]] == [1, 2]
    assert all(row["path"] == "per-example" and row["images"] == 8 for row in rows[:2])
    assert rows[2] == {"verdict": "no_target", "best_img_per_sec": r["best_img_per_sec"],
                       "target_img_per_sec": None, "headroom_x": None,
                       "decode": r["decode"], "decode_reason": r["decode_reason"]}
    assert r["decode"] in ("native", "python")
    r = bench_input_pipeline.main(["--data_root", "datasets/shapes_toy", "--image_size", "96",
                                   "--batch", "4", "--workers", "1", "--max_images", "8",
                                   "--target", "1e-3", "--batched"])
    assert r["verdict"] == "feeds_train_step" and r["target_img_per_sec"] == 1e-3
    assert r["rows"][0]["path"] == "batched"


def test_multihost_smoke_two_processes(tmp_path):
    port = free_port()
    outs = run_ranks([[sys.executable, "-m", "yolov3_tpu_torch.tools.multihost_smoke",
                       "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                       "--process_id", str(rank), "--device", "cpu"] for rank in range(2)],
                     tmp_path)
    found = [re.search(r"MULTIHOST_OK procs=(\d+) devices=(\d+) loss=([\d.eE+-]+)", out)
             for out in outs]
    assert all(found), outs
    assert {(m.group(1), m.group(2)) for m in found} == {("2", "2")}
    losses = [float(m.group(3)) for m in found]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], multihost_smoke.dp_step_loss(2, 96, "cpu"),
                               rtol=1e-5)


def test_make_mesh_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is that card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.make_mesh(spatial=2)
    mesh = tmesh.make_mesh(devices=("cpu",))
    assert mesh.devices == (torch.device("cpu"),) and mesh.shape == {"data": 1}


def test_multihost_smoke_raises_without_a_card():
    """Without ``--device cpu`` the tool asks for the card before it joins a
    process group."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost_smoke.main(["--coordinator", "127.0.0.1:1", "--num_processes", "2",
                              "--process_id", "0"])
    assert not torch.distributed.is_initialized()


def test_new_tools_import_without_jax():
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'yolov3_tpu', 'tools'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "for m in ('jax', 'jaxlib', 'yolov3_tpu', 'tools'):\n"
        "    sys.modules[m] = None\n"
        f"for tool in {NEW_TOOLS!r}:\n"
        "    __import__('yolov3_tpu_torch.tools.' + tool)\n"
        "bad = [m for m, v in sys.modules.items()\n"
        "       if v is not None and m.split('.')[0] in ('jax', 'yolov3_tpu', 'tools')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
