"""Data parallelism across processes in the port (yolov3_tpu_torch/parallel/
mesh.py and the trainer's ``multihost`` key), on the CPU: two processes joined
by ``torch.distributed`` over gloo on a free 127.0.0.1 port, each with a
subprocess timeout.

  * ``cli train`` with the ``multihost`` dict in two processes, mirroring
    tests/test_multihost.py: both finish, only rank 0 writes (each rank has
    a checkpoint path of its own, as on hosts without a shared filesystem),
    a resumed run starts both ranks at epoch 2 (rank 0 decides and
    broadcasts), and each epoch's losses match one process training the same
    global batches from the same state within 1e-3 (``shard_bn_sums``: the
    one process takes its BatchNorm sums over the ranks' shards and adds
    them, as the all-reduce does; epoch 2 starts from rank 0's checkpoint,
    since the differences left, in the order of the gradients' sums, grow
    from step to step);
  * the mesh helpers: ``local_batch_slice`` and the JAX module's checks and
    messages.

This file is also the workers' program: ``python tests/test_torch_multihost.py
<scenario> <rank> <world size> <port> <directory>`` joins the group and runs
a scenario of ``SCENARIOS`` (tests/test_torch_parallel.py drives the
data-parallel train step through it). It imports no JAX, so a worker starts
with torch alone."""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import re
import shutil
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

if __package__:  # under pytest; the ranks run this file as a script
    from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 300


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argvs, cwd, timeout=WORKER_TIMEOUT_S):
    """Start one process per argument list, wait for all of them, and return
    their outputs; a rank that fails or outlives ``timeout`` fails the test
    (every process is killed first)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(argv, cwd=str(cwd), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed (rc {p.returncode}):\n{out[-4000:]}"
    return outs


def run_scenario(scenario, workdir, world=2):
    """Every rank of ``world`` runs ``scenario`` of this file's ``SCENARIOS``."""
    port = str(free_port())
    return run_ranks([[sys.executable, os.path.abspath(__file__), scenario, str(rank),
                       str(world), port, str(workdir)] for rank in range(world)], workdir)


@contextlib.contextmanager
def shard_bn_sums(shards: int):
    """One process's reference for sync-BN over ``shards`` ranks: while the
    block runs, K5's plain sums are taken over each of ``shards`` equal
    slices of the batch and added in rank order — the sums the all-reduce
    adds. BatchNorm's one-pass variance (``E[x²] − E[x]²``) cancels where a
    channel's mean is large against its spread, so the order of these sums
    moves a gradient: on YOLOv3-tiny at 96 px, B = 8, by up to 1.4e-2 of a
    leaf's largest entry, in the JAX package too (its own step on one device
    against its 8-device mesh: 5e-3 to 9e-2). Summed per shard, the
    single process is the data-parallel step's math within 1e-5 of a leaf's
    largest gradient entry."""
    from yolov3_tpu_torch.ops.cuda import bn_stats

    whole = bn_stats.bn_sums_plain

    def per_shard(x):
        sums = [whole(part) for part in x.chunk(shards)]
        return tuple(functools.reduce(torch.add, column) for column in zip(*sums))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bn_stats, "bn_sums_plain", per_shard)
        yield


@contextlib.contextmanager
def one_process_group(tmp_path):
    """A gloo process group of this process alone, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the workers' scenarios
# ---------------------------------------------------------------------------


def dp_step(rank, world, workdir):
    """The data-parallel train step on this rank's shard of the case that
    tests/test_torch_parallel.py wrote to ``case.pt``: the DP gradient
    (sync-BN, then the coalesced mean), whole steps with each option of
    ``case["steps"]``, the eval step, and K5's synced plain version with its
    backward. Writes ``rank<r>.pt``: every rank its states' digests and its
    small results, rank 0 also the gradient and each step's params and BN
    state that the tests compare (the file stays small)."""
    from yolov3_tpu_torch.models.spec import parse_model_config
    from yolov3_tpu_torch.ops.cuda import bn_stats
    from yolov3_tpu_torch.parallel import train_step as tts
    from yolov3_tpu_torch.parallel.mesh import local_batch_slice, make_mesh
    from yolov3_tpu_torch.tree import tree_leaves, tree_unflatten

    case = torch.load(os.path.join(workdir, "case.pt"))
    spec = parse_model_config(case["model"], case["nclasses"])
    batch, anchors, grids = case["batch"], case["anchors"], case["grids"]
    mesh = make_mesh(devices=("cpu",))
    rows = mesh.local_slice(batch)
    assert rows == local_batch_slice(batch) and mesh.size == world
    images, labels = case["images"][rows], case["labels"][rows]
    out = {"rank": rank}
    grads, bn, metrics = tts.loss_and_grads(spec, case["params"], case["state"], images, labels,
                                            anchors, grids, batch // world, bn_group=mesh.group)
    grads = tree_unflatten(grads, mesh.all_reduce_mean(tree_leaves(grads)))
    out["grads_digest"] = digest(grads)
    if rank == 0:
        out.update(grads=grads, bn=bn)
    out["metrics"] = tree_unflatten(metrics, mesh.all_reduce_mean(tree_leaves(metrics)))
    out["sync_launches"] = (bn_stats.bn_sums.sync_launches, bn_stats.bn_moments_dx.sync_launches)
    for name, options in case["steps"].items():
        options = dict(options)
        optimizer = tts.make_adam(options.pop("lr"), optimizer=options.pop("optimizer", None))
        step_images = options.pop("images", case["images"])
        step = tts.make_train_step(spec, anchors, grids, batch, optimizer, mesh=mesh, **options)
        state = tts.init_train_state(case["params"], case["state"], optimizer,
                                     ema="ema_decay" in options)
        state, m = step(state, step_images[rows], case["labels"][rows])
        out[name] = {"digest": digest(state), "keys": sorted(state), "metrics": m}
        if rank == 0:
            out[name].update(params=state["params"], bn_state=state["bn_state"])
    eval_step = tts.make_eval_step(spec, anchors, grids, batch, mesh=mesh)
    out["eval"] = eval_step(case["params"], case["state"], images, labels)
    x = case["bn_x"][rows].clone().requires_grad_(True)
    mean, var = bn_stats.bn_moments(x, group=mesh.group)
    # this rank's share of the objective, as the DP step's loss is
    ((mean @ case["bn_w"][0] + var @ case["bn_w"][1]) / world).backward()
    out["bn_moments"] = {"mean": mean.detach(), "var": var.detach(), "dx": x.grad}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def digest(tree) -> str:
    """sha256 of every leaf of a tree of tensors, in sorted-key order."""
    import hashlib

    from yolov3_tpu_torch.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def dsp_step(rank, world, workdir):
    """One train step of a (data ``world`` × spatial 2) mesh: this rank's
    shard of the case that tests/test_torch_spatial.py wrote to
    ``dsp_case.pt``, its images' rows in two bands on this process's CPU.
    Writes ``rank<r>.pt``: the state's digest, the metrics and, on rank 0,
    the new params and BN state."""
    from yolov3_tpu_torch.models.spec import parse_model_config
    from yolov3_tpu_torch.parallel import train_step as tts
    from yolov3_tpu_torch.parallel.mesh import make_mesh

    case = torch.load(os.path.join(workdir, "dsp_case.pt"))
    spec = parse_model_config(case["model"], case["nclasses"])
    mesh = make_mesh(devices=("cpu", "cpu"), spatial=2)
    assert mesh.shape == {"data": world, "spatial": 2} and mesh.world_size == world
    rows = mesh.local_slice(case["batch"])
    optimizer = tts.make_adam(1e-3)
    step = tts.make_train_step(spec, case["anchors"], case["grids"], case["batch"], optimizer,
                               mesh=mesh)
    state, metrics = step(tts.init_train_state(case["params"], case["state"], optimizer),
                          case["images"][rows], case["labels"][rows])
    out = {"digest": digest(state), "metrics": metrics}
    if rank == 0:
        out.update(params=state["params"], bn_state=state["bn_state"])
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


SCENARIOS = {"dp_step": dp_step, "dsp_step": dsp_step}


def _worker(scenario, rank, world, port, workdir):
    from yolov3_tpu_torch.parallel.mesh import initialize_multihost

    torch.set_num_threads(2)
    initialize_multihost(f"127.0.0.1:{port}", int(world), int(rank), backend="gloo")
    try:
        SCENARIOS[scenario](int(rank), int(world), workdir)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def _train_config(out_path, **overrides):
    import yaml

    from .conftest import absolutize_run_config

    with open(os.path.join(REPO, "config/train_config.yaml")) as f:
        cfg = absolutize_run_config(yaml.safe_load(f))
    cfg.update(image_size=96, batch_size=8, epochs=1, learning_rate=1e-3, training_mode="fit",
               resume=True, max_dataset_examples=16, output_checkpoints_path=str(out_path))
    cfg.update(overrides)
    return cfg


def _epoch_losses(text):
    """{(metric, epoch): value} of the trainer's per-epoch loss lines."""
    return {(m.group(2), int(m.group(1))): float(m.group(3))
            for m in re.finditer(r"epoch (\d+): (train_loss|val_loss) ([\d.eE+-]+)", text)}


def test_train_cli_multihost(tmp_path):
    """``cli train`` in two processes joined by the ``multihost`` dict, then
    resumed, against one process training the same global batches."""
    import yaml

    from yolov3_tpu_torch.data.native_build import ensure_native_library

    from .test_torch_data import NATIVE_DIR, native_decode_tier

    ensure_native_library(NATIVE_DIR)  # every process decodes on the same tier

    def run_both(epochs):
        port, argvs = free_port(), []
        for rank in range(2):
            cfg = _train_config(
                tmp_path / f"mh{rank}.tf", epochs=epochs,
                multihost={"coordinator_address": f"127.0.0.1:{port}", "num_processes": 2,
                           "process_id": rank, "backend": "gloo"})
            path = tmp_path / f"cfg{rank}.yaml"
            path.write_text(yaml.safe_dump(cfg))
            argvs.append([sys.executable, "-m", "yolov3_tpu_torch.apps.cli", "train",
                          "--config", str(path), "--device", "cpu"])
        return run_ranks(argvs, tmp_path)

    outs = run_both(epochs=1)
    for rank, out in enumerate(outs):
        assert f"multihost: rank {rank} of 2 (gloo)" in out
        assert f"data-parallel over 2 processes: rank {rank} on cpu, 4 of each batch of 8" in out
    # rank 0 wrote the checkpoint, the train state and the summary; rank 1 nothing
    assert (tmp_path / "mh0.tf.npz").exists() and (tmp_path / "mh0.tf.train_state.npz").exists()
    assert (tmp_path / "model_summary.txt").exists()
    assert not [f for f in os.listdir(tmp_path) if f.startswith("mh1")]
    (tmp_path / "epoch1").mkdir()
    for suffix in (".npz", ".train_state.npz"):  # rank 0's files as of epoch 1
        shutil.copy(tmp_path / f"mh0.tf{suffix}", tmp_path / "epoch1" / f"one.tf{suffix}")
    # resume: only rank 0 has a state file; both ranks start at epoch 2
    outs2 = run_both(epochs=2)
    for out in outs2:
        assert "resumed full train state" in out and "at epoch 2" in out
    assert not [f for f in os.listdir(tmp_path) if f.startswith("mh1")]
    losses = [{**_epoch_losses(a), **_epoch_losses(b)} for a, b in zip(outs, outs2)]
    assert losses[0] == losses[1] and len(losses[0]) == 4

    # one process over the same global batches: epoch 1 from the same init,
    # epoch 2 resumed from rank 0's checkpoint of epoch 1
    from yolov3_tpu_torch.apps.train_app import Train

    def single(epochs):
        lines = []

        class Handler(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        handler = Handler(level=logging.INFO)
        logging.getLogger().addHandler(handler)
        try:
            with native_decode_tier(), shard_bn_sums(2):
                Train()(**_train_config(tmp_path / "one" / "one.tf", epochs=epochs,
                                        device="cpu"))
        finally:
            logging.getLogger().removeHandler(handler)
        return _epoch_losses("\n".join(lines))

    want = single(1)
    for suffix in (".npz", ".train_state.npz"):
        shutil.copy(tmp_path / "epoch1" / f"one.tf{suffix}", tmp_path / "one" / f"one.tf{suffix}")
    want.update(single(2))
    assert set(want) == set(losses[0])
    for key, value in want.items():
        assert losses[0][key] == pytest.approx(value, rel=1e-3), key


def test_local_batch_slice_and_mesh_checks(tmp_path):
    """``local_batch_slice`` and ``make_mesh`` / ``make_data_parallel_mesh``
    with the JAX module's checks and messages; a lone device holds every band
    of a spatial axis."""
    from yolov3_tpu_torch.parallel import mesh as tmesh

    assert tmesh.local_batch_slice(8) == slice(0, 8)  # no group: this process is all of it
    with one_process_group(tmp_path):
        assert tmesh.local_batch_slice(8) == slice(0, 8)
        m = tmesh.make_mesh(devices=("cpu",))
        assert (m.world_size, m.rank, m.size, m.shape) == (1, 0, 1, {"data": 1})
        assert m.group is dist.group.WORLD
    m = tmesh.Mesh((torch.device("cpu"),) * 2, rank=1, world_size=4)
    assert m.local_slice(16) == slice(4, 8) and m.size == 8
    assert tmesh.make_data_parallel_mesh(8, devices=("cpu",)) is None
    lone = tmesh.make_data_parallel_mesh(8, spatial=2, devices=("cpu",))  # both bands on it
    assert lone.shape == {"data": 1, "spatial": 2}
    assert lone.replicas == ((torch.device("cpu"),) * 2,)
    with pytest.raises(ValueError, match=r"batch_size \(6\) divisible by the data-axis size "
                                         r"\(4 = 4 devices / spatial 1\)"):
        tmesh.make_data_parallel_mesh(6, devices=("cpu",) * 4)
    with pytest.raises(ValueError, match=r"spatial_partitioning \(3\) must divide the device "
                                         r"count \(4\)"):
        tmesh.make_data_parallel_mesh(8, spatial=3, devices=("cpu",) * 4)
    cpu = torch.device("cpu")
    sp = tmesh.make_data_parallel_mesh(8, spatial=2, devices=("cpu",) * 4)
    assert (sp.shape, sp.axis_names, sp.size) == ({"data": 2, "spatial": 2},
                                                  ("data", "spatial"), 4)
    assert sp.replicas == ((cpu, cpu), (cpu, cpu)) and sp.group is None
    bands = tmesh.make_mesh(devices=("cpu",) * 2, spatial=2)
    assert (bands.shape, bands.replicas) == ({"data": 1, "spatial": 2}, ((cpu, cpu),))
    with pytest.raises(ValueError, match=r"mesh axes \{'data': 3\} need 3 devices, got 2"):
        tmesh.make_mesh(devices=("cpu",) * 2, axes={"data": 3})
    two = tmesh.make_data_parallel_mesh(4, devices=("cpu", "cpu"))
    assert two.group is None and two.size == 2
    x = torch.arange(8.0).view(4, 2)
    parts = tmesh.batch_sharding(two)(x)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:].tolist()]
    assert torch.equal(two.gather_batch(parts), x)
    assert tmesh.image_sharding(two) == two.shard_batch
    assert [torch.equal(c, x) for c in tmesh.replicated_sharding(two)(x)] == [True, True]
    with pytest.raises(ValueError, match=r"batch_size \(3\) divisible by the data-axis size"):
        two.shard_batch(x[:3])


if __name__ == "__main__":
    _worker(*sys.argv[1:])
