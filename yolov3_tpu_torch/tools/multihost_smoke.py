"""Multi-process data-parallel smoke: one global train step across processes.

Counterpart of the JAX package's ``tools/multihost_smoke.py``, with its
flags (``--platform cpu`` is ``--device cpu`` here, and ``--backend`` picks
the ``torch.distributed`` backend). Each process joins the group
(``parallel/mesh.py::initialize_multihost``), builds the mesh over every
process's device (``make_mesh()``: this process's card; ``--device cpu``
passes the CPU), feeds its ``local_batch_slice`` of the global batch and
runs the port's data-parallel train step: the gradients are averaged by one
all-reduce and training-mode BatchNorm takes the global batch's statistics
(sync-BN through K5's ``bn_moments(group=)`` on the card).

Two processes on one host (a free port P), on the card or with
``--device cpu``:

    python -m yolov3_tpu_torch.tools.multihost_smoke --coordinator 127.0.0.1:P \\
        --num_processes 2 --process_id 0 [--device cpu] &
    python -m yolov3_tpu_torch.tools.multihost_smoke --coordinator 127.0.0.1:P \\
        --num_processes 2 --process_id 1 [--device cpu]

Under ``torchrun`` leave the three out (``env://``). Two processes sharing
one card need ``--backend gloo`` (NCCL takes one card a rank). Each process
prints ``MULTIHOST_OK procs=<n> devices=<d> loss=<float>``: the loss of the
global batch, the same on every process and equal to one process's over the
same global batch (``global_batch_loss``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from . import _measure as M

TINY = "config/models/yolov3_tiny/model.yaml"
ANCHORS = np.array([[0.1, 0.1], [0.2, 0.2], [0.3, 0.3],
                    [0.4, 0.4], [0.5, 0.5], [0.6, 0.6]], np.float32).reshape(2, 3, 2)


def global_batch(batch: int, image_size: int):
    """The global batch every process draws the same: ``RandomState(0)``
    images and one box an image."""
    rng = np.random.RandomState(0)
    images = rng.rand(batch, image_size, image_size, 3).astype(np.float32)
    labels = np.zeros((batch, 5, 6), np.float32)
    labels[:, 0] = [0.2, 0.2, 0.5, 0.5, 1, 1]
    return images, labels


def dp_step_loss(batch: int, image_size: int, device, mesh=None) -> float:
    """One train step of the 3-class tiny (Keras-default weights of
    ``torch.Generator().manual_seed(0)``, the same on every process, Adam
    1e-3, float32) over this process's slice of the global batch under
    ``mesh`` (None: one process over the whole batch) → the global loss."""
    from ..models import init_model, parse_model_config
    from ..models.network import head_grid_sizes, to_device
    from ..parallel.mesh import local_batch_slice
    from ..parallel.train_step import init_train_state, make_adam, make_train_step

    spec = parse_model_config(M.repo_path(TINY), 3)
    params, state = init_model(spec, torch.Generator().manual_seed(0))
    opt = make_adam(1e-3)
    step = make_train_step(spec, ANCHORS, head_grid_sizes(spec, image_size), batch_size=batch,
                           optimizer=opt, mesh=mesh)
    ts = init_train_state(to_device(params, device), to_device(state, device), opt)
    images, labels = global_batch(batch, image_size)
    rows = local_batch_slice(batch) if mesh is not None else slice(None)
    _, metrics = step(ts, torch.from_numpy(images[rows]).to(device),
                      torch.from_numpy(labels[rows]).to(device))
    loss = float(metrics["total_loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return loss


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.multihost_smoke",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (omit under torchrun: env://)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: nccl on the card, gloo on the CPU)")
    ap.add_argument("--image_size", type=int, default=96)
    ap.add_argument("--per_device_batch", type=int, default=1)
    args = ap.parse_args(argv)
    from ..parallel.mesh import initialize_multihost, make_mesh

    dev = resolve_device(args.device)
    backend = args.backend or ("gloo" if dev.type == "cpu" else None)
    initialize_multihost(args.coordinator, args.num_processes, args.process_id, backend=backend)
    mesh = make_mesh(devices=("cpu",)) if dev.type == "cpu" else make_mesh()
    dev = mesh.devices[0]
    batch = args.per_device_batch * mesh.size
    loss = dp_step_loss(batch, args.image_size, dev, mesh)
    print(f"MULTIHOST_OK procs={mesh.world_size} devices={mesh.size} loss={loss:.6f}",
          flush=True)
    return dict(procs=mesh.world_size, devices=mesh.size, loss=loss,
                device=M.device_record(dev))


if __name__ == "__main__":
    main()
