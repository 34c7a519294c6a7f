"""The data-parallel mesh on ``torch.distributed``.

Counterpart of ``yolov3_tpu/parallel/mesh.py``, with its names. The JAX
package puts all local devices on one ``data`` axis and compiles one SPMD
program: params and optimizer state replicate, the batch shards, XLA inserts
the gradient all-reduce, and training-mode BatchNorm reduces over the
*global* batch because its reductions live inside the same jit. Here the
same math runs eagerly, in one of two shapes:

  * **training** — one process per card (``torchrun --nproc_per_node N``,
    or the ``multihost`` dict), joined by ``initialize_multihost``: each
    rank feeds its ``local_batch_slice`` of the global batch, BatchNorm's
    sums are all-reduced before the moments (``ops/cuda/bn_stats.py``,
    sync-BN), and the gradients are averaged by one coalesced all-reduce
    (``Mesh.all_reduce_mean``) before the optimizer runs, so every rank's
    state stays identical. The JAX package drives all local devices from one
    process; a different launch, the same math.
  * **serving** — one process, one replica of the predictor per device of
    ``Mesh.devices`` (``apps/inference_app.py::make_predictor``): the batch
    splits evenly over them (``shard_batch``) and the answers come back in
    batch order on the first (``gather_batch``).

``Mesh.size`` is the data axis: processes × devices per process. The
``spatial`` axis (a conv split over image rows with halo exchanges) is not
ported: asking for it raises ``NotImplementedError`` by name.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import torch
import torch.distributed as dist

from ..device import local_rank

log = logging.getLogger(__name__)

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


def check_spatial(spatial: int):
    """Raise ``NotImplementedError`` by name for ``spatial_partitioning`` > 1."""
    if spatial > 1:
        raise NotImplementedError(
            f"spatial_partitioning ({spatial}): the (data × spatial) mesh is not ported yet "
            "(a later slice of the port); only the data axis is")


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None,
                         backend=None):
    """Join the process group (``torch.distributed.init_process_group``).

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the group meets at ``tcp://host:port``; with none of them
    it reads ``torchrun``'s environment (``env://``). ``backend`` defaults to
    NCCL with a card and gloo without; gloo also moves CUDA tensors (through
    the host), which is how two processes share one card. Sets this process's
    card (``device.local_rank``). A process already in a group stays in it.
    A failure raises: there is no single-process fallback."""
    if dist.is_initialized():
        log.info(f"multihost: already rank {dist.get_rank()} of {dist.get_world_size()}")
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("multihost: coordinator_address needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    else:
        dist.init_process_group(backend, init_method="env://")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank())
    log.info(f"multihost: rank {dist.get_rank()} of {dist.get_world_size()} ({backend})")


def _process_group():
    """(group, rank, world size): the default group when one is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    return None, 0, 1


def local_batch_slice(global_batch: int):
    """This process's slice of the global batch under 1-D data sharding."""
    _, rank, world = _process_group()
    per = global_batch // world
    start = rank * per
    return slice(start, start + per)


def local_devices(device_type: str = "cuda"):
    """The devices this process can put replicas on: every visible card, or
    the one CPU."""
    if device_type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    return (torch.device(device_type),)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: ``devices`` are this process's (one per process when
    training, the replicas' when serving), ``group`` the process group (None:
    this process alone), ``rank`` and ``world_size`` this process's place in
    it."""

    devices: tuple
    group: object = None
    rank: int = 0
    world_size: int = 1

    @property
    def size(self) -> int:
        """The data axis: every device of every process."""
        return self.world_size * len(self.devices)

    @property
    def axis_names(self):
        return (DATA_AXIS,)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size}

    def local_slice(self, global_batch: int):
        """This process's rows of a global batch."""
        per = global_batch // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_batch(self, x):
        """Split this process's batch ``x`` evenly over ``devices`` → one
        shard per device, in batch order (a batch that does not divide
        raises, with the JAX package's message)."""
        n = len(self.devices)
        if x.shape[0] % n:
            raise ValueError(f"data-sharded serving needs batch_size ({x.shape[0]}) divisible "
                             f"by the data-axis size ({n} devices)")
        return tuple(part.to(dev, non_blocking=True)
                     for part, dev in zip(x.split(x.shape[0] // n), self.devices))

    def gather_batch(self, parts):
        """The shards back in batch order, on the first device."""
        return torch.cat([p.to(self.devices[0], non_blocking=True) for p in parts])

    def replicate(self, x):
        """A copy of ``x`` on each device."""
        return tuple(x.to(dev) for dev in self.devices)

    def all_reduce_mean(self, tensors):
        """The mean over the processes of each tensor of ``tensors`` (one
        dtype): one coalesced ``all_reduce`` of their flat concatenation."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world_size)
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                   tensors)]

    def all_gather_batch(self, x):
        """Every process's ``x`` concatenated in rank order: the global batch."""
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    def broadcast_state(self, tree):
        """``tree`` (nested dicts of tensors) as rank 0 holds it, on every
        rank; each leaf keeps its device (a CPU leaf crosses NCCL on the
        card). The leaves go in sorted-key order, whatever order each rank's
        dicts hold them in."""
        if isinstance(tree, dict):
            return {k: self.broadcast_state(tree[k]) for k in sorted(tree)}
        t = tree.to(self.devices[0]).clone()
        dist.broadcast(t, src=0, group=self.group)
        return t.to(tree.device)


def make_mesh(devices=None, axes: dict | None = None, spatial: int = 1) -> Mesh:
    """Build a mesh. Default: under an initialized process group, this
    process's card (or the CPU) on every rank of the group; else every local
    device of this process.

    ``spatial`` > 1 (or a ``spatial`` entry in ``axes``) asks for the (data ×
    spatial) mesh, which is not ported and raises ``NotImplementedError``
    once the JAX function's checks pass."""
    group, rank, world = _process_group()
    if devices is None:
        if group is not None:
            devices = (torch.device("cuda", local_rank()) if torch.cuda.is_available()
                       else torch.device("cpu"),)
        else:
            devices = local_devices("cuda" if torch.cuda.is_available() else "cpu")
    devices = tuple(torch.device(d) for d in devices)
    count = world * len(devices)
    if axes is None:
        spatial = int(spatial)
        if spatial < 1 or count % spatial:
            raise ValueError(
                f"spatial_partitioning ({spatial}) must divide the device "
                f"count ({count})")
        axes = {DATA_AXIS: count // spatial}
        if spatial > 1:
            axes[SPATIAL_AXIS] = spatial
    if math.prod(axes.values()) != count:
        raise ValueError(f"mesh axes {axes} need {math.prod(axes.values())} devices, "
                         f"got {count}")
    unknown = set(axes) - {DATA_AXIS, SPATIAL_AXIS}
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)}: only {DATA_AXIS!r} and "
                         f"{SPATIAL_AXIS!r} exist")
    check_spatial(int(axes.get(SPATIAL_AXIS, 1)))
    return Mesh(devices, group, rank, world)


def make_data_parallel_mesh(batch_size: int, spatial: int = 1, devices=None) -> Mesh | None:
    """Mesh over this process's devices (default: every visible card) for
    sharded serving/evaluation, or None on a single device; in-process, so
    it has no process group. The batch must divide evenly over the data
    axis; ``spatial`` > 1 raises (not ported) once the JAX function's checks
    pass."""
    devices = tuple(local_devices() if devices is None else devices)
    count = len(devices)
    if count <= 1:
        if int(spatial) > 1:
            raise ValueError("spatial_partitioning needs more than one device")
        return None
    if int(spatial) < 1 or count % int(spatial):
        raise ValueError(
            f"spatial_partitioning ({spatial}) must divide the device "
            f"count ({count})")
    data_size = count // int(spatial)
    if batch_size % data_size:
        raise ValueError(
            f"data-sharded serving needs batch_size ({batch_size}) divisible "
            f"by the data-axis size ({data_size} = {count} "
            f"devices / spatial {spatial})")
    check_spatial(int(spatial))
    return Mesh(tuple(torch.device(d) for d in devices))


def batch_sharding(mesh: Mesh):
    """Shard the leading (batch) dim over the data axis: ``mesh.shard_batch``."""
    return mesh.shard_batch


def image_sharding(mesh: Mesh):
    """Sharding for an NHWC image batch: over the data axis, as the batch
    (image height over a spatial axis is not ported)."""
    return mesh.shard_batch


def replicated_sharding(mesh: Mesh):
    """A copy on every device: ``mesh.replicate``."""
    return mesh.replicate
