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

The ``spatial`` axis splits each image's rows into bands, one per device of
a spatial group of ``spatial`` devices *inside one process*, as the JAX
package's GSPMD program splits them over the local devices (single-host
only): ``parallel/spatial.py`` runs every layer band by band with the halo
rows taken from the neighbouring bands. A (data × spatial) mesh is then
``world_size`` processes × (devices of this process / ``spatial``) data
replicas, each over ``spatial`` band devices. The bands of a group may share
a device (``("cpu",) * S``, or one card): the layout and the math are the
same, the bands queue on one stream.

``Mesh.size`` counts every device of every process; ``Mesh.shape`` is
``{"data": size / spatial, "spatial": spatial}`` as in the JAX ``Mesh``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import socket

import torch
import torch.distributed as dist

from ..device import local_rank, resolve_device

log = logging.getLogger(__name__)

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


SINGLE_HOST = "spatial_partitioning is single-host (ICI) only"


def check_single_host(group=None):
    """Raise the JAX package's single-host message when the process group
    (default: the initialized one) spans more than one host: the spatial
    axis lives inside one process, its data axis on one host. One
    ``all_gather_object`` of the host names."""
    if group is None:
        group, _, world = _process_group()
    else:
        world = dist.get_world_size(group)
    if group is None or world == 1:
        return
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname(), group=group)
    if len(set(names)) > 1:
        raise ValueError(SINGLE_HOST)


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


def spatial_devices(devices, spatial: int) -> tuple:
    """The devices of this process's part of a mesh with ``spatial`` bands
    to a data replica: ``devices``, whose count ``spatial`` must divide (the
    JAX package's check and message), or a lone device once per band. The
    JAX package needs a device per band; here the bands of a group may share
    one, where they queue on its stream: the split's layout and math, slower
    than the unsharded forward, which a warning says."""
    devices = tuple(torch.device(d) for d in devices)
    spatial = int(spatial)
    if spatial > 1 and len(devices) == 1:
        devices = devices * spatial
    if spatial < 1 or len(devices) % spatial:
        raise ValueError(f"spatial_partitioning ({spatial}) must divide the device "
                         f"count ({len(devices)})")
    if spatial > 1 and len(set(devices)) < len(devices):
        log.warning(f"spatial_partitioning ({spatial}): bands share a device "
                    f"({sorted({str(d) for d in devices})}) and queue on it, slower than the "
                    "unsharded forward")
    return devices


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data × spatial) mesh. ``devices`` are this process's, data-major:
    ``spatial`` band devices for each of its data replicas (one replica per
    process when training, one per device or spatial group when serving);
    ``group`` the process group (None: this process alone), ``rank`` and
    ``world_size`` this process's place in it."""

    devices: tuple
    group: object = None
    rank: int = 0
    world_size: int = 1
    spatial: int = 1

    @property
    def size(self) -> int:
        """Every device of every process."""
        return self.world_size * len(self.devices)

    @property
    def replicas(self) -> tuple:
        """This process's devices shaped (data, spatial): one tuple of band
        devices per data replica."""
        s = self.spatial
        return tuple(self.devices[i:i + s] for i in range(0, len(self.devices), s))

    @property
    def axis_names(self):
        return (DATA_AXIS, SPATIAL_AXIS) if self.spatial > 1 else (DATA_AXIS,)

    @property
    def shape(self) -> dict:
        shape = {DATA_AXIS: self.size // self.spatial}
        if self.spatial > 1:
            shape[SPATIAL_AXIS] = self.spatial
        return shape

    def local_slice(self, global_batch: int):
        """This process's rows of a global batch."""
        per = global_batch // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_batch(self, x):
        """Split this process's batch ``x`` evenly over its data replicas →
        one shard per replica, on the replica's first device, in batch order
        (a batch that does not divide raises, with the JAX package's
        message)."""
        n = len(self.replicas)
        if x.shape[0] % n:
            raise ValueError(f"data-sharded serving needs batch_size ({x.shape[0]}) divisible "
                             f"by the data-axis size ({n} devices)")
        return tuple(part.to(bands[0], non_blocking=True)
                     for part, bands in zip(x.split(x.shape[0] // n), self.replicas))

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
    process's card (``device.resolve_device``) on every rank of the group;
    else every card of this process. With no card the default raises: a CPU
    caller passes ``devices=("cpu",)``.

    ``spatial`` > 1 (or a ``spatial`` entry in ``axes``) builds the (data ×
    spatial) mesh over this process's ``spatial_devices``: the spatial
    groups lie inside the process (a lone device holds every band). A
    process group that spans hosts raises the JAX package's single-host
    message."""
    group, rank, world = _process_group()
    if axes is not None:
        spatial = int(axes.get(SPATIAL_AXIS, 1))
    spatial = int(spatial)
    if devices is None:
        card = resolve_device(None)  # raises without a card
        devices = (card,) if group is not None else local_devices("cuda")
    devices = spatial_devices(devices, spatial)
    count = world * len(devices)
    if axes is None:
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
    if spatial > 1:
        check_single_host(group)
    return Mesh(devices, group, rank, world, spatial)


def make_data_parallel_mesh(batch_size: int, spatial: int = 1, devices=None) -> Mesh | None:
    """Mesh over this process's devices (default: every visible card) for
    sharded serving/evaluation, or None on a single device; in-process, so
    it has no process group. The batch must divide evenly over the data
    axis, ``device count // spatial``: e.g. 8 cards, ``spatial: 8``, batch 1
    is the single-image latency configuration. The JAX function's checks and
    messages over ``spatial_devices`` (a lone device holds every band)."""
    devices = spatial_devices(local_devices() if devices is None else devices, spatial)
    count = len(devices)
    if count <= 1:
        return None
    data_size = count // int(spatial)
    if batch_size % data_size:
        raise ValueError(
            f"data-sharded serving needs batch_size ({batch_size}) divisible "
            f"by the data-axis size ({data_size} = {count} "
            f"devices / spatial {spatial})")
    return Mesh(devices, spatial=int(spatial))


def batch_sharding(mesh: Mesh):
    """Shard the leading (batch) dim over the data axis: ``mesh.shard_batch``."""
    return mesh.shard_batch


def image_sharding(mesh: Mesh, stride: int = 32):
    """Sharding for an NHWC image batch: over the data axis, as the batch,
    and, when the mesh has a spatial axis, image rows over its bands →
    one ``spatial.Bands`` per data replica. ``stride``: the model's total
    stride, the unit of the band layout (``spatial.band_starts``)."""
    if mesh.spatial == 1:
        return mesh.shard_batch
    from . import spatial as sp

    def shard(x):
        return tuple(sp.split_rows(part, bands, stride)
                     for part, bands in zip(mesh.shard_batch(x), mesh.replicas))

    return shard


def replicated_sharding(mesh: Mesh):
    """A copy on every device: ``mesh.replicate``."""
    return mesh.replicate
