"""K5 — training-mode BatchNorm statistics: CUDA kernels + plain PyTorch version.

Replaces the Pallas TPU kernel ``yolov3_tpu/ops/pallas/bn_stats.py``
(``bn_sums``, and ``bn_moments`` with its custom VJP):

    sum[c], sumsq[c] = Σ f32(x), Σ f32(x)²     over every non-channel position
    mean = sum / n;   var = max(sumsq / n − mean², 0)         (biased variance)
    backward:  dx = dmean/n + dvar·(2/n)·(x − mean), in x's dtype

``x`` is the port's fp activation: logically (B, C, H, W), f32 or bf16, and
in memory either channels-last or contiguous NCHW (a cuDNN convolution may
hand back either). The kernels read it where it lies, with one code path for
each layout; any other stride pattern raises, and nothing copies or converts
the activation before a launch.

On a CUDA tensor the forward is one launch (``bn_moments_*_kernel``): every
block writes its partial sums to a workspace and takes a ticket, and the block
that draws the last ticket folds them and writes sum, sumsq, mean and var
into the one (4, C) tensor the call allocates. The workspace (ticket counters
and partial rows) is kept per (device, stream) and grows when a shape needs
more; the kernel leaves the counters at 0, so nothing is cleared or allocated
per call. ``_plan`` sizes grid and block from the shape alone. mean and var
are bit-equal to the plain expression evaluated on the card, where PyTorch
divides a tensor by a Python scalar by multiplying with the scalar's f32
reciprocal: the kernel is given ``1.0f / f32(n)`` and does the same.

The backward follows the TPU kernel's custom VJP: it does not look at the
``max(·, 0)``, so a channel whose variance clamps still passes ``dvar``
through (differentiating the clamp would pass zero there). One launch
(``bn_dx_kernel``) evaluates it as ``a·x + b`` with per-channel
``a = dvar·(2/n)`` and ``b = dmean·(1/n) − a·mean`` computed in the thread
that uses them, every product and sum rounded once, which is exactly what the
plain version's element-wise ops do: in f32 and in bf16 the two are bit-equal
on one device.

The forward's sums are taken in another order than the plain version's, so
those are held to a tolerance: ``SUM_RTOL`` of Σ|x| and of Σx² against a
float64 reference. Two launches on one input give the same bits (no atomics
on floats; every order is fixed by the shape).

Sync-BN (``group``, a ``torch.distributed`` process group): the statistics of
the *global* batch, as the JAX package's SPMD step reduces them. Every rank
computes its local sums (one launch), the stacked (2, C) f32 sums are
all-reduced over the group, and mean and var follow from them by the same
finishing expression over the global count n = n_local · world size (every
rank holds an equal shard of the batch, as the data-parallel step slices
it). The backward all-reduces the stacked (dmean, dvar) before the dx
launch, whose scalars come from that global n. One all-reduce each way a
call, counted in ``bn_sums.sync_launches`` and
``bn_moments_dx.sync_launches``. The count stays a Python number, so the
division is the expression the unsynced path evaluates on each device: with
a group of one process the result is the unsynced one, bit for bit.

Over bands (``bn_moments_bands``: the spatial split of image rows,
``parallel/spatial.py``): every band launches K5 once on its own rows and
device, the (2, C) sums are added in band order on the first band's device
(then all-reduced over the process group, when there is one), and mean and
var follow over the summed true count of the bands' rows, uneven as they
are. The backward launches K5's dx once a band with that count. An empty
band is not passed in, so it launches nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from . import build

# |kernel − float64| ≤ SUM_RTOL · Σ|x| for the sum (a sum near zero has no
# relative error of its own), ≤ SUM_RTOL · Σx² for the sum of squares
SUM_RTOL = 1e-5
_MAX_BLOCKS = 2048  # NCHW: about two waves of 8 blocks on each of 132 SMs
_MAX_BLOCKS_CL = 1024  # channels-last: one wave, so the last block folds half as many rows
_PER_THREAD = 64    # elements a thread should have to read before blocks are added
_WORKSPACE_HEAD = 256  # 32-bit ticket counters before the partial rows (the kernel's kCounters)

_workspaces: dict = {}  # (device index, stream handle) -> f32 workspace tensor


def _check_activation(what: str, x):
    """(channels_last, b, c, hw) of a dense 4-D f32/bf16 CUDA activation, or raise."""
    if x.dim() != 4:
        raise ValueError(f"{what}: needs a (B, C, H, W) activation, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: needs float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0 or x.numel() >= 2 ** 31:
        raise ValueError(f"{what}: needs 1 ≤ elements < 2^31, got {x.numel()}")
    b, c, h, w = x.shape
    if x.is_contiguous(memory_format=torch.channels_last):
        if c > 32 * _WORKSPACE_HEAD:
            raise ValueError(f"{what}: channels-last memory takes at most "
                             f"{32 * _WORKSPACE_HEAD} channels, got {c}")
        return True, b, c, h * w
    if x.is_contiguous():
        return False, b, c, h * w
    raise ValueError(f"{what}: the activation must be dense channels-last or NCHW in "
                     f"memory, got shape {tuple(x.shape)} strides {x.stride()}")


@functools.lru_cache(maxsize=None)
def _plan(channels_last: bool, b: int, c: int, hw: int):
    """(p, per_block, threads, lanes, inv_n): ``p`` blocks along the reduced axis,
    each taking ``per_block`` rows (channels-last memory; a block is 32
    channels × 8 rows of threads, ``threads`` = 256, ``lanes`` = 32) or
    ``per_block`` elements of a plane in every image (NCHW; a block has
    ``threads`` threads in groups of ``lanes``, one group an image at a time;
    slices start on multiples of 8 elements so that 16-byte loads stay legal).
    ``inv_n`` is ``1.0f / f32(B·H·W)``, the reciprocal the kernel multiplies
    by. A pure function of the shape, so the order of every sum is.

    Sized from the bytes: a thread gets about ``_PER_THREAD`` elements before
    blocks are added along the reduced axis, up to ``_MAX_BLOCKS`` in all, so
    C=1024 at 13² or C=512 at 26² is one short block a channel (p = 1, no
    fold) and C=32 at 416² is 64 blocks a channel."""
    n = b * hw
    inv_n = float(np.float32(1.0) / np.float32(n))
    if channels_last:
        want = max(1, min(-(-n // (8 * _PER_THREAD // 4)),
                          _MAX_BLOCKS_CL // ((c + 31) // 32)))
        per_block = -(-(-(-n // want)) // 8) * 8
        return -(-n // per_block), per_block, 256, 32, inv_n
    threads = 128 if n <= 8192 else 256
    want = max(1, min(-(-n // (threads * _PER_THREAD)), _MAX_BLOCKS // c))
    per_block = hw if want == 1 else -(-max(32, -(-hw // want)) // 8) * 8
    lanes = 256 if threads == 256 and per_block >= 2048 else 32
    return -(-hw // per_block), per_block, threads, lanes, inv_n


def _workspace(device, stream: int, words: int):
    """The f32 workspace of one (device, stream), at least ``words`` long: the
    zeroed ticket counters, then room for the partial rows. Two streams never
    share one; it is replaced by a larger one when a shape needs more."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < words:
        ws = torch.zeros(max(words, 1 << 16), dtype=torch.float32, device=device)
        _workspaces[key] = ws
    return ws


def _launch_moments(x, out, channels_last, b, c, hw, p, per_block, threads, lanes, inv_n,
                    stream):
    ws = _workspace(x.device, stream, _WORKSPACE_HEAD + p * 2 * c)
    return build.function("bn_stats", "bn_moments_launch")(
        x.data_ptr(), ws.data_ptr(), out.data_ptr(), x.dtype == torch.bfloat16, channels_last,
        b, c, hw, p, per_block, threads, lanes, inv_n, stream)


def _moments_cuda(what: str, x):
    """One launch → the (4, C) f32 tensor (sum, sumsq, mean, var) of a CUDA
    activation, or raise."""
    channels_last, b, c, hw = _check_activation(what, x)
    out = torch.empty((4, c), dtype=torch.float32, device=x.device)
    build.launch(_launch_moments, x.device, what, x, out, channels_last, b, c, hw,
                 *_plan(channels_last, b, c, hw))
    bn_sums.launches += 1
    return out


def bn_sums_plain(x):
    """Plain PyTorch version: per-channel (Σx, Σx²) over axes (0, 2, 3) of a
    (B, C, H, W) activation, in f32."""
    x32 = x.float()
    return x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3))


def bn_sums(x):
    """x (B, C, H, W) f32 or bf16 → (sum, sumsq), two (C,) f32 tensors. CPU
    tensors take the plain version; CUDA tensors launch ``bn_moments_*_kernel``
    once (counted in ``bn_sums.launches``) or raise."""
    if x.device.type == "cpu":
        return bn_sums_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"bn_sums: unsupported device {x.device}")
    total, total_sq, _, _ = _moments_cuda("bn_sums", x).unbind(0)
    return total, total_sq


bn_sums.launches = 0
bn_sums.sync_launches = 0  # forward all-reduces of sync-BN (any device)


def _scalars(n: int):
    """(1/n, 2/n) as the f32 values both versions multiply by."""
    return float(np.float32(1.0 / n)), float(np.float32(2.0 / n))


def bn_moments_dx_plain(x, mean, dmean, dvar, n=None):
    """Plain PyTorch version of the backward: ``a·x + b`` per channel, each
    op rounded once in f32, then cast to x's dtype. ``n``: the count the
    statistics were taken over (sync-BN's global one; default x's own)."""
    inv_n, two_inv_n = _scalars(x.numel() // x.shape[1] if n is None else n)
    a = dvar * two_inv_n
    b = dmean * inv_n - a * mean
    shape = (1, -1, 1, 1)
    return (a.view(shape) * x.float() + b.view(shape)).to(x.dtype)


def bn_moments_dx(x, mean, dmean, dvar, n=None):
    """Gradient of (mean, var) w.r.t. x: x (B, C, H, W); mean, dmean, dvar
    (C,) f32 → dx like x (same dtype and memory format). ``n``: the count the
    statistics were taken over (sync-BN's global one; default B·H·W of x).
    CPU tensors take the plain version; CUDA tensors launch ``bn_dx_kernel``
    (counted in ``bn_moments_dx.launches``) or raise."""
    if x.device.type == "cpu":
        return bn_moments_dx_plain(x, mean, dmean, dvar, n)
    if x.device.type != "cuda":
        raise ValueError(f"bn_moments_dx: unsupported device {x.device}")
    channels_last, b, c, hw = _check_activation("bn_moments_dx", x)
    vectors = []
    for name, t in (("mean", mean), ("dmean", dmean), ("dvar", dvar)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) or t.device != x.device:
            raise ValueError(f"bn_moments_dx: {name} must be an f32 ({c},) tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        vectors.append(t.contiguous())  # (C,) vectors; the activation is never copied
    dx = torch.empty_like(x)  # keeps x's memory format
    if dx.stride() != x.stride():
        raise ValueError("bn_moments_dx: could not allocate dx in x's memory format")
    per_vector = 16 // x.element_size()
    vec = (x.data_ptr() % 16 == 0 and dx.data_ptr() % 16 == 0
           and (c if channels_last else hw) % per_vector == 0)
    inv_n, two_inv_n = _scalars(b * hw if n is None else n)
    build.launch(build.function("bn_stats", "bn_moments_dx_launch"), x.device, "bn_moments_dx",
                 x.data_ptr(), vectors[1].data_ptr(), vectors[2].data_ptr(),
                 vectors[0].data_ptr(), dx.data_ptr(), x.dtype == torch.bfloat16, channels_last,
                 vec, b, c, hw, inv_n, two_inv_n)
    bn_moments_dx.launches += 1
    return dx


bn_moments_dx.launches = 0
bn_moments_dx.sync_launches = 0  # backward all-reduces of sync-BN (any device)


class _BnMoments(torch.autograd.Function):
    """(mean, biased var) over axes (0, 2, 3) with the analytic backward of
    the TPU kernel's custom VJP. ``plain`` forces the plain versions;
    ``group`` syncs the statistics over a process group (see the module's
    docstring)."""

    @staticmethod
    def forward(ctx, x, plain: bool, group):
        n = x.numel() // x.shape[1]
        on_cpu = plain or x.device.type == "cpu"
        if group is not None:
            sums = torch.stack(bn_sums_plain(x) if on_cpu else bn_sums(x))
            dist.all_reduce(sums, group=group)
            bn_sums.sync_launches += 1
            n *= dist.get_world_size(group)
            mean = sums[0] / n
            var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
        elif on_cpu:
            s, s2 = bn_sums_plain(x)
            mean = s / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
        elif x.device.type == "cuda":
            _, _, mean, var = _moments_cuda("bn_moments", x).unbind(0)
        else:
            raise ValueError(f"bn_moments: unsupported device {x.device}")
        ctx.save_for_backward(x, mean)
        ctx.plain, ctx.group, ctx.n = plain, group, n
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, mean = ctx.saved_tensors
        if ctx.group is not None:
            grads = torch.stack([dmean, dvar])
            dist.all_reduce(grads, group=ctx.group)
            bn_moments_dx.sync_launches += 1
            dmean, dvar = grads.unbind(0)
        dx = (bn_moments_dx_plain if ctx.plain else bn_moments_dx)(x, mean, dmean, dvar, ctx.n)
        return dx, None, None


def bn_moments(x, group=None):
    """x (B, C, H, W) → (mean, var), two (C,) f32 tensors, differentiable in
    x. On a CUDA tensor the forward is one launch (counted in
    ``bn_sums.launches``) and, unsynced, no other op; the backward one launch.
    ``group``: a process group to take the global batch's statistics over
    (sync-BN), or None."""
    return _BnMoments.apply(x, False, group)


def bn_moments_plain(x, group=None):
    """The same function through the plain versions on any device."""
    return _BnMoments.apply(x, True, group)


class _BandMoments(torch.autograd.Function):
    """(mean, biased var) over the bands ``xs`` of one activation, split
    over image rows (see the module's docstring): the sums per band in band
    order, the count the bands' total. ``group``: sync-BN's process group
    (every rank holds the same band layout of an equal shard of the batch)."""

    @staticmethod
    def forward(ctx, plain: bool, group, *xs):
        dev = xs[0].device
        sums = [torch.stack(bn_sums_plain(x) if plain or x.device.type == "cpu"
                            else bn_sums(x)).to(dev) for x in xs]
        total = functools.reduce(torch.add, sums)
        n = sum(x.numel() // x.shape[1] for x in xs)
        if group is not None:
            dist.all_reduce(total, group=group)
            bn_sums.sync_launches += 1
            n *= dist.get_world_size(group)
        mean = total[0] / n
        var = torch.clamp(total[1] / n - mean * mean, min=0.0)
        ctx.save_for_backward(mean, *xs)
        ctx.plain, ctx.group, ctx.n = plain, group, n
        return mean, var

    @staticmethod
    def backward(ctx, dmean, dvar):
        mean, *xs = ctx.saved_tensors
        if ctx.group is not None:
            grads = torch.stack([dmean, dvar])
            dist.all_reduce(grads, group=ctx.group)
            bn_moments_dx.sync_launches += 1
            dmean, dvar = grads.unbind(0)
        dx = bn_moments_dx_plain if ctx.plain else bn_moments_dx
        return (None, None) + tuple(
            dx(x, *(t.to(x.device) for t in (mean, dmean, dvar)), ctx.n) for x in xs)


def bn_moments_bands(xs, group=None):
    """The bands ``xs`` (each (B, C, h_j, W), on its own device, none
    empty) of one activation → (mean, var) of the whole, two (C,) f32
    tensors on the first band's device, differentiable in every band. One
    K5 launch a band forward and one backward on CUDA tensors; ``group``:
    sync-BN's process group, or None."""
    return _BandMoments.apply(False, group, *xs)


def bn_moments_bands_plain(xs, group=None):
    """The same function through the plain versions on any device."""
    return _BandMoments.apply(True, group, *xs)
