"""The spatial axis: image rows in bands, with halo exchanges.

Counterpart of what GSPMD does for the JAX package's ``spatial`` mesh axis
(``yolov3_tpu/parallel/mesh.py::image_sharding``): every conv split over
image rows, with the rows its window reaches across a band edge brought
from the neighbouring band. Here the split is written out. An activation is
a ``Bands``: one part per device of a spatial group (``Mesh.replicas``), the
image rows ``[starts[j], starts[j+1])`` of band ``j`` on ``devices[j]``, or
``None`` for a band that owns no rows. The model's one interpreter
(``models/network.py::apply_model``) runs every activation as a ``Bands``
(the unsharded forward is one band) through the helpers here, and gathers
the heads on the first band's device, so decode, NMS and the loss run on
whole grids, exactly as unsharded. Sharding is a layout, never a change to
the math: every layer computes the unsharded layer's values on the band's
rows.

**Band layout: rows owned on the coarsest grid.** YOLOv3-416's coarsest
grid has 13 rows (416 / 32), which no even split of 416 over two bands
keeps consistent (208 / 208 gives 7 / 6 at 13², and the upsample then 14 / 12
at 26², which the backbone's 13 / 13 route tap cannot join). So the
``H / D`` coarse rows (``D``: the model's total stride, 32 for all three
families) are split as evenly as possible, the first bands taking the
remainder, and a band at a level of stride ``s`` owns its coarse rows ×
``D / s`` (224 / 192 input rows at 416 over two bands). Every stride-2
conv's band then starts on its stride's lattice, every route concatenates
bands that agree, and a band may be empty (96² over 8 bands: 3 coarse rows);
an empty band does no work and its neighbours take their halo rows from the
nearest band that has rows.

**Halo rows** follow from the window alone: output rows ``[o0, o1)`` of a
window of ``k`` rows at stride ``s`` with ``top`` rows of padding read input
rows ``[o0·s − top, o1·s − s − top + k)``. Rows inside the image come from
whichever bands own them (``halo_rows``); only at the image's own edges does
a layer pad, with its own padding (zeros, or −inf for a max-pool). So a 3×3
stride-1 conv takes one row above and one below, a Darknet 3×3 stride-2 conv
one above, a 1×1 conv and an upsample none, tiny's 2×2 stride-1 'same' pool
one below, the space-to-depth stem's 4×4 stride-2 conv0 one above and one
below (its second row of bottom padding is read by no output row inside the
image) and its 2×2 conv1 one above. Each halo is a slice of the neighbour's
tensor moved with ``.to(device)`` (a plain slice where the bands share a
device), so autograd gives every exchange's adjoint, carrying gradients back
to the band that owns the rows, and sums each weight's gradient over the
bands (parameters are used as ``p.to(band_device)``). ``HALO`` counts the
slices moved and their bytes.

Training-mode BatchNorm over more than one band takes each band's K5 sums
and adds them in band order (``band_moments``); the statistics' subsample
keeps the image's rows (``layers._subsampled``' ``row0``). The fused
residual stages of ``int8_chain`` run K4 per band with its halo rows marked
as a neighbour's pixels (``fused_stage_bands``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ..models import layers as L
from ..ops.cuda import resblock
from ..ops.cuda.bn_stats import bn_moments_bands

# halo exchanges since the last reset: neighbour slices moved and their bytes
HALO = {"copies": 0, "bytes": 0}


def reset_halo_counts():
    HALO.update(copies=0, bytes=0)


def coarse_rows(coarse: int, spatial: int) -> tuple:
    """The coarse rows each of ``spatial`` bands owns: as even as possible,
    the first bands taking the remainder (3 over 8: 1, 1, 1, 0, 0, 0, 0, 0)."""
    return tuple(coarse // spatial + (j < coarse % spatial) for j in range(spatial))


def band_starts(height: int, spatial: int, stride: int) -> tuple:
    """The ``spatial + 1`` row offsets of the bands of a ``height``-row
    image whose coarsest grid is ``height / stride`` rows."""
    if height % stride:
        raise ValueError(f"spatial_partitioning: the image height ({height}) must be a "
                         f"multiple of the model's total stride ({stride}), the band unit")
    starts = [0]
    for rows in coarse_rows(height // stride, spatial):
        starts.append(starts[-1] + rows * stride)
    return tuple(starts)


@functools.lru_cache(maxsize=None)
def total_stride(spec, image_size: int) -> int:
    """``D``: the input rows of one row of ``spec``'s coarsest grid."""
    from ..models.network import head_grid_sizes  # network runs its layers through here

    coarse = min(head_grid_sizes(spec, image_size))
    if image_size % coarse:
        raise ValueError(f"spatial_partitioning: image size {image_size} is not a multiple "
                         f"of the coarsest grid ({coarse})")
    return image_size // coarse


@dataclasses.dataclass(frozen=True)
class Bands:
    """One activation split over image rows: ``parts[j]`` holds the rows
    ``[starts[j], starts[j+1])`` on ``devices[j]`` (None: an empty band).
    A part is an fp tensor (B, C, h, W) or a ``layers.QAct`` (q: B, h, W, C);
    ``nhwc`` marks fp parts whose rows are axis 1 (the images, the heads)."""

    parts: tuple
    starts: tuple
    devices: tuple
    nhwc: bool = False

    @property
    def height(self) -> int:
        return self.starts[-1]

    def with_parts(self, parts, nhwc: bool = False) -> "Bands":
        """New parts on the same devices; each band's rows are its part's."""
        starts = [0]
        for part in parts:
            starts.append(starts[-1] + (0 if part is None else
                                        _rows(part, nhwc)))
        return Bands(tuple(parts), tuple(starts), self.devices, nhwc)

    def map(self, fn, nhwc: bool = False) -> "Bands":
        """``fn(j, part)`` on every non-empty band."""
        return self.with_parts([None if p is None else fn(j, p)
                                for j, p in enumerate(self.parts)], nhwc=nhwc)


def whole(part, nhwc: bool = False) -> Bands:
    """One activation as one band, the unsharded forward's: a (B, C, H, W)
    tensor, a ``layers.QAct``, or with ``nhwc`` (B, H, W, C) images."""
    device = (part.q if isinstance(part, L.QAct) else part).device
    return Bands((part,), (0, _rows(part, nhwc)), (device,), nhwc)


def split_rows(images, devices, stride: int = 32) -> Bands:
    """(B, H, W, C) images → their ``Bands`` over ``devices``, each band a
    dense copy on its device."""
    starts = band_starts(images.shape[1], len(devices), stride)
    parts = tuple(None if a == b else images[:, a:b].to(dev).contiguous()
                  for a, b, dev in zip(starts, starts[1:], devices))
    return Bands(parts, starts, tuple(devices), nhwc=True)


def gather_rows(bands: Bands):
    """The parts of an NHWC ``Bands`` joined along the rows, on the first
    band's device."""
    if len(bands.parts) == 1:
        return bands.parts[0]
    dev = bands.devices[0]
    return torch.cat([p.to(dev) for p in bands.parts if p is not None], dim=1)


def _rows_axis(part, nhwc: bool) -> int:
    return 1 if nhwc or isinstance(part, L.QAct) else 2


def _rows(part, nhwc: bool) -> int:
    return (part.q if isinstance(part, L.QAct) else part).shape[_rows_axis(part, nhwc)]


def _narrow(part, axis: int, start: int, length: int):
    if isinstance(part, L.QAct):
        return L.QAct(part.q.narrow(axis, start, length), part.scale)
    return part.narrow(axis, start, length)


def _moved(part, dev):
    """A neighbour's slice on ``dev``, counted in ``HALO``."""
    q = part.q if isinstance(part, L.QAct) else part
    HALO["copies"] += 1
    HALO["bytes"] += q.numel() * q.element_size()
    if isinstance(part, L.QAct):
        return L.QAct(q.to(dev), part.scale.to(dev))
    return q.to(dev)


def halo_rows(bands: Bands, j: int, lo: int, hi: int):
    """Rows ``[lo, hi)`` of the activation for band ``j``: those inside the
    image from the bands that own them, on band ``j``'s device, joined →
    ``(x, pad_top, pad_bottom)``, the rows of [lo, hi) outside the image."""
    a, b = max(lo, 0), min(hi, bands.height)
    dev = bands.devices[j]
    pieces = []
    for k, part in enumerate(bands.parts):
        s, e = bands.starts[k], bands.starts[k + 1]
        x0, x1 = max(a, s), min(b, e)
        if part is None or x0 >= x1:
            continue
        axis = _rows_axis(part, bands.nhwc)
        piece = part if (x0, x1) == (s, e) else _narrow(part, axis, x0 - s, x1 - x0)
        pieces.append(piece if k == j else _moved(piece, dev))
    if len(pieces) == 1:
        x = pieces[0]
    elif isinstance(pieces[0], L.QAct):
        x = L.QAct(torch.cat([p.q for p in pieces], dim=1), pieces[0].scale)
    else:
        x = torch.cat(pieces, dim=_rows_axis(pieces[0], bands.nhwc))
    return x, a - lo, hi - b


def halo_extent(k: int, s: int, top: int) -> tuple:
    """(rows above, rows below) that a band of a window of ``k`` rows at
    stride ``s`` with ``top`` rows of padding above reads beyond its own
    rows (its band starts on the stride's lattice)."""
    return top, k - s - top


def window(bands: Bands, k: int, s: int, pads: tuple, op) -> Bands:
    """A windowed layer of ``k`` rows at stride ``s`` whose own row padding
    is ``pads`` (top, bottom): ``op(device, x, (pad_top, pad_bottom))`` on
    each non-empty band's rows with their halo, padded only at the image's
    edges, there with the layer's own padding (see the module's docstring).
    One band is the unsharded layer: its rows, its padding."""
    above, below = halo_extent(k, s, pads[0])
    parts = []
    for j, part in enumerate(bands.parts):
        if part is None:
            parts.append(None)
            continue
        x, pad_top, _ = halo_rows(bands, j, bands.starts[j] - above,
                                  bands.starts[j + 1] + below)
        pad_bottom = pads[1] if bands.starts[j + 1] == bands.height else 0
        parts.append(op(bands.devices[j], x, (pad_top, pad_bottom)))
    return bands.with_parts(parts)


def band_moments(x: Bands, phases: int, stats_subsample: int, group=None):
    """Training-mode BatchNorm's (mean, var) over every band of ``x``: each
    band's statistics view (``layers.stats_view``, its subsample keeping
    the image's rows) through K5, the sums added in band order on the first
    band's device and all-reduced over ``group`` (``bn_moments_bands``)."""
    views = [L.stats_view(part, phases, stats_subsample, row0=x.starts[j])
             for j, part in enumerate(x.parts) if part is not None]
    # a band's subsample may hold no row of the image's (one row, odd start)
    return bn_moments_bands([v for v in views if v.numel()], group=group)


def fused_stage_bands(x: Bands, on, starts) -> Bands:
    """``resblock.fused_stage`` over bands: each band in halo layout with one
    row above and below, the neighbour's rows where there is a neighbour
    (K4's ``halo_top`` / ``halo_bottom``) and zeros at the image's edges; one
    K4 launch a band a block; after every block but the last, the halo rows
    that K4 left zero are refreshed from the neighbours' new rows. ``x``:
    QAct bands; ``on(device)``: the sub-model's params on a device. One
    band is the unsharded stage (``resblock.fused_stage``)."""
    if len(x.parts) == 1:
        q = x.parts[0]
        return x.with_parts([L.QAct(*resblock.fused_stage((q.q, q.scale), on(x.devices[0]),
                                                          starts))])
    live = [j for j, part in enumerate(x.parts) if part is not None]
    xp, geo, scale = {}, {}, {}
    for j in live:
        band, pad_top, pad_bottom = halo_rows(x, j, x.starts[j] - 1, x.starts[j + 1] + 1)
        b, _, w, c = band.q.shape
        xp[j] = F.pad(band.q, (0, 0, 1, 1, pad_top, pad_bottom)).reshape(-1, c)
        geo[j] = dict(b=b, h=x.starts[j + 1] - x.starts[j], w=w, halo_top=not pad_top,
                      halo_bottom=not pad_bottom)
        scale[j] = band.scale

    def grid(j):
        g = geo[j]
        return xp[j].view(g["b"], g["h"] + 2, g["w"] + 2, -1)

    def owner_row(r):
        """(band, halo-layout row) of image row r."""
        k = next(k for k in live if x.starts[k] <= r < x.starts[k + 1])
        return k, r - x.starts[k] + 1

    for n, i in enumerate(starts):
        for j in live:
            params = on(x.devices[j])
            kwargs, scale[j] = resblock.block_args(params[f"layer{i}"], params[f"layer{i + 1}"],
                                                   params[f"layer{i + 2}"], scale[j])
            xp[j] = resblock.fused_resblock(xp[j], **kwargs, **geo[j])
        if n + 1 == len(starts):
            break
        for j in live:
            g = geo[j]
            for flag, r, dst in (("halo_top", x.starts[j] - 1, 0),
                                 ("halo_bottom", x.starts[j + 1], g["h"] + 1)):
                if g[flag]:
                    k, src = owner_row(r)
                    grid(j)[:, dst, 1:g["w"] + 1].copy_(
                        _moved(grid(k)[:, src, 1:g["w"] + 1], x.devices[j]))
    return x.with_parts([
        None if j not in xp else L.QAct(
            resblock.from_halo(xp[j], geo[j]["b"], geo[j]["h"], geo[j]["w"]).contiguous(),
            scale[j]) for j in range(len(x.parts))])
