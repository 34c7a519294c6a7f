"""The spatial train step of the port (yolov3_tpu_torch/parallel/spatial.py
through parallel/train_step.py, K5 over bands) on the CPU, against the JAX
package's spatial step and against the port's own unsharded step whose K5
sums are taken per band. Split from tests/test_torch_spatial.py (the band
layout, halos, K4 over bands, the predictors, the data 2 × spatial 2 ranks
and ``cli train``), whose fixtures and cases this file shares. Every band is
a CPU "device": a mesh over ``("cpu",) * S``.

  * the spatial train step (tiny at 96², a batch of 8, spatial 2 and 4)
    against the JAX package's spatial step (float32 and float64), and
    against the port's own step whose K5 sums are taken per band
    (``band_bn_sums``), YOLOv3 at 64² over two bands too;
  * the trainer's options over three bands (QAT, ``remat``, the BN
    statistics' subsample) against the unsharded step;
  * one whole ``make_train_step`` update over a (1 × 2) mesh.

Why the plain step is not the train step's reference: BatchNorm's one-pass
variance (E[x²] − E[x]²) cancels where a channel's mean is large against its
spread, so the gradient depends on the order of the statistics' sums (up to
9.9e-2 of a leaf's largest entry at YOLOv3-416, PERF.md). Summed per band,
the unsharded step is the spatial step's math; the two are compared in
float64, where the convolutions' own reordering over bands (1.2e-5 of a
leaf's largest entry in float32 on these weights) drops below the 1e-5
tolerance and only a fault of the band math would show."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.models import layers as jlayers
from yolov3_tpu.models.network import head_grid_sizes
from yolov3_tpu.parallel import mesh as jmesh
from yolov3_tpu.parallel import train_step as jts
from yolov3_tpu_torch.models import parse_model_config
from yolov3_tpu_torch.models.convert import params_to_jax
from yolov3_tpu_torch.ops.cuda import bn_stats
from yolov3_tpu_torch.parallel import mesh as tmesh
from yolov3_tpu_torch.parallel import spatial as sp
from yolov3_tpu_torch.parallel import train_step as tts
from yolov3_tpu_torch.tree import tree_leaves, tree_map

from .test_torch_spatial import (ANCHORS, ANCHORS3, GRAD_TOL, YOLOV3, _step_case, cpus,
                                 tmesh_init)
from .test_torch_spatial import tiny  # noqa: F401  (the module fixture)
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)


def _jax_grads(jspec, jp, js, mesh=None, dtype=np.float32):
    """The JAX package's (gradient, new BN state, metrics) of the batch's
    loss, on one device or by one jit over ``mesh``'s shardings."""
    images, labels = _step_case()
    images = images.astype(dtype)
    grids = head_grid_sizes(jspec, 96)

    def grads_of(params, bn, im, lb):
        return jax.grad(lambda p: jts._loss_and_metrics(
            jspec, p, bn, im, lb, jnp.asarray(ANCHORS), grids, 8, (), True), has_aux=True)(
            params)

    if mesh is None:
        out = jax.jit(grads_of)(jp, js, jnp.asarray(images), jnp.asarray(labels))
    else:
        data, repl = jmesh.batch_sharding(mesh), jmesh.replicated_sharding(mesh)
        shard = jmesh.image_sharding(mesh)
        out = jax.jit(grads_of, in_shardings=(repl, repl, shard, data), out_shardings=repl)(
            jp, js, jax.device_put(jnp.asarray(images), shard),
            jax.device_put(jnp.asarray(labels), data))
    grads, (bn, metrics) = jax.tree.map(np.asarray, out)
    return grads, bn, metrics


def _port_grads(tspec, tp, ts, spatial, dtype=torch.float32, size=96, batch=8, **options):
    images, labels = (torch.from_numpy(a[:batch]) for a in _step_case())
    if size != 96:
        images = torch.nn.functional.interpolate(images.permute(0, 3, 1, 2), size=size)
        images = images.permute(0, 2, 3, 1).contiguous()
    mesh = tmesh.make_mesh(devices=cpus(spatial), spatial=spatial) if spatial > 1 else None
    grids = head_grid_sizes(tspec, size)
    return tts.loss_and_grads(
        tspec, tree_map(lambda t: t.to(dtype), tp), ts, images.to(dtype), labels,
        torch.from_numpy(ANCHORS if len(grids) == 2 else ANCHORS3), grids, batch,
        bands=None if mesh is None else mesh.replicas[0], **options)


@contextlib.contextmanager
def band_bn_sums(spatial: int, coarse: int = 3):
    """The unsharded step's reference for BatchNorm over ``spatial`` bands of
    an image with ``coarse`` rows on its coarsest grid: while the block
    runs, K5's plain sums are taken over each band's rows
    (``spatial.coarse_rows``) and added in band order, as
    ``bn_moments_bands`` adds them."""
    whole = bn_stats.bn_sums_plain

    def per_band(x):
        unit = x.shape[2] // coarse
        rows = [r * unit for r in sp.coarse_rows(coarse, spatial) if r]
        sums = [whole(part) for part in x.split(rows, dim=2)]
        return tuple(functools.reduce(torch.add, column) for column in zip(*sums))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bn_stats, "bn_sums_plain", per_band)
        yield


def _leaf_rel(got, want):
    return {k: float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max()
                     / max(float(np.abs(np.asarray(want[k])).max()), 1e-30))
            for k in want}


def _flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: patched into the
    JAX package's layers module, its BatchNorm statistics
    (``x.astype(jnp.float32)``) run in float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _jax_grads64(jspec, jp, js, mesh=None):
    """``_jax_grads`` with float64 weights, images and BatchNorm statistics
    (the loss after the heads stays float32, as in the port)."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "jnp", _Float64Numpy())
        return _jax_grads(jspec, *jax.tree.map(lambda a: a.astype(np.float64), (jp, js)), mesh,
                          dtype=np.float64)


@pytest.fixture(scope="module")
def jax_single_step(tiny):
    """The JAX package's single-device gradient, its own sum-order spread
    (each leaf's distance to the same jit over its 8-device data mesh,
    tests/test_torch_parallel.py's ``grad_tol``), and the single-device
    gradient with float64 statistics (``_jax_grads64``)."""
    jspec, _, jp, js, _, _ = tiny
    single, data = (_flat(_jax_grads(jspec, jp, js, mesh)[0]) for mesh in (None,
                                                                         jmesh.make_mesh()))
    return (single, {k: float(np.abs(w - data[k]).max()) for k, w in single.items()},
            _flat(_jax_grads64(jspec, jp, js)[0]))


@pytest.mark.parametrize("spatial", [2, 4])
def test_spatial_step_matches_the_jax_spatial_step(tiny, jax_single_step, spatial):
    """The port's spatial step against the JAX package's, taken by one jit
    over its (data 8/S × spatial S) mesh.

    In float32: loss terms 1e-4 relative and BN state 1e-4 of JAX's spatial
    step; each gradient leaf within the larger of 2e-4 of its largest entry
    and twice the JAX package's own sum-order spread of JAX's single-device
    gradient (``jax_single_step``, as tests/test_torch_parallel.py holds the
    data axis). JAX's float32 spatial gradient is not the reference there:
    its spatial reduction order moves it from its single-device gradient by
    up to 1.1 × a backbone leaf's largest entry (printed), which float64
    statistics take to 1e-13 (PERF.md §7): BatchNorm's one-pass variance
    cancels, and the order of the sums decides the gradient.

    In float64 (weights, images and both packages' BatchNorm statistics):
    each gradient leaf within 1e-5 of its largest entry of JAX's spatial
    step's, 20 times tighter than 2e-4 (the float32 loss after the heads
    bounds the two packages' distance at about 1e-7)."""
    jspec, tspec, jp, js, tp, ts = tiny
    mesh = jmesh.make_mesh(spatial=spatial)
    jgrads, jbn, jmetrics = _jax_grads(jspec, jp, js, mesh)
    grads, bn, metrics = _port_grads(tspec, tp, ts, spatial)
    g, b = params_to_jax(grads, bn)
    np.testing.assert_allclose(metrics["per_grid_per_source"].numpy(),
                               jmetrics["per_grid_per_source"], rtol=1e-4, atol=1e-6)
    for key, w in _flat(jbn).items():
        np.testing.assert_allclose(np.asarray(_flat(b)[key]), w, rtol=1e-4, atol=1e-6)
    single, spread, single64 = jax_single_step
    got = _flat(g)
    for key, w in single.items():
        tol = max(GRAD_TOL * float(np.abs(w).max()), 2 * spread[key])
        assert float(np.abs(np.asarray(got[key]) - w).max()) <= tol, key
    order = max(spread[k] / max(float(np.abs(w).max()), 1e-30) for k, w in single.items())
    print(f"spatial {spatial}, float32, worst leaf of each distance / its largest entry: "
          f"JAX spatial vs JAX single {max(_leaf_rel(_flat(jgrads), single).values())}, "
          f"port spatial vs JAX single {max(_leaf_rel(got, single).values())}, "
          f"JAX data mesh vs JAX single {order}")

    want = _flat(_jax_grads64(jspec, jp, js, mesh)[0])
    with float64_bn_sums():
        g64 = _flat(params_to_jax(_port_grads(tspec, tp, ts, spatial, torch.float64)[0], {})[0])
    rel = _leaf_rel(g64, want)
    print(f"spatial {spatial}, float64: port spatial vs JAX spatial {max(rel.values())}, "
          f"JAX spatial vs JAX single {max(_leaf_rel(want, single64).values())}")
    assert max(rel.values()) <= 1e-5, max(rel.values())


@pytest.mark.parametrize("model,size,spatial", [("tiny", 96, 2), ("tiny", 96, 4),
                                                ("yolov3", 64, 2)])
def test_spatial_step_matches_the_per_band_sums_step(tiny, model, size, spatial):
    """The port's spatial gradient, BN state and loss against its unsharded
    step with K5's sums per band (``band_bn_sums``), in float64: each leaf
    within 1e-5 of its largest entry, BN state 1e-6, loss 1e-10 relative. A
    band that read zeros where a neighbour's rows belong, or BatchNorm over
    one band, moves a leaf by far more (the tiny over 4 bands runs an empty
    band at the coarsest level; YOLOv3 at 64², B=2, adds Darknet-53's
    stride-2 convs, shortcuts and routes)."""
    if model == "tiny":
        _, tspec, _, _, tp, ts = tiny
        batch = 8
    else:
        tspec = parse_model_config(YOLOV3, 3)
        tp, ts = tmesh_init(tspec)
        batch = 2
    kw = dict(size=size, batch=batch)
    with band_bn_sums(spatial, coarse=size // 32):
        g1, bn1, m1 = _port_grads(tspec, tp, ts, 1, torch.float64, **kw)
    gs, bns, ms = _port_grads(tspec, tp, ts, spatial, torch.float64, **kw)
    rel = _leaf_rel(dict(enumerate(tree_leaves(gs))), dict(enumerate(tree_leaves(g1))))
    assert max(rel.values()) <= 1e-5, max(rel.values())
    for a, b in zip(tree_leaves(bns), tree_leaves(bn1)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    torch.testing.assert_close(ms["total_loss"], m1["total_loss"], rtol=1e-10, atol=0)


@contextlib.contextmanager
def float64_bn_sums():
    """K5's plain sums in float64 while the block runs: with float64
    activations no order of the sums then moves a result, so any band split
    is held to the unsharded step as it is."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bn_stats, "bn_sums_plain",
                   lambda x: (x.double().sum(dim=(0, 2, 3)), (x.double() ** 2).sum(dim=(0, 2, 3))))
        yield


@pytest.mark.parametrize("options", [{"qat": "full"}, {"remat": "conv"}, {"remat": True},
                                     {"bn_stats_subsample": 2}])
def test_spatial_step_options_match_the_unsharded_step(tiny, options):
    """The trainer's options over three bands of the tiny at 96² (at the
    coarsest level one row a band): activation QAT (one fake-quant scale
    over all bands), ``remat`` conv and true (checkpoints over bands), and
    the BatchNorm statistics' stride-2 subsample (rows kept where the
    image's are, whichever band holds them). Float64 activations and BN sums
    (``float64_bn_sums``): each gradient leaf within 1e-5 of its largest
    entry of the unsharded step's, BN state 1e-6."""
    _, tspec, _, _, tp, ts = tiny
    with float64_bn_sums():
        g1, bn1, _ = _port_grads(tspec, tp, ts, 1, torch.float64, **options)
        gs, bns, _ = _port_grads(tspec, tp, ts, 3, torch.float64, **options)
    rel = _leaf_rel(dict(enumerate(tree_leaves(gs))), dict(enumerate(tree_leaves(g1))))
    assert max(rel.values()) <= 1e-5, max(rel.values())
    for a, b in zip(tree_leaves(bns), tree_leaves(bn1)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_spatial_train_step_updates_as_the_per_band_sums_step(tiny):
    """One whole step through ``make_train_step`` with a (1 × 2) mesh (SGD,
    float64, as above): params within 2e-4 of each leaf's largest update (or
    2e-6) of the unsharded step with per-band sums, BN state 1e-5, loss 1e-5
    relative; the eval step's metrics too."""
    _, tspec, _, _, tp, ts = tiny
    tp = tree_map(lambda t: t.double(), tp)
    images, labels = (torch.from_numpy(a) for a in _step_case())
    images = images.double()
    grids = head_grid_sizes(tspec, 96)
    opt = tts.make_adam(1e-3, optimizer={"type": "sgd", "momentum": 0.0})
    mesh = tmesh.make_mesh(devices=cpus(2), spatial=2)
    runs = []
    for m in (None, mesh):
        with band_bn_sums(2) if m is None else contextlib.nullcontext():
            step = tts.make_train_step(tspec, ANCHORS, grids, 8, opt, mesh=m)
            state, metrics = step(tts.init_train_state(tp, ts, opt), images, labels)
            evaluated = tts.make_eval_step(tspec, ANCHORS, grids, 8, mesh=m)(tp, ts, images,
                                                                             labels)
        runs.append((state, metrics, evaluated))
    (want, wm, we), (got, gm, ge) = runs
    for p0, a, b in zip(tree_leaves(tp), tree_leaves(got["params"]),
                        tree_leaves(want["params"])):
        tol = max(GRAD_TOL * float((b - p0).abs().max()), 2e-6)
        assert float((a - b).abs().max()) <= tol
    for a, b in zip(tree_leaves(got["bn_state"]), tree_leaves(want["bn_state"])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    torch.testing.assert_close(gm["total_loss"], wm["total_loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(ge["total_loss"], we["total_loss"], rtol=1e-5, atol=0)
