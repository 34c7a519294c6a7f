"""Data parallelism in the port (yolov3_tpu_torch/parallel/mesh.py, the mesh
of parallel/train_step.py, sync-BN through ops/cuda/bn_stats.py, and
``make_predictor`` / ``make_sweepable_predictor`` over a serving mesh) on the
CPU, mirroring tests/test_parallel.py.

The data-parallel train step runs in two processes joined by gloo (the
``dp_step`` worker of tests/test_torch_multihost.py), YOLOv3-tiny at 96 px,
a global batch of 8 as 2 ranks × 4, weights from a JAX seed carried across:

  * against the port's single-process step on the same 8 images, its
    BatchNorm sums taken per shard and added as the all-reduce adds them
    (``shard_bn_sums``): loss rtol 1e-5, BN state 1e-5, the DP gradient
    within 2e-4 of each leaf's largest entry, params after one SGD step
    within 2e-4 of each leaf's largest update (``LR`` times the gradient
    tolerance, as tests/test_torch_train_step.py holds whole steps) or 2e-6;
    with ``accum_steps: 2`` and ``augmentation`` (mosaic too) the same; the
    two ranks' params, BN state, optimizer state and EMA bit-identical;
  * against the JAX package's step over its 8-device mesh (sync-BN inside
    one SPMD jit): loss terms 1e-4 relative, BN state 1e-4, each gradient
    leaf within the larger of 2e-4 of its largest entry and twice the
    distance between the JAX package's own gradient on one device and over
    its mesh (``grad_tol``). BatchNorm's one-pass variance makes this
    gradient depend on the order of the statistics' sums (``shard_bn_sums``):
    the JAX package's own two gradients are 5e-3 to 9e-2 of a leaf's largest
    entry apart on these weights and images (backbone, necks; the heads'
    last convs 2e-5), 6.5e-2 on tests/test_parallel.py's own images. A
    sharding fault (unsynced statistics, a gradient counted twice or not
    averaged) moves a leaf by its whole size.
  * sync-BN on non-iid shards: the running mean equals one process's within
    1e-4, and a per-shard run (unsynced) differs, which shows the test can
    fail;
  * K5's synced plain version: mean and var of the global batch, dx = the
    rows of the single process's dx (its global count), within 1e-6; with a
    group of one process bit-equal to the unsynced path.

Serving over the mesh ("cpu", "cpu"): fp32 and int8 equal the single
predictor (atol 1e-5), and equal JAX's sharded predictor as the packages
equal each other (NMS index-exact, boxes and scores 1e-4, int8 with JAX's
qparams carried across); the sweepable predictor the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.apps.evaluate_app import make_sweepable_predictor as jax_sweepable
from yolov3_tpu.apps.inference_app import make_predictor as jax_make_predictor
from yolov3_tpu.models import network as jnet
from yolov3_tpu.ops import quantize as jquant
from yolov3_tpu.parallel import mesh as jmesh
from yolov3_tpu.parallel import train_step as jts
from yolov3_tpu_torch.apps.evaluate_app import make_sweepable_predictor
from yolov3_tpu_torch.apps.inference_app import make_predictor
from yolov3_tpu_torch.models.convert import params_to_jax, qparams_from_jax
from yolov3_tpu_torch.ops.cuda import bn_stats
from yolov3_tpu_torch.parallel import mesh as tmesh
from yolov3_tpu_torch.parallel import train_step as tts
from yolov3_tpu_torch.tree import tree_leaves

from .test_torch_int8_slice import _compare_predictions, _tiny
from .test_torch_multihost import one_process_group, run_scenario, shard_bn_sums
from .test_torch_train_step import ANCHORS, GRAD_TOL, _assert_trees_close, _np
from .test_torch_train_step import make_setup as _make_setup

from .conftest import REPO

BATCH, WORLD, LR = 8, 2, 1e-3
SGD = {"type": "sgd", "momentum": 0.0}
STEPS = {
    "sgd": {"lr": LR, "optimizer": SGD},
    "adam_ema": {"lr": LR, "ema_decay": 0.99},
    "accum_aug": {"lr": LR, "optimizer": SGD, "accum_steps": 2, "augment": {}, "seed": 3},
    "mosaic": {"lr": LR, "optimizer": SGD, "augment": {"mosaic": 1.0}, "seed": 5},
    "noniid": {"lr": 0.0},
}


def _labels(rng, n):
    labels = np.zeros((n, 10, 6), np.float32)
    for b in range(n):
        for m in range(3):
            x0, y0 = rng.rand(2) * 0.6
            w, h = rng.rand(2) * 0.3 + 0.05
            labels[b, m] = [x0, y0, x0 + w, y0 + h, 1, rng.randint(3)]
    return labels


@pytest.fixture(scope="module")
def case():
    """YOLOv3-tiny in both packages (JAX-seeded weights with non-trivial BN),
    a global batch of 8 seeded images and labels, non-iid images (image i
    offset by i), and a K5 input."""
    s = _make_setup(f"{REPO}/config/models/yolov3_tiny/model.yaml")
    rng = np.random.RandomState(7)
    s["images"] = rng.rand(BATCH, 96, 96, 3).astype(np.float32)
    s["labels"] = _labels(rng, BATCH)
    s["noniid"] = s["images"] + np.arange(BATCH, dtype=np.float32).reshape(BATCH, 1, 1, 1)
    s["bn_x"] = rng.randn(BATCH, 5, 6, 7).astype(np.float32)
    s["bn_w"] = rng.randn(2, 5).astype(np.float32)
    return s


def _options(name, images):
    options = dict(STEPS[name])
    if name == "noniid":
        options["images"] = images
    return options


def _single_step(s, name, images=None):
    """The port's single-process step over the whole global batch (over
    ``images`` and their labels when given)."""
    options = _options(name, images)
    options.pop("images", None)
    optimizer = tts.make_adam(options.pop("lr"), optimizer=options.pop("optimizer", None))
    step = tts.make_train_step(s["tspec"], ANCHORS, s["grids"], BATCH, optimizer, **options)
    state = tts.init_train_state(s["tp"], s["ts"], optimizer, ema="ema_decay" in options)
    x = s["noniid"] if name == "noniid" else s["images"]
    return step(state, torch.from_numpy(x if images is None else images),
                torch.from_numpy(s["labels"] if images is None else s["labels"][:len(images)]))


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """Both ranks' results of the ``dp_step`` worker."""
    workdir = tmp_path_factory.mktemp("dp_step")
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    torch.save({
        "model": f"{REPO}/config/models/yolov3_tiny/model.yaml", "nclasses": 3,
        "batch": BATCH, "anchors": t(ANCHORS), "grids": tuple(case["grids"]),
        "params": case["tp"], "state": case["ts"], "images": t(case["images"]),
        "labels": t(case["labels"]), "bn_x": t(case["bn_x"]), "bn_w": t(case["bn_w"]),
        "steps": {name: _options(name, t(case["noniid"])) for name in STEPS},
    }, workdir / "case.pt")
    run_scenario("dp_step", workdir, WORLD)
    return [torch.load(workdir / f"rank{r}.pt") for r in range(WORLD)]


def _jax_grads(case, mesh=None):
    """The JAX package's gradient of the global batch's loss, on one device
    or by the same jit over ``mesh``'s shardings (its SPMD step's)."""
    images, labels = jnp.asarray(case["images"]), jnp.asarray(case["labels"])

    def grads_of(params, bn, im, lb):
        return jax.grad(lambda p: jts._loss_and_metrics(
            case["jspec"], p, bn, im, lb, jnp.asarray(ANCHORS), case["grids"], BATCH, (),
            True)[0])(params)

    if mesh is None:
        return _np(jax.jit(grads_of)(case["jp"], case["js"], images, labels))
    data, repl = jmesh.batch_sharding(mesh), jmesh.replicated_sharding(mesh)
    shard = jmesh.image_sharding(mesh)
    return _np(jax.jit(grads_of, in_shardings=(repl, repl, shard, data), out_shardings=repl)(
        case["jp"], case["js"], jax.device_put(images, shard), jax.device_put(labels, data)))


@pytest.fixture(scope="module")
def jax_mesh_grads(case):
    return _jax_grads(case, jmesh.make_mesh())


@pytest.fixture(scope="module")
def grad_tol(case, jax_mesh_grads):
    """Each gradient leaf's absolute tolerance (module docstring), as a tree
    in the JAX key layout."""
    single = _jax_grads(case)
    return jax.tree.map(lambda a, b: max(GRAD_TOL * float(np.abs(b).max()),
                                         2 * float(np.abs(a - b).max())), single, jax_mesh_grads)


def _assert_updates_close(case, got, want):
    """Params after one SGD step: within 2e-4 of each leaf's largest update
    (``LR`` times the gradient tolerance), or 2e-6."""
    for p0, a, b in zip(tree_leaves(case["tp"]), tree_leaves(got["params"]),
                        tree_leaves(want["params"])):
        tol = max(GRAD_TOL * float((b - p0).abs().max()), 2e-6)
        assert float((a - b).abs().max()) <= tol


def _assert_within(got, want, tol, scale=1.0, floor=0.0):
    """Leaf by leaf |got − want| ≤ max(scale · tol, floor) (JAX key layout)."""
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    g, w, t = flat(got), flat(want), flat(tol)
    assert set(g) == set(w) == set(t)
    for path in w:
        err = float(np.abs(np.asarray(g[path]) - np.asarray(w[path])).max())
        assert err <= max(scale * t[path], floor), (jax.tree_util.keystr(path), err,
                                                    scale * t[path])


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_ranks_stay_bit_identical(ranks):
    """Params, BN state, optimizer state (Adam's moments, counters) and the
    EMA after a step are the same bits on both ranks (their digests), and so
    are the averaged gradient and metrics."""
    r0, r1 = ranks
    for name in STEPS:
        assert r0[name]["digest"] == r1[name]["digest"], name
        assert _equal_trees(r0[name]["metrics"], r1[name]["metrics"]), name
    assert r0["adam_ema"]["keys"] == ["bn_state", "ema", "opt_state", "params", "step"]
    assert r0["grads_digest"] == r1["grads_digest"] and _equal_trees(r0["eval"], r1["eval"])


def test_dp_step_matches_the_single_process_step(case, ranks):
    """Against one process whose BN sums are taken per shard: loss rtol 1e-5,
    BN state 1e-5, the DP gradient 2e-4 of each leaf's largest entry, the
    params after one SGD step 2e-4 of each leaf's largest update or 2e-6,
    the eval metrics rtol 1e-5."""
    r0 = ranks[0]
    with shard_bn_sums(WORLD):
        grads, bn, metrics = tts.loss_and_grads(case["tspec"], case["tp"], case["ts"],
                                                torch.from_numpy(case["images"]),
                                                torch.from_numpy(case["labels"]), ANCHORS,
                                                case["grids"], BATCH)
        state, m = _single_step(case, "sgd")
    _assert_trees_close(params_to_jax(r0["grads"], {})[0], params_to_jax(grads, {})[0], rtol=0,
                        atol=None, scale_by_leaf_max=GRAD_TOL)
    _assert_trees_close(_np(r0["bn"]), _np(bn), rtol=1e-5, atol=1e-6)
    _assert_trees_close(_np(r0["metrics"]), _np(metrics), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(r0["sgd"]["metrics"]["total_loss"]), float(m["total_loss"]),
                               rtol=1e-5)
    _assert_updates_close(case, r0["sgd"], state)
    single_eval = tts.make_eval_step(case["tspec"], ANCHORS, case["grids"], BATCH)(
        case["tp"], case["ts"], torch.from_numpy(case["images"]),
        torch.from_numpy(case["labels"]))
    _assert_trees_close(_np(r0["eval"]), _np(single_eval), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["accum_aug", "mosaic"])
def test_accumulation_and_augmentation_match_the_single_process_step(case, ranks, name):
    """``accum_steps: 2`` with augmentation drawn once for the global batch
    (each rank its slice of the draws), and mosaic (composites across the
    gathered global batch), against one process whose BN sums are taken per
    shard: loss rtol 1e-5, BN 1e-5, params after one SGD step 2e-4 of each
    leaf's largest update or 2e-6."""
    with shard_bn_sums(WORLD):
        state, m = _single_step(case, name)
    got = ranks[0][name]
    np.testing.assert_allclose(float(got["metrics"]["total_loss"]), float(m["total_loss"]),
                               rtol=1e-5)
    _assert_trees_close(_np(got["bn_state"]), _np(state["bn_state"]), rtol=1e-5, atol=1e-6)
    _assert_updates_close(case, got, state)


def test_dp_step_matches_the_jax_mesh_step(case, ranks, jax_mesh_grads, grad_tol):
    """The JAX package's step over its 8-device mesh (one image a device):
    loss terms 1e-4 relative, BN state 1e-4; its gradient, taken by the same
    jit over the same shardings, against the DP gradient: within each leaf's
    tolerance."""
    assert jax.device_count() == 8
    mesh = jmesh.make_mesh()
    data = jmesh.batch_sharding(mesh)
    images = jax.device_put(jnp.asarray(case["images"]), jmesh.image_sharding(mesh))
    labels = jax.device_put(jnp.asarray(case["labels"]), data)
    optimizer = jts.make_adam(LR)
    step = jts.make_train_step(case["jspec"], ANCHORS, case["grids"], BATCH, optimizer,
                               mesh=mesh)
    jstate, jmetrics = step(jts.init_train_state(case["jp"], case["js"], optimizer), images,
                            labels)
    r0 = ranks[0]
    g, bn = params_to_jax(r0["grads"], r0["bn"])
    _assert_within(g, jax_mesh_grads, grad_tol)
    _assert_trees_close(bn, _np(jstate["bn_state"]), rtol=1e-4, atol=1e-6)
    _assert_trees_close(_np(r0["metrics"]), _np(jmetrics), rtol=1e-4, atol=1e-4)


def test_sync_bn_over_the_global_batch(case, ranks):
    """Non-iid shards (image i offset by i): the synced running mean equals
    one process's over the whole batch within 1e-4; a rank's own shard
    alone (what an unsynced BN would see) gives another mean."""
    state, _ = _single_step(case, "noniid")
    synced = ranks[0]["noniid"]["bn_state"]["backbone"]["layer1"]["mean"]
    single = state["bn_state"]["backbone"]["layer1"]["mean"]
    np.testing.assert_allclose(synced.numpy(), single.numpy(), rtol=1e-4)
    shard, _ = _single_step(case, "noniid", images=case["noniid"][:BATCH // WORLD])
    per_shard = shard["bn_state"]["backbone"]["layer1"]["mean"]
    assert not np.allclose(per_shard.numpy(), single.numpy(), rtol=1e-4)


def test_synced_bn_moments_use_the_global_batch_and_count(case, ranks):
    """K5's synced plain version: each rank's mean and var are the global
    batch's, and its dx is its rows of the single process's dx, whose count
    is the global one (within 1e-6); one all-reduce each way a BN layer."""
    x = torch.from_numpy(case["bn_x"]).requires_grad_(True)
    mean, var = bn_stats.bn_moments(x)
    w = torch.from_numpy(case["bn_w"])
    (mean @ w[0] + var @ w[1]).backward()
    for rank, got in enumerate(ranks):
        rows = slice(rank * BATCH // WORLD, (rank + 1) * BATCH // WORLD)
        torch.testing.assert_close(got["bn_moments"]["mean"], mean.detach(), rtol=0, atol=1e-6)
        torch.testing.assert_close(got["bn_moments"]["var"], var.detach(), rtol=0, atol=1e-6)
        torch.testing.assert_close(got["bn_moments"]["dx"], x.grad[rows], rtol=0, atol=1e-6)
    n_bn = sum("bn" in e for entries in case["tp"].values() for e in entries.values())
    assert ranks[0]["sync_launches"] == (n_bn, n_bn) and n_bn == 11


def test_sync_bn_over_a_group_of_one_is_the_unsynced_path(tmp_path):
    """With a process group of this process alone, the synced forward and
    backward are the unsynced ones bit for bit (f32 and bf16, NCHW and
    channels-last), and each call makes one all-reduce each way."""
    rng = np.random.RandomState(3)
    with one_process_group(tmp_path) as group:
        for dtype in (torch.float32, torch.bfloat16):
            for fmt in (torch.contiguous_format, torch.channels_last):
                x0 = torch.from_numpy(rng.randn(4, 6, 5, 3).astype(np.float32)).to(dtype)
                x0 = x0.contiguous(memory_format=fmt)
                dmean, dvar = (torch.from_numpy(rng.randn(6).astype(np.float32))
                               for _ in range(2))
                outs = []
                for g in (None, group):
                    x = x0.clone().requires_grad_(True)
                    before = (bn_stats.bn_sums.sync_launches,
                              bn_stats.bn_moments_dx.sync_launches)
                    mean, var = bn_stats.bn_moments(x, group=g)
                    (mean @ dmean + var @ dvar).backward()
                    after = (bn_stats.bn_sums.sync_launches,
                             bn_stats.bn_moments_dx.sync_launches)
                    assert [a - b for a, b in zip(after, before)] == ([0, 0] if g is None
                                                                       else [1, 1])
                    outs.append((mean, var, x.grad))
                for a, b in zip(*outs):
                    assert torch.equal(a, b) and a.dtype == b.dtype


TWO_CPUS = tmesh.Mesh((torch.device("cpu"), torch.device("cpu")))


@pytest.fixture(scope="module")
def tiny():
    return _tiny()


@pytest.mark.parametrize("quantize", [None, "int8", "int8_chain"])
def test_sharded_predictor_matches_the_single_predictor(tiny, quantize):
    """Two replicas over ("cpu", "cpu"): the batch of 8 split 4 + 4, the
    answers gathered in batch order, equal to one predictor (atol 1e-5); an
    int8 tier calibrates once and its replica holds the same quantized
    params."""
    jspec, tspec, jp, js, tp, ts, calib, args = tiny
    kwargs = dict(quantize=quantize, calibration_batches=calib if quantize else None,
                  image_size=96, device="cpu")
    single = make_predictor(tspec, tp, ts, *args, **kwargs)
    sharded = make_predictor(tspec, tp, ts, *args, **kwargs, mesh=TWO_CPUS)
    assert len(sharded.replicas) == 2 and sharded.replicas[1] is not sharded.replicas[0]
    assert _equal_trees(sharded.replicas[0].tree("params"), sharded.replicas[1].tree("params"))
    images = np.random.RandomState(4).rand(8, 96, 96, 3).astype(np.float32)
    got, want = sharded(images), single(images)
    assert int(want[4].sum()) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        sharded(images[:3])


@pytest.mark.parametrize("tier", ["fp32", "int8_chain"])
def test_sharded_predictor_matches_jax_sharded_predictor(tiny, tier):
    """The port over ("cpu", "cpu") against the JAX package over its 8
    devices, as the packages' predictors are held to each other: NMS
    index-exact, boxes and scores 1e-4 (int8 with JAX's calibrated qparams
    carried across)."""
    jspec, tspec, jp, js, tp, ts, calib, args = tiny
    if tier == "fp32":
        jargs, targs, kw = (jp, js), (tp, ts), {}
    else:
        jf = jnet.fold_batch_norm(jp, js)
        in_absmax, out_absmax = jquant.calibrate_scales(jspec, jf, calib)
        jq = jquant.quantize_params(jspec, jf, in_absmax, out_absmax=out_absmax)
        tq = qparams_from_jax(jax.tree.map(np.asarray, jq))
        jargs, targs, kw = (jq, {}), (tq, {}), {"fold_bn": False}
    jpred = jax_make_predictor(jspec, *jargs, *args, mesh=jmesh.make_mesh(), **kw)
    tpred = make_predictor(tspec, *targs, *args, device="cpu", mesh=TWO_CPUS, **kw)
    images = calib[0][np.arange(8) % len(calib[0])]
    assert (_compare_predictions(jpred(images), tpred(images)) > 0).all()


def test_sharded_sweepable_predictor(tiny):
    """The evaluation predictor over ("cpu", "cpu") at two thresholds: equal
    to the single one (atol 1e-5) and to JAX's sharded one (index-exact,
    1e-4)."""
    jspec, tspec, jp, js, tp, ts, calib, args = tiny
    nc = args[1]
    anchors = args[0]
    single = make_sweepable_predictor(tspec, tp, ts, anchors, nc, 20, device="cpu")
    sharded = make_sweepable_predictor(tspec, tp, ts, anchors, nc, 20, device="cpu",
                                       mesh=TWO_CPUS)
    jpred = jax_sweepable(jspec, jp, js, anchors, nc, 20, mesh=jmesh.make_mesh())
    images = calib[0][np.arange(8) % len(calib[0])]
    for thr in (0.004, 0.5):
        got = sharded(images, 0.5, thr)
        for a, b in zip(got, single(images, 0.5, thr)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
        _compare_predictions(jpred(images, 0.5, thr), got)


def test_training_mesh_is_refused_for_serving(tiny):
    jspec, tspec, jp, js, tp, ts, calib, args = tiny
    with pytest.raises(ValueError, match="spans processes"):
        make_predictor(tspec, tp, ts, *args, device="cpu",
                       mesh=tmesh.Mesh((torch.device("cpu"),), world_size=2))
