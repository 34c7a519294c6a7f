"""The spatial axis of the port (yolov3_tpu_torch/parallel/spatial.py, the
spatial axis of parallel/mesh.py, K4's halo-row flags, K5 over bands) on the
CPU, mirroring tests/test_spatial.py. Every band is a CPU "device": a mesh
over ``("cpu",) * S``.

  * the band layout (coarse-grid ownership, empty bands) and the halo rows
    each layer kind reads;
  * K4's plain version over bands with exchanged halo rows: bit-equal to the
    whole-image block; with both flags off, today's contract;
  * the spatial predictor against the JAX package's spatial predictor on
    tests/test_spatial.py's configurations (YOLOv3-tiny at 96², 3 classes,
    (data 2 × spatial 4) at B = 4 and (1 × 8) at B = 1): atol 1e-5, as that
    file holds the JAX package to its own unsharded predictor;
  * the port's spatial forward against its own unsharded one: fp32 heads
    within 1e-5 and NMS index-exact, ``int8`` / ``int8_chain`` heads and
    detections bit-equal, YOLOv3 (Darknet-53 with the space-to-depth int8
    stem and K4's fused stages over the bands) at 64² over two bands;
  * the data 2 × spatial 2 step in two gloo processes, ranks
    bit-identical, and the single-host rule;
  * ``cli train`` with ``spatial_partitioning: 2`` (tests/test_spatial.py's
    e2e, a bad factor rejected before any step). ``serve``, ``evaluate``
    and ``Inference`` with the key are held to their unsharded runs in
    tests/test_torch_{slice,evaluate_app,inference_app}.py.

The spatial train step's parity (against the JAX package's spatial step and
the port's per-band-sums step) is in tests/test_torch_spatial_step.py, which
shares this file's fixtures and cases."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from yolov3_tpu.apps.inference_app import make_predictor as jax_make_predictor
from yolov3_tpu.models import init_model as jax_init_model
from yolov3_tpu.models import parse_model_config as jax_parse
from yolov3_tpu.models.network import head_grid_sizes
from yolov3_tpu.parallel import mesh as jmesh
from yolov3_tpu_torch.apps import cli
from yolov3_tpu_torch.apps.inference_app import make_predictor
from yolov3_tpu_torch.apps.train_app import Train
from yolov3_tpu_torch.models import apply_model, parse_model_config
from yolov3_tpu_torch.models.convert import params_from_jax
from yolov3_tpu_torch.ops.cuda import resblock
from yolov3_tpu_torch.parallel import mesh as tmesh
from yolov3_tpu_torch.parallel import spatial as sp
from yolov3_tpu_torch.parallel import train_step as tts

from .conftest import REPO, absolutize_run_config
from .test_torch_multihost import run_scenario
from .test_torch_threads import torch_threads  # noqa: F401  (the module fixture)

ANCHORS = np.array(
    [[0.1, 0.1], [0.2, 0.2], [0.3, 0.3],
     [0.4, 0.4], [0.5, 0.5], [0.6, 0.6]], np.float32).reshape(2, 3, 2)
ANCHORS3 = np.linspace(0.05, 0.6, 18, dtype=np.float32).reshape(3, 3, 2)  # YOLOv3's 3 heads
KW = dict(anchors_table=ANCHORS, nclasses=3, yolo_max_boxes=20, nms_iou_threshold=0.5,
          nms_score_threshold=0.1)
TINY = os.path.join(REPO, "config/models/yolov3_tiny/model.yaml")
YOLOV3 = os.path.join(REPO, "config/models/yolov3/model.yaml")
GRAD_TOL = 2e-4  # of each leaf's largest entry
CPU = torch.device("cpu")


def cpus(n):
    return (CPU,) * n


@pytest.fixture(scope="module")
def tiny():
    """tests/test_spatial.py's setup in both packages: YOLOv3-tiny, 3
    classes, the JAX package's ``init_model(PRNGKey(0))`` carried across."""
    jspec, tspec = jax_parse(TINY, nclasses=3), parse_model_config(TINY, 3)
    jp, js = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0), jspec))
    tp, ts = params_from_jax(jp, js)
    return jspec, tspec, jp, js, tp, ts


# ---------------------------------------------------------------------------
# band layout and halo rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("height,spatial,starts", [
    (416, 2, (0, 224, 416)),                      # 13 coarse rows: 7 / 6
    (416, 4, (0, 128, 224, 320, 416)),            # 4 / 3 / 3 / 3
    (64, 2, (0, 32, 64)),                         # one coarse row a band
    (96, 8, (0, 32, 64, 96, 96, 96, 96, 96, 96)),  # 3 coarse rows, 5 empty bands
])
def test_band_layout_owns_rows_on_the_coarsest_grid(height, spatial, starts):
    assert sp.band_starts(height, spatial, 32) == starts
    images = torch.arange(2 * height * 3 * 1, dtype=torch.float32).view(2, height, 3, 1)
    bands = sp.split_rows(images, cpus(spatial), 32)
    assert [p is None for p in bands.parts] == [a == b for a, b in zip(starts, starts[1:])]
    assert torch.equal(sp.gather_rows(bands), images)


def test_image_sharding_splits_each_replicas_rows():
    """``image_sharding`` of a (data 2 × spatial 2) mesh: the batch over the
    replicas, each replica's images over its two bands."""
    mesh = tmesh.make_data_parallel_mesh(4, spatial=2, devices=cpus(4))
    x = torch.arange(4 * 64 * 2.0).view(4, 64, 2, 1)
    shards = tmesh.image_sharding(mesh)(x)
    assert [s.starts for s in shards] == [(0, 32, 64)] * 2
    assert all(torch.equal(sp.gather_rows(s), x[2 * i:2 * i + 2]) for i, s in enumerate(shards))
    assert tmesh.image_sharding(tmesh.make_data_parallel_mesh(4, devices=cpus(2))) is not None


def test_band_layout_needs_the_total_stride_and_finds_it(tiny):
    with pytest.raises(ValueError, match="multiple of the model's total stride"):
        sp.band_starts(100, 2, 32)
    assert sp.total_stride(tiny[1], 96) == 32
    assert sp.total_stride(parse_model_config(YOLOV3, 3), 416) == 32


@pytest.mark.parametrize("kind,window,halo", [
    ("3x3 stride 1, SAME", (3, 1, 1), (1, 1)),
    ("3x3 stride 2, Darknet ((1,0),(1,0))", (3, 2, 1), (1, 0)),
    ("1x1", (1, 1, 0), (0, 0)),
    ("tiny's 2x2 stride-1 'same' max-pool, pads (0,1)", (2, 1, 0), (0, 1)),
    ("s2d conv0, 4x4 stride 2, pads ((1,2),(1,2)): the second bottom row is never read",
     (4, 2, 1), (1, 1)),
    ("s2d conv1, 2x2 stride 1, pads ((1,0),(1,0))", (2, 1, 1), (1, 0)),
])
def test_halo_rows_of_each_layer_kind(kind, window, halo):
    assert sp.halo_extent(*window) == halo, kind


def test_halo_rows_come_from_the_nearest_band_with_rows():
    """Band 2 of (rows 0-1 | empty | rows 2-3): its row above is band 0's
    last, moved and counted; only rows outside the image are padding."""
    x = torch.arange(4.0).view(1, 1, 4, 1)
    bands = sp.Bands((x[:, :, :2], None, x[:, :, 2:]), (0, 2, 2, 4), cpus(3))
    sp.reset_halo_counts()
    got, pad_top, pad_bottom = sp.halo_rows(bands, 2, 1, 5)
    assert got.flatten().tolist() == [1.0, 2.0, 3.0] and (pad_top, pad_bottom) == (0, 1)
    assert sp.HALO == {"copies": 1, "bytes": 4}


# ---------------------------------------------------------------------------
# K4's plain version over bands
# ---------------------------------------------------------------------------


def _block(rng, c, cm):
    w1 = torch.from_numpy(rng.randint(-127, 128, (cm, c)).astype(np.int8))
    w2 = torch.from_numpy(rng.randint(-20, 21, (9, c, cm)).astype(np.int8))
    f = lambda *shape: torch.from_numpy(rng.rand(*shape).astype(np.float32))  # noqa: E731
    s = [torch.tensor(v, dtype=torch.float32) for v in (1 / 0.05177, 1 / 0.07273, 0.07273,
                                                       0.04131, 1 / 0.06113)]
    return dict(w1=w1, w2=w2, scale1=f(cm) * 1e-3, bias1=f(cm) - 0.5, inv_s1=s[0],
                scale2=f(c) * 1e-4, bias2=f(c) - 0.5, inv_s2=s[1], s2=s[2], s_x=s[3],
                inv_out=s[4])


@pytest.mark.parametrize("cuts", [(7, 6), (4, 3, 3, 3), (13,)])
def test_k4_plain_over_bands_equals_the_whole_image_block(cuts):
    """Two chained blocks on a 13-row image, as bands of ``cuts`` rows: each
    band in halo layout with its neighbours' rows (``halo_top`` /
    ``halo_bottom``), the halo rows refreshed between the blocks; the
    bands' interiors joined are the whole-image blocks' output, bit for bit.
    One band has no neighbour: both flags off, today's contract."""
    rng = np.random.RandomState(0)
    b, h, w, c, cm = 2, 13, 9, 64, 32
    x = torch.from_numpy(rng.randint(-127, 128, (b, h, w, c)).astype(np.int8))
    blocks = [_block(rng, c, cm) for _ in range(2)]
    whole = resblock.to_halo(x)
    for kw in blocks:
        whole = resblock.fused_resblock_plain(whole, **kw, b=b, h=h, w=w)
    want = resblock.from_halo(whole, b, h, w)

    starts = np.cumsum((0,) + cuts)
    q = x
    for kw in blocks:
        padded = torch.nn.functional.pad(q, (0, 0, 1, 1, 1, 1))  # zero rows at the image's edges
        outs = []
        for a, e in zip(starts, starts[1:]):
            xp = padded[:, a:e + 2].reshape(-1, c)  # the band with its neighbours' rows
            flags = dict(halo_top=bool(a > 0), halo_bottom=bool(e < h))
            out = resblock.fused_resblock_plain(xp, **kw, b=b, h=e - a, w=w, **flags)
            outs.append(resblock.from_halo(out, b, e - a, w))
        q = torch.cat(outs, dim=1)
    assert torch.equal(q, want) and len(torch.unique(want)) > 20
    if len(cuts) > 1:  # without the flags the band edges read zeros: another result
        band = resblock.fused_resblock_plain(
            torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))[:, :cuts[0] + 2].reshape(-1, c),
            **blocks[0], b=b, h=cuts[0], w=w)
        ref = resblock.from_halo(resblock.fused_resblock_plain(
            resblock.to_halo(x), **blocks[0], b=b, h=h, w=w), b, h, w)
        assert not torch.equal(resblock.from_halo(band, b, cuts[0], w), ref[:, :cuts[0]])


@pytest.mark.parametrize("rows,hw,c", [(28, 52, 256), (24, 52, 256), (7, 13, 1024),
                                       (6, 13, 1024), (112, 208, 64), (4, 13, 1024)])
def test_k4_plan_at_band_heights(rows, hw, c):
    """K4's launch plan for a band of ``rows`` of a Darknet-53 stage at 416²
    (B=16): a cut that fits shared memory and covers the band's rows."""
    pl = resblock.plan(16, rows, hw, c, c // 2)
    assert pl["band_rows"] <= rows and pl["bands"] * pl["band_rows"] >= rows
    assert pl["smem"] <= resblock._MAX_SMEM and pl["items"] == 16 * pl["bands"] * pl["slices"]


# ---------------------------------------------------------------------------
# the spatial predictor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data,spatial,batch", [(2, 4, 4), (1, 8, 1)])
def test_spatial_predictor_matches_the_jax_spatial_predictor(tiny, data, spatial, batch):
    """tests/test_spatial.py's two configurations: the JAX predictor over
    its (data × spatial) mesh of 8 devices against the port's over
    ``("cpu",) * 8`` with the same axes; every output within 1e-5 (NMS
    index-exact, counts equal)."""
    jspec, tspec, jp, js, tp, ts = tiny
    images = np.random.RandomState(batch).rand(batch, 96, 96, 3).astype(np.float32)
    jpred = jax_make_predictor(jspec, jp, js, mesh=jmesh.make_data_parallel_mesh(
        batch, spatial=spatial), **KW)
    mesh = tmesh.make_data_parallel_mesh(batch, spatial=spatial, devices=cpus(8))
    assert mesh.shape == {"data": data, "spatial": spatial}
    tpred = make_predictor(tspec, tp, ts, mesh=mesh, device="cpu", **KW)
    got, want = tpred(images), jpred(jnp.asarray(images))
    assert int(want[4].sum()) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("model,size,spatial,batch", [(TINY, 96, 3, 2), (YOLOV3, 64, 2, 2)])
@pytest.mark.parametrize("tier", [None, "int8", "int8_chain"])
def test_spatial_predictor_matches_the_unsharded_predictor(model, size, spatial, batch, tier,
                                                           monkeypatch):
    """The port against itself: fp32 heads within 1e-5 and NMS index-exact;
    the int8 tiers' heads and detections bit-equal (every quantized
    activation upstream of a head is then equal). YOLOv3 at 64² (one coarse
    row a band) runs the space-to-depth int8 stem over bands and, in
    ``int8_chain``, its five residual stages through K4 per band (23 blocks
    a band)."""
    spec = parse_model_config(model, 3)
    params, state = tmesh_init(spec)
    rng = np.random.RandomState(size)
    calib = [rng.rand(4, size, size, 3).astype(np.float32)]
    images = rng.rand(batch, size, size, 3).astype(np.float32)
    kwargs = dict(KW, nms_score_threshold=0.0, quantize=tier, device="cpu", image_size=size,
                  calibration_batches=calib if tier else None)
    plain = make_predictor(spec, params, state, **kwargs)
    sharded = make_predictor(spec, params, state, **kwargs,
                             mesh=tmesh.make_data_parallel_mesh(batch, spatial=spatial,
                                                                devices=cpus(spatial)))
    detector = sharded.module
    assert detector.bands == cpus(spatial)
    stages = _counting(monkeypatch, sp, "fused_stage_bands")
    blocks = _counting(monkeypatch, resblock, "fused_resblock")
    with torch.inference_mode():
        x = torch.from_numpy(images)
        heads = apply_model(detector.spec, detector.tree("params"), {}, x)
        band_heads = apply_model(detector.spec, detector.tree("params"), {}, x,
                                 devices=detector.bands)
    if tier == "int8_chain" and model == YOLOV3:
        assert [layer.get("size") for layer in detector.spec.sub_models[0].layers
                if layer.kind == "convolutional"][:2] == [4, 2]  # the s2d stem
        assert len(stages) == 2 * 5 and len(blocks) == 2 * 23 + 23  # the bands', the whole image's
    got, want = sharded(images), plain(images)
    assert int(want[4].sum()) > 0
    if tier is None:
        for a, b in zip(band_heads, heads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
        for a, b in zip(got[3:], want[3:]):
            assert torch.equal(a, b)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    else:
        assert all(torch.equal(a, b) for a, b in zip(band_heads, heads))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def tmesh_init(spec):
    from yolov3_tpu_torch.models import init_model

    return init_model(spec, torch.Generator().manual_seed(3))


# ---------------------------------------------------------------------------
# the data 2 × spatial 2 step and the single-host rule (the step's parity:
# tests/test_torch_spatial_step.py)
# ---------------------------------------------------------------------------


def _step_case():
    """tests/test_spatial.py's train-step inputs: 8 images at 96², one box
    each."""
    rng = np.random.RandomState(0)
    images = rng.rand(8, 96, 96, 3).astype(np.float32)
    labels = np.zeros((8, 5, 6), np.float32)
    labels[:, 0] = [0.2, 0.2, 0.5, 0.5, 1, 1]
    return images, labels


def test_data_2_by_spatial_2_ranks_are_bit_identical(tiny, tmp_path):
    """Two gloo processes, each with its 4 images' rows in two CPU bands:
    after one Adam step both ranks hold the same bits (params, BN state,
    optimizer state), and the step's loss is the single-process spatial
    step's within 1e-5 relative."""
    _, tspec, _, _, tp, ts = tiny
    images, labels = (torch.from_numpy(a) for a in _step_case())
    torch.save({"model": TINY, "nclasses": 3, "batch": 8, "anchors": torch.from_numpy(ANCHORS),
                "grids": tuple(head_grid_sizes(tspec, 96)), "params": tp, "state": ts,
                "images": images, "labels": labels}, tmp_path / "dsp_case.pt")
    run_scenario("dsp_step", tmp_path, 2)
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt") for r in range(2))
    assert r0["digest"] == r1["digest"]
    opt = tts.make_adam(1e-3)
    step = tts.make_train_step(tspec, ANCHORS, head_grid_sizes(tspec, 96), 8, opt,
                               mesh=tmesh.make_mesh(devices=cpus(2), spatial=2))
    _, metrics = step(tts.init_train_state(tp, ts, opt), images, labels)
    torch.testing.assert_close(r0["metrics"]["total_loss"], metrics["total_loss"], rtol=1e-5,
                               atol=0)


def test_single_host_rule(monkeypatch, tmp_path):
    """A process group whose ranks report two host names raises the JAX
    package's single-host message; one host passes."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        tmesh.check_single_host()
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)

        def two_hosts(out, name, group=None):
            out[:] = [name, name + "-other"]

        monkeypatch.setattr(dist, "all_gather_object", two_hosts)
        with pytest.raises(ValueError, match=r"spatial_partitioning is single-host \(ICI\) only"):
            tmesh.check_single_host()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_cli_train_spatial_e2e(tmp_path):
    """``cli train`` with ``spatial_partitioning: 2`` for one epoch on the
    toy dataset at 96² (the bands share the CPU), as tests/test_spatial.py
    drives the JAX trainer; a bad factor is rejected before any step."""
    with open(os.path.join(REPO, "config/train_config.yaml")) as f:
        cfg = absolutize_run_config(yaml.safe_load(f))
    cfg.update(image_size=96, epochs=1, batch_size=8, training_mode="fit", ema=None,
               output_checkpoints_path=f"{tmp_path}/sp.tf", spatial_partitioning=2)
    with pytest.raises(ValueError, match=r"spatial_partitioning \(5\)"):
        Train()(**dict(cfg, spatial_partitioning=5), device="cpu")
    assert not os.path.exists(f"{tmp_path}/sp.tf.npz")
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    lines = []

    class Handler(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Handler()
    logging.getLogger().addHandler(handler)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        cli.main(["train", "--config", str(path), "--device", "cpu"])
    finally:
        os.chdir(cwd)
        logging.getLogger().removeHandler(handler)
    assert any("data×spatial parallel: 1 process(es) × 2 bands" in line for line in lines)
    assert any(line.startswith("epoch 1:") for line in lines)
    assert os.path.exists(f"{tmp_path}/sp.tf.npz")
