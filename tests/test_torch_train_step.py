"""The port's train step (yolov3_tpu_torch/parallel/train_step.py,
models/network.py training mode, models/convert.py train-state carry)
against the JAX package's, on the CPU in float32: YOLOv3-tiny at 96 px, B=4,
weights from a JAX seed carried across, images and labels from numpy seeds.

Tolerances:
  * one forward + backward: metrics 1e-5 relative (floor 1e-4 absolute), new
    BN state 1e-5, every gradient leaf within 2e-4 of the leaf's largest entry
    (two libraries' f32 convolutions, 13 layers deep);
  * optimizers are fed THE SAME gradients and moments on both sides and held
    to 1e-6: after a whole step Adam's first update is ±lr whatever the
    gradient's size, so a gradient near zero that differs in the last bits
    flips it, which says nothing about the optimizer;
  * whole steps are compared with plain SGD (momentum 0), whose update is
    linear in the gradient: params within lr · the gradient tolerance;
  * bf16 compute: total loss 2e-2 relative (bf16 rounds elsewhere in the two
    frameworks); remat (true and "conv"): the port against itself, rtol 2e-5
    as the JAX test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov3_tpu.io.checkpoint import _flatten as jax_flatten
from yolov3_tpu.models import network as jnet
from yolov3_tpu.models.spec import parse_model_config as jax_parse
from yolov3_tpu.models.transfer import trainable_mask as jax_trainable_mask
from yolov3_tpu.parallel import train_step as jts
from yolov3_tpu_torch.io.checkpoint import _flatten as port_flatten
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.models.convert import (params_from_jax, params_to_jax,
                                             train_state_from_jax, train_state_to_jax)
from yolov3_tpu_torch.models.spec import parse_model_config
from yolov3_tpu_torch.models.transfer import trainable_mask
from yolov3_tpu_torch.parallel import train_step as tts
from yolov3_tpu_torch.tree import tree_leaves, tree_map

from .conftest import REPO

ANCHORS = np.array([[0.1, 0.1], [0.2, 0.2], [0.3, 0.3],
                    [0.4, 0.4], [0.5, 0.5], [0.6, 0.6]], np.float32).reshape(2, 3, 2)
SIZE, BATCH, NC = 96, 4, 3
LR = 1e-2
GRAD_TOL = 2e-4   # of each leaf's largest entry
OPT_TOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, rtol, atol, scale_by_leaf_max=None, path=""):
    """Nested dicts / tuples of arrays, leaf by leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], rtol, atol, scale_by_leaf_max, f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, rtol, atol, scale_by_leaf_max, f"{path}/{i}")
    else:
        want = np.asarray(want)
        got = np.asarray(got)
        assert got.shape == want.shape, path
        if scale_by_leaf_max is not None:
            atol = scale_by_leaf_max * max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)


def make_setup(model):
    """Specs of ``model`` in both packages, seeded JAX weights with
    non-trivial BN carried across, numpy images and labels."""
    jspec, tspec = jax_parse(model, NC), parse_model_config(model, NC)
    jp, js = jnet.init_model(jax.random.PRNGKey(0), jspec)
    rng = np.random.RandomState(0)
    # non-trivial BN parameters and running statistics
    jp, js = _np(jp), _np(js)
    for sm, entries in jp.items():
        for key, e in entries.items():
            if "bn" in e:
                c = e["kernel"].shape[-1]
                e["bn"] = {"gamma": (rng.rand(c) + 0.5).astype(np.float32),
                           "beta": (rng.randn(c) * 0.1).astype(np.float32)}
                js[sm][key] = {"mean": (rng.randn(c) * 0.1).astype(np.float32),
                               "var": (rng.rand(c) + 0.5).astype(np.float32)}
    images = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    labels = np.zeros((BATCH, 10, 6), np.float32)
    for b in range(BATCH):
        for m in range(3):
            x0, y0 = rng.rand(2) * 0.6
            w, h = rng.rand(2) * 0.3 + 0.05
            labels[b, m] = [x0, y0, x0 + w, y0 + h, 1, rng.randint(NC)]
    grids = jnet.head_grid_sizes(jspec, SIZE)
    assert tnet.head_grid_sizes(tspec, SIZE) == grids
    tp, ts = params_from_jax(jp, js)
    return dict(jspec=jspec, tspec=tspec, jp=jp, js=js, tp=tp, ts=ts, images=images,
                labels=labels, grids=grids)


@pytest.fixture(scope="module")
def setup():
    return make_setup(f"{REPO}/config/models/yolov3_tiny/model.yaml")


@pytest.fixture(scope="module")
def jax_grads(setup):
    """One jitted JAX forward + backward, shared by the tests of this module."""
    s = setup

    @jax.jit
    def fn(params, bn, images, labels):
        (_, (new_bn, metrics)), grads = jax.value_and_grad(
            lambda p: jts._loss_and_metrics(s["jspec"], p, bn, images, labels,
                                            jnp.asarray(ANCHORS), s["grids"], BATCH, (), True),
            has_aux=True)(params)
        return grads, new_bn, metrics

    return _np(fn(s["jp"], s["js"], s["images"], s["labels"]))


def _port_grads(s, **kwargs):
    grads, new_bn, metrics = tts.loss_and_grads(
        s["tspec"], s["tp"], s["ts"], torch.from_numpy(s["images"]),
        torch.from_numpy(s["labels"]), ANCHORS, s["grids"], BATCH, **kwargs)
    g_np, bn_np = params_to_jax(grads, new_bn)
    return g_np, bn_np, {k: v.numpy() for k, v in metrics.items()}


def test_one_forward_backward_matches_jax(setup, jax_grads):
    jgrads, jbn, jmetrics = jax_grads
    g, bn, metrics = _port_grads(setup)
    assert set(metrics) == {"total_loss", "regularization", "per_grid", "per_source",
                            "per_grid_per_source"}
    _assert_trees_close(metrics, jmetrics, rtol=1e-5, atol=1e-4)
    _assert_trees_close(bn, jbn, rtol=1e-5, atol=1e-6)
    _assert_trees_close(g, jgrads, rtol=0, atol=None, scale_by_leaf_max=GRAD_TOL)
    assert len(jax.tree.leaves(g)) == len(jax.tree.leaves(jgrads)) == 37


def test_remat_gives_the_same_step_and_one_bn_update(setup):
    plain = _port_grads(setup)
    for mode in (True, "conv"):
        remat = _port_grads(setup, remat=mode)
        _assert_trees_close(remat[2], plain[2], rtol=2e-5, atol=0)
        _assert_trees_close(remat[0], plain[0], rtol=2e-5, atol=1e-7)
        # the new BN state is the first forward's: one momentum step from the
        # old one, bit-equal to no-remat, not a second step taken by the
        # recomputation
        for a, b in zip(jax.tree.leaves(remat[1]), jax.tree.leaves(plain[1])):
            np.testing.assert_array_equal(a, b)


def test_bf16_compute_keeps_f32_masters(setup, jax_grads):
    g, bn, metrics = _port_grads(setup, compute_dtype=torch.bfloat16)
    assert all(leaf.dtype == np.float32 for leaf in jax.tree.leaves(g))
    assert metrics["total_loss"].dtype == np.float32
    np.testing.assert_allclose(metrics["total_loss"], jax_grads[2]["total_loss"], rtol=2e-2)
    # L2 is taken on the f32 masters: bit-for-bit the fp32 run's
    np.testing.assert_allclose(metrics["regularization"], jax_grads[2]["regularization"],
                               rtol=1e-6)
    _assert_trees_close(bn, jax_grads[1], rtol=5e-2, atol=5e-3)


OPTIMIZERS = {
    "adam": dict(),
    "adam_clip": dict(grad_clip_norm=0.5),
    "adam_clip_inactive": dict(grad_clip_norm=1e9),
    "sgd": dict(optimizer="sgd"),
    "sgd_nesterov_clip": dict(grad_clip_norm=0.5,
                              optimizer={"type": "sgd", "momentum": 0.8, "nesterov": True}),
    "adam_scheduled": dict(scheduled=True),
    "sgd_scheduled_clip": dict(scheduled=True, grad_clip_norm=0.5, optimizer="sgd"),
}


def _make_pair(conf):
    conf = dict(conf)
    scheduled = conf.pop("scheduled", False)
    jmake = jts.make_adam_scheduled if scheduled else jts.make_adam
    tmake = tts.make_adam_scheduled if scheduled else tts.make_adam
    return (jmake(LR, conf.get("grad_clip_norm"), conf.get("optimizer")),
            tmake(LR, conf.get("grad_clip_norm"), conf.get("optimizer")))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_given_the_same_gradients(setup, jax_grads, name):
    """Three updates from the same gradients on both sides (the second and
    third scaled, so the moments and Adam's bias correction matter), the
    state carried across once by ``train_state_from_jax``."""
    jopt, topt = _make_pair(OPTIMIZERS[name])
    jstate = jts.init_train_state(setup["jp"], setup["js"], jopt)
    tstate = train_state_from_jax(_np(jstate), topt)
    jparams, jopt_state = jstate["params"], jstate["opt_state"]
    tparams, topt_state = tstate["params"], tstate["opt_state"]
    for factor in (1.0, -0.5, 3.0):
        jg = jax.tree.map(lambda g: jnp.asarray(g * factor), jax_grads[0])
        tg, _ = params_from_jax(_np(jg), {})
        updates, jopt_state = jopt.update(jg, jopt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        tparams, topt_state = topt.update(tg, topt_state, tparams)
    back = train_state_to_jax({"params": tparams, "bn_state": tstate["bn_state"],
                               "opt_state": topt_state, "step": tstate["step"]}, topt)
    _assert_trees_close(back["params"], _np(jparams), rtol=0, atol=OPT_TOL)
    _assert_trees_close(back["opt_state"], _np(jopt_state), rtol=1e-5, atol=OPT_TOL)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_train_state_keys_are_the_jax_checkpoint_layout(setup, name):
    """``train_state_to_jax`` nests the optimizer state as the JAX package's
    checkpoints flatten it: the same keys, shapes and dtypes, EMA included."""
    jopt, topt = _make_pair(OPTIMIZERS[name])
    jflat = jax_flatten(_np(jts.init_train_state(setup["jp"], setup["js"], jopt, ema=True)))
    tstate = tts.init_train_state(setup["tp"], setup["ts"], topt, ema=True)
    tflat = port_flatten(train_state_to_jax(tstate, topt))
    assert sorted(tflat) == sorted(jflat)
    for k in jflat:
        assert tflat[k].shape == jflat[k].shape and tflat[k].dtype == jflat[k].dtype, k
    again = train_state_from_jax(train_state_to_jax(tstate, topt), topt)
    for a, b in zip(tree_leaves(again["opt_state"]), tree_leaves(tstate["opt_state"])):
        assert torch.equal(a, b)


def test_optimizer_config_is_strict():
    with pytest.raises(ValueError, match="momentun"):
        tts.make_adam(1e-3, optimizer={"type": "sgd", "momentun": 0.9})
    with pytest.raises(ValueError, match="unknown optimizer type"):
        tts.make_adam(1e-3, optimizer="lion")
    with pytest.raises(ValueError, match="'type' key"):
        tts.make_adam(1e-3, optimizer={"momentum": 0.9})
    with pytest.raises(ValueError, match="positive"):
        tts.make_adam(1e-3, grad_clip_norm=-1)
    with pytest.raises(ValueError, match="momentum"):
        tts.make_adam(1e-3, optimizer={"type": "adam", "momentum": 0.9})
    assert tts.make_adam(1e-3, grad_clip_norm=0).grad_clip_norm is None


SGD0 = {"type": "sgd", "momentum": 0.0}


def _whole_step_pair(setup, **kwargs):
    """One whole step on both sides with plain SGD → (jax state, port state
    in JAX layout, jax metrics, port metrics)."""
    jkw, tkw = dict(kwargs), dict(kwargs)
    if "freeze" in kwargs:
        freeze = jkw.pop("freeze")
        tkw.pop("freeze")
        jkw["trainable_mask"] = jax_trainable_mask(setup["jp"], freeze)
        tkw["trainable_mask"] = trainable_mask(setup["tp"], freeze)
    ema = kwargs.get("ema_decay") is not None
    jopt, topt = jts.make_adam(LR, None, SGD0), tts.make_adam(LR, None, SGD0)
    jstep = jts.make_train_step(setup["jspec"], ANCHORS, setup["grids"], BATCH, jopt, **jkw)
    tstep = tts.make_train_step(setup["tspec"], ANCHORS, setup["grids"], BATCH, topt, **tkw)
    jstate = jts.init_train_state(setup["jp"], setup["js"], jopt, ema=ema)
    tstate = train_state_from_jax(_np(jstate), topt)
    jnew, jm = jstep(jstate, jnp.asarray(setup["images"]), jnp.asarray(setup["labels"]))
    tnew, tm = tstep(tstate, torch.from_numpy(setup["images"]), torch.from_numpy(setup["labels"]))
    return _np(jnew), train_state_to_jax(tnew, topt), _np(jm), {k: v.numpy()
                                                                for k, v in tm.items()}


def _assert_step_close(jnew, tnew, jm, tm, jgrads):
    _assert_trees_close(tm, jm, rtol=1e-5, atol=1e-4)
    _assert_trees_close(tnew["bn_state"], jnew["bn_state"], rtol=1e-5, atol=1e-6)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    # params moved by −lr·g: held to lr · the gradient tolerance per leaf
    for (path, t), j, g in zip(_paths(tnew["params"]), jax.tree.leaves(jnew["params"]),
                               jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(t, j, rtol=0, err_msg=path,
                                   atol=LR * GRAD_TOL * max(float(np.abs(g).max()), 1e-9) + 1e-7)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_whole_step_with_mask_and_ema_matches_jax(setup, jax_grads):
    """freeze_train_list=['backbone'] and an EMA shadow in one step: frozen
    leaves do not move at all, the rest move by −lr·g, the shadow follows the
    step count BEFORE the update (warm-up decay (1+0)/(10+0))."""
    jnew, tnew, jm, tm = _whole_step_pair(setup, freeze=["backbone"], ema_decay=0.999)
    _assert_step_close(jnew, tnew, jm, tm, jax_grads[0])
    t0, _ = params_to_jax(setup["tp"], {})
    for key, entry in tnew["params"]["backbone"].items():
        np.testing.assert_array_equal(entry["kernel"], t0["backbone"][key]["kernel"])
    moved = tnew["params"]["head0"]["layer2"]["kernel"] - t0["head0"]["layer2"]["kernel"]
    assert float(np.abs(moved).max()) > 0
    # the shadow moved by 0.9 · (new − old): the params' tolerance carries over
    _assert_trees_close(tnew["ema"], jnew["ema"], rtol=1e-5, atol=5e-6)


def test_accum_steps_split_strided_and_thread_bn_state(setup, jax_grads):
    jnew, tnew, jm, tm = _whole_step_pair(setup, accum_steps=2)
    # the averaged microbatch gradients are not the full-batch gradients
    # (BatchNorm sees two images at a time): compare against JAX's own accum run
    _assert_trees_close(tm, jm, rtol=1e-5, atol=1e-4)
    _assert_trees_close(tnew["bn_state"], jnew["bn_state"], rtol=1e-5, atol=1e-6)
    _assert_trees_close(tnew["params"], jnew["params"], rtol=0, atol=LR * 5e-3)
    assert abs(float(tm["total_loss"]) - float(jax_grads[2]["total_loss"])) > 1e-3
    with pytest.raises(ValueError, match="not divisible"):
        tts.make_train_step(setup["tspec"], ANCHORS, setup["grids"], BATCH,
                            tts.make_adam(LR), accum_steps=3)


def test_eval_step_matches_jax(setup):
    jstep = jts.make_eval_step(setup["jspec"], ANCHORS, setup["grids"], BATCH)
    tstep = tts.make_eval_step(setup["tspec"], ANCHORS, setup["grids"], BATCH)
    jm = _np(jstep(setup["jp"], setup["js"], jnp.asarray(setup["images"]),
                   jnp.asarray(setup["labels"])))
    tm = tstep(setup["tp"], setup["ts"], torch.from_numpy(setup["images"]),
               torch.from_numpy(setup["labels"]))
    assert not any(v.requires_grad for v in tm.values())
    _assert_trees_close({k: v.numpy() for k, v in tm.items()}, jm, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("step,decay,warmup", [(0, 0.999, True), (7, 0.999, True),
                                               (500, 0.9, True), (3, 0.5, False)])
def test_ema_update_matches_jax(step, decay, warmup):
    rng = np.random.RandomState(step)
    ema = {"a": {"w": rng.randn(3, 4).astype(np.float32)}, "b": rng.randn(5).astype(np.float32)}
    new = jax.tree.map(lambda x: (x + rng.randn(*x.shape)).astype(np.float32), ema)
    want = _np(jts.ema_update(jax.tree.map(jnp.asarray, ema), jax.tree.map(jnp.asarray, new),
                              decay, jnp.asarray(step, jnp.int32), warmup=warmup))
    to_t = lambda tree: tree_map(torch.from_numpy, tree)  # noqa: E731
    got = tts.ema_update(to_t(ema), to_t(new), decay, torch.tensor(step, dtype=torch.int32),
                         warmup=warmup)
    _assert_trees_close(tree_map(lambda t: t.numpy(), got), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("schedule", ["cosine", {"type": "cosine", "warmup_epochs": 3},
                                      {"type": "cosine", "warmup_epochs": 2,
                                       "min_lr_fraction": 0.1}])
def test_epoch_learning_rate_numbers(schedule):
    for epoch in range(1, 13):
        assert tts.epoch_learning_rate(1e-3, epoch, 12, schedule) == \
            jts.epoch_learning_rate(1e-3, epoch, 12, schedule)
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        tts.epoch_learning_rate(1e-3, 1, 10, "linear")


def test_scheduled_learning_rate_is_read_from_the_state(setup, jax_grads):
    topt = tts.make_adam_scheduled(LR, None, SGD0)
    state = topt.init(setup["tp"])
    state["learning_rate"] = torch.tensor(0.5, dtype=torch.float32)
    grads, _ = params_from_jax(jax_grads[0], {})
    new_params, new_state = topt.update(grads, state, setup["tp"])
    k0, g0 = setup["tp"]["head0"]["layer2"]["kernel"], grads["head0"]["layer2"]["kernel"]
    torch.testing.assert_close(new_params["head0"]["layer2"]["kernel"], k0 - 0.5 * g0)
    assert int(new_state["inject_count"]) == 1


@pytest.mark.parametrize("key", ["mesh"])
def test_later_slices_raise_by_name(setup, key, tmp_path):
    """``mesh`` is ported (parallel/mesh.py): over a process group of this
    process alone the data-parallel step (sync-BN, the coalesced gradient
    and metric all-reduces) is the plain step bit for bit; a serving mesh
    (several devices of one process) is refused by name."""
    from yolov3_tpu_torch.parallel import mesh as tmesh

    from .test_torch_multihost import one_process_group

    optimizer = tts.make_adam(LR)
    images, labels = torch.from_numpy(setup["images"]), torch.from_numpy(setup["labels"])
    plain = tts.make_train_step(setup["tspec"], ANCHORS, setup["grids"], BATCH, optimizer)
    want = plain(tts.init_train_state(setup["tp"], setup["ts"], optimizer), images, labels)
    with one_process_group(tmp_path):
        step = tts.make_train_step(setup["tspec"], ANCHORS, setup["grids"], BATCH, optimizer,
                                   **{key: tmesh.make_mesh(devices=("cpu",))})
        got = step(tts.init_train_state(setup["tp"], setup["ts"], optimizer), images, labels)
    for g, w in zip(got, want):  # (train state, metrics)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g), tree_leaves(w)))
    with pytest.raises(ValueError, match="one process per device"):
        tts.make_train_step(setup["tspec"], ANCHORS, setup["grids"], BATCH, optimizer,
                            **{key: tmesh.Mesh(("cpu", "cpu"))})
