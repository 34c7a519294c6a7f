"""Train / eval steps: assignment + forward + loss + gradients + update.

Counterpart of ``yolov3_tpu/parallel/train_step.py``. What the JAX package
compiles into one jit runs eagerly here: target assignment on the device, the
forward (training-mode BatchNorm through the K5 kernels on the card), the
4-term loss, L2 regularization, ``torch.autograd.grad``, and the optimizer
update. fp32 (no ``compute_dtype``) runs in IEEE fp32 on the card
(``device.pin_fp32_ieee``).

With a ``mesh`` (``parallel/mesh.py``: one process per card, joined by a
process group) each rank steps on its shard of the global batch and the step
computes what the JAX package's SPMD step computes over the whole batch:
BatchNorm's statistics are the global batch's (sync-BN through K5), each
rank's loss is ``Σ terms_local / b_local + L2`` and the gradients are
averaged over the ranks by one coalesced all-reduce, so L2 counts once and
the terms are divided by the global batch; the trainable mask, the clip, the
optimizer and the EMA then run on every rank on the same averaged gradients,
which keeps every rank's state identical. The metrics are averaged too.

With a spatial axis (``mesh.spatial`` > 1: this process's ``spatial`` band
devices, ``parallel/spatial.py``) each image of the rank's shard is split
into bands of rows once, on the device, after augmentation and the
microbatch split; the forward runs band by band with halo exchanges,
BatchNorm's statistics add every band's K5 sums (and all-reduce over the
process group), and the heads are gathered on the first band's device, so
assignment and loss run on whole grids as unsharded. Autograd sums each
weight's gradient over the bands; the ranks' average follows as above.

Each step runs inside the span ``S|step`` (``utils/profiling.py::span``:
a profiler range while a profiler runs, always a host-clock record), its
phases inside spans of their own: ``S|anchors`` (the anchors' copy to the
device; from pageable host memory, so on the card it waits until the
device has run what was queued before it), ``S|augment``, ``S|assign``
(``assign_targets``), ``S|forward`` (QAT and mixed-precision casts through
the heads), ``S|loss`` (the terms, L2 and the metrics), ``S|backward``
(``torch.autograd.grad`` and the zero-fill of unused gradients),
``S|allreduce`` (under a process group) and ``S|optimizer`` (the trainable
mask, the update and the EMA). With ``accum_steps`` > 1 assign, forward,
loss and backward repeat under one ``S|step``. An eval step's phases run
under ``S|eval``.

The optimizer is the port's own small functional one over the param dicts,
because three details of the JAX package's optimizers differ from
``torch.optim`` / ``torch.nn.utils``: Adam adds ``eps=1e-7`` outside the
root of the bias-corrected second moment; the global-norm clip scales by
``max_norm / norm`` only when ``norm ≥ max_norm`` and adds no epsilon; SGD's
momentum is the trace ``t = g + m·t`` (Nesterov: ``g + m·t_new``).

Train state (a dict): ``params`` and ``bn_state`` trees on the device,
``opt_state`` (a dict, see ``Optimizer.init``), ``step`` (0-d int32 CPU
tensor: counters and the learning rate live on the host, so reading them
never waits for the device), and ``ema`` when asked for. A step returns a new
state and leaves the old one's tensors untouched.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import pin_fp32_ieee
from ..models.network import apply_model, l2_regularization
from ..ops.assign import assign_targets
from ..ops.augment import apply_augment, draw_augment, step_generator
from ..ops.loss import yolo_loss_terms
from ..ops.quantize import fake_quant_weights, make_activation_fake_quant
from ..tree import tree_leaves, tree_map, tree_unflatten
from ..utils.profiling import span

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-7


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _optimizer_conf(optimizer):
    """(kind, momentum, nesterov) from the ``optimizer`` config value; strict
    keys, so a typo raises instead of silently taking a default."""
    conf = ({"type": optimizer} if isinstance(optimizer, str)
            else dict(optimizer) if optimizer else {"type": "adam"})
    if "type" not in conf:
        raise ValueError(f"optimizer config needs a 'type' key (adam | sgd), got {conf}")
    kind = str(conf.pop("type")).lower()
    if kind == "adam":
        allowed = set()
    elif kind == "sgd":
        allowed = {"momentum", "nesterov"}
    else:
        raise ValueError(f"unknown optimizer type {kind!r} (adam | sgd)")
    unknown = set(conf) - allowed
    if unknown:
        raise ValueError(f"unknown {kind} optimizer keys {sorted(unknown)} "
                         f"(allowed: {sorted(allowed)})")
    return kind, float(conf.get("momentum", 0.9)), bool(conf.get("nesterov", False))


def _f32(value) -> float:
    """A Python float that is exactly the float32 nearest to ``value``."""
    return float(np.float32(value))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam (Keras defaults: b1 0.9, b2 0.999, eps 1e-7) or SGD with a
    momentum trace, optionally behind a global-norm clip, optionally with the
    learning rate as a value of the state (``scheduled``)."""

    kind: str
    learning_rate: float
    momentum: float = 0.9
    nesterov: bool = False
    grad_clip_norm: float | None = None
    scheduled: bool = False

    def init(self, params):
        """``{"count", "mu", "nu"}`` (Adam) or ``{"trace"}`` (SGD), plus
        ``{"inject_count", "learning_rate"}`` when scheduled. Counters and the
        learning rate are 0-d CPU tensors."""
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        if self.kind == "adam":
            state = {"count": torch.zeros((), dtype=torch.int32), "mu": zeros(), "nu": zeros()}
        else:
            state = {"trace": zeros()}
        if self.scheduled:
            state["inject_count"] = torch.zeros((), dtype=torch.int32)
            state["learning_rate"] = torch.tensor(self.learning_rate, dtype=torch.float32)
        return state

    def update(self, grads, opt_state, params):
        """One update → ``(new_params, new_opt_state)``."""
        g = tree_leaves(grads)
        p = tree_leaves(params)
        new_state = dict(opt_state)
        if self.grad_clip_norm:
            g = _clip_by_global_norm(g, self.grad_clip_norm)
        lr = (float(opt_state["learning_rate"]) if self.scheduled
              else _f32(self.learning_rate))
        if self.kind == "adam":
            count = opt_state["count"] + 1
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - ADAM_B1),
                                    torch._foreach_mul(tree_leaves(opt_state["mu"]), ADAM_B1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - ADAM_B2),
                torch._foreach_mul(tree_leaves(opt_state["nu"]), ADAM_B2))
            # bias corrections in f32 on the host, as 1 − decay**count
            c = count.to(torch.float32)
            bc1 = float(1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** c)
            bc2 = float(1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** c)
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)),
                                       ADAM_EPS)
            updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            new_state.update(count=count, mu=tree_unflatten(params, mu),
                             nu=tree_unflatten(params, nu))
        else:
            trace = torch._foreach_add(
                g, torch._foreach_mul(tree_leaves(opt_state["trace"]), self.momentum))
            updates = (torch._foreach_add(g, torch._foreach_mul(trace, self.momentum))
                       if self.nesterov else trace)
            new_state["trace"] = tree_unflatten(params, trace)
        new_p = torch._foreach_add(p, torch._foreach_mul(updates, -lr))
        if self.scheduled:
            new_state["inject_count"] = opt_state["inject_count"] + 1
        return tree_unflatten(params, new_p), new_state


def _clip_by_global_norm(grads, max_norm: float):
    """Scale by ``max_norm / norm`` only when ``norm ≥ max_norm``; the
    decision stays on the device (a ``where``), nothing waits for it."""
    norm = torch.sqrt(torch.stack([torch.sum(torch.square(x)) for x in grads]).sum())
    keep = norm < max_norm
    return [torch.where(keep, x, (x / norm) * max_norm) for x in grads]


def _make_optimizer(learning_rate, grad_clip_norm, optimizer, scheduled):
    kind, momentum, nesterov = _optimizer_conf(optimizer)
    if grad_clip_norm and float(grad_clip_norm) < 0:
        raise ValueError(f"grad_clip_norm must be positive, got {grad_clip_norm}")
    return Optimizer(kind, float(learning_rate), momentum, nesterov,
                     float(grad_clip_norm) if grad_clip_norm else None, scheduled)


def make_adam(learning_rate: float, grad_clip_norm=None, optimizer=None) -> Optimizer:
    """Keras-default Adam, or SGD via ``optimizer: sgd`` / ``{type: sgd,
    momentum, nesterov}``; ``grad_clip_norm`` clips the global gradient norm
    before the update (None/0 = off)."""
    return _make_optimizer(learning_rate, grad_clip_norm, optimizer, False)


def make_adam_scheduled(learning_rate: float, grad_clip_norm=None, optimizer=None) -> Optimizer:
    """Like ``make_adam`` with the learning rate kept in the optimizer state
    (``opt_state["learning_rate"]``), which the train app sets per epoch."""
    return _make_optimizer(learning_rate, grad_clip_norm, optimizer, True)


def epoch_learning_rate(base_lr: float, epoch: int, epochs: int, schedule) -> float:
    """Epoch-keyed LR schedule (epoch is 1-based).

    ``schedule``: "cosine" or {type: cosine, warmup_epochs: W,
    min_lr_fraction: f}. Warmup ramps linearly over the first W epochs;
    cosine decays from base_lr to f·base_lr over the remainder.
    """
    conf = {"type": schedule} if isinstance(schedule, str) else dict(schedule)
    kind = conf.get("type", "cosine")
    if kind != "cosine":
        raise ValueError(f"unknown lr_schedule type {kind!r}")
    warmup = int(conf.get("warmup_epochs", 0))
    min_frac = float(conf.get("min_lr_fraction", 0.01))
    if warmup and epoch <= warmup:
        return base_lr * epoch / warmup
    # first post-warmup epoch at full LR, final epoch at the floor
    span = max(epochs - warmup - 1, 1)
    progress = min(max(epoch - warmup - 1, 0) / span, 1.0)
    cos = 0.5 * (1.0 + np.cos(np.pi * progress))
    return base_lr * (min_frac + (1.0 - min_frac) * cos)


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------


def init_train_state(params, state, optimizer: Optimizer, ema: bool = False):
    """Own copies of ``params`` / ``state`` (on their device), a fresh
    optimizer state, step 0 and, with ``ema``, the shadow seeded at the
    initial weights."""
    clone = lambda t: t.detach().clone()  # noqa: E731
    params = tree_map(clone, params)
    state = tree_map(clone, state)
    ts = {"params": params, "bn_state": state, "opt_state": optimizer.init(params),
          "step": torch.zeros((), dtype=torch.int32)}
    if ema:
        ts["ema"] = {"params": tree_map(clone, params), "bn_state": tree_map(clone, state)}
    return ts


def ema_update(ema, new, decay, step, warmup: bool = True):
    """One exponential-moving-average step over a tree: ``e + (1−d)·(n − e)``.

    With ``warmup`` the effective decay is ``min(decay, (1+t)/(10+t))``, so
    early steps track the young weights instead of the random init. ``step``
    is the number of completed updates BEFORE this one (0-based)."""
    d = torch.tensor(decay, dtype=torch.float32)
    if warmup:
        t = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
        d = torch.minimum(d, (1.0 + t) / (10.0 + t))
    one_minus_d = float(1.0 - d)
    e = tree_leaves(ema)
    n = [x.to(dtype=y.dtype) for x, y in zip(tree_leaves(new), e)]
    out = torch._foreach_add(e, torch._foreach_mul(torch._foreach_sub(n, e), one_minus_d))
    return tree_unflatten(ema, out)


# ---------------------------------------------------------------------------
# loss and steps
# ---------------------------------------------------------------------------


def _loss_and_metrics(spec, params, bn_state, images, labels, anchors_table, grid_sizes,
                      batch_size, bn_frozen, train, compute_dtype=None, remat=False, qat=False,
                      qat_min_k2cin=0, bn_stats_subsample=1, bn_group=None, bands=None):
    """→ ``(total, (new_bn_state, metrics))``; total = Σ terms / batch + L2
    on the master weights, everything after the heads in f32. ``bn_group``:
    sync-BN's process group (``apply_model``). ``bands``: the band devices
    of a spatial split (``apply_model``'s ``devices``), or None.

    ``qat``: 'weights' (or True) fake-quants the conv kernels, 'activations'
    the conv inputs, 'full' both (``ops/quantize.py``), before the
    mixed-precision cast, so the rounding happens in f32; L2 still reads the
    masters."""
    with span("S|assign"):
        y_true = assign_targets(labels, anchors_table, grid_sizes)
    params_master = params
    with span("S|forward"):
        act_transform = None
        if qat:
            if qat in ("weights", "full", True):
                params = fake_quant_weights(spec, params, min_k2cin=qat_min_k2cin)
            if qat in ("full", "activations"):
                act_transform = make_activation_fake_quant(spec, min_k2cin=qat_min_k2cin)
        if compute_dtype is not None:
            # mixed precision: the casts sit inside the differentiated graph,
            # so the gradients come back f32 at the f32 masters
            images = images.to(compute_dtype)
            params_c = tree_map(lambda x: x.to(compute_dtype), params)
        else:
            params_c = params
        if train:
            outputs, new_bn = apply_model(spec, params_c, bn_state, images, train=True,
                                          bn_frozen=bn_frozen, remat=remat,
                                          conv_input_transform=act_transform,
                                          bn_stats_subsample=bn_stats_subsample,
                                          bn_group=bn_group, devices=bands)
        else:
            outputs, new_bn = (apply_model(spec, params_c, bn_state, images, devices=bands),
                               bn_state)
    with span("S|loss"):
        terms = torch.stack([
            yolo_loss_terms(t, p, anchors_table[i], spec.nclasses) / batch_size
            for i, (t, p) in enumerate(zip(y_true, outputs))])  # (nscales, 4) [xy, wh, obj, class]
        reg = l2_regularization(params_master, spec.decay_factor)
        total = torch.sum(terms) + reg
        metrics = {
            "total_loss": total,
            "regularization": reg,
            "per_grid": torch.sum(terms, dim=1),      # (nscales,)
            "per_source": torch.sum(terms, dim=0),    # (4,) [xy, wh, obj, class]
            "per_grid_per_source": terms,             # (nscales, 4)
        }
    return total, (new_bn, metrics)


def loss_and_grads(spec, params, bn_state, images, labels, anchors_table, grid_sizes,
                   batch_size, bn_frozen=(), compute_dtype=None, remat=False, qat=False,
                   qat_min_k2cin=0, bn_stats_subsample=1, bn_group=None, bands=None):
    """One training forward and backward → ``(grads, new_bn_state, metrics)``:
    the gradient of the total loss w.r.t. every leaf of ``params`` (a tree
    like ``params``, f32 at the f32 masters), the BatchNorm state after this
    batch, and the detached metrics. ``bands``: see ``_loss_and_metrics``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    total, (new_bn, metrics) = _loss_and_metrics(
        spec, tree_unflatten(params, leaves), bn_state, images, labels, anchors_table,
        tuple(int(g) for g in grid_sizes), batch_size, tuple(bn_frozen), True,
        compute_dtype, remat, qat, qat_min_k2cin, bn_stats_subsample, bn_group, bands)
    with span("S|backward"):
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return (tree_unflatten(params, grads), new_bn,
            tree_map(lambda m: m.detach(), metrics))


def _local_batch(batch_size: int, mesh):
    """This rank's share of the global ``batch_size`` under ``mesh`` (None:
    the whole batch); raises for a mesh the step cannot run on."""
    if mesh is None:
        return batch_size
    if len(mesh.devices) != mesh.spatial:
        raise ValueError(
            f"data-parallel training runs one process per device (one spatial group of "
            f"{mesh.spatial}); this mesh holds {len(mesh.devices)} devices of one process "
            "(a serving mesh)")
    if batch_size % mesh.world_size:
        raise ValueError(f"batch_size ({batch_size}) must divide over the data axis "
                         f"({mesh.world_size} processes)")
    return batch_size // mesh.world_size


def _split(mesh):
    """(data-parallel mesh or None, band devices or None) of a step's mesh:
    the first when it has a process group, the second when it has a spatial
    axis."""
    if mesh is None:
        return None, None
    return (mesh if mesh.group is not None else None,
            mesh.replicas[0] if mesh.spatial > 1 else None)


def _check_local(images, local: int, mesh):
    if mesh is not None and images.shape[0] != local:
        raise ValueError(f"this rank's batch has {images.shape[0]} images; its shard of the "
                         f"global batch is {local}")


def make_train_step(spec, anchors_table, grid_sizes, batch_size, optimizer: Optimizer,
                    mesh=None, bn_frozen=(), trainable_mask=None, compute_dtype=None,
                    remat=False, augment=None, seed=0, accum_steps: int = 1, qat=False,
                    qat_min_k2cin: int = 0, ema_decay=None, ema_warmup: bool = True,
                    bn_stats_subsample: int = 1):
    """Returns ``step(train_state, images, labels) → (train_state, metrics)``.

    ``images`` (B, H, W, 3) and ``labels`` (B, M, 6) are float tensors on the
    device of the params. ``trainable_mask``: optional tree of bools matching
    params; False leaves get a zero gradient, multiplied in BEFORE the clip
    and the update (with Adam a zero gradient gives an exactly-zero update).
    ``compute_dtype`` (``torch.bfloat16``): forward and backward in that type
    against f32 master weights. ``remat``: see ``apply_model``.
    ``augment``: None, or a dict of ``ops/augment.py::draw_augment`` options:
    each step augments its batch on the device with draws keyed by
    (``seed``, the state's step), before the microbatch split.
    ``accum_steps``: the batch splits strided (element i → microbatch
    i % accum), the BN state threads through the microbatches, gradients and
    metrics are averaged. ``qat``: False | True/'weights' | 'activations' |
    'full' (see ``_loss_and_metrics``), skipping the convs the int8 serving
    tier skips at ``qat_min_k2cin``. ``ema_decay``: keep
    ``train_state["ema"]`` (``init_train_state(ema=True)``).
    ``bn_stats_subsample``: see ``layers.batch_norm``. The metrics are
    detached tensors on the device.

    ``mesh`` (``parallel/mesh.py::make_mesh``): data parallelism under a
    process group, and a spatial split over ``mesh.spatial`` band devices of
    this process, see the module's docstring. ``batch_size`` stays the global
    batch; each rank passes its ``local_batch_slice`` of it. Augmentation
    draws once for the global batch and each rank takes its slice of the
    draws (mosaic, whose composites mix images across the batch, augments
    the gathered global batch and keeps the rank's slice). ``accum_steps``
    must divide the local batch, so that microbatch k of every rank together
    is the global microbatch k.
    """
    aug_options = None if augment is None else dict(augment)
    if aug_options is not None:
        draw_augment(batch_size, step_generator(seed, 0), **aug_options)  # options checked now
    grid_sizes = tuple(int(g) for g in grid_sizes)
    bn_frozen = tuple(bn_frozen)
    local = _local_batch(batch_size, mesh)
    dp, bands = _split(mesh)
    group = None if dp is None else dp.group
    if accum_steps > 1 and local % accum_steps:
        raise ValueError(f"batch {local} not divisible by accum_steps {accum_steps}"
                         + (f" (this rank's shard of {batch_size})" if dp is not None else ""))
    micro = local // accum_steps
    mask_leaves = (None if trainable_mask is None
                   else [float(bool(m)) for m in tree_leaves(trainable_mask)])

    def grads_of(params, bn_state, images, labels, anchors, divisor):
        grads, new_bn, metrics = loss_and_grads(
            spec, params, bn_state, images, labels, anchors, grid_sizes, divisor,
            bn_frozen=bn_frozen, compute_dtype=compute_dtype, remat=remat, qat=qat,
            qat_min_k2cin=qat_min_k2cin, bn_stats_subsample=bn_stats_subsample,
            bn_group=group, bands=bands)
        return tree_leaves(grads), new_bn, metrics

    def augmented(images, labels, step_index):
        gen = step_generator(seed, step_index)
        if dp is None:
            return apply_augment(images, labels, draw_augment(images.shape[0], gen,
                                                              **aug_options))
        draws = draw_augment(batch_size, gen, **aug_options)
        rows = dp.local_slice(batch_size)
        if "mosaic_take" in draws:
            images, labels = apply_augment(dp.all_gather_batch(images),
                                           dp.all_gather_batch(labels), draws)
            return images[rows], labels[rows]
        return apply_augment(images, labels, {k: v[rows] for k, v in draws.items()})

    anchors_np = np.asarray(anchors_table, np.float32)

    def step(train_state, images, labels):
        with span("S|step"):
            return _step(train_state, images, labels)

    def _step(train_state, images, labels):
        _check_local(images, local, mesh)
        if compute_dtype is None:
            for dev in bands or (images.device,):
                pin_fp32_ieee(dev)
        params = train_state["params"]
        with span("S|anchors"):
            anchors = torch.as_tensor(anchors_np, device=images.device)
        if aug_options is not None:
            with span("S|augment"):
                images, labels = augmented(images, labels, int(train_state["step"]))
        if accum_steps > 1:
            bn, grads, metrics = train_state["bn_state"], None, None
            for k in range(accum_steps):
                g, bn, m = grads_of(params, bn, images[k::accum_steps],
                                    labels[k::accum_steps], anchors, micro)
                grads = g if grads is None else torch._foreach_add(grads, g)
                metrics = m if metrics is None else tree_map(torch.add, metrics, m)
            grads = torch._foreach_div(grads, accum_steps)
            metrics = tree_map(lambda m: m / accum_steps, metrics)
            new_bn = bn
        else:
            grads, new_bn, metrics = grads_of(params, train_state["bn_state"], images, labels,
                                              anchors, local)
        if dp is not None:
            with span("S|allreduce"):
                grads = dp.all_reduce_mean(grads)
                metrics = tree_unflatten(metrics, dp.all_reduce_mean(tree_leaves(metrics)))
        with span("S|optimizer"), torch.no_grad():
            if mask_leaves is not None:
                grads = [g * m for g, m in zip(grads, mask_leaves)]
            new_params, new_opt_state = optimizer.update(
                tree_unflatten(params, grads), train_state["opt_state"], params)
            new_train_state = {"params": new_params, "bn_state": new_bn,
                               "opt_state": new_opt_state, "step": train_state["step"] + 1}
            if ema_decay is not None:
                new_train_state["ema"] = ema_update(
                    train_state["ema"], {"params": new_params, "bn_state": new_bn},
                    ema_decay, train_state["step"], warmup=ema_warmup)
        return new_train_state, metrics

    return step


def make_eval_step(spec, anchors_table, grid_sizes, batch_size, mesh=None, bn_frozen=()):
    """Validation loss step (no update): ``step(params, bn_state, images,
    labels) → metrics``. With a ``mesh`` each rank passes its shard of the
    global ``batch_size`` and the metrics are averaged over the ranks; a
    spatial axis splits the images into bands, as in ``make_train_step``."""
    local = _local_batch(batch_size, mesh)
    dp, bands = _split(mesh)
    anchors_np = np.asarray(anchors_table, np.float32)
    grid_sizes = tuple(int(g) for g in grid_sizes)

    @torch.no_grad()
    def step(params, bn_state, images, labels):
        with span("S|eval"):
            _check_local(images, local, mesh)
            with span("S|anchors"):
                anchors = torch.as_tensor(anchors_np, device=images.device)
            _, (_, metrics) = _loss_and_metrics(spec, params, bn_state, images, labels,
                                                anchors, grid_sizes, local, tuple(bn_frozen),
                                                False, bands=bands)
            if dp is not None:
                with span("S|allreduce"):
                    metrics = tree_unflatten(metrics,
                                             dp.all_reduce_mean(tree_leaves(metrics)))
            return metrics

    return step
