"""Train application — the reference train.py surface on PyTorch and one CUDA card.

Counterpart of ``yolov3_tpu/apps/train_app.py``. Accepts the same
train_config.yaml schema (keys splatted into ``Train()``) and reproduces the
observable behaviour: model summary dump beside the checkpoints,
``dataset_example.png`` in the working directory (``render_dataset_example``),
the transfer-learning dispatch, per-batch loss logging in ``eager_tf`` mode,
periodic and final weight saving, a validation pass per epoch, early
stopping on val_loss with best-weights restore, full-state resume, EMA shadow
weights, and the JAX trainer's extensions: ``augmentation`` (on the device,
``ops/augment.py``), ``qat`` (fake quantization, ``ops/quantize.py``),
``stem_s2d`` (``ops/s2d.py::s2d_stem_train``), ``multi_scale`` (per epoch or
per N steps, cycle or random), ``device_dataset`` (f32 or uint8),
``bn_stats_subsample``, ``remat: conv``, ``tensorboard`` scalars, a
``profile_trace_dir`` trace of the first epoch, data parallelism over
processes (``multihost``, ``parallel/mesh.py``) and the spatial split of
image rows (``spatial_partitioning``, ``parallel/spatial.py``).

Differences, by design:
  * the step runs eagerly; one process drives one device — the card unless
    the config says ``device: cpu``. Data parallelism runs one process per
    card (``torchrun --nproc_per_node N`` with ``multihost: true``, or the
    ``multihost`` dict with ``coordinator_address`` / ``num_processes`` /
    ``process_id`` and optionally ``backend``); the JAX package drives all
    local devices from one process. The math is the same: every process
    iterates the same dataset and steps on its ``local_batch_slice`` of each
    global batch, BatchNorm syncs, gradients average, and only rank 0 writes
    (summary, checkpoints, train state, TensorBoard, profiler trace);
  * checkpoints are the JAX package's native ``.npz`` files, so either
    package loads the other's weights and resumes the other's train state;
  * ``spatial_partitioning: S`` splits each image into S bands of rows
    inside the process, on S cards from the process's own when it is alone
    and they exist, else all on its device (one card, or the CPU); the JAX
    package's checks and messages, and its single-host rule for a process
    group that spans hosts;
  * ``bn_stats_subsample`` is an argument threaded down to ``batch_norm``,
    not a process-wide setting, and the profiler trace is ``torch.profiler``'s.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..config import count_file_lines, get_anchors
from ..data.native_build import ensure_native_library
from ..data.pipeline import Batcher, DeviceDataset, DevicePrefetcher, batched, create_dataset
from ..device import resolve_device
from ..io.checkpoint import checkpoint_keys, load_train_state, save_train_state
from ..io.resolve import load_weights, native_path, save_weights
from ..models import init_model, parse_model_config
from ..models.network import head_grid_sizes, to_device
from ..models.transfer import bn_frozen_selectors, do_transfer_learning, expand_transfer_list
from ..models.transfer import trainable_mask as make_trainable_mask
from ..ops.image import resize_antialiased
from ..ops.s2d import s2d_stem_train
from ..parallel.mesh import initialize_multihost, make_mesh
from ..parallel.spatial import band_starts, total_stride
from ..parallel.train_step import (epoch_learning_rate, init_train_state, make_adam,
                                   make_adam_scheduled, make_eval_step, make_train_step)
from ..tree import tree_map
from ..utils.profiling import StepTimer, trace

log = logging.getLogger(__name__)

def band_cards(dev, spatial: int, alone: bool):
    """The devices a training process lays its bands on: ``spatial`` cards
    from ``dev``'s when the process is ``alone`` (no process group) and they
    exist, else ``dev`` (which then holds every band, ``mesh.spatial_devices``)."""
    if alone and dev.type == "cuda" and (dev.index or 0) + spatial <= torch.cuda.device_count():
        return tuple(torch.device("cuda", (dev.index or 0) + k) for k in range(spatial))
    return (dev,)


def parse_qat_mode(qat_conf):
    """Normalize the `qat` config key (extension) to
    False | 'weights' | 'activations' | 'full'.

    `true`/`'weights'` → weight-only QAT; `'full'` (or
    `{weights: true, activations: true}`) → also fake-quant conv-input
    activations on the int8_chain serving lattice (parallel/train_step.py);
    `'activations'` (or `{weights: false, activations: true}`) →
    activation fake-quant only, weights stay fp.
    """
    if isinstance(qat_conf, dict):
        weights = qat_conf.get("weights", True)
        activations = qat_conf.get("activations", False)
        if activations:
            return "full" if weights else "activations"
        return "weights" if weights else False
    if isinstance(qat_conf, str):
        mode = qat_conf.strip().lower()
        if mode not in ("weights", "activations", "full"):
            raise ValueError(
                f"qat must be true, 'weights', 'activations', or 'full', got {qat_conf!r}")
        return mode
    return "weights" if qat_conf else False


def parse_qat_min_k2cin(qat_conf) -> int:
    """`qat: {..., min_k2cin: N}` — mirror the serving tier's
    mixed-precision threshold (quantize_params' min_k2cin) in the QAT
    lattice, so training skips the same convs serving keeps in bf16."""
    if isinstance(qat_conf, dict):
        return int(qat_conf.get("min_k2cin", 0) or 0)
    return 0


def parse_multi_scale(multi_scale, device_dataset):
    """The ``multi_scale`` config value → (sizes, mode, interval): ``[s, …]``
    or ``{sizes, mode: cycle|random, interval: epoch|N steps}``; a step
    interval needs ``device_dataset``. The sizes' divisibility is checked by
    the caller, which knows the model."""
    conf = ({"sizes": list(multi_scale)} if isinstance(multi_scale, (list, tuple))
            else dict(multi_scale))
    sizes = [int(v) for v in conf["sizes"]]
    mode = conf.get("mode", "cycle")
    if mode not in ("cycle", "random"):
        raise ValueError(f"multi_scale mode must be cycle|random, got {mode!r}")
    interval = conf.get("interval", "epoch")
    if interval != "epoch":
        interval = int(interval)
        if interval < 1:
            raise ValueError(
                f"multi_scale interval must be 'epoch' or a positive "
                f"step count, got {interval}")
        if not device_dataset:
            raise ValueError(
                "multi_scale interval in steps requires "
                "device_dataset (the split is staged once at "
                "image_size and resized per batch on device)")
    return sizes, mode, interval


def ms_size_for(sizes, mode, seed, epoch):
    """The image size of ``epoch`` (1-based) under per-epoch multi-scale:
    cycling, or drawn from a RandomState keyed by (seed, epoch) so a resumed
    run picks the sizes it would have picked without the restart."""
    if mode == "random":
        r = np.random.RandomState(seed * 100003 + epoch)
        return sizes[int(r.randint(len(sizes)))]
    return sizes[(epoch - 1) % len(sizes)]


def ms_size_for_step(sizes, mode, interval, seed, epoch, bi):
    """The image size of batch ``bi`` of ``epoch`` under step-interval
    multi-scale, keyed by (epoch, slot = bi // interval); cycling starts each
    epoch one size further on, so short epochs still cover every size."""
    slot = bi // interval
    if mode == "random":
        r = np.random.RandomState((seed * 100003 + epoch) * 7919 + slot)
        return sizes[int(r.randint(len(sizes)))]
    return sizes[(slot + epoch) % len(sizes)]


def _entry_param_count(entry) -> int:
    return sum(_entry_param_count(v) if isinstance(v, dict) else v.numel()
               for v in entry.values())


def model_summary(spec, params, image_size=None) -> str:
    """Keras-summary-style dump: per-sub-model layer table with kinds,
    per-conv param counts, and (when image_size is given) the head grids."""
    lines = [f'Model "{spec.output_stage}-staged" — {len(spec.sub_models)} sub-models']
    total = 0
    for sm in spec.sub_models:
        n = _entry_param_count(params.get(sm.name, {}))
        total += n
        lines.append(f"\n{sm.name}: {len(sm.layers)} layers, {n:,} params")
        for i, layer in enumerate(sm.layers):
            desc = layer.kind
            if layer.kind == "convolutional":
                entry = params[sm.name][f"layer{i}"]
                cout, cin, kh, kw = entry["kernel"].shape  # OIHW
                desc += (f" {kh}x{kw} {cin}→{cout}"
                         f" s{layer['stride']}"
                         f"{' +bn' if 'bn' in entry else ''}"
                         f" {layer.get('activation')}  ({_entry_param_count(entry):,} params)")
            elif layer.kind == "maxpool":
                desc += f" {list(layer['size_xy'])}/{list(layer['stride_xy'])}"
            elif layer.kind == "upsample":
                desc += f" x{layer['stride']}"
            elif layer.kind == "shortcut":
                desc += f" from {layer['from']}"
            lines.append(f"  [{i:3d}] {desc}")
    lines.append(f"\nTotal params: {total:,}")
    if image_size:
        lines.append(f"Head grids @ {image_size}: {head_grid_sizes(spec, image_size)}")
    return "\n".join(lines)


def _ema_config(ema_conf):
    """``ema`` config value → (conf dict or None, decay or None)."""
    if not ema_conf:
        return None, None
    if isinstance(ema_conf, dict):
        ema_conf = dict(ema_conf)
    elif isinstance(ema_conf, float):  # shorthand: `ema: 0.9995`
        ema_conf = {"decay": ema_conf}
    elif ema_conf is True:
        ema_conf = {}
    else:
        raise ValueError(f"ema must be true, a decay float, or a dict, got {ema_conf!r}")
    decay = float(ema_conf.get("decay", 0.9999))
    if not 0.0 <= decay <= 1.0:
        raise ValueError(f"ema decay must be in [0, 1], got {decay}")
    return ema_conf, decay


class Train:
    def __call__(
        self,
        model_config_file,
        image_size,
        batch_size,
        max_bboxes,
        debug_mode,
        anchors_file,
        learning_rate,
        early_stop_patience,
        epochs,
        training_mode,
        render_dataset_example,
        max_dataset_examples,
        transfer_learning_config,
        dataset_config,
        classes_name_file,
        output_checkpoints_path,
        early_stopping,
        weights_save_peroid,
        resume=False,
        profile_trace_dir=None,
        debug_nans=False,
        mixed_precision=False,
        remat=False,
        augmentation=None,
        accum_steps=1,
        device=None,
        **kwargs,
    ):
        if remat not in (False, True, "conv", None):
            raise ValueError(
                f"remat must be false, true, or 'conv' "
                f"(save-conv-outputs policy), got {remat!r}")
        if not logging.getLogger().handlers:
            logging.basicConfig(level=logging.INFO, format="%(levelname)s:%(name)s:%(message)s")
        logging.getLogger().setLevel(logging.INFO)
        if kwargs.get("compilation_cache"):
            log.info("compilation_cache: nothing is compiled ahead of time here; no effect")
        ensure_native_library()  # the decoding library, before any rank reads data
        bn_stats_subsample = int(kwargs.get("bn_stats_subsample") or 1)
        if bn_stats_subsample < 1:
            raise ValueError(f"bn_stats_subsample must be >= 1, got {bn_stats_subsample}")
        if bn_stats_subsample > 1:
            log.info(f"bn_stats_subsample: {bn_stats_subsample}")
        if debug_nans:
            torch.autograd.set_detect_anomaly(True)
        # --- multi-host: join the process group BEFORE the device is chosen
        # (each process takes its own card). World size 1 is the plain
        # trainer, as a one-device mesh is in the JAX package.
        multihost = kwargs.get("multihost")
        if multihost:
            initialize_multihost(**(multihost if isinstance(multihost, dict) else {}))
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise ValueError(
                "this process was started as one of several (WORLD_SIZE="
                f"{os.environ['WORLD_SIZE']}); add `multihost: true` to the config to train "
                "them data-parallel")
        dev = resolve_device(device)
        world = torch.distributed.get_world_size() if multihost else 1
        is_main = not multihost or torch.distributed.get_rank() == 0
        mesh = None
        spatial = int(kwargs.get("spatial_partitioning") or 1)
        if world > 1 and batch_size % world:
            raise ValueError(
                f"multihost training needs batch_size ({batch_size}) divisible "
                f"by the global device count ({world})")
        seed = int(kwargs.get("seed", 0))

        anchors_table = get_anchors(anchors_file)
        nclasses = count_file_lines(classes_name_file)

        spec = parse_model_config(model_config_file, nclasses)
        if spatial > 1:
            # the JAX trainer's checks and messages (the device count is
            # world × spatial here, so it divides), and the band unit
            ms = kwargs.get("multi_scale")
            ms_sizes = ms.get("sizes", []) if isinstance(ms, dict) else (ms or [])
            sizes = [image_size] + [int(v) for v in ms_sizes]
            bad = [v for v in sizes if v % spatial]
            if bad:
                raise ValueError(
                    f"image sizes {bad} not divisible by spatial_partitioning "
                    f"({spatial}) — row shards must be equal")
            for v in sizes:
                band_starts(v, spatial, total_stride(spec, v))
            mesh = make_mesh(devices=band_cards(dev, spatial, world == 1), spatial=spatial)
            log.info(f"data×spatial parallel: {world} process(es) × {spatial} bands on "
                     f"{[str(d) for d in mesh.devices]} (mesh {mesh.shape})")
        elif world > 1:
            mesh = make_mesh(devices=(dev,))
        if world > 1:
            log.info(f"data-parallel over {world} processes: rank {mesh.rank} on {dev}, "
                     f"{batch_size // world} of each batch of {batch_size}")
        elif dev.type == "cuda" and torch.cuda.device_count() > 1 and spatial == 1:
            log.info(f"{torch.cuda.device_count()} cards visible; training on {dev} "
                     "(data parallelism runs one process per card: multihost)")
        dp = mesh if world > 1 else None  # the process group's mesh, when there is one
        params, bn_state = init_model(spec, torch.Generator().manual_seed(seed))

        if is_main:
            summary_dir = os.path.dirname(output_checkpoints_path) or "."
            os.makedirs(summary_dir, exist_ok=True)
            with open(os.path.join(summary_dir, "model_summary.txt"), "w") as f:
                f.write(model_summary(spec, params, image_size) + "\n")

        # --- transfer learning dispatch (reference train.py:160-166) ---
        trainable_mask = None
        bn_frozen = ()
        tlc = transfer_learning_config
        if tlc and tlc.get("transfer_list"):
            tl = tlc["transfer_list"]
            if "all" in tl:
                params, bn_state = load_weights(spec, params, bn_state, tlc["input_weights_path"])
            elif "none" not in tl:
                def load_fn(output_stage):
                    ref_spec = spec.with_output_stage(output_stage)
                    rp, rs = init_model(ref_spec, torch.Generator().manual_seed(0))
                    # only the sub-models that transfer are read: a source of
                    # another class count (other head shapes) loads, as in the
                    # JAX package, whose load takes a leaf of any shape
                    keep = expand_transfer_list([output_stage])
                    rp, rs = ({k: v for k, v in t.items() if any(s in k for s in keep)}
                              for t in (rp, rs))
                    return load_weights(ref_spec, rp, rs, tlc["input_weights_path"])

                params, bn_state, trainable_mask, bn_frozen = do_transfer_learning(
                    spec, params, bn_state, tlc, load_fn)
            else:
                # 'none' still honors freeze lists
                trainable_mask = make_trainable_mask(params, tlc.get("freeze_train_list"))
                bn_frozen = bn_frozen_selectors(tlc.get("batch_norm_freeze_list"))

        lr_schedule = kwargs.get("lr_schedule")
        grad_clip_norm = kwargs.get("grad_clip_norm")
        optimizer_conf = kwargs.get("optimizer")
        make = make_adam_scheduled if lr_schedule else make_adam
        optimizer = make(learning_rate, grad_clip_norm, optimizer_conf)
        grid_sizes = head_grid_sizes(spec, image_size)

        dataset, dataset_size = create_dataset(
            dataset_config, image_size, max_bboxes, classes_name_file, max_dataset_examples)
        if 0 < min(s for s in dataset_size if s is not None) < batch_size:
            raise ValueError("Dataset size less than batch size!")
        ds_train, ds_val = dataset

        if debug_mode:
            # eager single-batch assignment check (reference
            # preprocess_dataset_debug, core/preprocess_dataset.py:94-120)
            from ..ops.assign import assign_targets

            _, labels = next(iter(Batcher(ds_train, min(batch_size, 2))))
            grids = assign_targets(torch.from_numpy(labels).to(dev), anchors_table, grid_sizes)
            for s, cube in enumerate(grids):
                n = int(cube[..., 4].sum())
                log.info(f"debug_mode: scale {s} (g={cube.shape[1]}): {n} boxes assigned")

        if render_dataset_example and is_main:
            from PIL import Image

            from ..utils.render import render_bboxes

            images, labels = next(iter(Batcher(ds_train, 1)))
            rendered = render_bboxes(images[0], labels[0][labels[0][:, 4] == 1][:, :4])
            Image.fromarray(np.uint8(np.clip(rendered, 0, 1) * 255)).save("dataset_example.png")
            log.info("render_dataset_example: wrote dataset_example.png")

        ema_conf, ema_decay = _ema_config(kwargs.get("ema"))
        if ema_conf is not None:
            log.info(f"ema: decay {ema_decay}"
                     + (", used for validation/early-stopping"
                        if ema_conf.get("use_for_validation") else ""))

        qat_mode = parse_qat_mode(kwargs.get("qat", False))
        if qat_mode:
            log.info(f"qat: {qat_mode}")
        stem_s2d = bool(kwargs.get("stem_s2d", False))

        def build_step_spec(size):
            # the space-to-depth stem is spec only: params, gradients and
            # checkpoints are the original spec's (ops/s2d.py::s2d_stem_train)
            if not stem_s2d:
                return spec
            step_spec = s2d_stem_train(spec, size)
            if step_spec is not spec:
                log.info(f"stem_s2d: training stem rescheduled to 2×2-phase layout @{size}")
            return step_spec

        def build_train_step(size):
            # one step per image size: its grids, and its stem spec
            return make_train_step(
                build_step_spec(size), anchors_table, head_grid_sizes(spec, size), batch_size,
                optimizer, mesh=mesh, bn_frozen=bn_frozen, trainable_mask=trainable_mask,
                compute_dtype=torch.bfloat16 if mixed_precision else None, remat=remat,
                augment=(augmentation if isinstance(augmentation, dict)
                         else {} if augmentation else None),
                seed=seed, accum_steps=accum_steps, qat=qat_mode,
                qat_min_k2cin=parse_qat_min_k2cin(kwargs.get("qat", False)),
                ema_decay=ema_decay,
                ema_warmup=bool(ema_conf.get("warmup", True)) if ema_conf is not None else True,
                bn_stats_subsample=bn_stats_subsample)

        train_step = build_train_step(image_size)
        eval_step = make_eval_step(build_step_spec(image_size), anchors_table, grid_sizes,
                                   batch_size, mesh=mesh, bn_frozen=bn_frozen)
        # every process iterates the same deterministic dataset and keeps
        # only its slice of each global batch (the JAX trainer's `put`)
        rows = None if dp is None else dp.local_slice(batch_size)

        # multi-scale: one size per epoch, or per N steps with device_dataset;
        # validation stays at image_size so val_loss compares across epochs
        multi_scale = kwargs.get("multi_scale")
        device_ds_conf = kwargs.get("device_dataset")
        ms_sizes, ms_mode, ms_interval = None, "cycle", "epoch"
        if multi_scale:
            ms_sizes, ms_mode, ms_interval = parse_multi_scale(multi_scale, device_ds_conf)
            # the model's max stride at a power-of-two probe size: the base
            # image_size itself may not be stride-aligned
            probe = 2048
            max_stride = probe // min(head_grid_sizes(spec, probe))
            bad = [s for s in ms_sizes if s <= 0 or s % max_stride]
            if bad:
                raise ValueError(
                    f"multi_scale sizes {bad} not divisible by the model's "
                    f"max stride {max_stride}")
            log.info(f"multi_scale: sizes {ms_sizes} ({ms_mode}, "
                     f"interval {ms_interval})")

        ms_cache = {}

        def ms_pipeline(size):
            """(train_step, ds_train) of one size on the host path: the split
            letterboxed anew at that size."""
            if size == image_size:
                return train_step, ds_train
            if size not in ms_cache:
                (ds_s, _), _ = create_dataset(dataset_config, size, max_bboxes,
                                              classes_name_file, max_dataset_examples)
                ms_cache[size] = (build_train_step(size), ds_s)
            return ms_cache[size]

        def ms_device(size):
            """(train_step, resize) of one size with device_dataset: the staged
            batch is downscaled on the device (bilinear with antialiasing, as
            jax.image.resize); labels are normalized, so they stay."""
            if size == image_size:
                return train_step, None
            if size not in ms_cache:
                ms_cache[size] = (build_train_step(size),
                                  lambda im, _s=size: resize_antialiased(im, _s, _s))
            return ms_cache[size]

        shuffle_conf = kwargs.get("shuffle")
        if shuffle_conf:
            shuffle_buffer = int(shuffle_conf.get("buffer", 1024)
                                 if isinstance(shuffle_conf, dict) else 1024)
            log.info(f"shuffle: buffer {shuffle_buffer}")
        else:
            shuffle_buffer = 0
        stream_workers = kwargs.get("stream_workers")
        if stream_workers is not None:
            stream_workers = int(stream_workers)
            if stream_workers < 1:
                raise ValueError(f"stream_workers must be >= 1, got {stream_workers}")

        # device-resident dataset: decode once, stage the split on the card
        dd_train = dd_val = None
        if device_ds_conf:
            if ms_sizes and max(ms_sizes) > image_size:
                raise ValueError(
                    "device_dataset + multi_scale requires every size <= "
                    f"image_size ({image_size}): the split is staged once at "
                    "image_size and smaller sizes run as device-side "
                    "bilinear downscales (staging per size would multiply "
                    "HBM). Raise image_size to the largest scale wanted.")
            if dp is not None:
                raise ValueError(
                    "device_dataset + multihost is not supported "
                    "(each process would need its own local-shard staging)")
            store_uint8 = (isinstance(device_ds_conf, dict)
                           and str(device_ds_conf.get("dtype", "")).lower() == "uint8")
            t0 = time.time()
            dd_train = DeviceDataset(ds_train, batch_size, dev, store_uint8=store_uint8)
            dd_val = DeviceDataset(ds_val, batch_size, dev, store_uint8=store_uint8)
            log.info(
                f"device_dataset: staged {dd_train.n}+{dd_val.n} examples "
                f"({(dd_train.nbytes + dd_val.nbytes) >> 20} MB"
                f"{', uint8' if store_uint8 else ''}) in {time.time() - t0:.1f}s")

        train_state = init_train_state(to_device(params, dev), to_device(bn_state, dev),
                                       optimizer, ema=ema_conf is not None)
        verbose = training_mode == "eager_tf"

        # full-state resume (params + BN stats + optimizer moments + step)
        state_path = native_path(output_checkpoints_path).replace(".npz", ".train_state.npz")
        ema_path = native_path(output_checkpoints_path).replace(".npz", ".ema.npz")
        start_epoch = 1
        # under a mesh only rank 0 writes checkpoints, so the resume decision
        # and the restored state both come from rank 0 (per-process
        # os.path.exists could diverge without a shared filesystem)
        do_resume = resume and is_main and os.path.exists(state_path)
        if dp is not None:
            flag = torch.tensor([int(do_resume)], device=dev)
            torch.distributed.broadcast(flag, src=0)
            do_resume = bool(flag.item())
        if do_resume and is_main:
            # the core state loads strictly; the EMA subtree may be absent
            # (resuming a pre-EMA run with `ema:` newly enabled) — it reseeds
            # from the restored weights
            want_ema = "ema" in train_state
            have_ema = want_ema and any(k.startswith("ema/") for k in checkpoint_keys(state_path))
            like = (train_state if have_ema else
                    {k: v for k, v in train_state.items() if k != "ema"})
            restored, saved_epoch = load_train_state(state_path, like, optimizer, dev)
            if want_ema and not have_ema:
                clone = lambda t: t.clone()  # noqa: E731
                restored["ema"] = {"params": tree_map(clone, restored["params"]),
                                   "bn_state": tree_map(clone, restored["bn_state"])}
                log.info("resume: checkpoint has no EMA state; "
                         "seeded EMA from the restored weights")
            train_state = restored
            start_epoch = int(saved_epoch or 0) + 1
        if do_resume and dp is not None:
            # the other ranks receive rank 0's restored state and epoch
            train_state = dp.broadcast_state(train_state)
            start_epoch = int(dp.broadcast_state(torch.tensor(start_epoch)))
        if do_resume:
            log.info(f"resumed full train state from {state_path} at epoch {start_epoch}")

        def save_all(epoch):
            if not is_main:
                return
            save_weights(spec, train_state["params"], train_state["bn_state"],
                         output_checkpoints_path, step=epoch)
            save_train_state(state_path, train_state, optimizer, step=epoch)
            if "ema" in train_state:
                save_weights(spec, train_state["ema"]["params"],
                             train_state["ema"]["bn_state"], ema_path, step=epoch)

        best_val = float("inf")
        best_weights = None
        patience_left = early_stop_patience
        last_epoch = start_epoch - 1
        timer = StepTimer(images_per_step=batch_size)  # host time to enqueue each step
        # TensorBoard scalars: `tensorboard: <logdir>` or true (./tb_logs); one
        # device fetch per epoch, never a per-step wait
        tb_writer = None
        tb_conf = kwargs.get("tensorboard")
        if tb_conf and is_main:
            from ..utils.tb import SummaryWriter

            tb_writer = SummaryWriter(tb_conf if isinstance(tb_conf, str) else "tb_logs")
            log.info(f"tensorboard: writing scalars to {tb_writer.path}")
        cur_lr = learning_rate
        try:
            for epoch in range(start_epoch, epochs + 1):
                last_epoch = epoch
                if lr_schedule:
                    cur_lr = epoch_learning_rate(learning_rate, epoch, epochs, lr_schedule)
                    train_state = {**train_state, "opt_state": {
                        **train_state["opt_state"],
                        "learning_rate": torch.tensor(cur_lr, dtype=torch.float32)}}
                    log.info(f"epoch {epoch}: learning_rate {cur_lr:.6g}")
                epoch_step, epoch_ds, ms_resize = train_step, ds_train, None
                ms_per_step = ms_sizes is not None and ms_interval != "epoch"
                if ms_sizes and not ms_per_step:
                    size = ms_size_for(ms_sizes, ms_mode, seed, epoch)
                    log.info(f"epoch {epoch}: multi_scale image_size {size}")
                    if dd_train is not None:
                        epoch_step, ms_resize = ms_device(size)
                    else:
                        epoch_step, epoch_ds = ms_pipeline(size)
                t0 = time.time()
                nbatches = 0
                if dd_train is not None:
                    # device-resident epoch: the same epoch-keyed determinism,
                    # a full permutation instead of a buffer window
                    epoch_iter = dd_train.batches(
                        seed * 1000003 + epoch if shuffle_buffer else None)
                else:
                    # epoch-keyed shuffle seed: fresh order each epoch, identical
                    # sequence across an interrupted+resumed run
                    epoch_iter = DevicePrefetcher(
                        batched(epoch_ds, batch_size, shuffle_buffer=shuffle_buffer or None,
                                seed=seed * 1000003 + epoch, num_workers=stream_workers), dev,
                        rows=rows)
                ms_used = {}
                with trace(profile_trace_dir if epoch == start_epoch and is_main
                           else None) as trace_path:
                    for bi, (images, labels) in enumerate(epoch_iter):
                        step_fn, resize = epoch_step, ms_resize
                        if ms_per_step:
                            # Darknet-style switch within the epoch: this slot's
                            # size, the staged batch downscaled on the device
                            size = ms_size_for_step(ms_sizes, ms_mode, ms_interval, seed,
                                                    epoch, bi)
                            ms_used[size] = ms_used.get(size, 0) + 1
                            step_fn, resize = ms_device(size)
                        if resize is not None:
                            images = resize(images)
                        with timer:
                            train_state, metrics = step_fn(train_state, images, labels)
                        nbatches += 1
                        if verbose:
                            self._log_metrics(epoch, "train", nbatches - 1, cur_lr, metrics)
                if trace_path:
                    log.info(f"profile_trace_dir: wrote {trace_path}")
                if ms_used:
                    log.info(f"epoch {epoch}: multi_scale batches per size "
                             f"{dict(sorted(ms_used.items()))}")
                if nbatches == 0:
                    raise ValueError("Dataset size less than batch size!")
                # fetch the last step's loss BEFORE taking the epoch time: the
                # loop above only enqueues work, the scalar fetch waits for the
                # epoch's final step, so the logged rate is honest
                epoch_train_loss = float(metrics["total_loss"])
                dt = time.time() - t0
                log.info(f"epoch {epoch}: {nbatches} steps in {dt:.2f}s "
                         f"({nbatches * batch_size / dt:.1f} img/s)")
                log.info(f"epoch {epoch}: train_loss {epoch_train_loss:.4f}")
                if tb_writer:
                    scalars = {"train/total_loss": epoch_train_loss,
                               "train/images_per_sec": nbatches * batch_size / dt,
                               "train/learning_rate": float(cur_lr)}
                    for name, v in zip(("xy", "wh", "obj", "class"),
                                       metrics["per_source"].cpu().tolist()):
                        scalars[f"train/loss_{name}"] = float(v)
                    tb_writer.add_scalars(scalars, step=epoch)

                if epoch % weights_save_peroid == 0:
                    save_all(epoch)

                # validation pass (train.py:80-91). With `ema.use_for_validation`
                # the pass (and thus early stopping + best-weights restore) runs
                # on the EMA shadow — the weights one would actually serve.
                val_src = (train_state["ema"]
                           if ema_conf and ema_conf.get("use_for_validation") else train_state)
                val_losses = []
                val_iter = (dd_val.batches(None) if dd_val is not None else DevicePrefetcher(
                    batched(ds_val, batch_size, num_workers=stream_workers), dev, rows=rows))
                for batch_i, (images, labels) in enumerate(val_iter):
                    metrics = eval_step(val_src["params"], val_src["bn_state"], images, labels)
                    # keep the per-batch loss on the device: one stacked fetch
                    # after the loop waits once instead of once per batch
                    val_losses.append(metrics["total_loss"])
                    if verbose:
                        self._log_metrics(epoch, "val", batch_i, cur_lr, metrics)
                if val_losses:
                    val_losses = torch.stack(val_losses).cpu().tolist()
                    log.info(f"epoch {epoch}: val_loss {float(np.mean(val_losses)):.4f}")
                    if tb_writer:
                        tb_writer.add_scalar("val/total_loss", float(np.mean(val_losses)),
                                             step=epoch)

                if early_stopping and val_losses:
                    val_loss = float(np.mean(val_losses))
                    if val_loss < best_val:
                        best_val = val_loss
                        snapshot = lambda t: t.detach().cpu().clone()  # noqa: E731
                        best_weights = (tree_map(snapshot, val_src["params"]),
                                        tree_map(snapshot, val_src["bn_state"]))
                        patience_left = early_stop_patience
                    else:
                        patience_left -= 1
                        if patience_left <= 0:
                            log.info(f"early stopping at epoch {epoch} "
                                     f"(best val_loss {best_val:.4f})")
                            if best_weights is not None:
                                # restore the best weights INTO the train state
                                # so the final save persists them (Keras
                                # EarlyStopping restore_best_weights). When
                                # validation monitored the EMA shadow the best
                                # snapshot is an EMA one: it goes back into the
                                # shadow, and the raw params stay coherent with
                                # the optimizer moments for resume.
                                p, s = (to_device(t, dev) for t in best_weights)
                                if ema_conf and ema_conf.get("use_for_validation"):
                                    train_state = dict(train_state,
                                                       ema={"params": p, "bn_state": s})
                                else:
                                    train_state = dict(train_state, params=p, bn_state=s)
                            break

            # final save so short runs always leave a checkpoint, stamped with
            # the actual last epoch so resume accounting stays correct
            save_all(last_epoch)
        finally:
            if tb_writer:
                tb_writer.close()
        if timer.durations:
            log.info(f"step timing (host enqueue): {timer.stats()}")
        return train_state

    @staticmethod
    def _log_metrics(epoch, split, batch, lr, metrics):
        # format parity with reference train.py:70-75
        per_grid = [float(x) for x in metrics["per_grid"].cpu()]
        per_source = metrics["per_source"].cpu().numpy()
        pgs = [list(map(float, row)) for row in metrics["per_grid_per_source"].cpu()]
        log.info(
            f"{epoch}_{split}_{batch}_lr:{lr:.6f}, "
            f"totLoss:{float(metrics['total_loss'])}, "
            f"perGrid{per_grid}, "
            f"perSource[xy,wh,obj,class]:{per_source}, "
            f"perGridPerSource:{pgs}"
        )
