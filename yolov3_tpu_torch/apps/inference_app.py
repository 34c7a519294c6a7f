"""Inference application and its predictor: BN-folded forward + decode + NMS.

Counterpart of ``yolov3_tpu/apps/inference_app.py``: the predictor
(``make_predictor``, ``calibration_batches_from_dir``,
``build_serving_predictor``, ``gather_valid_detections``) with the fp32 and
bf16 tiers and the int8 PTQ tiers (``quantize: int8`` / ``int8_chain``), and
``Inference``, the reference inference.py surface (detect_config.yaml
schema): annotated ``detect_<i>.jpg`` images and one ``detect.txt`` line per
image from tfrecords, an images directory, one image file or a video file.
The JAX package compiles the pipeline into one jit; here it runs eagerly on
the device, and on the card the NMS sweeps and every int8 convolution go
through the hand-written CUDA kernels (``ops/nms.py``,
``models/layers.py::conv2d_int8``). The serving body is one module,
``Detector``: the predictor calls it eagerly and ``export/aot.py`` exports
it.
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np
import torch

from ..config import dir_filelist, get_anchors, read_class_names
from ..data.image import decode_image, letterbox_resize, letterbox_unmap_boxes, resize_bilinear
from ..data.tfrecord import parse_tfrecords
from ..device import pin_fp32_ieee, resolve_device
from ..export.aot import as_predict
from ..io.resolve import load_weights, save_weights
from ..models import apply_model, fold_batch_norm, init_model, parse_model_config
from ..models.network import pack_fused_stages, to_device
from ..ops.decode import yolo_decode
from ..ops.nms import yolo_nms
from ..ops.quantize import calibrate_scales, quantize_params
from ..ops.s2d import s2d_stem
from ..parallel.mesh import local_devices, make_data_parallel_mesh
from ..parallel.spatial import band_starts, total_stride
from ..utils.render import render_text_annotated_bboxes

log = logging.getLogger(__name__)

_DTYPES = {"bf16": torch.bfloat16, "fp32": None, None: None}


def _fill(layout, buffers):
    """A tree of ``layout``'s shape whose leaves (buffer names) are replaced
    by those buffers."""
    return {k: buffers[v] if isinstance(v, str) else _fill(v, buffers)
            for k, v in layout.items()}


class Detector(torch.nn.Module):
    """The serving body: (B, H, W, 3) float32 images → the forward
    (``apply_model``) → ``yolo_decode`` → ``yolo_nms``, whose tuple it
    returns. The params (folded, possibly quantized), the BatchNorm state
    when BN is not folded, and the anchors are its buffers, one buffer a
    tensor (entries that share a tensor share its buffer), so
    ``torch.export`` lifts them into the program; each forward rebuilds the
    params tree over the buffers. ``make_predictor`` calls it under ``inference_mode`` and
    ``export/aot.py`` exports it under ``no_grad``.
    ``compute_dtype`` (e.g. ``torch.bfloat16``) casts the images for the
    forward; decode and NMS run in float32. ``bands``: the band devices of a
    spatial split (``apply_model``'s ``devices``; the heads come
    back whole on the first), or None."""

    bands = None

    def __init__(self, spec, params, state, anchors, nclasses, max_boxes, iou_threshold,
                 score_threshold, per_class=False, compute_dtype=None):
        super().__init__()
        self.spec, self.nclasses, self.compute_dtype = spec, int(nclasses), compute_dtype
        self.nms = dict(max_boxes=int(max_boxes), iou_threshold=float(iou_threshold),
                        score_threshold=float(score_threshold), per_class=bool(per_class))
        self.register_buffer("anchors", anchors)
        names = {}
        self._layout = {"params": self._register(params, ("params",), names),
                        "state": self._register(state, ("state",), names)}

    def _register(self, tree, path, names):
        """Register ``tree``'s tensors as buffers (``names``: id of a tensor
        → its buffer's name) → its layout: the same tree with each tensor
        replaced by its buffer's name."""
        layout = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                layout[key] = self._register(value, path + (key,), names)
            elif not isinstance(value, torch.Tensor):
                raise TypeError(f"Detector: {'/'.join(path + (key,))} is not a tensor")
            else:
                if id(value) not in names:
                    names[id(value)] = "__".join(path + (key,))
                    self.register_buffer(names[id(value)], value)
                layout[key] = names[id(value)]
        return layout

    def tree(self, name: str) -> dict:
        """The ``params`` or ``state`` tree over the current buffers."""
        return _fill(self._layout[name], self._buffers)

    def forward(self, images):
        x = images if self.compute_dtype is None else images.to(self.compute_dtype)
        outputs = apply_model(self.spec, self.tree("params"), self.tree("state"), x,
                              devices=self.bands)
        boxes, conf, probs = yolo_decode(outputs, self.anchors, self.nclasses)
        return yolo_nms(boxes, conf, probs, **self.nms)


def make_predictor(spec, params, bn_state, anchors_table, nclasses, yolo_max_boxes,
                   nms_iou_threshold, nms_score_threshold, fold_bn: bool = True,
                   compute_dtype=None, quantize=None, calibration_batches=None,
                   image_size=None, nms_per_class: bool = False, device=None, mesh=None):
    """Build ``predict(images)``: (B, H, W, 3) float32 images (numpy or
    tensor) → the ``yolo_nms`` tuple of tensors on ``device``
    (``export.aot.as_predict`` over a ``Detector``, which ``predict.module``
    holds for export).

    ``compute_dtype`` (e.g. ``torch.bfloat16``) casts weights and images for
    the forward; decode and NMS run in float32 as in the JAX package.

    ``quantize='int8'`` is the int8 PTQ tier: per-channel int8 weights and
    calibrated per-tensor activation scales; every quantized conv quantizes
    its fp input and emits fp. ``quantize='int8_chain'`` keeps activations
    int8 between convs (each conv's epilogue requantizes, shortcuts are a
    dequant-add-requant). Both need ``calibration_batches`` (a list of
    (B, H, W, 3) float arrays) and ``fold_bn``, run the forward in float32
    whatever ``compute_dtype`` says, and apply the bit-exact space-to-depth
    stem rewrite (``ops/s2d.py``; pass ``image_size`` so odd sizes skip it).
    Calibration runs on ``device``. ``int8_chain`` packs the fused residual
    blocks' constant kernel arguments here, once
    (``models/network.py::pack_fused_stages``). A tier that runs its forward
    in float32 (fp32, and the int8 tiers' fp tails and calibration) pins fp32
    to IEEE on the card (``device.pin_fp32_ieee``).

    ``mesh`` (``parallel/mesh.py::make_data_parallel_mesh``): data-parallel
    serving, one replica per data replica of the mesh, on its first device
    (then ``device`` is not read). The first device builds the predictor
    (and calibrates an int8 tier, unsharded), the other replicas get copies
    of its params, as the JAX package replicates them; a call splits the
    batch evenly over the replicas (it must divide), runs each slice and
    gathers the answers in batch order on the first device. With a spatial
    axis (``mesh.spatial`` > 1) each replica runs its slice in bands of
    image rows over its band devices (``Detector.bands``), gathers the heads
    and decodes and suppresses them as unsharded. ``image_size`` (when
    given) must then split into bands: a multiple of the model's total
    stride.
    """
    if mesh is not None and mesh.world_size > 1:
        raise ValueError("make_predictor: data-parallel serving shards over one process's "
                         "devices; this mesh spans processes (a training mesh)")
    devices = ([resolve_device(device)] if mesh is None
               else [resolve_device(d) for d in mesh.devices])
    dev = devices[0]
    if compute_dtype is None or quantize in ("int8", "int8_chain"):
        for d in devices:
            pin_fp32_ieee(d)
    if mesh is not None and mesh.spatial > 1 and image_size is not None:
        band_starts(int(image_size), mesh.spatial, total_stride(spec, int(image_size)))
    run_params = fold_batch_norm(params, bn_state) if fold_bn else params
    run_state = {} if fold_bn else to_device(bn_state, dev)
    if quantize in ("int8", "int8_chain"):
        if not fold_bn:
            raise ValueError("int8 quantization requires fold_bn=True")
        if not calibration_batches:
            raise ValueError("int8 quantization needs calibration_batches")
        run_params = to_device(run_params, dev)
        batches = [np.asarray(b, np.float32) for b in calibration_batches]
        in_absmax, out_absmax = calibrate_scales(spec, run_params, batches)
        run_params = quantize_params(
            spec, run_params, in_absmax,
            out_absmax=out_absmax if quantize == "int8_chain" else None)
        spec, run_params = s2d_stem(spec, run_params, image_size=image_size)
        compute_dtype = None
    elif quantize is not None:
        raise ValueError(f"quantize must be None, 'int8' or 'int8_chain', got {quantize!r}")
    run_params = to_device(run_params, dev, compute_dtype)
    if quantize == "int8_chain":
        run_params = pack_fused_stages(spec, run_params)
    anchors = torch.as_tensor(np.asarray(anchors_table), dtype=torch.float32, device=dev)
    detector = Detector(spec, run_params, run_state, anchors, nclasses, yolo_max_boxes,
                        nms_iou_threshold, nms_score_threshold, nms_per_class, compute_dtype)
    if mesh is None:
        return as_predict(detector, dev)
    firsts = [bands[0] for bands in mesh.replicas]
    replicas = [detector] + [copy.deepcopy(detector).to(d) for d in firsts[1:]]
    if mesh.spatial > 1:
        for replica, bands in zip(replicas, mesh.replicas):
            replica.bands = tuple(bands)
    return sharded_predict(replicas, mesh)


def sharded_predict(replicas, mesh):
    """``predict(images)`` over one ``Detector`` replica per data replica of
    ``mesh``: the batch split evenly (``mesh.shard_batch``), each slice
    answered on its devices, the ``yolo_nms`` tuple gathered in batch order
    on the first device (``mesh.gather_batch``). The replicas are called one
    after another from this thread; nothing in a call waits for the device,
    so each replica's launches queue on its own device without waiting for
    the others. ``predict.replicas`` holds them; ``predict.module`` is the
    first."""

    @torch.inference_mode()
    def predict(images):
        parts = mesh.shard_batch(torch.as_tensor(images, dtype=torch.float32))
        outs = [replica(part) for replica, part in zip(replicas, parts)]
        return tuple(mesh.gather_batch(list(field)) for field in zip(*outs))

    predict.device, predict.module, predict.replicas = mesh.devices[0], replicas[0], replicas
    return predict


def calibration_batches_from_dir(images_dir, image_size, limit: int = 8, preprocess=None):
    """int8-calibration batches from a directory of images (square resize,
    /255 — the ``image_file`` preprocessing; pass ``preprocess`` to match a
    letterboxed pipeline)."""
    preprocess = preprocess or resize_bilinear
    calib = []
    for file in dir_filelist(images_dir, (".jpeg", ".jpg", ".png", ".bmp"))[:limit]:
        with open(file, "rb") as f:
            img = decode_image(f.read()).astype(np.float32) / 255.0
        calib.append(preprocess(img, image_size, image_size))
    if not calib:
        raise ValueError(f"no calibration images in {images_dir}")
    return [np.stack(calib)]


def build_serving_predictor(model_config_file, classes_name_file, anchors_file,
                            input_weights_path, image_size, yolo_max_boxes=100,
                            nms_iou_threshold=0.5, nms_score_threshold=0.3,
                            quantize=None, compute_precision=None,
                            calibration_images_dir=None, letterbox=False,
                            nms_per_class=False, device=None, seed=None, mesh=None):
    """Detect-config keys → ``(predictor, class_names, model_name)``.

    ``quantize: int8`` / ``int8_chain`` calibrates on the images of
    ``calibration_images_dir`` (``letterbox`` selects the calibration
    geometry to match the caller's preprocessing).

    ``input_weights_path`` is a native ``.npz`` checkpoint (JAX key layout).
    ``input_weights_path=None`` with a ``seed`` serves Keras-default weights
    drawn from ``torch.Generator().manual_seed(seed)`` — for runs that need
    the full-width model but have no trained weights for it. ``mesh``:
    data-parallel serving (``make_predictor``).
    """
    anchors_table = get_anchors(anchors_file)
    class_names = read_class_names(classes_name_file)
    spec = parse_model_config(model_config_file, len(class_names))
    params, bn_state = init_model(spec, torch.Generator().manual_seed(
        0 if seed is None else int(seed)))
    if input_weights_path is not None:
        params, bn_state = load_weights(spec, params, bn_state, input_weights_path)
    elif seed is None:
        raise ValueError("build_serving_predictor needs input_weights_path or a seed")
    calibration_batches = None
    if quantize in ("int8", "int8_chain"):
        if not calibration_images_dir:
            raise ValueError(f"quantize: {quantize} needs calibration_images_dir")
        calibration_batches = calibration_batches_from_dir(
            calibration_images_dir, image_size,
            preprocess=letterbox_resize if letterbox else None)
    predictor = make_predictor(
        spec, params, bn_state, anchors_table, len(class_names), yolo_max_boxes,
        nms_iou_threshold, nms_score_threshold,
        compute_dtype=_DTYPES[compute_precision], quantize=quantize,
        calibration_batches=calibration_batches, image_size=image_size,
        nms_per_class=nms_per_class, device=device, mesh=mesh)
    model_name = os.path.basename(os.path.dirname(model_config_file)) or "yolov3"
    return predictor, class_names, model_name


def data_parallel_mesh(data_parallel, batch_size: int, device, spatial=1):
    """The ``data_parallel`` and ``spatial_partitioning`` keys → the serving
    mesh over every local device of ``device``'s kind
    (``parallel/mesh.py::make_data_parallel_mesh``, with its checks), or
    None: both off, or ``data_parallel`` alone on one device, where it is a
    no-op (logged), as in the JAX package. With ``spatial`` > 1 on one device
    (the CPU, or one card) the bands share it (``mesh.spatial_devices``)."""
    spatial = int(spatial or 1)
    if not data_parallel and spatial == 1:
        return None
    mesh = make_data_parallel_mesh(batch_size, spatial=spatial,
                                   devices=local_devices(device.type))
    if mesh is None:
        log.info(f"data_parallel: one {device.type} device, a no-op")
    else:
        log.info(f"sharded: batch {batch_size} over {mesh.size} devices {mesh.devices} "
                 f"(mesh {mesh.shape})")
    return mesh


def gather_valid_detections(bboxes, class_indices, scores, selected, num_valid):
    """reference inference.py:21-28 — one image's valid detections."""
    sel = selected[: int(num_valid)]
    return bboxes[sel], class_indices[sel], scores[sel]


def _open_video(path):
    """→ ``(capture, fps, (width, height))``; OpenCV decodes the container."""
    import cv2

    if not path:
        raise ValueError("input_data_source: video_file needs video_file_path")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video {path}")
    fps = float(cap.get(cv2.CAP_PROP_FPS)) or 25.0
    size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    return cap, fps, size


def _video_frames(cap):
    """Yield RGB float32 [0,1] frames until the stream ends."""
    while True:
        ok, frame = cap.read()
        if not ok:
            return
        yield frame[:, :, ::-1].astype(np.float32) / 255.0


class Inference:
    """``Inference()(**detect_config)`` → per image ``(class names, boxes,
    scores)`` (video: the last batch's frames), writing ``detect.txt``,
    ``detect_<i>.jpg`` (video: ``detect.mp4``) and
    ``model_inference_summary.txt`` into ``output_dir``.

    Geometry as in the JAX package: tfrecords images are already square;
    image_file / images_dir / video_file take a plain square resize, or with
    ``letterbox: true`` an aspect-preserving one whose boxes are mapped back
    to, and drawn on, the original image. ``save_model_path`` writes the
    loaded weights as a native ``.npz``. ``quantize: int8`` / ``int8_chain``
    calibrate on up to 8 images of the input source. ``data_parallel: true``
    shards each batch over every visible card (``make_predictor(mesh=)``; a
    no-op on one device; a source that predicts one image at a time raises,
    as in the JAX package); ``spatial_partitioning: S`` splits each image
    into S bands of rows (alone it is valid for every source: the data axis
    collapses to 1 for a source that predicts one image at a time). Runs on
    the card unless ``device: cpu``."""

    def __call__(
        self,
        model_config_file,
        classes_name_file,
        anchors_file,
        input_weights_path,
        image_size,
        input_data_source,
        images_dir,
        tfrecords_dir,
        batch_size,
        image_file_path,
        output_dir,
        yolo_max_boxes,
        nms_iou_threshold,
        nms_score_threshold,
        bbox_color,
        font_size,
        video_file_path=None,
        letterbox=False,
        nms_per_class=False,
        display_result_images=None,
        save_model_path=None,
        quantize=None,
        compute_precision=None,
        data_parallel=False,
        spatial_partitioning=1,
        device=None,
        **kwargs,
    ):
        batched_sources = ("tfrecords", "video_file")
        if data_parallel and input_data_source not in batched_sources:
            # image_file / images_dir predict one image at a time
            raise ValueError(
                "data_parallel requires a batched input_data_source "
                "(tfrecords/video_file); image_file/images_dir predict "
                "per-image")
        if kwargs.get("compilation_cache"):
            log.info("compilation_cache: nothing is compiled ahead of time here; no effect")
        dev = resolve_device(device)
        eff_batch = batch_size if input_data_source in batched_sources else 1
        mesh = data_parallel_mesh(data_parallel, eff_batch, dev, spatial_partitioning)
        os.makedirs(output_dir, exist_ok=True)
        detect_txt = f"{output_dir}/detect.txt"
        if os.path.exists(detect_txt):
            os.remove(detect_txt)

        anchors_table = get_anchors(anchors_file)
        class_names = read_class_names(classes_name_file)
        nclasses = len(class_names)

        spec = parse_model_config(model_config_file, nclasses)
        params, bn_state = init_model(spec, torch.Generator().manual_seed(0))

        # the summary lands in the run's output_dir, with its other artifacts
        from .train_app import model_summary

        with open(os.path.join(output_dir, "model_inference_summary.txt"), "w") as f:
            f.write(model_summary(spec, params) + "\n")

        params, bn_state = load_weights(spec, params, bn_state, input_weights_path)
        print("weights loaded")

        if save_model_path:
            print(f"Saving weights loaded model to {save_model_path}: (configurable)")
            save_weights(spec, params, bn_state, os.path.join(save_model_path, "model"))

        prep = letterbox_resize if letterbox else resize_bilinear

        calibration_batches = None
        if quantize in ("int8", "int8_chain"):
            # calibrate on up to 8 images from the configured input source
            calib_images = []
            if input_data_source == "tfrecords":
                for img, _ in parse_tfrecords(tfrecords_dir, image_size, yolo_max_boxes, None):
                    calib_images.append(img)
                    if len(calib_images) >= 8:
                        break
            elif input_data_source == "video_file":
                cap, _, _ = _open_video(video_file_path)
                try:
                    for frame in _video_frames(cap):
                        calib_images.append(prep(frame, image_size, image_size))
                        if len(calib_images) >= 8:
                            break
                finally:
                    cap.release()
                if not calib_images:
                    raise ValueError(
                        f"no decodable calibration frames in {video_file_path}")
            elif input_data_source == "image_file":
                with open(image_file_path, "rb") as f:
                    orig = decode_image(f.read()).astype(np.float32) / 255.0
                calib_images.append(prep(orig, image_size, image_size))
            else:  # images_dir — shared helper (clear empty-dir error)
                calibration_batches = calibration_batches_from_dir(
                    images_dir, image_size, preprocess=prep)
            if calibration_batches is None:
                if not calib_images:
                    raise ValueError(
                        f"no calibration images from input_data_source="
                        f"{input_data_source!r}")
                calibration_batches = [np.stack(calib_images)]

        predict = make_predictor(
            spec, params, bn_state, anchors_table, nclasses,
            yolo_max_boxes, nms_iou_threshold, nms_score_threshold,
            compute_dtype=_DTYPES[compute_precision], quantize=quantize,
            calibration_batches=calibration_batches, image_size=image_size,
            nms_per_class=nms_per_class, device=dev, mesh=mesh)

        image_counter = 0
        results = []
        outfile = open(detect_txt, "a")

        def process(batch_images, raw_sizes=None, n_real=None, sink=None, originals=None):
            """Run one batch; render/write the first ``n_real`` images (tail
            batches arrive zero-padded to the batch size). ``sink(annotated)``
            replaces the per-image jpg (video mode streams frames to a
            writer). ``originals`` (letterbox mode): the full-resolution source
            images — boxes are mapped out of the letterbox frame and rendered
            on them."""
            nonlocal image_counter
            bboxes, class_idx, scores, selected, num_valid = (
                t.cpu().numpy() for t in predict(batch_images))
            for i in range(len(batch_images) if n_real is None else n_real):
                bb, cc, ss = gather_valid_detections(
                    bboxes[i], class_idx[i], scores[i], selected[i], num_valid[i])
                names = [class_names[int(c)] for c in cc]
                if originals is not None:
                    oh, ow = originals[i].shape[:2]
                    bb = letterbox_unmap_boxes(bb, oh, ow, image_size, image_size)
                    render_source = originals[i]
                else:
                    render_source = batch_images[i]
                annotated, detections = render_text_annotated_bboxes(
                    render_source, bb, names, ss, bbox_color, font_size)
                if raw_sizes is not None and originals is None:
                    annotated = annotated.resize(raw_sizes[i])
                outfile.write(f"{detections}\n")
                outfile.flush()
                if sink is None:
                    annotated.save(f"{output_dir}/detect_{image_counter}.jpg")
                else:
                    sink(annotated)
                image_counter += 1
                results.append((names, bb, ss))

        try:
            if input_data_source == "tfrecords":
                # parse_tfrecords yields square image_size images: the
                # reference's letterbox on top is the identity there
                batch = []
                for img, _ in parse_tfrecords(tfrecords_dir, image_size, yolo_max_boxes, None):
                    batch.append(img)
                    if len(batch) == batch_size:
                        process(np.stack(batch))
                        batch = []
                if batch:  # pad the tail to the batch size, drop it after
                    pad = batch_size - len(batch)
                    process(np.stack(batch + [np.zeros_like(batch[0])] * pad),
                            n_real=len(batch))
            elif input_data_source == "video_file":
                self._video(process, prep, video_file_path, output_dir, image_size,
                            batch_size, letterbox, results)
                print(f"wrote {image_counter} annotated frames to {output_dir}/detect.mp4")
            else:
                if input_data_source == "image_file":
                    filenames = [image_file_path]
                elif input_data_source == "images_dir":
                    filenames = dir_filelist(images_dir, (".jpeg", ".jpg", ".png", ".bmp"))
                else:
                    filenames = []
                for file in filenames:
                    with open(file, "rb") as f:
                        orig = decode_image(f.read()).astype(np.float32) / 255.0
                    image = prep(orig, image_size, image_size)
                    process(image[None], raw_sizes=[(orig.shape[1], orig.shape[0])],
                            originals=[orig] if letterbox else None)
        finally:
            outfile.close()
        if results:
            names, bb, ss = results[-1]
            for class_name, box, score in zip(names, bb, ss):
                print(f"{class_name} bbox: {box} score: {score}")
        return results

    @staticmethod
    def _video(process, prep, video_file_path, output_dir, image_size, batch_size,
               letterbox, results):
        """Video mode: frames batch like tfrecords mode (zero-padded tail) with
        the image_file geometry; annotated frames stream to
        ``<output_dir>/detect.mp4`` at the source fps and size, and only the
        freshest batch's detections stay in ``results`` (videos are
        unbounded; detect.txt has every frame)."""
        import cv2

        cap, fps, vid_size = _open_video(video_file_path)
        video_out = f"{output_dir}/detect.mp4"
        writer = cv2.VideoWriter(video_out, cv2.VideoWriter_fourcc(*"mp4v"), fps, vid_size)
        if not writer.isOpened():
            cap.release()
            raise ValueError(f"cannot open video writer for {video_out}")

        def sink(annotated):
            writer.write(np.asarray(annotated)[:, :, ::-1])  # RGB→BGR

        try:
            batch, sizes, origs = [], [], []
            for frame in _video_frames(cap):
                batch.append(prep(frame, image_size, image_size))
                sizes.append(vid_size)
                if letterbox:
                    origs.append(frame)
                if len(batch) == batch_size:
                    process(np.stack(batch), raw_sizes=sizes, sink=sink,
                            originals=origs if letterbox else None)
                    del results[:-batch_size]
                    batch, sizes, origs = [], [], []
            if batch:
                pad = batch_size - len(batch)
                padded = np.stack(batch + [np.zeros_like(batch[0])] * pad)
                process(padded, raw_sizes=sizes, n_real=len(batch), sink=sink,
                        originals=origs if letterbox else None)
                del results[:-len(batch)]
        finally:
            cap.release()
            writer.release()
