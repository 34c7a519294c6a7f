"""Input pipeline: dataset dispatcher, batcher, async host→device prefetch.

Counterpart of ``yolov3_tpu/data/pipeline.py``. The host half (``Dataset``,
``load_debug_dataset``, ``create_dataset``, ``shuffled``, ``batched``,
``Batcher``) is a framework-neutral copy of the original — decode + resize
in numpy, because the expensive label work (grid-scatter target assignment)
runs on the device inside the train step (ops/assign.py) —
and tests/test_torch_data.py pins it to its original. ``DevicePrefetcher``
is the port's own: pinned host memory and a non-blocking copy on a side
stream, two batches in flight. So is ``DeviceDataset``: the whole split
resident on the device, each batch a gather.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading

import numpy as np


class Dataset:
    """Restartable dataset: wraps a generator factory of (image, labels)."""

    def __init__(self, gen_factory, size: int = -1):
        self._gen_factory = gen_factory
        self.size = size

    def __iter__(self):
        return iter(self._gen_factory())

    def take(self, n: int) -> "Dataset":
        return Dataset(lambda: itertools.islice(self._gen_factory(), n),
                       size=min(self.size, n) if self.size >= 0 else n)

    def map(self, fn) -> "Dataset":
        return Dataset(lambda: (fn(*ex) for ex in self._gen_factory()), size=self.size)


def load_debug_dataset(image_size: int, repo_root: str = "."):
    """Single-image debug dataset (reference create_dataset.py:18-33):
    girl.png + 3 hardcoded boxes (person, chair, cell phone)."""
    from .image import decode_image, resize_bilinear

    path = os.path.join(repo_root, "datasets/coco2012/images/girl.png")
    labels = np.array(
        [
            [0.18494931, 0.03049111, 0.9435849, 0.96302897, 1, 0],
            [0.01586703, 0.35938117, 0.17582396, 0.6069674, 1, 56],
            [0.09158827, 0.48252046, 0.26967454, 0.6403017, 1, 67],
        ]
        + [[0, 0, 0, 0, 0, 0]] * 97,
        np.float32,
    )

    def gen():
        with open(path, "rb") as f:
            img = decode_image(f.read()).astype(np.float32)
        img = resize_bilinear(img / 255.0, image_size, image_size)
        yield img, labels

    return Dataset(gen, size=1), 1


def create_dataset(dataset_config, image_size, max_bboxes, classes_name_file,
                   max_dataset_examples=None):
    """Dispatcher with the reference surface (create_dataset.py:36-59):
    returns ([train, valid] Datasets, [train_size, valid_size])."""
    datasets = [None, None]
    sizes = [-1, -1]
    source = dataset_config["input_data_source"]
    if source == "tfrecords":
        from .tfrecord import parse_tfrecords, stream_batches

        for idx, split in enumerate(["train", "valid"]):
            tfdir = dataset_config["tfrecords"][split]
            datasets[idx] = Dataset(
                lambda d=tfdir: parse_tfrecords(d, image_size, max_bboxes, classes_name_file)
            )
            # zero-copy batched fast path (see batched()); .take/.map/
            # shuffled() return fresh Datasets without this attribute, so
            # any transformed view falls back to the generic path
            datasets[idx].batched_factory = (
                lambda bs, shuffle=None, workers=None, d=tfdir: stream_batches(
                    d, image_size, max_bboxes, bs, class_file=classes_name_file,
                    num_workers=workers or 4, shuffle=shuffle))
    elif source == "data_files":
        from .coco_json import create_dataset_from_files

        for idx, split in enumerate(["train", "valid"]):
            cfg = dataset_config["data_files"][split]
            datasets[idx], sizes[idx] = create_dataset_from_files(
                cfg["images_dir"], cfg["annotations"], image_size,
                max_dataset_examples, max_bboxes=max_bboxes,
            )
    elif source == "voc":  # extension: Pascal VOC XML annotations
        from .voc import create_voc_dataset

        for idx, split in enumerate(["train", "valid"]):
            cfg = dataset_config["voc"][split]
            datasets[idx], sizes[idx] = create_voc_dataset(
                cfg["images_dir"], cfg["annotations_dir"], image_size,
                classes_name_file, max_dataset_examples, max_bboxes=max_bboxes,
            )
    else:  # debug single-image dataset
        for idx in range(2):
            datasets[idx], sizes[idx] = load_debug_dataset(image_size)

    if max_dataset_examples and source == "tfrecords":
        datasets = [d.take(int(max_dataset_examples)) for d in datasets]
    return datasets, sizes


def shuffled(dataset: "Dataset", buffer_size: int, seed: int) -> "Dataset":
    """Buffer-shuffled view of a dataset (tf.data ``Dataset.shuffle``
    semantics: a reservoir of ``buffer_size`` examples, each yield swaps a
    uniformly-random slot with the next incoming example). Deterministic
    for a given seed — the train app keys the seed by (run seed, epoch) so
    every epoch gets a fresh order and an interrupted+resumed run sees the
    same order a straight-through run sees.

    The reference never shuffles (its tf.data pipelines carry no
    .shuffle call) — this is an extension, off by default.
    """
    if buffer_size < 1:
        raise ValueError(f"shuffle buffer_size must be >= 1, got {buffer_size}")

    def gen():
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        buf = []
        for ex in dataset:
            if len(buf) < buffer_size:
                buf.append(ex)
                continue
            i = rng.randint(buffer_size)
            out = buf[i]
            buf[i] = ex
            yield out
        while buf:
            yield buf.pop(rng.randint(len(buf)))

    return Dataset(gen, size=dataset.size)


def batched(dataset, batch_size: int, shuffle_buffer: int | None = None,
            seed: int = 0, num_workers: int | None = None):
    """Batches of ``dataset``, preferring the zero-copy streaming fast path.

    Datasets built straight from a tfrecords dir carry a
    ``batched_factory`` (create_dataset): worker threads decode each
    example directly into its slot of a preallocated batch
    (tfrecord.stream_batches) — no per-example buffers, no np.stack copy.
    Every other dataset (COCO-JSON/VOC/debug, or any .take/.map/shuffled
    view) goes through the generic ``Batcher``, optionally behind the
    reservoir shuffle. Both paths produce bit-identical streams (pinned
    by tests/test_stream_batches.py)."""
    factory = getattr(dataset, "batched_factory", None)
    if factory is not None:
        return factory(batch_size,
                       (shuffle_buffer, seed) if shuffle_buffer else None,
                       num_workers)
    if shuffle_buffer:
        dataset = shuffled(dataset, shuffle_buffer, seed)
    return Batcher(dataset, batch_size)


class Batcher:
    """Stack examples into fixed-size batches; drop_remainder is mandatory
    (static shapes — same reason as reference preprocess_dataset.py:123-127)."""

    def __init__(self, dataset, batch_size: int, drop_remainder: bool = True):
        if not drop_remainder:
            raise ValueError("static-shape pipeline requires drop_remainder=True")
        self.dataset = dataset
        self.batch_size = batch_size

    def __iter__(self):
        images, labels = [], []
        for img, lab in self.dataset:
            images.append(img)
            labels.append(lab)
            if len(images) == self.batch_size:
                yield np.stack(images), np.stack(labels)
                images, labels = [], []


class DeviceDataset:
    """Whole-split device residency (the ``device_dataset`` train key).

    Decode and resize each example once on the host, stage the whole split
    on ``device`` once, then every epoch is device work: a batch is a gather
    through a per-epoch permutation, so no image bytes cross after staging.

    ``store_uint8``: keep pixels as uint8 on the device (4× less memory and
    staging traffic) and turn them back into f32 / 255 in the gather. Values
    a host resize left off the 1/255 lattice move by ≤ 1/510; the default
    f32 storage is bit-exact against the host path.
    """

    def __init__(self, dataset, batch_size: int, device, store_uint8: bool = False):
        import torch

        imgs, labs = [], []
        for img, lab in dataset:
            a = np.asarray(img, np.float32)
            imgs.append(np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)
                        if store_uint8 else a)
            labs.append(np.asarray(lab, np.float32))
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.store_uint8 = store_uint8
        self.n = len(imgs)
        self.nbatches = self.n // batch_size
        self.nbytes = 0
        self.images = self.labels = None
        if self.n == 0:
            return  # empty split: batches() yields nothing (val-less runs)
        host_images = np.stack(imgs)
        host_labels = np.stack(labs)
        del imgs, labs
        self.nbytes = host_images.nbytes + host_labels.nbytes
        self.images = torch.from_numpy(host_images).to(self.device)
        self.labels = torch.from_numpy(host_labels).to(self.device)

    def batches(self, shuffle_seed=None):
        """One epoch of device-resident (images, labels) batches.

        ``shuffle_seed``: None = dataset order; an int seeds a FULL
        permutation of the split (``np.random.RandomState``, as the JAX
        package's), moved to the device once an epoch."""
        import torch

        if self.n == 0:
            return
        order = (np.arange(self.n, dtype=np.int64) if shuffle_seed is None
                 else np.random.RandomState(shuffle_seed & 0x7FFFFFFF)
                 .permutation(self.n).astype(np.int64))
        order = torch.from_numpy(order).to(self.device)
        for b in range(self.nbatches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            images = self.images.index_select(0, idx)
            if self.store_uint8:
                images = images.to(torch.float32) / 255.0
            yield images, self.labels.index_select(0, idx)


class DevicePrefetcher:
    """Background-thread prefetch: overlaps host decode and the host→device
    copy with device compute.

    A worker thread takes (images, labels) numpy batches from ``iterable``
    and, for a CUDA ``device``, stages each in pinned host memory and copies
    it without blocking on a side stream; the consumer's stream waits on the
    copy's event before it uses the batch, so a batch's transfer overlaps the
    previous step's kernels. At most ``buffer_size`` (2) batches are in flight.
    For the CPU the batches become tensors that share the numpy memory.
    ``rows`` (a slice): keep only those rows of every batch, before the copy
    — a data-parallel rank's ``local_batch_slice`` of the global batch that
    every rank iterates alike (the JAX trainer's ``put``).
    """

    def __init__(self, iterable, device, buffer_size: int = 2, rows=None):
        import torch

        self.iterable = iterable
        self.buffer_size = buffer_size
        self.device = torch.device(device)
        self.rows = slice(None) if rows is None else rows

    def __iter__(self):
        import torch

        on_card = self.device.type == "cuda"
        q: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        stop = object()
        err_box = []
        abandoned = threading.Event()  # consumer stopped consuming
        copy_stream = torch.cuda.Stream(self.device) if on_card else None

        def _put(item) -> bool:
            # bounded wait instead of a blocking put: if the consumer
            # abandoned the iterator (exception/break mid-epoch) the worker
            # must exit rather than pin device batches + a thread forever
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def to_device(batch):
            tensors = [torch.from_numpy(np.ascontiguousarray(a[self.rows])) for a in batch]
            if not on_card:
                return tuple(tensors), None
            with torch.cuda.stream(copy_stream):
                moved = tuple(t.pin_memory().to(self.device, non_blocking=True)
                              for t in tensors)
                done = torch.cuda.Event()
                done.record(copy_stream)
            return moved, done

        def worker():
            try:
                for batch in self.iterable:
                    if not _put(to_device(batch)):
                        return
            except BaseException as e:  # propagate to consumer
                err_box.append(e)
            finally:
                _put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if err_box:
                        raise err_box[0]
                    return
                batch, done = item
                if done is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(done)
                    # the allocator may not reuse the memory before this stream is done with it
                    for tensor in batch:
                        tensor.record_stream(current)
                yield batch
        finally:
            # generator closed/abandoned: release the worker and drain the
            # queue so device-resident batches are dropped promptly
            abandoned.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
