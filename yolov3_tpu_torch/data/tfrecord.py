"""Dependency-free TFRecord + tf.train.Example reader.

The reference reads detection TFRecords through tf.data
(core/load_tfrecords.py:18-101). This framework reads the same files with
a ~150-line pure-Python/numpy implementation — no TensorFlow import:

  * TFRecord framing: [uint64 length][uint32 masked-crc(length)]
    [data][uint32 masked-crc(data)] — CRCs are validated (crc32c).
  * tf.train.Example protobuf: hand-rolled wire-format decoder for the
    tiny message subset Example uses (Features → map<string, Feature> →
    {bytes_list, float_list, int64_list}).

Feature schema parity (load_tfrecords.py:34-41): image/encoded,
image/object/class/text, image/object/bbox/{xmin,ymin,xmax,ymax}.
Label rows are [xmin, ymin, xmax, ymax, obj=1, class_id] padded to
max_bboxes (load_tfrecords.py:52-74).

Framework-neutral copy of ``yolov3_tpu/data/tfrecord.py`` (host code in numpy; the port
imports nothing of the JAX package). tests/test_torch_data.py pins it to its original.
"""

from __future__ import annotations

import glob
import os
import struct

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (software table implementation — hot path is JPEG decode, not CRC)
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c_table():
    """256-entry CRC32C lookup table as a plain Python list (list indexing
    beats np scalar indexing in the per-byte fallback loop)."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tab = _crc32c_table()
    crc_val = 0xFFFFFFFF
    for b in data:
        crc_val = tab[(crc_val ^ b) & 0xFF] ^ (crc_val >> 8)
    return crc_val ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def iter_tfrecord_records(path: str, validate_crc: bool = True):
    """Yield raw record bytes from one TFRecord file.

    Uses the native scanner (hardware CRC32C) when the C++ core is built;
    falls back to the pure-Python framing otherwise.
    """
    from . import native

    if native.available():
        with open(path, "rb") as f:
            buf = f.read()
        try:
            spans = native.scan_tfrecord(buf, validate=validate_crc)
        except IOError as e:
            raise IOError(f"{path}: {e}") from e
        if spans is not None:
            for offset, length in spans:
                yield buf[offset : offset + length]
            return
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if validate_crc and masked_crc(header[:8]) != len_crc:
                raise IOError(f"{path}: length CRC mismatch")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"{path}: truncated record body")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if validate_crc and masked_crc(data) != data_crc:
                raise IOError(f"{path}: data CRC mismatch")
            yield data


def iter_tfrecord_files(tfrecords_dir: str):
    """All *.tfrec files in a dir (reference globs '*.tfrec',
    load_tfrecords.py:92)."""
    return sorted(glob.glob(os.path.join(tfrecords_dir, "*.tfrec")))


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format decode for tf.train.Example
# ---------------------------------------------------------------------------


def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = bytes(buf[pos : pos + 8]); pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]; pos += ln
        elif wire == 5:  # 32-bit
            val = bytes(buf[pos : pos + 4]); pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: memoryview):
    """Feature = oneof {bytes_list=1, float_list=2, int64_list=3}."""
    for field, _, val in _iter_fields(buf):
        if field == 1:  # BytesList { repeated bytes value = 1 }
            return [bytes(v) for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:  # FloatList { repeated float value = 1 [packed] }
            floats = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    floats.extend(np.frombuffer(v, "<f4").tolist())
                else:
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:  # Int64List { repeated int64 value = 1 [packed] }
            ints = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(x)
                else:
                    ints.append(v)
            return ints
    return []


def parse_example(record: bytes) -> dict:
    """tf.train.Example → {feature_name: list}."""
    features = {}
    buf = memoryview(record)
    for field, _, val in _iter_fields(buf):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(val):
            if f2 != 1:  # Features.feature (map entry)
                continue
            name, feat = None, []
            for f3, _, v3 in _iter_fields(entry):
                if f3 == 1:
                    name = bytes(v3).decode("utf-8")
                elif f3 == 2:
                    feat = _parse_feature(v3)
            if name is not None:
                features[name] = feat
    return features


# ---------------------------------------------------------------------------
# Detection-example decoding (schema parity with the reference)
# ---------------------------------------------------------------------------


def decode_detection_example_into(example: dict, img_out: np.ndarray,
                                  lab_out: np.ndarray, class_to_id):
    """One parsed Example decoded straight into caller-provided slots:
    ``img_out`` float32 (S, S, 3) gets the resized image in [0,1] (the
    native path writes each pixel exactly once — no intermediate buffer),
    ``lab_out`` float32 (max_bboxes, 6) gets the padded label rows. This
    is the per-slot worker of ``stream_batches``."""
    from . import native
    from .image import decode_image, resize_bilinear

    image_size = img_out.shape[0]
    max_bboxes = lab_out.shape[0]
    encoded = example["image/encoded"][0]
    done = False
    if encoded[:2] == b"\xff\xd8":  # JPEG → fused native decode+resize
        done = native.decode_resize_jpeg_into(encoded, img_out)
    if not done:
        img = decode_image(encoded)
        img_out[...] = resize_bilinear(
            img.astype(np.float32), image_size, image_size) / 255.0

    lab_out[:] = 0.0
    xmin = np.asarray(example.get("image/object/bbox/xmin", []), np.float32)
    ymin = np.asarray(example.get("image/object/bbox/ymin", []), np.float32)
    xmax = np.asarray(example.get("image/object/bbox/xmax", []), np.float32)
    ymax = np.asarray(example.get("image/object/bbox/ymax", []), np.float32)
    names = [b.decode("utf-8") for b in example.get("image/object/class/text", [])]

    nboxes = len(xmin)
    if nboxes > max_bboxes:
        raise ValueError(f"example has {nboxes} boxes > max_bboxes={max_bboxes}")
    if nboxes:
        # class lookup parity: unknown names → -1 (StaticHashTable default,
        # load_tfrecords.py:89-91)
        ids = np.asarray([class_to_id.get(n, -1) for n in names], np.float32) \
            if class_to_id is not None else np.ones((nboxes,), np.float32)
        lab_out[:nboxes, 0] = xmin
        lab_out[:nboxes, 1] = ymin
        lab_out[:nboxes, 2] = xmax
        lab_out[:nboxes, 3] = ymax
        lab_out[:nboxes, 4] = 1.0
        if class_to_id is not None:
            lab_out[:nboxes, 5] = ids


def decode_detection_example(example: dict, image_size: int, max_bboxes: int, class_to_id):
    """One parsed Example → (image float32 (S,S,3) in [0,1], labels (M,6))."""
    img = np.empty((image_size, image_size, 3), np.float32)
    labels = np.zeros((max_bboxes, 6), np.float32)
    decode_detection_example_into(example, img, labels, class_to_id)
    return img, labels


# ---------------------------------------------------------------------------
# Writing (fixtures / dataset-creation tooling)
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(field_num: int, wire: int, payload: bytes) -> bytes:
    return _varint((field_num << 3) | wire) + payload


def _bytes_list_feature(values: list[bytes]) -> bytes:
    inner = b"".join(_field(1, 2, _varint(len(v)) + v) for v in values)
    return _field(1, 2, _varint(len(inner)) + inner)


def _float_list_feature(values) -> bytes:
    packed = np.asarray(values, "<f4").tobytes()
    inner = _field(1, 2, _varint(len(packed)) + packed)
    return _field(2, 2, _varint(len(inner)) + inner)


def encode_example(features: dict) -> bytes:
    """{name: list[bytes] | list[float]} → serialized tf.train.Example."""
    entries = b""
    for name, values in features.items():
        if values and isinstance(values[0], (bytes, bytearray, str)):
            vals = [v.encode() if isinstance(v, str) else bytes(v) for v in values]
            feat = _bytes_list_feature(vals)
        else:
            feat = _float_list_feature(values)
        key = name.encode()
        entry = _field(1, 2, _varint(len(key)) + key) + _field(2, 2, _varint(len(feat)) + feat)
        entries += _field(1, 2, _varint(len(entry)) + entry)
    return _field(1, 2, _varint(len(entries)) + entries)


def write_tfrecord(path: str, records: list[bytes]):
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc(data)))


def parse_tfrecords(tfrecords_dir: str, image_size: int, max_bboxes: int,
                    class_file: str | None = None, num_workers: int | None = None):
    """Generator of (image, labels) over all records in a dir — the
    reference's parse_tfrecords surface (load_tfrecords.py:77-101).

    Decode is spread over a thread pool (the native decode path holds no
    GIL), order-preserving, with a bounded in-flight window.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    class_to_id = None
    if class_file:
        from ..config import read_class_names

        class_to_id = {n: i for i, n in enumerate(read_class_names(class_file))}

    def records():
        for path in iter_tfrecord_files(tfrecords_dir):
            yield from iter_tfrecord_records(path)

    def decode(record):
        return decode_detection_example(parse_example(record), image_size, max_bboxes, class_to_id)

    if num_workers is None:
        # sequential by default: the device prefetcher already overlaps host
        # decode with device compute, and pool startup dominates on small
        # sets. Pass num_workers>1 for large-image training corpora.
        num_workers = 1
    if num_workers <= 1:
        for record in records():
            yield decode(record)
        return

    window = 4 * num_workers
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: deque = deque()
        it = records()
        try:
            for record in it:
                pending.append(pool.submit(decode, record))
                if len(pending) >= window:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
        finally:
            for fut in pending:
                fut.cancel()


def stream_batches(tfrecords_dir: str, image_size: int, max_bboxes: int,
                   batch_size: int, class_file: str | None = None,
                   num_workers: int = 4, shuffle=None):
    """Zero-copy batched streaming: yield (images (B,S,S,3) f32,
    labels (B,M,6) f32) with each example decoded by a worker thread
    STRAIGHT INTO its batch slot.

    Versus ``Batcher(Dataset(parse_tfrecords(...)))`` this removes the two
    GIL-serialized costs the input-pipeline bench identified (PERF.md):
    the per-example 2 MB output allocation and the 266 MB ``np.stack``
    copy per 416² B=128 batch — each pixel is written exactly once, by the
    native decoder, GIL-free. Up to two batches are in flight so decode of
    batch k+1 overlaps the consumer's use of batch k. Batch arrays are
    freshly allocated per batch on purpose: glibc recycles the just-freed
    previous batch, so steady-state writes hit warm pages (the
    buffer-ring alternative measured slower — PERF.md).

    ``shuffle``: None or ``(buffer_size, seed)`` — reservoir-shuffles the
    RAW records through ``pipeline.shuffled`` before decode. The swap
    sequence depends only on positions and the seeded RNG, so the example
    order is identical to shuffling decoded examples (pinned by test).

    Semantics parity: exactly ``Batcher(shuffled?(Dataset(
    parse_tfrecords(...))), batch_size)`` — same order, same values, same
    drop-remainder behavior, and decode errors in the dropped remainder
    still raise (the generic path decodes those examples too).
    """
    from concurrent.futures import ThreadPoolExecutor

    class_to_id = None
    if class_file:
        from ..config import read_class_names

        class_to_id = {n: i for i, n in enumerate(read_class_names(class_file))}

    def records():
        for path in iter_tfrecord_files(tfrecords_dir):
            yield from iter_tfrecord_records(path)

    rec_source = records()
    if shuffle is not None:
        from .pipeline import Dataset, shuffled

        buffer_size, seed = shuffle
        rec_source = iter(shuffled(Dataset(lambda: records()), buffer_size, seed))

    def decode_into(record, img_slot, lab_slot):
        decode_detection_example_into(
            parse_example(record), img_slot, lab_slot, class_to_id)

    def open_batch():
        return (np.empty((batch_size, image_size, image_size, 3), np.float32),
                np.zeros((batch_size, max_bboxes, 6), np.float32), [])

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending: list = []  # at most 2 full batches in flight
        cur = open_batch()
        slot = 0
        try:
            for record in rec_source:
                images, labels, futs = cur
                futs.append(pool.submit(decode_into, record,
                                        images[slot], labels[slot]))
                slot += 1
                if slot == batch_size:
                    pending.append(cur)
                    cur = open_batch()
                    slot = 0
                    if len(pending) == 2:
                        images, labels, futs = pending.pop(0)
                        for f in futs:
                            f.result()
                        yield images, labels
            # surface decode errors from the dropped remainder (generic-path
            # parity: Batcher pulls those examples through decode too)
            pending.append(cur)
            for images, labels, futs in pending:
                for f in futs:
                    f.result()
                if len(futs) == batch_size:
                    yield images, labels
        finally:
            for _, _, futs in pending + [cur]:
                for f in futs:
                    f.cancel()
