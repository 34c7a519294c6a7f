"""TensorBoard scalar logging — dependency-free event-file writer.

The reference has no metrics system (its TensorBoard callback is commented
out at reference train.py:200-204; observability is `logging.info` loss
lines). This gives the train app real observability without importing
TensorFlow: a `SummaryWriter` that emits standard
``events.out.tfevents.*`` files any stock TensorBoard can read.

Format notes (kept deliberately tiny):
  * An event file is TFRecord framing ([len u64][masked-crc32c(len) u32]
    [payload][masked-crc32c(payload) u32]) — framing + CRC shared with
    ``data/tfrecord.py`` (the same code that round-trips the reference's
    .tfrec fixtures).
  * Each payload is a serialized ``tensorflow.Event`` proto. We hand-encode
    the three shapes we need (protobuf wire format is stable by contract):
      Event{ wall_time: double=1, step: int64=2, file_version: string=3,
             summary: Summary=5 }
      Summary{ value: repeated Value=1 }
      Summary.Value{ tag: string=1, simple_value: float=2 }
  * First record is the canonical ``file_version: "brain.Event:2"`` header
    event TensorBoard uses for format detection.

Compatibility is pinned by tests/test_tb.py, which reads the files back
with TensorFlow's own ``event_pb2`` when TF is available.

Framework-neutral copy of ``yolov3_tpu/utils/tb.py`` (the port imports nothing of the
JAX package). tests/test_torch_tb.py pins it to its original.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

from ..data.tfrecord import masked_crc

__all__ = ["SummaryWriter"]


def _varint(n: int) -> bytes:
    """Protobuf base-128 varint (non-negative)."""
    if n < 0:
        raise ValueError("varint encoder only handles non-negative values")
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, value: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict[str, float] | None = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, int(step))
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode()) + _field_float(2, float(value)))
            for tag, value in scalars.items())
        msg += _field_bytes(5, summary)
    return msg


class SummaryWriter:
    """Append-only TensorBoard event writer (thread-safe, flush-on-write).

    >>> with SummaryWriter("runs/exp1") as tb:
    ...     tb.add_scalar("train/loss", 3.2, step=0)
    ...     tb.add_scalars({"train/loss": 2.9, "train/lr": 1e-3}, step=1)
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._lock = threading.Lock()
        self._file = open(self.path, "wb")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        with self._lock:
            self._file.write(header)
            self._file.write(struct.pack("<I", masked_crc(header)))
            self._file.write(payload)
            self._file.write(struct.pack("<I", masked_crc(payload)))
            self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: float | None = None):
        self.add_scalars({tag: value}, step, wall_time=wall_time)

    def add_scalars(self, scalars: dict[str, float], step: int,
                    wall_time: float | None = None):
        """One Event carrying every (tag, value) pair at ``step``."""
        self._write(_event(wall_time if wall_time is not None else time.time(),
                           step=step, scalars=scalars))

    def flush(self):
        with self._lock:
            self._file.flush()
            os.fsync(self._file.fileno())

    def close(self):
        with self._lock:
            if not self._file.closed:
                self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
