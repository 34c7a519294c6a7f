"""Batching detection server — the port's serving path.

Counterpart of ``yolov3_tpu/apps/serve_app.py``. This app wraps the
forward+decode+NMS predictor of ``inference_app.make_predictor`` (fp32 or
bf16 on the CUDA card, NMS sweeps in the hand-written kernels) behind an
HTTP server with **dynamic batching**:

  * the server pre-declares a small ladder of batch "buckets"
    (``batch_buckets: [1, 4, 16]``) so the device sees a few fixed batch
    shapes (warmed up at startup with ``warmup: true``).
  * Incoming requests queue up; a single dispatcher thread drains the
    queue, waits at most ``batch_timeout_ms`` for followers, zero-pads the
    group to the smallest bucket that fits, runs ONE device program, and
    fans the per-image results back to the waiting handler threads.
    One thread owns the device → no dispatch contention; handler threads
    only do host-side JPEG decode/resize (parallel, pure numpy/PIL).
  * Tail padding is free correctness-wise: every pipeline stage is
    per-image independent (same argument as DP serving).

Endpoints:
  * ``POST /detect``  — body = JPEG/PNG bytes → JSON detections (class id,
    name, score, box in original-image pixels + normalized xyxy).
  * ``GET /healthz``  — liveness + model/device info.
  * ``GET /stats``    — request counters, batch-size histogram, latency
    percentiles (measured enqueue→result, i.e. including batching delay).

Preprocessing matches the reference's ``image_file`` input mode (plain
square resize, /255 — reference inference.py:148-158), so a request's
detections are exactly what the inference CLI would print for that file.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

log = logging.getLogger(__name__)

MAX_BODY_BYTES = 32 * 1024 * 1024  # reject absurd uploads before decoding


class _Request:
    __slots__ = ("image", "event", "result", "error", "enqueue_t")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.enqueue_t = time.monotonic()


class ServerStats:
    """Thread-safe request/batch/latency counters for ``GET /stats``."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.batches = {}  # real group size -> count
        self.latencies_ms = deque(maxlen=window)

    def record_request(self, latency_ms: float):
        with self._lock:
            self.requests += 1
            self.latencies_ms.append(latency_ms)

    def record_error(self):
        with self._lock:
            self.errors += 1

    def record_batch(self, n_real: int):
        with self._lock:
            self.batches[n_real] = self.batches.get(n_real, 0) + 1

    def snapshot(self, queue_depth: int = 0) -> dict:
        with self._lock:
            lat = sorted(self.latencies_ms)
            pct = (lambda p: round(lat[min(len(lat) - 1, int(p * len(lat)))], 3)) if lat else (lambda p: None)
            return {
                "requests": self.requests,
                "errors": self.errors,
                "batch_histogram": {str(k): v for k, v in sorted(self.batches.items())},
                "latency_ms": {
                    "p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99),
                    "mean": round(sum(lat) / len(lat), 3) if lat else None,
                },
                "queue_depth": queue_depth,
            }

    def prometheus(self, queue_depth: int = 0) -> str:
        """Render the counters in Prometheus text exposition format
        (``GET /metrics`` — scrapeable by a stock Prometheus)."""
        s = self.snapshot(queue_depth)
        lines = [
            "# HELP yolov3_requests_total Detection requests served.",
            "# TYPE yolov3_requests_total counter",
            f"yolov3_requests_total {s['requests']}",
            "# HELP yolov3_request_errors_total Failed detection requests.",
            "# TYPE yolov3_request_errors_total counter",
            f"yolov3_request_errors_total {s['errors']}",
            "# HELP yolov3_queue_depth Requests waiting for the batcher.",
            "# TYPE yolov3_queue_depth gauge",
            f"yolov3_queue_depth {s['queue_depth']}",
            "# HELP yolov3_batches_total Device launches by real group size.",
            "# TYPE yolov3_batches_total counter",
        ]
        lines += [f'yolov3_batches_total{{size="{k}"}} {v}'
                  for k, v in s["batch_histogram"].items()]
        lat = s["latency_ms"]
        if lat["p50"] is not None:
            lines += [
                "# HELP yolov3_request_latency_ms Enqueue-to-result latency "
                "(sliding window).",
                "# TYPE yolov3_request_latency_ms summary",
                f'yolov3_request_latency_ms{{quantile="0.5"}} {lat["p50"]}',
                f'yolov3_request_latency_ms{{quantile="0.9"}} {lat["p90"]}',
                f'yolov3_request_latency_ms{{quantile="0.99"}} {lat["p99"]}',
            ]
        return "\n".join(lines) + "\n"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class DynamicBatcher:
    """Groups concurrent requests into one device batch.

    ``predictor`` takes a ``(bucket, H, W, 3)`` float32 array and returns
    the ``yolo_nms`` tuple ``(bboxes, class_idx, scores, selected,
    num_valid)`` (tensors or arrays); the eager forward serves every bucket
    with the same callable. Only the dispatcher thread touches the device.
    """

    def __init__(self, predictor, batch_buckets, batch_timeout_ms=5.0,
                 stats: ServerStats | None = None):
        if not batch_buckets:
            raise ValueError("batch_buckets must be non-empty")
        self.buckets = sorted(set(int(b) for b in batch_buckets))
        if self.buckets[0] < 1:
            raise ValueError(f"batch buckets must be >= 1, got {self.buckets}")
        self.timeout_s = float(batch_timeout_ms) / 1e3
        self.stats = stats or ServerStats()
        self._predictor = predictor
        self._queue: queue.Queue[_Request] = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="yolov3-batcher",
                                        daemon=True)
        self._thread.start()

    # -- client side ------------------------------------------------------
    def submit(self, image: np.ndarray, timeout: float = 60.0):
        """Block until the image's detections are ready; returns the
        per-image ``(bboxes, class_idx, scores)`` after valid-gather."""
        if self._stop.is_set():
            raise RuntimeError("batcher is shut down")
        req = _Request(image)
        self._queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("detection timed out")
        if req.error is not None:
            raise req.error
        self.stats.record_request((time.monotonic() - req.enqueue_t) * 1e3)
        return req.result

    def shutdown(self, timeout: float = 10.0):
        self._stop.set()
        self._thread.join(timeout)

    def queue_depth(self) -> int:
        return self._queue.qsize()

    # -- dispatcher side --------------------------------------------------
    def warmup(self, image_hw: tuple[int, int]):
        """Run every bucket once up front (one zeros batch each)."""
        h, w = image_hw
        for b in self.buckets:
            self._predictor(np.zeros((b, h, w, 3), np.float32))

    def _gather(self, batch):
        """Collect up to max-bucket requests, waiting ``timeout_s`` past
        the first arrival for followers."""
        deadline = time.monotonic() + self.timeout_s
        while len(batch) < self.buckets[-1]:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while True:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            batch = self._gather([first])
            bucket = next(b for b in self.buckets if b >= len(batch))
            self.stats.record_batch(len(batch))
            try:
                images = np.stack([r.image for r in batch], axis=0)
                if bucket > len(batch):
                    pad = np.zeros((bucket - len(batch),) + images.shape[1:],
                                   images.dtype)
                    images = np.concatenate([images, pad], axis=0)
                out = self._predictor(images)
                bboxes, class_idx, scores, selected, num_valid = map(_host, out)
                for i, req in enumerate(batch):
                    sel = selected[i][: int(num_valid[i])]
                    req.result = (bboxes[i][sel], class_idx[i][sel], scores[i][sel])
            except Exception as exc:  # surface the failure to every waiter
                log.exception("batch of %d failed", len(batch))
                for req in batch:
                    req.error = exc
            finally:
                for req in batch:
                    req.event.set()


class _Handler(BaseHTTPRequestHandler):
    # the ThreadingHTTPServer instance carries the app state (see serve())
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs through logging
        log.debug("%s %s", self.address_string(), fmt % args)

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        app = self.server.app
        if self.path == "/healthz":
            self._reply(200, app.health())
        elif self.path == "/stats":
            self._reply(200, app.stats.snapshot(app.batcher.queue_depth()))
        elif self.path == "/metrics":
            body = app.stats.prometheus(app.batcher.queue_depth()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        app = self.server.app
        if self.path != "/detect":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        if length <= 0:
            self._reply(400, {"error": "missing request body (image bytes)"})
            return
        if length > MAX_BODY_BYTES:
            self._reply(413, {"error": f"body exceeds {MAX_BODY_BYTES} bytes"})
            return
        data = self.rfile.read(length)
        try:
            result = app.detect(data)
        except ValueError as exc:
            app.stats.record_error()
            self._reply(400, {"error": str(exc)})
            return
        except Exception as exc:  # device/batcher failure
            app.stats.record_error()
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, result)


class DetectionApp:
    """Request pipeline shared by all handler threads, wrapping ONE ready
    predictor (a ``make_predictor`` result). One predictor serves every
    bucket, and a single params copy lives on the device."""

    def __init__(self, predictor, class_names, image_size,
                 batch_buckets=(1, 4, 16), batch_timeout_ms=5.0,
                 model_name="yolov3", quantize=None, letterbox=False):
        self.class_names = list(class_names)
        self.image_size = int(image_size)
        self.model_name = model_name
        self.quantize = quantize
        self.letterbox = bool(letterbox)
        self.stats = ServerStats()
        dev = getattr(predictor, "device", None)
        self._device = (torch.cuda.get_device_name(dev) if dev is not None
                        and dev.type == "cuda" else str(dev))
        self.batcher = DynamicBatcher(predictor, batch_buckets, batch_timeout_ms,
                                      stats=self.stats)

    def health(self) -> dict:
        return {
            "status": "ok",
            "model": self.model_name,
            "device": self._device,
            "image_size": self.image_size,
            "classes": len(self.class_names),
            "quantize": self.quantize,
            "letterbox": self.letterbox,
            "batch_buckets": self.batcher.buckets,
        }

    def detect(self, encoded_image: bytes) -> dict:
        """Decode → square-resize (or letterbox) → batched predict →
        JSON-able dict. With ``letterbox`` boxes are un-mapped to the
        original frame (both ``box`` and ``box_normalized``)."""
        from ..data.image import (decode_image, letterbox_resize,
                                  letterbox_unmap_boxes, resize_bilinear)

        t0 = time.monotonic()
        try:
            orig = decode_image(encoded_image).astype(np.float32) / 255.0
        except Exception as exc:
            raise ValueError(f"could not decode image: {exc}") from exc
        h, w = orig.shape[:2]
        prep = letterbox_resize if self.letterbox else resize_bilinear
        image = prep(orig, self.image_size, self.image_size)
        bboxes, class_idx, scores = self.batcher.submit(image)
        if self.letterbox and len(bboxes):
            bboxes = letterbox_unmap_boxes(bboxes, h, w,
                                           self.image_size, self.image_size)
        detections = []
        for box, cls, score in zip(bboxes, class_idx, scores):
            cls = int(cls)
            x1, y1, x2, y2 = (float(v) for v in box)
            detections.append({
                "class_id": cls,
                "class_name": self.class_names[cls] if 0 <= cls < len(self.class_names) else str(cls),
                "score": float(score),
                "box": [x1 * w, y1 * h, x2 * w, y2 * h],
                "box_normalized": [x1, y1, x2, y2],
            })
        return {
            "detections": detections,
            "width": w,
            "height": h,
            "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
        }

    def shutdown(self):
        self.batcher.shutdown()


def create_server(host, port, app: DetectionApp) -> ThreadingHTTPServer:
    # accept backlog sized for request storms: the http.server default (5)
    # drops concurrent connects with RST once accept() falls behind under
    # load (observed as client ConnectionResetError in the storm test on a
    # busy host); listen(128) lets the kernel queue them instead
    class _Server(ThreadingHTTPServer):
        request_queue_size = 128

    httpd = _Server((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.app = app
    return httpd


class Serve:
    """Config-driven entry point
    (``python -m yolov3_tpu_torch.apps.cli serve --config …``).

    Accepts the serve-config schema of the JAX package's ``serve.py``:
    the detect-config keys (model/weights/anchors/names/NMS/precision) plus
    ``host``, ``port``, ``batch_buckets``, ``batch_timeout_ms``, ``warmup``.
    ``device`` (default: the CUDA card) may be set to ``cpu``. The keys
    ``artifact``, ``data_parallel`` and ``spatial_partitioning`` belong to
    later slices of the port and raise ``NotImplementedError``.
    """

    def __call__(
        self,
        model_config_file=None,
        classes_name_file=None,
        anchors_file=None,
        input_weights_path=None,
        image_size=None,
        yolo_max_boxes=100,
        nms_iou_threshold=0.5,
        nms_score_threshold=0.3,
        quantize=None,
        compute_precision=None,
        host="127.0.0.1",
        port=8000,
        batch_buckets=(1, 4, 16),
        batch_timeout_ms=5.0,
        warmup=True,
        artifact=None,
        data_parallel=False,
        spatial_partitioning=1,
        letterbox=False,
        nms_per_class=False,
        serve_forever=True,
        device=None,
        **kwargs,
    ):
        later = [k for k, v in (("artifact", artifact), ("data_parallel", data_parallel),
                                ("spatial_partitioning", int(spatial_partitioning or 1) > 1))
                 if v]
        if later:
            raise NotImplementedError(
                f"serve keys {later} belong to later slices of the port "
                "(export artifact, data/spatial parallelism)")
        from .inference_app import build_serving_predictor

        missing = [k for k, v in [("model_config_file", model_config_file),
                                  ("classes_name_file", classes_name_file),
                                  ("anchors_file", anchors_file),
                                  ("input_weights_path", input_weights_path),
                                  ("image_size", image_size)] if not v]
        if missing:
            raise ValueError(f"serve config needs {missing}")
        predictor, class_names, model_name = build_serving_predictor(
            model_config_file, classes_name_file, anchors_file,
            input_weights_path, image_size, yolo_max_boxes,
            nms_iou_threshold, nms_score_threshold, quantize,
            compute_precision, nms_per_class=nms_per_class, device=device)

        app = DetectionApp(
            predictor, class_names, image_size,
            batch_buckets=batch_buckets, batch_timeout_ms=batch_timeout_ms,
            model_name=model_name, quantize=quantize, letterbox=letterbox,
        )
        if warmup:
            t0 = time.monotonic()
            app.batcher.warmup((image_size, image_size))
            log.info("warmup ran %s in %.1fs", app.batcher.buckets,
                     time.monotonic() - t0)

        httpd = create_server(host, int(port), app)
        previous = None
        if serve_forever:
            import signal

            def _drain(signum, frame):
                # SIGTERM: stop accepting, let in-flight batches finish, then
                # exit serve_forever (shutdown() must run off the loop's thread)
                log.info("signal %d: draining and shutting down", signum)
                threading.Thread(target=httpd.shutdown, daemon=True).start()

            previous = signal.signal(signal.SIGTERM, _drain)
        log.info("serving on http://%s:%d (POST /detect)", host, httpd.server_address[1])
        if serve_forever:
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                signal.signal(signal.SIGTERM, previous)
                httpd.shutdown()
                app.shutdown()
        return httpd, app
