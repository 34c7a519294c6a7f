"""Detection-endpoint client — the Python counterpart of ``serve.py``.

Dependency-free (urllib): point it at a running server and get the JSON
the endpoint returns, with image inputs accepted as raw encoded bytes, a
file path, or a numpy array (PNG-encoded via PIL on the way out).

>>> from yolov3_tpu.client import DetectionClient
>>> client = DetectionClient("http://localhost:8000")
>>> result = client.detect("dog.jpg")
>>> [(d["class_name"], d["score"]) for d in result["detections"]]

Framework-neutral copy of ``yolov3_tpu/client.py`` (the port imports nothing of the
JAX package). tests/test_torch_eval.py pins it to its original.
"""

from __future__ import annotations

import json
import urllib.request


class DetectionClient:
    def __init__(self, base_url: str, timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)

    def _get(self, path: str):
        with urllib.request.urlopen(self.base_url + path,
                                    timeout=self.timeout) as resp:
            return resp.read()

    def detect(self, image) -> dict:
        """``image``: encoded bytes, a file path, or an (H, W, 3) uint8 /
        float [0,1] numpy array. Returns the server's JSON dict
        (``detections`` with class/score/box, ``width``, ``height``)."""
        data = self._encode(image)
        req = urllib.request.Request(self.base_url + "/detect", data=data,
                                     method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    @staticmethod
    def _encode(image) -> bytes:
        if isinstance(image, bytes):
            return image
        if isinstance(image, str):
            with open(image, "rb") as f:
                return f.read()
        import io

        import numpy as np
        from PIL import Image

        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    def health(self) -> dict:
        return json.loads(self._get("/healthz"))

    def stats(self) -> dict:
        return json.loads(self._get("/stats"))

    def metrics(self) -> str:
        return self._get("/metrics").decode()


__all__ = ["DetectionClient"]
