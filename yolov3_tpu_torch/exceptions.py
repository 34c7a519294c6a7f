"""Framework exceptions (reference core/exceptions.py surface).

Framework-neutral copy of ``yolov3_tpu/exceptions.py`` (the port imports nothing of the
JAX package). tests/test_torch_eval.py pins it to its original.
"""


class NoDetectionsFound(Exception):
    """Raised when an inference pass yields zero valid detections
    (reference core/exceptions.py:14-16; unused there, available here)."""
