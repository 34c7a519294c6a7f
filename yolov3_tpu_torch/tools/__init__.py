"""Command-line tools of the port, run as ``python -m yolov3_tpu_torch.tools.<name>``."""
