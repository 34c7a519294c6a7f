"""The benchmark of yolov3_tpu_torch on one H100: see BENCHMARK.json and run.py."""
