"""Nothing the benchmark runs loads JAX or the JAX package, and its plain
reference loads nothing of the port: top-level module names compared whole
(``yolov3_tpu_torch`` is not ``yolov3_tpu``), in fresh interpreters."""

import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "yolov3_tpu"}

PROBE = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    importlib.import_module(name)
{extra}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_level_after(modules, extra=""):
    code = PROBE.format(root=ROOT, modules=modules, extra=extra)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def portbench_modules():
    names = []
    for path in glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"), recursive=True):
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if ".tests." in rel or rel.startswith("portbench.metrics."):
            continue
        names.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(names)


def test_the_benchmark_loads_no_jax_and_no_jax_package():
    readers = ("from portbench.records import reader\n"
               "import os\n"
               "for f in os.listdir(os.path.join({root!r}, 'portbench', 'metrics')):\n"
               "    reader(f[:-3])\n").format(root=ROOT)
    # the program's entries the modes call
    program = ("import yolov3_tpu_torch.apps.inference_app, yolov3_tpu_torch.ops.nms, "
               "yolov3_tpu_torch.parallel.train_step, yolov3_tpu_torch.models.network\n")
    loaded = top_level_after(portbench_modules(), readers + program)
    assert "yolov3_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    modules = [m for m in portbench_modules() if m.startswith("portbench.reference")]
    assert "portbench.reference.model" in modules
    loaded = top_level_after(modules)
    assert not loaded & (FORBIDDEN | {"yolov3_tpu_torch"})
