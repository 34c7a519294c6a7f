"""The benchmark of yolov3_tpu_torch on one H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell (``portbench/workloads/<cell>.json``)
names a configuration (``configs/<config>.json``: the model file, classes,
image size, anchors) and holds its traffic (batch, tier or precision, NMS,
boxes), its ``mode``, which picks its module (``modes/<mode>.py``), and the
check's limits. A run makes the weights and
the inputs from ``--seed`` on the card, builds the program's entry for the
cell, warms up every shape the window uses (all of that is ``setup_s``,
from the process's start to the first timed batch or step), measures for
``--seconds``, and checks what the timed path produced against the plain
reference (``judge.py``). With ``--trace 1`` it then profiles a stretch of
batches or steps and reports the cell's per-layer metrics
(``metrics/<name>.py``, found by the names in ``BENCHMARK.json``) in place
of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), and last ``check``, each compared number with its limit; the same
numbers are the last lines of standard error. Without a card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded, the
run prints no result and exits non-zero.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "yolov3_tpu")


def _environment():
    """Build caches inside the checkout, at fixed paths."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """One run: its data files and arguments, and what the mode leaves in it."""

    def __init__(self, name, seed, seconds, trace, device, config=None, cell=None):
        import torch

        self.name, self.seed = name, int(seed)
        self.seconds, self.trace = float(seconds), bool(trace)
        self.device = torch.device(device)
        self.cell = cell or load_json("portbench", "workloads", f"{name}.json")
        self.config = config or load_json("portbench", "configs", f"{self.cell['config']}.json")
        self.setup_s = None
        self.window, self.spans, self.e2e, self.check = {}, {}, {}, {}
        self.evidence = None
        self.attempted = self.failed = 0
        self.trace_data = None
        self.memory_peak = 0
        self.check_s = None

    def path(self, rel):
        return os.path.join(ROOT, rel)

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, what):
        """Note on standard error when a part of the set-up ended."""
        print(f"portbench: {what} at {time.perf_counter() - PROCESS_START:.3f} s",
              file=sys.stderr, flush=True)

    def setup_done(self):
        self.setup_s = time.perf_counter() - PROCESS_START
        self.mark("set-up")

    def profile(self, run, units):
        from portbench.trace import profile

        self.trace_data = profile(run, units)

    def read_memory(self):
        import torch

        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def verdict(limits, numbers):
    """The cell's ``limits`` over the check's ``numbers`` → (correct,
    {name: {"value", "limit"}}): correct where every number is finite and
    at most its limit."""
    values = {name: float(numbers[name]) for name in limits}
    correct = all(math.isfinite(v) and v <= limits[n] for n, v in values.items())
    # a gap that is not a number stays readable in strict JSON
    return correct, {n: {"value": v if math.isfinite(v) else str(v), "limit": limits[n]}
                     for n, v in values.items()}


def run_cell(ctx):
    """Drive the cell's mode over ``ctx``, check what it produced and read
    its metrics → the result dict (without ``device``)."""
    from portbench.flops import layer_table
    from portbench.records import Records, reader
    from portbench.reference.graph import load_graph

    mode = importlib.import_module(f"portbench.modes.{ctx.cell['mode']}")
    mode.run(ctx)
    checked_at = time.perf_counter()
    ctx.check = mode.check(ctx, ctx.evidence)
    ctx.check_s = time.perf_counter() - checked_at
    bench = load_json("BENCHMARK.json")
    applies = lambda m: ctx.name in m.get("workloads", [ctx.name])  # noqa: E731
    result = {"attempted": ctx.attempted, "failed": ctx.failed}
    if not ctx.trace:
        values = dict(ctx.e2e, setup_s=ctx.setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in bench["end_to_end"] if applies(m)}
    else:
        graph = load_graph(ctx.path(ctx.config["model"]), int(ctx.config["classes"]))
        rec = Records(ctx.cell, ctx.config,
                      layer_table(graph, int(ctx.config["classes"]), int(ctx.config["image_size"])),
                      int(ctx.cell["batch"]), ctx.spans, ctx.window, ctx.trace_data)
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m):
                value = reader(m["name"])(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        if ctx.trace_data is not None:
            result["breakdown"] = {"device_ops": ctx.trace_data.device_ops(),
                                   "idle_gaps": ctx.trace_data.idle_gaps()}
    result["correct"], result["check"] = verdict(ctx.cell["limits"], ctx.check)
    return result


def _power_limit():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def main(argv=None):
    _environment()
    ap = argparse.ArgumentParser(prog="python3 portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    # one thread for the host's own tensor work: idle intra-op workers spin
    # beside the thread that launches the kernels
    torch.set_num_threads(1)
    cell = load_json("portbench", "workloads", f"{args.workload}.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on {_power_limit()}, torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    ctx = Context(args.workload, args.seed, args.seconds, args.trace, "cuda", cell=cell)
    result = run_cell(ctx)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                        "memory_peak_bytes": ctx.memory_peak}
    if ctx.trace_data is not None:
        result["device"].update(busy_s=ctx.trace_data.busy_us() / 1e6,
                                window_s=ctx.trace_data.window_us() / 1e6)
    check = result.pop("check")
    result = {"correct": result.pop("correct"), **result, "check": check}
    print(f"portbench: memory peak {ctx.memory_peak} bytes; setup {ctx.setup_s} s; window "
          f"{json.dumps(ctx.window)}; the check took {ctx.check_s} s", file=sys.stderr)
    print(f"readings {json.dumps(ctx.check)}", file=sys.stderr)
    for name, c in check.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
