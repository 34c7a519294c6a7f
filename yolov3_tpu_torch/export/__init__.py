"""Export backends of the port: the browser (TFJS) graph-model, written and
run without TensorFlow (``tfjs_graph.py``, ``tfjs_runtime.py``), and the
serving artifact (``torch.export`` programs, ``aot.py``)."""

from .aot import (  # noqa: F401
    export_detector,
    load_detector_artifact,
    save_detector_artifact,
)
from .tfjs_graph import (  # noqa: F401
    TFJS_SUPPORTED_OPS,
    GraphTopology,
    build_graph_topology,
    quantize_weight,
    read_graph_model,
    write_graph_model,
)
from .tfjs_runtime import GraphModel, run_graph_model  # noqa: F401
