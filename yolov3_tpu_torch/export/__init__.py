"""Export backends of the port: the browser (TFJS) graph-model and the
serving artifact (``torch.export`` programs, ``aot.py``)."""

from .aot import (  # noqa: F401
    export_detector,
    load_detector_artifact,
    save_detector_artifact,
)
from .tfjs_graph import (  # noqa: F401
    TFJS_SUPPORTED_OPS,
    build_tf_graph,
    quantize_weight,
    read_graph_model,
    run_graph_model,
    write_graph_model,
)
