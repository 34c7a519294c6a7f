"""jsvm: the port's execution harness for the browser port (js/src).

A lexer, parser and interpreter for the ES-2020 subset the browser sources
use, plus a numpy TFJS API shim with TFJS's tidy/dispose memory semantics, so
that the real js/src sources run in Python against the Python pipeline
(``ops/decode.py``, ``ops/nms.py``) and against an exported TFJS graph-model
(``export/tfjs_graph.py``), which ``GraphModelHost`` runs through the port's
PyTorch executor (``export/tfjs_runtime.py``) on the card, or on the CPU
where the caller asks.

    from functools import partial
    from yolov3_tpu_torch.jsvm import GraphModelHost, Interpreter, TfShim

    shim = TfShim(model_loader=partial(GraphModelHost, device="cuda"))
    interp = Interpreter({"tf": shim})
    mod = interp.load_module("js/src/inference.js")
    detections = interp.call(mod["runInference"], {...})

``tools/run_js_pipeline.py`` drives it from the command line. The lexer,
parser and interpreter, and the shim apart from ``GraphModelHost``, are
copies of the JAX package's ``yolov3_tpu/jsvm/`` (numpy and the standard
library only); tests/test_torch_jsvm.py pins them.
"""

from .interp import (Interpreter, JSFunction, JSPromise, JsError,
                     JsSyntaxError, JsThrow, js_to_string, js_truthy)
from .tfshim import (GraphModelHost, JsImage, RecordingCanvas,
                     RecordingContext2D, TfShim, TfTensor)

__all__ = [
    "Interpreter", "JSFunction", "JSPromise", "JsError", "JsSyntaxError",
    "JsThrow", "js_to_string", "js_truthy",
    "GraphModelHost", "JsImage", "RecordingCanvas", "RecordingContext2D",
    "TfShim", "TfTensor",
]
