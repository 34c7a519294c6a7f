"""numpy-backed TFJS API shim for executing the browser port in-process.

The browser port (js/src/*.js) programs against the TFJS 4.x API. This
module provides the surface it touches: chainable tensor methods, ``tf.*``
namespace ops, ``tf.image.nonMaxSuppressionAsync`` with TF kernel semantics
(score filter ``> scoreThreshold``, suppression ``iou > iouThreshold``,
stable score ordering), ``tf.browser.fromPixels`` and the
half-pixel-centers ``resizeBilinear`` (delegating to data/image.py's
TF-exact resampler), so that jsvm runs the port's real source against the
Python pipeline.

Memory discipline is modelled rather than ignored: every tensor registers
with the shim, ``tf.tidy`` reclaims intermediates created in its scope
except those reachable from the return value (TFJS semantics), and
``tf.dispose`` frees explicitly. Tests assert the port leaves no live
tensor behind.

``tf.loadGraphModel`` is ``GraphModelHost``: the exported graph-model
(model.json + shards) loaded once into ``export/tfjs_runtime.GraphModel``, a
PyTorch executor of its nodes, on the card unless the caller asks for the
CPU. That class is the port's own; everything else is a framework-neutral
copy of ``yolov3_tpu/jsvm/tfshim.py`` (numpy; the port imports nothing of
the JAX package). tests/test_torch_jsvm.py pins its code, everything after
this docstring apart from ``GraphModelHost``, to its original.
"""

from __future__ import annotations

import numpy as np

from .interp import JSPromise, JsError

__all__ = ["TfShim", "TfTensor", "GraphModelHost", "JsImage",
           "RecordingCanvas", "RecordingContext2D"]


def _axis(a, ndim):
    a = int(a)
    return a + ndim if a < 0 else a


class TfTensor:
    """Chainable TFJS-style tensor over a numpy array."""

    def __init__(self, shim: "TfShim", arr):
        self._shim = shim
        self._arr = np.asarray(arr)
        self._disposed = False
        shim._track(self)

    # -- infrastructure --------------------------------------------------
    def _np(self) -> np.ndarray:
        if self._disposed:
            raise JsError("tensor is disposed (use-after-dispose in the JS port)")
        return self._arr

    def _new(self, arr) -> "TfTensor":
        return TfTensor(self._shim, arr)

    @property
    def shape(self):
        return [int(d) for d in self._np().shape]

    @property
    def dtype(self):
        kind = self._np().dtype.kind
        return {"f": "float32", "i": "int32", "b": "bool", "u": "int32"}[kind]

    @property
    def size(self):
        return float(self._np().size)

    @property
    def rank(self):
        return float(self._np().ndim)

    # -- shape ops -------------------------------------------------------
    def reshape(self, shape):
        return self._new(self._np().reshape([int(d) for d in shape]))

    def slice(self, begin, size):
        a = self._np()
        begin = [int(b) for b in begin]
        size = [int(s) for s in size]
        idx = tuple(
            slice(b, a.shape[d] if s == -1 else b + s)
            for d, (b, s) in enumerate(zip(begin, size)))
        return self._new(a[idx])

    def tile(self, reps):
        return self._new(np.tile(self._np(), [int(r) for r in reps]))

    def squeeze(self, axis=None):
        a = self._np()
        if axis is None:
            return self._new(np.squeeze(a))
        return self._new(np.squeeze(a, axis=_axis(axis, a.ndim)))

    def expandDims(self, axis=0):
        a = self._np()
        return self._new(np.expand_dims(a, _axis(axis, a.ndim + 1)))

    def transpose(self, perm=None):
        return self._new(np.transpose(
            self._np(), None if perm is None else [int(p) for p in perm]))

    # -- dtype -----------------------------------------------------------
    def toFloat(self):
        return self._new(self._np().astype(np.float32))

    def toInt(self):
        return self._new(self._np().astype(np.int32))

    def cast(self, dtype):
        np_dtype = {"float32": np.float32, "int32": np.int32, "bool": np.bool_}[dtype]
        return self._new(self._np().astype(np_dtype))

    # -- elementwise math (TFJS accepts tensor | scalar | nested array) --
    def _operand(self, o):
        if isinstance(o, TfTensor):
            return o._np()
        if isinstance(o, (list, tuple)):
            return np.asarray(o, np.float32)
        return np.float32(o)

    def add(self, o):
        return self._new(np.add(self._np(), self._operand(o), dtype=np.float32))

    def sub(self, o):
        return self._new(np.subtract(self._np(), self._operand(o), dtype=np.float32))

    def mul(self, o):
        return self._new(np.multiply(self._np(), self._operand(o), dtype=np.float32))

    def div(self, o):
        return self._new(np.divide(self._np(), self._operand(o), dtype=np.float32))

    def exp(self):
        return self._new(np.exp(self._np(), dtype=np.float32))

    def sigmoid(self):
        a = self._np().astype(np.float32)
        return self._new(_sigmoid(a))

    # -- reductions ------------------------------------------------------
    def max(self, axis=None, keepDims=False):
        a = self._np()
        if axis is None:
            return self._new(np.max(a))
        return self._new(np.max(a, axis=_axis(axis, a.ndim),
                                keepdims=bool(keepDims)))

    def min(self, axis=None, keepDims=False):
        a = self._np()
        if axis is None:
            return self._new(np.min(a))
        return self._new(np.min(a, axis=_axis(axis, a.ndim),
                                keepdims=bool(keepDims)))

    def sum(self, axis=None, keepDims=False):
        a = self._np()
        if axis is None:
            return self._new(np.sum(a, dtype=np.float32))
        return self._new(np.sum(a, axis=_axis(axis, a.ndim),
                                keepdims=bool(keepDims), dtype=np.float32))

    def argMax(self, axis=-1):
        a = self._np()
        return self._new(np.argmax(a, axis=_axis(axis, a.ndim)).astype(np.int32))

    # -- gather / host transfer ------------------------------------------
    def gather(self, indices, axis=0):
        idx = indices._np() if isinstance(indices, TfTensor) else \
            np.asarray([int(i) for i in indices], np.int32)
        a = self._np()
        return self._new(np.take(a, idx.astype(np.int64), axis=_axis(axis, a.ndim)))

    def array(self):
        return JSPromise(self._np().tolist())

    def arraySync(self):
        return self._np().tolist()

    def data(self):
        return JSPromise([float(x) for x in self._np().reshape(-1)])

    def dataSync(self):
        return [float(x) for x in self._np().reshape(-1)]

    # -- image ops (chainable in TFJS) -----------------------------------
    def resizeBilinear(self, size, alignCorners=False, halfPixelCenters=False):
        if alignCorners or not halfPixelCenters:
            raise JsError(
                "shim supports only resizeBilinear(size, false, true) — the "
                "TF2 half-pixel sampling the Python pipeline uses "
                "(js/src/inference.js pins exactly this call)")
        from ..data.image import resize_bilinear

        out_h, out_w = int(size[0]), int(size[1])
        a = self._np()
        if a.ndim == 4:
            out = np.stack([resize_bilinear(img, out_h, out_w) for img in a])
        else:
            out = resize_bilinear(a, out_h, out_w)
        return self._new(out.astype(np.float32))

    def dispose(self):
        self._disposed = True
        self._shim._untrack(self)

    def __repr__(self):  # pragma: no cover
        state = "disposed" if self._disposed else f"shape={self.shape}"
        return f"<TfTensor {state}>"


def _sigmoid(a: np.ndarray) -> np.ndarray:
    out = np.empty_like(a, np.float32)
    pos = a >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-a[pos]))
    ea = np.exp(a[~pos])
    out[~pos] = ea / (1.0 + ea)
    return out.astype(np.float32)


class _ImageNs:
    def __init__(self, shim):
        self._shim = shim

    def nonMaxSuppressionAsync(self, boxes, scores, maxOutputSize,
                               iouThreshold=0.5, scoreThreshold=float("-inf")):
        """Greedy NMS with TF kernel semantics; boxes are [y1, x1, y2, x2]."""
        b = np.asarray(boxes._np(), np.float32)
        s = np.asarray(scores._np(), np.float32)
        max_out = int(maxOutputSize)
        iou_thr = np.float32(iouThreshold)
        score_thr = np.float32(scoreThreshold)

        # candidates strictly above the score threshold, ordered by
        # descending score with index as the stable tie-break (TF sorts
        # with a stable sort over push order)
        cand = np.flatnonzero(s > score_thr)
        cand = cand[np.argsort(-s[cand], kind="stable")]

        y1 = np.minimum(b[:, 0], b[:, 2])
        x1 = np.minimum(b[:, 1], b[:, 3])
        y2 = np.maximum(b[:, 0], b[:, 2])
        x2 = np.maximum(b[:, 1], b[:, 3])
        area = (y2 - y1) * (x2 - x1)

        selected: list[int] = []
        for i in cand:
            suppressed = False
            for j in selected:
                yy1 = max(y1[i], y1[j])
                xx1 = max(x1[i], x1[j])
                yy2 = min(y2[i], y2[j])
                xx2 = min(x2[i], x2[j])
                inter = max(0.0, yy2 - yy1) * max(0.0, xx2 - xx1)
                union = area[i] + area[j] - inter
                iou = inter / union if union > 0 else 0.0
                if iou > iou_thr:
                    suppressed = True
                    break
            if not suppressed:
                selected.append(int(i))
                if len(selected) >= max_out:
                    break
        return JSPromise(TfTensor(self._shim, np.asarray(selected, np.int32)))

    def resizeBilinear(self, images, size, alignCorners=False,
                       halfPixelCenters=False):
        return images.resizeBilinear(size, alignCorners, halfPixelCenters)


class JsImage:
    """Host stand-in for an HTMLImageElement: .width/.height/.data."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.uint8)
        self.height = int(self.data.shape[0])
        self.width = int(self.data.shape[1])


class RecordingContext2D:
    """Canvas 2D context stand-in recording the draw calls render.js makes.

    Each call appends ``{"op", "args", "color"}`` (color = the stroke/fill
    style active at call time) so tests and tools can assert geometry,
    label text, and palette choices without a DOM.
    """

    CHAR_WIDTH = 7.0  # fixed-metric measureText stand-in

    def __init__(self):
        self.calls = []
        self.lineWidth = None
        self.font = None
        self.strokeStyle = None
        self.fillStyle = None

    def _record(self, op, args, color=None):
        self.calls.append({"op": op, "args": list(args), "color": color})

    def clearRect(self, *a):
        self._record("clearRect", a)

    def strokeRect(self, *a):
        self._record("strokeRect", a, self.strokeStyle)

    def fillRect(self, *a):
        self._record("fillRect", a, self.fillStyle)

    def fillText(self, *a):
        self._record("fillText", a, self.fillStyle)

    def strokeText(self, *a):
        self._record("strokeText", a, self.strokeStyle)

    def measureText(self, s):
        return {"width": self.CHAR_WIDTH * len(s)}

    def ops(self, op=None):
        if op is None:
            return list(self.calls)
        return [c for c in self.calls if c["op"] == op]


class RecordingCanvas:
    """HTMLCanvasElement stand-in: .width/.height + getContext('2d')."""

    def __init__(self):
        self.width = 0
        self.height = 0
        self.ctx = RecordingContext2D()

    def getContext(self, kind):
        if kind != "2d":
            raise JsError(f"unsupported canvas context {kind!r}")
        return self.ctx


class _BrowserNs:
    def __init__(self, shim):
        self._shim = shim

    def fromPixels(self, image, numChannels=3):
        data = image.data if isinstance(image, JsImage) else np.asarray(image)
        return TfTensor(self._shim, data[..., :int(numChannels)].astype(np.int32))


class GraphModelHost:
    """tf.loadGraphModel stand-in executing the exported graph-model in torch.

    Loads the artifact written by export/tfjs_graph.write_graph_model (the
    same files a browser would fetch) once into export/tfjs_runtime's
    ``GraphModel`` on ``device``: the card unless the caller passes
    ``device="cpu"``. Each call moves the input there and the heads back to
    numpy, as the TFJS runtime reads them back with ``array()``.
    """

    def __init__(self, shim: "TfShim", model_dir: str, device=None):
        from ..export.tfjs_runtime import GraphModel

        self._shim = shim
        self.model_dir = model_dir
        self.model = GraphModel(model_dir, device=device)

    def executeAsync(self, input_tensor: TfTensor):
        outs = self.model.run_numpy(input_tensor._np())
        return JSPromise([TfTensor(self._shim, o) for o in outs])

    # TFJS GraphModel also exposes synchronous execute()
    def execute(self, input_tensor: TfTensor):
        return self.executeAsync(input_tensor).value


class TfShim:
    """The ``tf`` global handed to the interpreter."""

    def __init__(self, model_loader=None):
        self._live: dict[int, TfTensor] = {}
        self._scopes: list[list[TfTensor]] = []
        self._model_loader = model_loader
        self.image = _ImageNs(self)
        self.browser = _BrowserNs(self)

    # -- registry --------------------------------------------------------
    def _track(self, t: TfTensor):
        self._live[id(t)] = t
        if self._scopes:
            self._scopes[-1].append(t)

    def _untrack(self, t: TfTensor):
        self._live.pop(id(t), None)

    def live_tensors(self):
        return list(self._live.values())

    def num_live(self) -> int:
        return len(self._live)

    # -- tensor creation -------------------------------------------------
    def tensor(self, values, shape=None, dtype=None):
        np_dtype = {None: np.float32, "float32": np.float32,
                    "int32": np.int32, "bool": np.bool_}[dtype]
        arr = np.asarray(values, np_dtype)
        if shape is not None:
            arr = arr.reshape([int(d) for d in shape])
        return TfTensor(self, arr)

    def tensor1d(self, values, dtype=None):
        return self.tensor(values, dtype=dtype)

    def tensor2d(self, values, shape=None, dtype=None):
        return self.tensor(values, shape, dtype)

    def scalar(self, v, dtype=None):
        return self.tensor(v, dtype=dtype)

    def zeros(self, shape, dtype=None):
        return self.tensor(np.zeros([int(d) for d in shape]), dtype=dtype)

    def ones(self, shape, dtype=None):
        return self.tensor(np.ones([int(d) for d in shape]), dtype=dtype)

    def range(self, start, stop, step=1, dtype=None):
        np_dtype = np.int32 if dtype == "int32" else np.float32
        return TfTensor(self, np.arange(start, stop, step, dtype=np_dtype))

    # -- namespace ops ---------------------------------------------------
    def concat(self, tensors, axis=0):
        arrs = [t._np() for t in tensors]
        return TfTensor(self, np.concatenate(arrs, axis=_axis(axis, arrs[0].ndim)))

    def stack(self, tensors, axis=0):
        return TfTensor(self, np.stack([t._np() for t in tensors], axis=int(axis)))

    def split(self, t: TfTensor, num_or_sizes, axis=0):
        a = t._np()
        ax = _axis(axis, a.ndim)
        if isinstance(num_or_sizes, (list, tuple)):
            sizes = [int(s) for s in num_or_sizes]
            points = np.cumsum(sizes)[:-1]
            parts = np.split(a, points, axis=ax)
        else:
            parts = np.split(a, int(num_or_sizes), axis=ax)
        return [TfTensor(self, p) for p in parts]

    def sigmoid(self, t: TfTensor):
        return t.sigmoid()

    def exp(self, t: TfTensor):
        return t.exp()

    def add(self, a, b):
        return a.add(b)

    def sub(self, a, b):
        return a.sub(b)

    def mul(self, a, b):
        return a.mul(b)

    def div(self, a, b):
        return a.div(b)

    # -- memory ----------------------------------------------------------
    def tidy(self, name_or_fn, fn=None):
        fn = fn if fn is not None else name_or_fn
        self._scopes.append([])
        try:
            result = fn()
        except BaseException:
            # TFJS disposes every tensor the scope created when fn throws
            for t in self._scopes.pop():
                t.dispose()
            raise
        created = self._scopes.pop()
        kept: set[int] = set()
        _collect_tensors(result, kept)
        for t in created:
            if id(t) in kept:
                if self._scopes:  # keep-alive escalates to the outer scope
                    self._scopes[-1].append(t)
            else:
                t.dispose()
        return result

    def dispose(self, value=None):
        _dispose_recursive(value)

    def keep(self, t: TfTensor):
        for scope in self._scopes:
            scope[:] = [x for x in scope if x is not t]
        return t

    def memory(self):
        return {"numTensors": float(len(self._live))}

    # -- model loading ---------------------------------------------------
    def loadGraphModel(self, url):
        if self._model_loader is None:
            raise JsError("no model loader configured in the shim")
        return JSPromise(self._model_loader(self, url))


def _collect_tensors(value, out: set):
    if isinstance(value, TfTensor):
        out.add(id(value))
    elif isinstance(value, (list, tuple)):
        for v in value:
            _collect_tensors(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _collect_tensors(v, out)
    elif isinstance(value, JSPromise):
        _collect_tensors(value.value, out)


def _dispose_recursive(value):
    if isinstance(value, TfTensor):
        value.dispose()
    elif isinstance(value, (list, tuple)):
        for v in value:
            _dispose_recursive(v)
    elif isinstance(value, dict):
        for v in value.values():
            _dispose_recursive(v)
    elif isinstance(value, JSPromise):
        _dispose_recursive(value.value)
