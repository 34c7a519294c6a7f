"""Run the browser port (js/src) on an image, through the port's jsvm.

Counterpart of the JAX package's ``tools/run_js_pipeline.py``, with its
flags plus ``--device``. Drives the real JavaScript sources
(js/src/inference.js and its imports) through the port's interpreter and
numpy TFJS shim (``yolov3_tpu_torch/jsvm/``) the way a browser drives them —
loadGraphModel on an exported TFJS graph-model directory
(``python -m yolov3_tpu_torch.tools.export_tfjs``), fromPixels →
resizeBilinear → forward → decode → NMS → canvas render — and prints the
detections. ``tf.loadGraphModel`` is the port's ``GraphModelHost``: the
graph-model loaded once into the PyTorch executor
(``export/tfjs_runtime.py``) on the card, or on the CPU with ``--device cpu``;
no TensorFlow is needed. With ``--compare`` it also runs the Python pipeline
on the same device and image — the port's ``data/image.py`` resize, the
executor, ``ops/decode.py::yolo_decode``, ``ops/nms.py::yolo_nms_exact``
(K1 at the default K, K2 once the escalation passes K = 512 on the card) and
``gather_detections`` — and reports the per-detection deltas.

    python -m yolov3_tpu_torch.tools.run_js_pipeline --model_dir tfjs_model \\
        --image datasets/coco2012/images/girl.png \\
        --classes datasets/coco2012/coco.names --compare [--device cpu]

``main(argv)`` returns the run as a dict; the command exits 1 when the
browser port leaves a tensor undisposed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
IMAGE_SIZE = 416  # js/src/inference.js IMAGE_SIZE


def python_pipeline(model, img_np, anchors, nclasses, max_boxes=100, iou_threshold=0.5,
                    score_threshold=0.1):
    """The Python pipeline the browser port mirrors, on the executor's device:
    resize → ``model`` (a ``tfjs_runtime.GraphModel``) → decode → exact NMS →
    gather. Returns the decoded tensors and the kept detections (numpy)."""
    from ..data.image import resize_bilinear
    from ..ops.decode import yolo_decode
    from ..ops.nms import gather_detections, yolo_nms_exact

    x = resize_bilinear(img_np.astype(np.float32), IMAGE_SIZE, IMAGE_SIZE)[None] / 255.0
    with torch.inference_mode():
        outs = model(torch.from_numpy(x.astype(np.float32)).to(model.device))
        table = np.asarray(anchors, np.float32).reshape(-1, 3, 2)[: len(outs)]
        pb, pc, pp = yolo_decode(outs, table, nclasses)
        bb, ci, sc, sel, nv = yolo_nms_exact(pb, pc, pp, max_boxes=max_boxes,
                                             iou_threshold=iou_threshold,
                                             score_threshold=score_threshold)
        gb, gc, gs, _ = gather_detections(bb, ci, sc, sel, nv)
    n = int(nv[0])
    return dict(heads=outs, decoded=(pb, pc, pp), n=n, boxes=gb[0, :n].cpu().numpy(),
                scores=gs[0, :n].cpu().numpy(), classes=gc[0, :n].cpu().numpy())


def compare(py, class_names, js_dets):
    """The JAX tool's delta fields: the Python pipeline's count, the largest
    box and score differences over the common prefix, and whether the class
    names and counts agree."""
    n = py["n"]
    m = min(n, len(js_dets))
    js_boxes = np.array([d["box"] for d in js_dets[:m]], np.float32)
    js_scores = np.array([d["score"] for d in js_dets[:m]], np.float32)
    js_names = [d["className"] for d in js_dets[:m]]
    return {
        "n_python": n,
        "box_delta": float(np.abs(js_boxes - py["boxes"][:m]).max()) if m else 0.0,
        "score_delta": float(np.abs(js_scores - py["scores"][:m]).max()) if m else 0.0,
        "classes_match": js_names == [class_names[c] for c in py["classes"][:m]]
        and n == len(js_dets),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m yolov3_tpu_torch.tools.run_js_pipeline",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--model_dir", required=True,
                    help="TFJS graph-model directory (model.json + shards), "
                         "e.g. the output of yolov3_tpu_torch.tools.export_tfjs")
    ap.add_argument("--image",
                    default=os.path.join(REPO, "datasets/coco2012/images/girl.png"))
    ap.add_argument("--classes",
                    default=os.path.join(REPO, "datasets/coco2012/coco.names"))
    ap.add_argument("--anchors", default=None,
                    help="anchors CSV (normalized, 13-grid first); default: "
                         "the port's built-in COCO table")
    ap.add_argument("--max_boxes", type=int, default=100)
    ap.add_argument("--iou_threshold", type=float, default=0.5)
    ap.add_argument("--score_threshold", type=float, default=0.1)
    ap.add_argument("--compare", action="store_true",
                    help="also run the Python pipeline and report deltas")
    ap.add_argument("--json_out", default=None,
                    help="write detections + draw calls to this JSON file")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..data.image import decode_image
    from ..device import resolve_device
    from ..jsvm import GraphModelHost, Interpreter, JsImage, RecordingCanvas, TfShim

    device = resolve_device(args.device)
    with open(args.image, "rb") as f:
        img_np = decode_image(f.read())
    with open(args.classes) as f:
        class_names = [ln.strip() for ln in f if ln.strip()]

    hosts = []

    def load_model(shim, url):
        hosts.append(GraphModelHost(shim, url, device=device))
        return hosts[-1]

    shim = TfShim(model_loader=load_model)
    interp = Interpreter({"tf": shim})
    mod = interp.load_module(os.path.join(REPO, "js", "src", "inference.js"))

    overlay = RecordingCanvas()
    request = {
        "modelUrl": args.model_dir,
        "image": JsImage(img_np),
        "overlay": overlay,
        "classNames": class_names,
        "maxBoxes": float(args.max_boxes),
        "iouThreshold": args.iou_threshold,
        "scoreThreshold": args.score_threshold,
    }
    anchors = np.loadtxt(args.anchors or os.path.join(REPO, "datasets/coco2012/anchors.txt"),
                         delimiter=",", dtype=np.float32)
    if args.anchors:
        request["anchors"] = anchors.reshape(-1, 3, 2).tolist()

    dets = interp.call(mod["runInference"], request)
    leaked = shim.num_live()

    print(f"js pipeline: {len(dets)} detections "
          f"({len(overlay.ctx.calls)} canvas draw calls, "
          f"{leaked} leaked tensors) on {device}")
    for d in dets:
        x0, y0, x1, y1 = d["box"]
        print(f"  {d['className']:<16} {d['score']:.4f} "
              f"[{x0:.4f}, {y0:.4f}, {x1:.4f}, {y1:.4f}]")
    result = {"device": str(device), "detections": dets, "draw_calls": len(overlay.ctx.calls),
              "leaked_tensors": leaked}
    if leaked:
        print("ERROR: browser port leaked tensors", file=sys.stderr)
        return result

    if args.compare:
        py = python_pipeline(hosts[0].model, img_np, anchors, len(class_names),
                             args.max_boxes, args.iou_threshold, args.score_threshold)
        deltas = compare(py, class_names, dets)
        print(f"python pipeline: {deltas['n_python']} detections; "
              f"max |box delta| {deltas['box_delta']:.2e}, "
              f"max |score delta| {deltas['score_delta']:.2e}, "
              f"classes {'match' if deltas['classes_match'] else 'DIFFER'}")
        result["compare"] = deltas
        result["python"] = py

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"detections": dets, "draw_calls": overlay.ctx.calls},
                      f, indent=2)
        print(f"wrote {args.json_out}")
    return result


if __name__ == "__main__":
    sys.exit(1 if main()["leaked_tensors"] else 0)
