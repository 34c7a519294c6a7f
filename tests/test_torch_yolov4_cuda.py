"""YOLOv4's serving predictor at 608², B=2, on an NVIDIA card, against the
plain float32 reference computed on the same card (TF32 off). Marked
``cuda``; each test skips without a card. Imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_yolov4_cuda.py

The weights, images and tolerances are ``test_torch_yolov4.py``'s: the
float32 predictor is held to the CPU test's limits (its rounding is the same
float32 rounding). bf16 rounds each layer's input and output at 2⁻⁸, ~10⁵
times float32's, which moves single candidates far (a worst logit 0.1 of
the heads' range at 608², printed with -s): the bf16 predictor is held to
gaps averaged over each image's candidates, at the worst image: the score,
the score its class gives up, and the centres' drift away from their cells'
middles (``scale_x_y``'s signature; rounding moves centres either way and
averages out); and to the NMS selection index for index."""

import pytest
import torch

from yolov3_tpu_torch.apps.inference_app import make_predictor
from yolov3_tpu_torch.models import network as tnet
from yolov3_tpu_torch.ops.decode import yolo_decode
from yolov3_tpu_torch.reference import yolov4_plain as ref

from .test_torch_yolov4 import (ANCHORS, CENTRE_TOL, HEAD_TOL, NC, NMS, PROB_TOL, SIZE_TOL,
                                _decode_gaps, _head_gap, seeded_model)

SIZE, BATCH = 608, 2
# bf16 at 608², B=64 on an H100 (PERF.md §6): sound readings over 22 seeds at
# most 0.0162, 0.00028 and 0.0029; a float8 reference at least 0.072, 0.0094
# and 0.025; Mish run as leaky and scale_x_y taken as 1 each above one limit
BF16 = dict(score=0.035, cls=0.0016, drift=0.01)


def _image_gaps(boxes, classes, scores, decoded, heads):
    """(score, class, centre drift) gaps, each the worst image's mean over
    its candidates; a centre's drift is signed away from the middle of the
    reference centre's cell, in cells."""
    rb, rc, rp = decoded
    best = rp.max(-1).values
    picked = torch.gather(rp, -1, classes.long()[..., None])[..., 0]
    grids = torch.cat([torch.full((h.shape[1] * h.shape[2] * 3,), float(h.shape[1]),
                                  device=h.device) for h in heads])
    cells = torch.cat([torch.stack(torch.meshgrid(
        torch.arange(h.shape[2], device=h.device), torch.arange(h.shape[1], device=h.device),
        indexing="xy"), -1)[:, :, None, :].expand(-1, -1, 3, -1).reshape(-1, 2)
        for h in heads]).float()
    centre_r = (rb[..., :2] + rb[..., 2:]) / 2 * grids[:, None]
    drift = (((boxes[..., :2] + boxes[..., 2:]) / 2 * grids[:, None] - centre_r)
             * torch.sign(centre_r - cells - 0.5)).mean(-1)
    return (float((scores - rc * best).abs().mean(1).max()),
            float((rc * (best - picked)).mean(1).max()), float(drift.mean(1).abs().max()))


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    ref.ieee_fp32()
    return seeded_model(SIZE, BATCH, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_predictor_against_the_reference_on_the_card(card_model, dtype):
    m = card_model
    compute = torch.bfloat16 if dtype == "bf16" else None
    folded = tnet.to_device(tnet.fold_batch_norm(m["params"], m["state"]), "cuda", compute)
    with torch.no_grad():
        heads = tnet.apply_model(m["spec"], folded, {}, m["images"].to(compute or torch.float32))
    heads = [h.float() for h in heads]
    gap = _head_gap(heads, m["heads"])
    centre, size, prob = _decode_gaps(yolo_decode(heads, ANCHORS, NC, m["spec"].head_scales()),
                                      m["decoded"])
    predict = make_predictor(m["spec"], m["params"], m["state"], ANCHORS, NC, NMS["max_boxes"],
                             NMS["iou_threshold"], NMS["score_threshold"], compute_dtype=compute,
                             image_size=SIZE, device="cuda")
    boxes, classes, scores, selected, num_valid = predict(m["images"])
    score, cls, drift = _image_gaps(boxes, classes, scores, m["decoded"], m["heads"])
    print(f"yolov4 {dtype} on the card vs reference: heads {gap:.3g}, centres {centre:.3g}, "
          f"sizes {size:.3g}, probabilities {prob:.3g}; image means: scores {score:.3g}, "
          f"classes {cls:.3g}, centre drift {drift:.3g}")
    if compute is None:
        assert gap <= HEAD_TOL and centre <= CENTRE_TOL and size <= SIZE_TOL and prob <= PROB_TOL
    else:
        assert score <= BF16["score"] and cls <= BF16["cls"] and drift <= BF16["drift"]
    want = ref.nms(boxes, scores, **NMS)
    got = [selected[b, :int(num_valid[b])].tolist() for b in range(BATCH)]
    assert all(got) and got == want
