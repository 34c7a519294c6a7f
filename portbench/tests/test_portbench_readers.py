"""The per-layer readers on synthetic records, against values worked out by
hand; a reader with nothing to read returns None."""

import os

import pytest

from portbench.flops import layer_table
from portbench.records import Records, reader
from portbench.reference.graph import load_graph
from portbench.trace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
YOLOV3 = load_graph(os.path.join(ROOT, "config/models/yolov3/model.yaml"), 80)
TABLE = layer_table(YOLOV3, 80, 416)


def records(trace=None, spans=None, window=None, cell=None, table=TABLE, batch=1):
    return Records(cell or {"tier": "int8_chain", "precision": "bf16"}, {}, table, batch,
                   spans or {}, window or {}, trace)


def trace(kernels=(), attributed=(), window=(0.0, 50.0), units=1, host=()):
    return Trace(list(kernels), window, list(attributed), list(host), units)


def test_idle_share_is_the_window_outside_the_union_of_kernels():
    t = trace(kernels=[(0.0, 10.0, "a"), (5.0, 20.0, "b"), (30.0, 40.0, "c")])
    assert t.busy_us() == 30.0
    assert reader("device_idle_pct.infer")(records(t)) == pytest.approx(40.0)
    assert reader("device_idle_pct.train")(records(None)) is None
    assert [g for g in t.gaps()] == [(20.0, 10.0), (40.0, 10.0)]


def test_forward_and_decode_split_by_layer_range_and_span():
    t = trace(units=2, attributed=[("k", 1000.0, "L|backbone|layer1|convolutional", "predict"),
                                   ("k2", 500.0, None, "predict"),
                                   ("k3", 200.0, None, "readback")])
    assert reader("forward_ms.infer")(records(t)) == pytest.approx(0.5)
    assert reader("decode_nms_ms.infer")(records(t)) == pytest.approx(0.25)
    assert reader("forward_ms.infer")(records(trace())) is None


def test_resblock_roofline_of_the_first_darknet_block():
    # one block at 208², C = 64, Cm = 32, B = 1: bytes-bound
    ops = 2.0 * (208 * 208 * 32 * 64 + 208 * 208 * 64 * 32 * 9)
    nbytes = 2 * 208 * 208 * 64 + (32 * 64 + 64 * 32 * 9) + 8 * (32 + 64) + 12
    least = max(ops / 1979e12, nbytes / 3.35e12)
    t = trace(attributed=[("resblock_int8_kernel", 10.0, "L|backbone|layer3-layer5|resblock",
                           "predict")])
    assert reader("resblock_roofline.infer")(records(t)) == pytest.approx(100 * least / 10e-6)
    assert reader("resblock_roofline.infer")(records(trace(attributed=[
        ("k", 10.0, "L|backbone|layer3|convolutional", "predict")]))) is None


def test_bn_stats_roofline_counts_each_batchnorm_input_once_each_way():
    table = {("backbone", 1): {"kind": "convolutional", "bn": True, "cout": 16,
                               "out": (16, 416, 416), "macs": 0}}
    elems = 2 * 16 * 416 * 416
    nbytes = (elems * 2 + 16 * 16) + (2 * elems * 2 + 12 * 16)
    t = trace(kernels=[(0.0, 12.0, "void bn_moments_cl_kernel<__nv_bfloat16>(...)"),
                       (12.0, 20.0, "void bn_dx_kernel<__nv_bfloat16, 8, true>(...)"),
                       (20.0, 30.0, "other")])
    rec = records(t, table=table, batch=2)
    assert reader("bn_stats_roofline.train")(rec) == pytest.approx(100 * nbytes / 3.35e12 / 20e-6)
    assert reader("bn_stats_roofline.train")(records(trace(kernels=[(0, 1, "x")]),
                                                      table=table, batch=2)) is None


def test_mfu_and_host_spans():
    flops = 2.0 * sum(e["macs"] for e in TABLE.values())
    rec = records(window={"images": 1000, "seconds": 2.0}, spans={"predict": [0.01, 0.03, 0.02],
                                                                   "step": [0.2]})
    assert reader("mfu_pct.infer")(rec) == pytest.approx(100 * flops * 500 / 1979e12)
    assert reader("mfu_pct.train")(rec) == pytest.approx(100 * 3 * flops * 500 / 989e12)
    assert reader("predict_host_ms.infer")(rec) == pytest.approx(20.0)
    assert reader("step_host_ms.train")(rec) == pytest.approx(200.0)
    assert reader("mfu_pct.infer")(records()) is None
    assert reader("predict_host_ms.infer")(records()) is None


def test_idle_gaps_are_named_by_the_host_activity_when_they_began():
    t = trace(kernels=[(0.0, 10.0, "a"), (30.0, 50.0, "b")],
              host=[(0.0, 50.0, 0, "portbench|step"), (8.0, 25.0, 1, "aten::conv"),
                    (26.0, 29.0, 1, "cudaLaunchKernel")])
    assert t.idle_gaps() == [["step/aten::conv", 20e-6]]
    assert t.device_ops() == [["b", 20e-6], ["a", 10e-6]]
