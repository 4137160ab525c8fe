"""The reduction of a traced slice (rtbench/trace.py) and the per-layer
readers on it, on a hand-made trace."""

import pytest

from rtbench import spec
from rtbench.trace import Trace, op_name


def _trace():
    host = [("rtbench.frame", 0, 100), ("rtbench.pose", 0, 10),
            ("rtbench.render", 10, 30), ("rtbench.enqueue", 30, 40),
            ("rtbench.wait", 40, 90), ("rtbench.fold", 90, 100),
            ("rtbench.frame", 100, 200), ("rtbench.pose", 100, 110),
            ("rtbench.render", 110, 130), ("rtbench.enqueue", 130, 140),
            ("rtbench.wait", 140, 190), ("rtbench.fold", 190, 200)]
    device = [("void rt_frame_kernel<0>(float const*)", 20, 60),
              ("Memcpy DtoH (Device -> Pinned)", 55, 70),
              ("void rt_frame_kernel<0>(float const*)", 120, 160),
              ("Memcpy DtoH (Device -> Pinned)", 160, 180),
              ("void rt_frame_kernel<0>(float const*)", 190, 230)]
    return Trace(host, device, 0.0, 200.0)


def test_reduction():
    tr = _trace()
    assert tr.frames == 2
    assert tr.busy() == [(20, 70), (120, 180), (190, 200)]
    assert tr.busy_us() == 120
    ops = dict(tr.device_ops())
    assert ops["rt_frame_kernel"] == pytest.approx((40 + 40 + 10) * 1e-6)
    assert op_name("Memcpy DtoH (Device -> Pinned)") in ops
    # Idle 0-20 (pose 0-10, render 10-20), 70-120 (wait 70-90, fold
    # 90-100, frame 2's pose 100-110 and render 110-120) and 180-190
    # (wait): each gap split by the step the host was in.
    assert dict(tr.idle_gaps()) == pytest.approx(
        {"rtbench.pose": 20e-6, "rtbench.render": 20e-6,
         "rtbench.wait": 30e-6, "rtbench.fold": 10e-6})


def test_readers():
    ctx = {"trace": _trace(),
           "roofline": {"bound_ms": 0.004}}
    read = {m: spec.load_reader(m) for m in (
        "host_frame_ms.orbit", "accumulate_ms", "rt_frame_ms.orbit",
        "rt_frame_roofline.accumulate", "device_idle_pct.orbit")}
    assert read["host_frame_ms.orbit"](ctx) == pytest.approx(0.040)
    assert read["accumulate_ms"](ctx) == pytest.approx(0.060)
    # Whole launches inside the slice only: the third ends past it.
    assert read["rt_frame_ms.orbit"](ctx) == pytest.approx(0.040)
    assert read["rt_frame_roofline.accumulate"](ctx) == pytest.approx(10.0)
    assert read["device_idle_pct.orbit"](ctx) == pytest.approx(40.0)


def test_readers_return_nothing_without_a_reading():
    empty = {"trace": None, "roofline": None}
    for m in spec.load_bench()["per_layer"]:
        assert spec.load_reader(m["name"])(empty) is None
    tr = _trace()
    tr.host = [h for h in tr.host if h[0] != "rtbench.fold"]
    tr.device = []
    ctx = {"trace": tr, "roofline": {"bound_ms": 1.0}}
    assert spec.load_reader("accumulate_ms")(ctx) is None
    assert spec.load_reader("rt_frame_roofline.orbit")(ctx) is None
    assert spec.load_reader("device_idle_pct.orbit")(ctx) is None
