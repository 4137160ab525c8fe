"""python -m refraction_tpu_torch.bench on the card, in small mode: the
headline's gate passes and each timed regime launched the frame kernel
once per frame it timed."""

import json

import pytest

from refraction_tpu_torch import bench

pytestmark = pytest.mark.cuda


def test_bench_small_mode_on_the_card(cuda, capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("RRT_BENCH_SMALL", "1")
    monkeypatch.setenv("RRT_ASSET_DIR", str(tmp_path))  # the stand-ins
    monkeypatch.delenv("RRT_BENCH_BUDGET_S", raising=False)
    rc = bench.main(["--device", "cuda"])
    lines = capsys.readouterr().out.splitlines()
    last = json.loads(lines[-1])
    assert rc == 0, last
    assert last["gate"]["headline"]["ok"]
    assert last["headline_scene"]["stand_in"]
    assert last["headline_scene"]["tris"] == 1280
    assert not any(k.endswith("_error") for k in last)
    assert set(last["launches"]) == {"latency", "loop", "device_ms",
                                     "batched"}
    for regime, n in last["launches"].items():
        assert n["fused_radiance"] == n["frames"] > 0, regime
    assert last["device"] != "cpu" and last["build_s"] >= 0.0
    assert last["frame_ms"] == min(last["frame_latency_ms"],
                                   last["loop_frame_ms"],
                                   last["batched_frame_ms"])
    assert last["device_ms"] > 0.0 and last["live_rays_per_frame"] > 0
