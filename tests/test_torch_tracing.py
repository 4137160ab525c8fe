"""The frame path's spans (`refraction_tpu_torch.tracing`) on the CPU: off
they cost one shared null context; under `torch.profiler` one frame
through the pose, the renderer, the host copies and the fold records
each of its spans where its work happens."""

import ast
import contextlib
import glob
import os

import numpy as np
import torch

from refraction_tpu_torch import tracing
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu_torch.render import Accumulator, make_renderer
from refraction_tpu_torch.run import HostCopies
from refraction_tpu_torch.scene import build_scene, scene_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = {"rt.pose", "rt.upload", "rt.launch", "rt.to_u8", "rt.fold.widen",
         "rt.fold.add", "rt.fold.card", "rt.fold.fetch"}
# Spans of the CUDA branches: the launch, and the fold into a card's sum.
CARD_SPANS = {"rt.launch", "rt.fold.card", "rt.fold.fetch"}


def _spans(prof) -> dict:
    """{name: [(start, end), ...]} of the profile's ``rt.*`` events."""
    out: dict = {}
    for ev in prof.events():
        if ev.name.startswith("rt."):
            out.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    return out


def test_span_off_is_one_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tracing.span("rt.pose"), tracing.span("rt.launch")
    assert a is b is tracing._OFF
    assert isinstance(a, contextlib.nullcontext)
    with a:
        with b:  # reentrant: spans nest
            pass


def test_one_frame_records_the_frame_paths_spans():
    cfg = RenderConfig(width=8, height=6, max_refract_depth=2)
    scene = scene_from_jax(build_scene(make_icosphere(1, 1.2),
                                       make_gradient_envmap(16, 32), 32)[0],
                           "cpu")
    renderer = make_renderer(cfg, "cuda", "cpu")
    copies = HostCopies(torch.device("cpu"), u8=True, radiance=True,
                        linear=False)
    acc = Accumulator(cfg.height, cfg.width)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        frame = orbit_camera(0.3, cfg)
        with torch.profiler.record_function("test.render"):
            img = renderer(scene, frame)
        _, radiance, done = copies.enqueue(img)
        acc.add(radiance)
    assert done is None and acc.count == 1
    got = _spans(prof)
    # The CPU renders the plain version and folds on the host.
    assert set(got) == SPANS - CARD_SPANS
    assert all(len(v) == 1 for v in got.values()), got
    (r0, r1), = [(ev.time_range.start, ev.time_range.end)
                 for ev in prof.events() if ev.name == "test.render"]
    (u0, u1), = got["rt.upload"]
    assert r0 <= u0 <= u1 <= r1
    # The fold's two steps in order, the pose before the render call.
    assert got["rt.fold.widen"][0][1] <= got["rt.fold.add"][0][0]
    assert got["rt.pose"][0][1] <= r0
    # The spans changed nothing: the fold is the radiance, widened.
    np.testing.assert_array_equal(acc.sum, img.numpy().astype(np.float64))


def test_span_without_the_fast_span_records_through_record_function(
        monkeypatch):
    monkeypatch.setattr(tracing, "_FAST", None)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("rt.pose"):
            torch.ones(2).sum()
    assert list(_spans(prof)) == ["rt.pose"]


def _span_calls(path: str) -> list:
    """The first arguments of the ``span(...)`` calls in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "span"):
            arg = node.args[0]
            out.append(arg.value if isinstance(arg, ast.Constant) else arg)
    return out


def test_the_port_opens_the_six_spans_and_no_other():
    """Each of the eight names once, as a literal, outside `tracing`; no
    other module records a span of its own (``record_function``)."""
    names = []
    for path in glob.glob(os.path.join(REPO, "refraction_tpu_torch", "**",
                                       "*.py"), recursive=True):
        if os.path.basename(path) == "tracing.py":
            continue
        names += _span_calls(path)
        with open(path) as f:
            assert "record_function" not in f.read(), path
    # rt.launch twice: the full-frame and the pixel-DP wrappers.
    assert sorted(names) == sorted([*SPANS, "rt.launch"])
    assert not any(n.startswith("rt_frame") for n in names)
