"""The renderer's modular path and the rest of the single-GPU CLI of
refraction_tpu_torch on the CPU: ``make_renderer(..., use_mega=False)``
against the JAX package's modular path (its Pallas kernels in interpret
mode) and the oracle, ``--backend``, ``--baseline``, ``--profile`` and the
pipelined frame loop, whose files must equal a frame-by-frame render.

Image bar from tests/test_golden.py: RMSE < 1e-4 and max abs error < 1e-3.
The CLI's files are compared byte for byte.
"""

import dataclasses
import json
import logging
import re
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rmse
from oracle.numpy_tracer import render_oracle
from refraction_tpu.config import RenderConfig as JaxRenderConfig
from refraction_tpu.config import baseline_config as jax_baseline_config
from refraction_tpu.ops.backends import get_backend as jax_get_backend
from refraction_tpu import run as jax_run
from refraction_tpu.render import make_renderer as jax_make_renderer
from refraction_tpu.utils.stats import log as rt_log
from refraction_tpu_torch import run
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import RenderConfig, baseline_config
from refraction_tpu_torch.fixtures import write_scene
from refraction_tpu_torch.io.png import decode_png_bytes
from refraction_tpu_torch.io.primitives import (
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu_torch.kernels.envmap import env_contribution
from refraction_tpu_torch.kernels.framekernel import fused_radiance
from refraction_tpu_torch.kernels.intersect import closest_hit
from refraction_tpu_torch.render import (
    Accumulator,
    make_renderer,
    resolve_backend,
)
from refraction_tpu_torch.scene import load_scene, scene_from_jax

torch.set_num_threads(1)

RMSE_BAR, MAX_BAR = 1e-4, 1e-3  # tests/test_golden.py
W, H = 16, 12


@pytest.fixture(scope="module")
def ball(tmp_path_factory):
    """A glass ball's OBJ and HDR files, and the port's config of them."""
    d = tmp_path_factory.mktemp("ball")
    obj, hdr = write_scene(str(d), "ball", make_icosphere(2, 1.2),
                           make_gradient_envmap(32, 64))
    cfg = RenderConfig(width=W, height=H, max_refract_depth=3,
                       scene_path=obj, envmap_path=hdr)
    return obj, hdr, cfg


def _argv(ball, out, *extra):
    obj, hdr, _ = ball
    return ["--scene", obj, "--envmap", hdr, "--width", str(W), "--height",
            str(H), "--bounces", "3", "--out", str(out), "--device", "cpu",
            *extra]


def _frames(cfg, n, backend="cuda"):
    """n frames of the orbit from angle 0.01, rendered one by one."""
    scene = scene_from_jax(load_scene(cfg)[0], "cpu")
    render = make_renderer(cfg, backend, "cpu")
    angles = [0.01]
    for _ in range(n - 1):
        angles.append(angles[-1] + cfg.orbit_speed)
    return [render(scene, orbit_camera(a, cfg)) for a in angles]


def _png_bytes(path, u8):
    run.write_png(str(path), u8)
    return path.read_bytes()


# ---- the modular path ----------------------------------------------------

def test_modular_path_matches_jax_modular_pallas_and_oracle(sphere_scene):
    """use_mega=False on CPU tensors (the closest-hit and env kernels'
    plain versions under the eager integrator) against the JAX modular
    path over its Pallas intersect and env kernels in interpret mode, and
    against the oracle."""
    scene, _ = sphere_scene
    cfg = JaxRenderConfig(width=24, height=18, max_refract_depth=3)
    frame = orbit_camera(0.85, cfg)
    before = (closest_hit.launches, env_contribution.launches,
              fused_radiance.launches)
    img = make_renderer(cfg, "cuda", "cpu", use_mega=False)(
        scene_from_jax(scene, "cpu"), frame).numpy()
    # CPU tensors take the plain versions: no launch is counted.
    assert (closest_hit.launches, env_contribution.launches,
            fused_radiance.launches) == before
    be = jax_get_backend("pallas", interpret=True)
    ref_j = np.asarray(jax_make_renderer(
        cfg, be.intersect, be.env_contribution, use_mega=False)(
            jax.tree.map(jnp.asarray, scene), frame))
    ref_o = render_oracle(scene, cfg, frame=frame)
    assert img.shape == (18, 24, 3)
    for ref in (ref_j, ref_o):
        assert rmse(img, ref) < RMSE_BAR
        assert np.abs(img - ref).max() < MAX_BAR


@pytest.mark.parametrize("spp", [1, 4])
def test_modular_path_equals_the_other_paths_on_cpu(ball, spp):
    """On the CPU the three paths run the same eager integrator over the
    brute force: bit-equal images."""
    cfg = ball[2].replace(spp=spp)
    scene = scene_from_jax(load_scene(cfg)[0], "cpu")
    frame = orbit_camera(0.3, cfg)
    imgs = [make_renderer(cfg, b, "cpu", use_mega=m)(scene, frame)
            for b, m in (("cuda", False), ("cuda", None), ("cuda", True),
                         ("torch", None), ("torch", False), ("auto", None))]
    for img in imgs[1:]:
        assert torch.equal(img, imgs[0])


def test_backend_resolution_and_refusals():
    assert resolve_backend("auto", "cpu") == "torch"
    assert resolve_backend("auto", torch.device("cuda", 0)) == "cuda"
    assert resolve_backend("cuda", "cpu") == "cuda"
    assert resolve_backend("torch", "cuda") == "torch"
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas", "cpu")
    cfg = RenderConfig(width=4, height=3)
    with pytest.raises(ValueError, match="use_mega=True"):
        make_renderer(cfg, "torch", "cpu", use_mega=True)


# ---- --backend, --baseline -----------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "torch", "cuda"])
def test_cli_backend_on_cpu_matches_make_renderer(ball, tmp_path, backend):
    out = tmp_path / "f.png"
    assert run.main(_argv(ball, out, "--backend", backend, "--raw")) == 0
    want = make_renderer(ball[2], backend, "cpu")(
        scene_from_jax(load_scene(ball[2])[0], "cpu"),
        orbit_camera(0.01, ball[2]))
    np.testing.assert_array_equal(np.load(tmp_path / "f.npy"), want.numpy())
    assert out.read_bytes() == _png_bytes(tmp_path / "want.png",
                                          run.to_u8(want).numpy())


def test_cli_backend_refuses_jax_names(ball, tmp_path):
    with pytest.raises(SystemExit):
        run.main(_argv(ball, tmp_path / "f.png", "--backend", "xla"))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_baseline_config_equals_jax(n):
    ours = dataclasses.asdict(baseline_config(n))
    assert ours == dataclasses.asdict(jax_baseline_config(n))


@pytest.mark.parametrize("bad", [0, 6])
def test_baseline_config_refuses_unknown(bad):
    with pytest.raises(ValueError):
        baseline_config(bad)
    with pytest.raises(ValueError):
        jax_baseline_config(bad)


def test_cli_baseline_6_is_refused_as_in_jax(capsys):
    for main in (run.main, jax_run.main):
        with pytest.raises(SystemExit):
            main(["--baseline", "6"])
        assert "--baseline: invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_cli_baseline_starts_the_config(n):
    """--baseline N starts from baseline_config(N), as the JAX CLI's
    build_config does; the other flags override it."""
    args = run.parse_args(["--baseline", str(n)])
    assert run.build_config(args) == baseline_config(n)
    args = run.parse_args(["--baseline", str(n), "--width", "64",
                           "--bounces", "2"])
    assert run.build_config(args) == baseline_config(n).replace(
        width=64, max_refract_depth=2)


# ---- --profile -------------------------------------------------------------

def test_cli_profile_on_cpu_writes_a_trace_of_the_frame(ball, tmp_path,
                                                        caplog):
    prof = tmp_path / "prof"
    with caplog.at_level(logging.INFO, logger="refraction_tpu"):
        assert run.main(_argv(ball, tmp_path / "f.png", "--profile",
                              str(prof), "--backend", "cuda")) == 0
    trace = json.loads((prof / "frame_trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in trace}
    # One loop iteration's spans (the launch span is the CUDA branch's;
    # the fold's only with --accumulate) and the eager integrator's ops.
    assert {"rt.pose", "rt.upload", "rt.to_u8"} <= names
    assert not names & {"rt.launch", "rt.fold.widen", "rt.fold.add"}
    assert {"aten::acos", "aten::atan2"} <= names
    assert any("profiler trace written to" in r.getMessage()
               for r in caplog.records)
    # Then the loop ran as usual.
    assert (tmp_path / "f.png").exists()


def test_cli_profile_with_accumulate_traces_the_fold_apart(ball, tmp_path):
    """With --accumulate the profiled iteration also folds, into an
    accumulator of its own: the saved state counts the loop's frames."""
    prof = tmp_path / "prof"
    assert run.main(_argv(ball, tmp_path / "acc.png", "--profile", str(prof),
                          "--accumulate", "--frames", "2", "--backend",
                          "cuda")) == 0
    trace = json.loads((prof / "frame_trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in trace}
    assert {"rt.pose", "rt.upload", "rt.fold.widen", "rt.fold.add"} <= names
    assert "rt.to_u8" not in names  # no u8 copy while accumulating
    assert int(np.load(tmp_path / "acc_state.npz")["count"]) == 2


# ---- the pipelined frame loop ----------------------------------------------

@pytest.mark.parametrize("raw", [False, True])
def test_pipelined_loop_files_equal_frame_by_frame(ball, tmp_path, raw):
    out = tmp_path / "f.png"
    extra = ["--frames", "3"] + (["--raw"] if raw else [])
    assert run.main(_argv(ball, out, *extra)) == 0
    frames = _frames(ball[2], 3)
    for i, img in enumerate(frames):
        path = tmp_path / f"f_{i:04d}.png"
        assert path.read_bytes() == _png_bytes(
            tmp_path / "want.png", run.to_u8(img).numpy()), i
        npy = tmp_path / f"f_{i:04d}.npy"
        if raw:
            np.testing.assert_array_equal(np.load(npy), img.numpy())
        else:
            assert not npy.exists()
    assert sorted(p.name for p in tmp_path.glob("f_*")) == sorted(
        [f"f_{i:04d}.{e}" for i in range(3)
         for e in (("png", "npy") if raw else ("png",))])


def test_pipelined_loop_accumulate_and_resume_files(ball, tmp_path):
    """--accumulate 3 frames, then --resume with 3 more: the state and the
    image are those of the six frames rendered one by one."""
    extra = ["--frames", "3", "--accumulate", "--raw"]
    assert run.main(_argv(ball, tmp_path / "a.png", *extra)) == 0
    frames = _frames(ball[2], 6)
    want = Accumulator(H, W)
    for img in frames[:3]:
        want.add(img.numpy())
    got = Accumulator.load(str(tmp_path / "a_state.npz"))
    assert got.count == 3
    np.testing.assert_array_equal(got.sum, want.sum)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), want.image)
    assert (tmp_path / "a.png").read_bytes() == _png_bytes(
        tmp_path / "want.png", run.to_u8(torch.from_numpy(want.image)).numpy())
    angle = 0.01
    for _ in range(3):
        angle += ball[2].orbit_speed
    assert run.main(_argv(ball, tmp_path / "b.png", *extra, "--angle",
                          repr(angle), "--resume",
                          str(tmp_path / "a_state.npz"))) == 0
    for img in frames[3:]:
        want.add(img.numpy())
    got = Accumulator.load(str(tmp_path / "b_state.npz"))
    assert got.count == 6
    np.testing.assert_array_equal(got.sum, want.sum)
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"), want.image)
    assert not list(tmp_path.glob("a_0*")) + list(tmp_path.glob("b_0*"))


def _serve(argv, fetch_frames):
    """Run ``run.main(argv)`` (a --serve run) in a thread; for each frame
    index in ``fetch_frames`` the frame's log line (logged after it was
    published) holds the loop until /frame was fetched over 127.0.0.1.
    Returns {frame index: PNG bytes}."""
    port, pngs, result = [], {}, []
    wanted = {i: (threading.Event(), threading.Event()) for i in fetch_frames}

    class Hold(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            m = re.match(r"live viewer at http://0\.0\.0\.0:(\d+)/", msg)
            if m:
                port.append(int(m.group(1)))
            m = re.match(r'\{"frame": (\d+),', msg)
            if m and int(m.group(1)) in wanted:
                published, fetched = wanted[int(m.group(1))]
                published.set()
                fetched.wait(60)

    hold = Hold()
    rt_log.addHandler(hold)
    try:
        worker = threading.Thread(target=lambda: result.append(run.main(argv)))
        worker.start()
        try:
            for i, (published, fetched) in wanted.items():
                assert published.wait(60) and port
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port[0]}/frame", timeout=30) as r:
                    assert r.headers["X-Frame-Id"] == str(i)
                    pngs[i] = r.read()
                fetched.set()
        finally:
            for _, fetched in wanted.values():
                fetched.set()
        worker.join(60)
        assert not worker.is_alive() and result == [0]
    finally:
        rt_log.removeHandler(hold)
    return pngs


@pytest.mark.parametrize("raw", [False, True])
def test_pipelined_loop_serve_publishes_every_frame(ball, tmp_path, raw):
    """--serve 0 --frames 3: each frame is published before its log line,
    as it was rendered; files only with --raw."""
    extra = ["--frames", "3", "--serve", "0"] + (["--raw"] if raw else [])
    pngs = _serve(_argv(ball, tmp_path / "live.png", *extra), [0, 1, 2])
    frames = _frames(ball[2], 3)
    for i, img in enumerate(frames):
        np.testing.assert_array_equal(decode_png_bytes(pngs[i]),
                                      run.to_u8(img).numpy())
    written = sorted(p.name for p in tmp_path.glob("live_*"))
    if raw:
        assert written == sorted(f"live_{i:04d}.{e}" for i in range(3)
                                 for e in ("png", "npy"))
        for i, img in enumerate(frames):
            assert (tmp_path / f"live_{i:04d}.png").read_bytes() == \
                _png_bytes(tmp_path / "want.png", run.to_u8(img).numpy())
            np.testing.assert_array_equal(
                np.load(tmp_path / f"live_{i:04d}.npy"), img.numpy())
    else:
        assert written == []


def test_pipelined_loop_drains_the_pending_frame_on_sigint(ball, tmp_path,
                                                           monkeypatch,
                                                           caplog):
    """--frames 0 --serve 0 --raw: an interrupt while frame 3 renders ends
    the loop cleanly, and frame 2, enqueued but not yet drained, is still
    written and logged."""
    real = run.orbit_camera
    calls = []

    def orbit(angle, cfg):
        calls.append(angle)
        if len(calls) == 4:
            raise KeyboardInterrupt
        return real(angle, cfg)

    monkeypatch.setattr(run, "orbit_camera", orbit)
    with caplog.at_level(logging.INFO, logger="refraction_tpu"):
        assert run.main(_argv(ball, tmp_path / "live.png", "--frames", "0",
                              "--serve", "0", "--raw")) == 0
    logged = [json.loads(r.getMessage())["frame"] for r in caplog.records
              if r.getMessage().startswith('{"frame"')]
    assert logged == [0, 1, 2]
    assert any("interrupted after 3 frames" in r.getMessage()
               for r in caplog.records)
    frames = _frames(ball[2], 3)
    for i, img in enumerate(frames):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"live_{i:04d}.npy"), img.numpy())
    assert not (tmp_path / "live_0003.npy").exists()


def test_loop_log_line_keeps_its_keys(ball, tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="refraction_tpu"):
        assert run.main(_argv(ball, tmp_path / "f.png", "--frames", "2")) == 0
    lines = [json.loads(r.getMessage()) for r in caplog.records
             if r.getMessage().startswith('{"frame"')]
    assert [sorted(x) for x in lines] == [["fps", "frame", "ms",
                                           "stream_ms"]] * 2
    assert [x["frame"] for x in lines] == [0, 1]
    assert all(x["stream_ms"] is None and x["ms"] > 0 for x in lines)


def test_host_copies_on_cpu(ball):
    img = _frames(ball[2], 1)[0]
    u8, rad, done = run.HostCopies(torch.device("cpu"), True, False,
                                   False).enqueue(img)
    assert done is None and rad is None
    np.testing.assert_array_equal(u8, run.to_u8(img).numpy())
    u8, rad, _ = run.HostCopies(torch.device("cpu"), False, True,
                                True).enqueue(img)
    assert u8 is None
    np.testing.assert_array_equal(rad, img.numpy())
