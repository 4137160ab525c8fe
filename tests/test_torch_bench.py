"""refraction_tpu_torch.bench, the port's headline benchmark, on the CPU.

The harness runs in small mode on ``--device cpu`` at a tiny size (its
frames are the frame kernel's plain version) with the regimes cut short
(fewer frames and bursts: the same code), and its counts and its frame are
held against the JAX package: the dense ray count against
``refraction_tpu.render.rays_per_frame``, the live count against the JAX
integrator's ``rays_traced`` (xla backend), the headline frame against the
JAX ``render_frame`` (xla backend) within tests/test_golden.py's bars.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rmse
from refraction_tpu.camera import generate_rays as np_generate_rays
from refraction_tpu.config import RenderConfig as JaxConfig
from refraction_tpu.integrator import render_pixels as jax_render_pixels
from refraction_tpu.ops.backends import xla_env_contribution, xla_intersect
from refraction_tpu.render import TILE_H, TILE_W
from refraction_tpu.render import rays_per_frame as jax_rays_per_frame
from refraction_tpu.render import render_frame as jax_render_frame
from refraction_tpu.scene import load_scene as jax_load_scene
from refraction_tpu_torch import bench
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.fixtures import write_scene
from refraction_tpu_torch.io.png import write_png
from refraction_tpu_torch.io.primitives import make_gradient_envmap, make_icosphere
from refraction_tpu_torch.render import count_live_rays, rays_per_frame, sample_offsets

torch.set_num_threads(1)

RMSE_BAR, MAX_BAR = 1e-4, 1e-3  # tests/test_golden.py
CPU = torch.device("cpu")
# bench.py's keys the port keeps (no vs_baseline, *_vs_500, vs_prev,
# compile_s: its build_s / first_frame_s), and the port's own.
HEADLINE_KEYS = {
    "metric", "value", "unit", "frame_ms", "frame_latency_ms",
    "mrays_dense", "mrays_note", "dense_rays_per_frame", "tris", "backend",
    "device", "device_ms", "live_rays_per_frame", "mrays_live",
    "ref_demo_note", "build_s", "build_cached", "first_frame_s",
    "loop_frame_ms", "batched_frame_ms", "gate", "card", "launches",
    "headline_scene"}
SPEED_KEYS = {"value", "frame_ms", "frame_latency_ms", "loop_frame_ms",
              "batched_frame_ms", "device_ms", "mrays_dense", "mrays_live"}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """An asset dir holding write_scene's monkey.obj (80 tris) and a small
    envmap.png."""
    d = tmp_path_factory.mktemp("assets")
    write_scene(str(d), "monkey", make_icosphere(1, 1.2),
                make_gradient_envmap(16, 32))
    write_png(str(d / "envmap.png"), make_gradient_envmap(16, 32))
    return d


@pytest.fixture
def small(monkeypatch, assets):
    """Small mode on the assets at 12x8 with the regimes cut short; the
    gate samples every 5th pixel of so small a frame."""
    monkeypatch.setenv("RRT_ASSET_DIR", str(assets))
    monkeypatch.setenv("RRT_BENCH_SMALL", "1")
    monkeypatch.delenv("RRT_BENCH_BUDGET_S", raising=False)
    monkeypatch.setattr(bench, "SMALL_SIZE", (12, 8))
    monkeypatch.setattr(bench, "LATENCY_FRAMES", 2)
    monkeypatch.setattr(bench, "LOOP_FRAMES", 3)
    monkeypatch.setattr(bench, "BURSTS", 2)
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "GATE_STRIDE", 5)
    return assets


def _run(capsys, argv=("--device", "cpu")):
    """rc and the JSON lines the harness printed (each must parse)."""
    rc = bench.main(list(argv))
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines, "no JSON line printed"
    return rc, lines


def test_small_mode_prints_whole_lines(small, capsys):
    rc, lines = _run(capsys)
    assert rc == 0
    last = lines[-1]
    assert len(lines) == 5  # the headline, three extras, the skipped cells
    assert HEADLINE_KEYS <= set(last), HEADLINE_KEYS - set(last)
    for cell in ("ref_demo", "ott", "config5", "spp4", "build80k"):
        assert last[f"{cell}_note"] == "skipped (RRT_BENCH_SMALL)"
    assert not any(k.endswith("_error") for k in last)
    assert last["device"] == "cpu" and last["card"].startswith("cpu")
    assert last["build_s"] is None and last["first_frame_s"] > 0
    assert last["gate"]["headline"] == {
        "rmse": last["gate"]["headline"]["rmse"], "share_off": 0.0,
        "pixels": 20, "stride": 5, "ok": True}
    assert last["gate"]["headline"]["rmse"] < 1e-6  # plain against plain
    scene = last["headline_scene"]
    assert scene["mesh"] == str(small / "monkey.obj")
    assert scene["envmap"] == str(small / "envmap.png")
    assert scene["tris"] == last["tris"] == 80 and not scene["stand_in"]
    assert "monkey.obj 12x8" in last["metric"]
    # Counts: the JAX package's dense count; the live count of the frame.
    cfg = bench.headline_config(True)
    assert last["dense_rays_per_frame"] == jax_rays_per_frame(
        JaxConfig(width=12, height=8, max_refract_depth=4))
    sc, _ = bench.load_cell("monkey.obj", CPU)
    assert last["live_rays_per_frame"] == count_live_rays(
        sc, cfg, orbit_camera(0.01, cfg), CPU)
    # The headline is the fastest regime; the rates follow from it.
    fastest = min(last["frame_latency_ms"], last["loop_frame_ms"],
                  last["batched_frame_ms"])
    assert last["frame_ms"] == pytest.approx(fastest)
    assert last["value"] == pytest.approx(1e3 / fastest)
    assert last["mrays_live"] == pytest.approx(
        last["live_rays_per_frame"] / fastest / 1e3)
    # Frames timed per regime; on the CPU no kernel is launched.
    assert last["launches"] == {
        "latency": {"frames": 2, "fused_radiance": 0},
        "loop": {"frames": 3, "fused_radiance": 0},
        "device_ms": {"frames": 4, "fused_radiance": 0},
        "batched": {"frames": 4, "fused_radiance": 0}}
    # Each line is the cumulative object: every key of a line is in the next.
    for a, b in zip(lines, lines[1:]):
        assert set(a) <= set(b)


def test_budget_zero_notes_every_extra(small, capsys, monkeypatch):
    monkeypatch.setenv("RRT_BENCH_BUDGET_S", "0")
    rc, lines = _run(capsys)
    assert rc == 0
    last = lines[-1]
    for cell in ("device_ms", "live_rays", "batched"):
        assert last[f"{cell}_note"].startswith("skipped (RRT_BENCH_BUDGET_S")
    assert "device_ms" not in last and "batched_frame_ms" not in last
    assert {"value", "frame_ms", "loop_frame_ms", "gate"} <= set(last)
    assert last["gate"]["headline"]["ok"]


def test_planted_wrong_frame_fails_the_gate(small, capsys, monkeypatch):
    """A frame with 1e-2 added to its top rows fails the gate: the line
    has the failed gate and no speed key, and the exit code is 1."""
    real = bench.fused_radiance

    def planted(scene, scalars, cfg):
        img = real(scene, scalars, cfg).clone()
        img[:3] += 1e-2
        return img

    planted.launches = 0
    monkeypatch.setattr(bench, "fused_radiance", planted)
    rc, lines = _run(capsys)
    assert rc == 1
    assert len(lines) == 1
    g = lines[0]["gate"]["headline"]
    assert not g["ok"] and g["share_off"] > 0.3 and g["rmse"] > 1e-3
    assert not SPEED_KEYS & set(lines[0])


def test_extra_that_raises_exits_nonzero(small, capsys, monkeypatch):
    """live_rays raises: its error is in the last line, the extras after
    it still ran, and the exit code is 1."""
    def broken(*args, **kwargs):
        raise RuntimeError("planted failure")

    monkeypatch.setattr(bench, "count_live_rays", broken)
    rc, lines = _run(capsys)
    assert rc == 1
    last = lines[-1]
    assert "planted failure" in last["live_rays_error"]
    assert "live_rays_per_frame" not in last and "mrays_live" not in last
    assert "batched_frame_ms" in last


def test_asset_dir_mesh_is_loaded(assets, monkeypatch):
    monkeypatch.setenv("RRT_ASSET_DIR", str(assets))
    sc, label = bench.load_cell("monkey.obj", CPU)
    assert label == {"mesh": str(assets / "monkey.obj"), "stand_in": False,
                     "tris": 80, "envmap": str(assets / "envmap.png"),
                     "cluster_size": 1024}
    assert sc.num_tris == 1024  # padded to one cluster


def test_empty_asset_dir_gives_labelled_stand_ins(tmp_path, monkeypatch):
    monkeypatch.setenv("RRT_ASSET_DIR", str(tmp_path))
    sc, label = bench.load_cell("monkey.obj", CPU)
    assert label == {"mesh": "stand-in make_icosphere(3, 1.2)",
                     "stand_in": True, "tris": 1280,
                     "envmap": "stand-in make_gradient_envmap(1024, 2048)",
                     "cluster_size": 128}
    assert tuple(sc.envmap.shape) == (1024, 2048, 3)
    assert bench.STAND_INS["ott.obj"] == (5, 1.2)
    assert make_icosphere(*bench.STAND_INS["ott.obj"]).num_tris == 20480


def test_cuda_without_cuda_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--device", "cuda"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("shape", [
    (1920, 1080, 4, 2, 1), (1024, 768, 5, 2, 1), (1920, 1080, 5, 2, 4),
    (256, 128, 4, 2, 4), (33, 17, 3, 1, 2)])
def test_dense_rays_per_frame_matches_jax(shape):
    w, h, refract, reflect, spp = shape
    kw = dict(width=w, height=h, max_refract_depth=refract,
              max_reflect_depth=reflect, spp=spp)
    assert rays_per_frame(RenderConfig(**kw)) == jax_rays_per_frame(
        JaxConfig(**kw))


@functools.lru_cache(maxsize=None)
def _jax_rays_traced_fn(n_refract):
    """The JAX integrator's rays_traced (xla backend), jitted once a
    bounce cap (the other fields render_pixels reads are the defaults)."""
    cfg = JaxConfig(max_refract_depth=n_refract, backend="xla")
    return jax.jit(lambda sc, o, d: jax_render_pixels(
        sc, o, d, cfg, xla_intersect, xla_env_contribution,
        collect_stats=True)[1]["rays_traced"])


@pytest.mark.parametrize("spp", [1, 4])
def test_live_rays_match_jax_integrator(assets, spp, monkeypatch):
    """count_live_rays (the bench's live_rays_per_frame) equals the JAX
    integrator's rays_traced over the same unpadded rays, every sample's;
    at 24x20, not a multiple of the 32x32 tile, bench.py's count (tiles
    padded with edge rays, the spp 1 count times spp) is larger."""
    w, h = 24, 20
    jcfg = JaxConfig(width=w, height=h, max_refract_depth=4, spp=spp,
                     scene_path=str(assets / "monkey.obj"),
                     envmap_path=str(assets / "envmap.png"))
    jscene = jax.tree.map(jnp.asarray, jax_load_scene(jcfg)[0])
    cfg = RenderConfig(width=w, height=h, max_refract_depth=4, spp=spp)
    frame = orbit_camera(0.01, cfg)
    fn = _jax_rays_traced_fn(4)
    want = 0
    for off in sample_offsets(spp):
        o, d = np_generate_rays(frame, w, h, jitter=np.broadcast_to(
            off, (w * h, 2)), xp=np)
        want += int(fn(jscene, jnp.asarray(o), jnp.asarray(d)))
    monkeypatch.setenv("RRT_ASSET_DIR", str(assets))
    tscene, _ = bench.load_cell("monkey.obj", CPU)
    assert count_live_rays(tscene, cfg, frame, CPU) == want

    o, d = np_generate_rays(frame, w, h, xp=np)
    pad = ((0, TILE_H - h), (0, TILE_W - w), (0, 0))
    o = np.pad(o.reshape(h, w, 3), pad, mode="edge").reshape(-1, 3)
    d = np.pad(d.reshape(h, w, 3), pad, mode="edge").reshape(-1, 3)
    padded = int(fn(jscene, jnp.asarray(o), jnp.asarray(d))) * spp
    assert want < padded


def test_small_headline_frame_matches_jax(small, monkeypatch):
    """The small-mode headline frame (bench.first_frame at 32x24, its
    asset scene) against the JAX render_frame (xla backend)."""
    monkeypatch.setattr(bench, "SMALL_SIZE", (32, 24))
    cfg = bench.headline_config(True)
    sc, _ = bench.load_cell("monkey.obj", CPU)
    img = bench.first_frame(sc, cfg, CPU).numpy()
    jcfg = JaxConfig(width=32, height=24, max_refract_depth=4, backend="xla",
                     scene_path=str(small / "monkey.obj"),
                     envmap_path=str(small / "envmap.png"))
    jscene = jax.tree.map(jnp.asarray, jax_load_scene(jcfg)[0])
    ref = np.asarray(jax_render_frame(jscene, jcfg, angle=0.01))
    assert img.shape == ref.shape == (24, 32, 3)
    assert ref.max() > 0
    assert rmse(img, ref) < RMSE_BAR
    assert np.abs(img - ref).max() < MAX_BAR
