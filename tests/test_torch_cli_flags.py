"""The rest of the single-GPU CLI of refraction_tpu_torch on the CPU: per-ray
instance masks in the eager integrator, instancing (``--instances``,
``--mtl-ior``), progressive accumulation (``--accumulate/--resume``), the
live-ray heatmap (``--heatmap``) and the live viewer (``--serve``), held
against the JAX package on the same scenes and rays.

Image bar from tests/test_golden.py: RMSE < 1e-4 and max abs error < 1e-3.
Heatmap counts, accumulator states and served PNGs are compared exactly.
"""

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
from refraction_tpu.camera import generate_rays as np_generate_rays
from refraction_tpu.config import RenderConfig
from refraction_tpu.integrator import render_pixels as jax_render_pixels
from refraction_tpu.io.hdr import write_hdr
from refraction_tpu.io.png import decode_png_bytes, load_png
from refraction_tpu.io.primitives import (
    make_cube,
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu.ops.backends import xla_env_contribution, xla_intersect
from refraction_tpu.render import Accumulator as JaxAccumulator
from refraction_tpu.render import heatmap_to_rgb as jax_heatmap_to_rgb
from refraction_tpu.render import make_renderer as jax_make_renderer
from refraction_tpu.render import render_heatmap as jax_render_heatmap
from refraction_tpu.scene import Instance, build_instanced_scene, instance_transform
from refraction_tpu.scene import load_instanced as jax_load_instanced
from refraction_tpu.utils.stats import log as rt_log
from refraction_tpu_torch import run
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.fixtures import write_obj, write_scene
from refraction_tpu_torch.integrator import render_pixels
from refraction_tpu_torch.ops.backends import cuda_intersect, get_backend
from refraction_tpu_torch.render import (
    Accumulator,
    count_live_rays,
    heatmap_to_rgb,
    make_renderer,
    render_heatmap,
)
from refraction_tpu_torch.scene import load_instanced, load_scene, scene_from_jax

torch.set_num_threads(1)

RMSE_BAR, MAX_BAR = 1e-4, 1e-3
W, H = 32, 24


@pytest.fixture(scope="module")
def two_cubes():
    """Cube A (mask 1) and cube B (mask 2), as tests/test_instancing.py."""
    mesh = make_cube(1.0)
    t_a = instance_transform(translate=(-1.2, 0.0, 0.0))
    t_b = instance_transform(translate=(1.2, 0.0, 0.0), rotate_y_deg=30.0)
    scene, _ = build_instanced_scene(
        [Instance(mesh, t_a, mask=1), Instance(mesh, t_b, mask=2)],
        make_gradient_envmap(), cluster_size=8)
    return scene


@pytest.fixture(scope="module")
def rays():
    cfg = RenderConfig(width=W, height=H, max_refract_depth=3)
    o, d = np_generate_rays(orbit_camera(0.4, cfg), W, H, xp=np)
    return cfg, o.astype(np.float32), d.astype(np.float32)


def _mask(kind, n):
    if kind == "per-ray":  # left half sees A only, right half B only
        return np.where(np.arange(n) % W < W // 2, 1, 2).astype(np.int32)
    return np.full(n, kind, np.int32)


def _port_pixels(scene, cfg, o, d, mask, backend="torch"):
    be = get_backend(backend)
    return render_pixels(
        scene_from_jax(scene, "cpu"), torch.from_numpy(o),
        torch.from_numpy(d), cfg, be.intersect, be.env_contribution,
        ray_mask=None if mask is None else torch.from_numpy(mask)).numpy()


def _jax_pixels(scene, cfg, o, d, mask):
    return np.asarray(jax_render_pixels(
        jax.tree.map(jnp.asarray, scene), jnp.asarray(o), jnp.asarray(d),
        cfg, xla_intersect, xla_env_contribution,
        ray_mask=None if mask is None else jnp.asarray(mask)))


@pytest.mark.parametrize("kind", [0xFF, 1, 2, 4, "per-ray"])
def test_ray_mask_matches_jax(two_cubes, rays, kind):
    cfg, o, d = rays
    mask = _mask(kind, o.shape[0])
    got = _port_pixels(two_cubes, cfg, o, d, mask)
    ref = _jax_pixels(two_cubes, cfg, o, d, mask)
    assert rmse(got, ref) < RMSE_BAR
    assert np.abs(got - ref).max() < MAX_BAR
    if kind == 0xFF:  # every instance admitted: the unmasked image
        np.testing.assert_array_equal(
            got, _port_pixels(two_cubes, cfg, o, d, None))


def test_ray_mask_without_tri_mask_raises_where_jax_ignores_it(two_cubes,
                                                                 rays):
    """The JAX xla_intersect skips the mask test when scene.tri_mask is
    None (ops/backends.py:58-71 with ops/intersect.py:98): a mask that
    admits no instance still renders both cubes. The port raises."""
    cfg, o, d = rays
    no_masks = two_cubes._replace(tri_mask=None)
    mask = _mask(4, o.shape[0])
    ignored = _jax_pixels(no_masks, cfg, o, d, mask)
    np.testing.assert_array_equal(
        ignored, _jax_pixels(no_masks, cfg, o, d, None))
    with pytest.raises(ValueError, match="tri_mask is None"):
        _port_pixels(no_masks, cfg, o, d, mask)
    # With the masks baked in, the same ray mask hides both cubes.
    assert rmse(_port_pixels(two_cubes, cfg, o, d, mask), ignored) > 1e-3


def test_cuda_backend_raises_on_ray_mask(two_cubes, rays):
    cfg, o, d = rays
    mask = _mask(1, o.shape[0])
    with pytest.raises(ValueError, match="constant 0xff"):
        _port_pixels(two_cubes, cfg, o, d, mask, backend="cuda")
    ts = scene_from_jax(two_cubes, "cpu")
    n = o.shape[0]
    with pytest.raises(ValueError, match="constant 0xff"):
        cuda_intersect(ts, torch.from_numpy(o), torch.from_numpy(d),
                       torch.ones(n, dtype=torch.bool),
                       torch.ones(n, dtype=torch.bool), 1e-3, 100.0,
                       ray_mask=torch.from_numpy(mask))


def _write_spec(tmp_path, with_mtl=False):
    """Three instances of two procedural meshes; the third has mask 0."""
    ball = str(tmp_path / "ball.obj")
    box = str(tmp_path / "box.obj")
    write_obj(ball, make_icosphere(2, 0.8))
    write_obj(box, make_cube(1.0))
    if with_mtl:
        (tmp_path / "ball.mtl").write_text("newmtl glass\nNi 1.45\n")
    spec = [{"obj": ball, "translate": [-1.0, 0.0, 0.0]},
            {"obj": box, "translate": [1.1, 0.0, 0.0], "rotate_y_deg": 30.0,
             "scale": 0.9},
            {"obj": box, "translate": [0.0, 1.5, 0.0], "mask": 0}]
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    hdr = str(tmp_path / "env.hdr")
    write_hdr(hdr, make_gradient_envmap(32, 64))
    return str(path), hdr


def test_instanced_render_matches_jax(tmp_path):
    spec, hdr = _write_spec(tmp_path)
    cfg = RenderConfig(width=W, height=H, max_refract_depth=3,
                       envmap_path=hdr, backend="xla")
    scene, meta = load_instanced(spec, cfg)
    assert meta.num_real_tris == make_icosphere(2, 0.8).num_tris + 12
    frame = orbit_camera(0.5, cfg)
    got = make_renderer(cfg, "cuda", "cpu")(scene_from_jax(scene, "cpu"),
                                            frame).numpy()
    j_scene, _ = jax_load_instanced(spec, cfg)
    ref = np.asarray(jax_make_renderer(cfg)(
        jax.tree.map(jnp.asarray, j_scene), frame))
    assert rmse(got, ref) < RMSE_BAR
    assert np.abs(got - ref).max() < MAX_BAR


def test_cli_instances_and_mtl_ior(tmp_path, caplog):
    spec, hdr = _write_spec(tmp_path, with_mtl=True)
    out = tmp_path / "inst.png"
    with caplog.at_level(logging.INFO, logger="refraction_tpu"):
        assert run.main(["--instances", spec, "--envmap", hdr, "--width",
                         str(W), "--height", str(H), "--bounces", "3",
                         "--mtl-ior", "--out", str(out), "--raw",
                         "--device", "cpu"]) == 0
    assert "IOR from MTL" in caplog.text and "1.45" in caplog.text
    cfg = RenderConfig(width=W, height=H, max_refract_depth=3,
                       envmap_path=hdr, ior=1.45)
    scene = scene_from_jax(load_instanced(spec, cfg)[0], "cpu")
    want = make_renderer(cfg, "cuda", "cpu")(scene, orbit_camera(0.01, cfg))
    np.testing.assert_array_equal(np.load(tmp_path / "inst.npy"),
                                  want.numpy())
    np.testing.assert_array_equal(load_png(str(out)),
                                  run.to_u8(want).numpy())


@pytest.mark.parametrize("form", ["list", "dict"])
@pytest.mark.parametrize("where", ["as given", "beside the scene"])
def test_mtl_ior_source_is_the_first_obj_load_instanced_reads(
        tmp_path, monkeypatch, form, where):
    """`scene.load_instanced` returns no paths, so ``run.mtl_ior_source``
    reads the spec itself; it must name the file that the port's
    load_instanced (the one the CLI calls) parses first."""
    import refraction_tpu_torch.scene as port_scene

    spec, hdr = _write_spec(tmp_path)
    entries = json.loads(open(spec).read())
    if where == "beside the scene":
        for e in entries:
            e["obj"] = e["obj"].rsplit("/", 1)[1]
    body = entries if form == "list" else {"instances": entries}
    (tmp_path / "spec.json").write_text(json.dumps(body))
    monkeypatch.chdir(tmp_path.parent)  # relative names do not exist as given
    cfg = RenderConfig(width=W, height=H, envmap_path=hdr,
                       scene_path=str(tmp_path / "scene.obj"))
    read = []
    parse = port_scene.parse_obj
    monkeypatch.setattr(port_scene, "parse_obj",
                        lambda p: read.append(p) or parse(p))
    port_scene.load_instanced(spec, cfg)
    args = run.parse_args(["--instances", spec])
    assert run.mtl_ior_source(args, cfg) == read[0]


@pytest.mark.parametrize("kind", ["ndarray", "cpu-tensor"])
def test_accumulator_host_fold_keeps_the_jax_packages_bits(kind):
    """A host frame (a numpy array or a CPU tensor) is folded on the host,
    bit for bit as the JAX package folds its numpy copy; no card fold."""
    rng = np.random.default_rng(2)
    frames = rng.random((4, 4, 5, 3)).astype(np.float32) * 3.0
    got, want = Accumulator(4, 5), JaxAccumulator(4, 5)
    for f in frames:
        got.add(f if kind == "ndarray" else torch.from_numpy(f))
        want.add(f)
    assert (got.count, got.card_folds) == (4, 0)
    assert isinstance(got.sum, np.ndarray) and got.sum.dtype == np.float64
    np.testing.assert_array_equal(got.sum.view(np.uint64),
                                  want.sum.view(np.uint64))
    np.testing.assert_array_equal(got.image, want.image)


def test_accumulator_sum_is_a_host_float64_array_that_can_be_set():
    acc = Accumulator(4, 5)
    got = acc.sum
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == (4, 5, 3) and not got.any()
    assert acc.sum is got  # one array: a read does not copy
    # Assigning sets the host value, as `load` does; a float32 state is
    # widened, and folds go on from it.
    start = np.arange(60, dtype=np.float32).reshape(4, 5, 3)
    acc.sum = start
    assert acc.sum.dtype == np.float64
    acc.add(np.ones((4, 5, 3), np.float32))
    np.testing.assert_array_equal(acc.sum, start.astype(np.float64) + 1.0)
    assert (acc.count, acc.card_folds) == (1, 0)


@pytest.mark.parametrize("direction", ["torch-to-jax", "jax-to-torch"])
def test_accumulator_state_round_trips(tmp_path, direction):
    rng = np.random.default_rng(1)
    frames = rng.random((3, 4, 5, 3)).astype(np.float32)
    src_cls, dst_cls = ((Accumulator, JaxAccumulator)
                        if direction == "torch-to-jax"
                        else (JaxAccumulator, Accumulator))
    src = src_cls(4, 5)
    for f in frames:
        src.add(f)
    path = str(tmp_path / "state.npz")
    src.save(path)
    dst = dst_cls.load(path)
    assert dst.count == 3
    np.testing.assert_array_equal(dst.sum, src.sum)
    np.testing.assert_array_equal(dst.image, src.image)
    dst.add(frames[0])
    assert dst.count == 4


def test_cli_accumulate_and_resume(tmp_path):
    obj, hdr = write_scene(str(tmp_path), "ball", make_icosphere(2, 1.2),
                           make_gradient_envmap(32, 64))
    common = ["--scene", obj, "--envmap", hdr, "--width", "16", "--height",
              "12", "--bounces", "3", "--accumulate", "--raw", "--device",
              "cpu"]
    cfg = RenderConfig(width=16, height=12, max_refract_depth=3,
                       scene_path=obj, envmap_path=hdr)
    angles = [0.01]
    for _ in range(2):
        angles.append(angles[-1] + cfg.orbit_speed)
    assert run.main(common + ["--frames", "2",
                              "--out", str(tmp_path / "a.png")]) == 0
    assert run.main(common + ["--frames", "1", "--angle", repr(angles[2]),
                              "--resume", str(tmp_path / "a_state.npz"),
                              "--out", str(tmp_path / "b.png")]) == 0
    state = Accumulator.load(str(tmp_path / "b_state.npz"))
    assert state.count == 3
    scene = scene_from_jax(load_scene(cfg)[0], "cpu")
    render = make_renderer(cfg, "cuda", "cpu")
    frames = [render(scene, orbit_camera(a, cfg)).numpy() for a in angles]
    mean = np.mean(np.asarray(frames, np.float64), axis=0)
    np.testing.assert_allclose(np.load(tmp_path / "b.npy"), mean, atol=1e-6,
                               rtol=0)
    assert load_png(str(tmp_path / "b.png")).shape == (12, 16, 3)


def test_resume_needs_accumulate(tmp_path):
    with pytest.raises(SystemExit):
        run.main(["--resume", str(tmp_path / "s.npz"), "--device", "cpu"])


def test_heatmap_matches_jax(sphere_scene):
    scene, _ = sphere_scene
    cfg = RenderConfig(width=W, height=H, max_refract_depth=3, spp=2,
                       backend="xla")
    frame = orbit_camera(0.3, cfg)
    port_scene = scene_from_jax(scene, "cpu")
    got = render_heatmap(port_scene, cfg, frame, "cpu")
    ref = jax_render_heatmap(jax.tree.map(jnp.asarray, scene), cfg,
                             frame=frame)
    assert got.dtype == np.int32 and got.shape == (H, W)
    np.testing.assert_array_equal(got, ref)
    # count_live_rays sums the integrator's rays_traced, not the map.
    assert int(got.sum()) == count_live_rays(port_scene, cfg, frame, "cpu")
    assert got.min() == 2 and got.max() > 4  # 2 samples; some trees grow
    np.testing.assert_array_equal(heatmap_to_rgb(got),
                                  jax_heatmap_to_rgb(ref))


def test_cli_heatmap_on_cpu(tmp_path):
    obj, hdr = write_scene(str(tmp_path), "ball", make_icosphere(2, 1.2),
                           make_gradient_envmap(32, 64))
    path = tmp_path / "heat.png"
    assert run.main(["--scene", obj, "--envmap", hdr, "--width", "16",
                     "--height", "12", "--heatmap", str(path),
                     "--out", str(tmp_path / "unused.png"),
                     "--device", "cpu"]) == 0
    cfg = RenderConfig(width=16, height=12, scene_path=obj, envmap_path=hdr)
    counts = render_heatmap(scene_from_jax(load_scene(cfg)[0], "cpu"), cfg,
                            orbit_camera(0.01, cfg), "cpu")
    rgb = heatmap_to_rgb(counts)
    np.testing.assert_array_equal(
        load_png(str(path)),
        (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    assert not (tmp_path / "unused.png").exists()


def test_cli_serve_publishes_frames_over_loopback(tmp_path):
    """``--serve 0 --frames 2`` in a thread: frame 0 is published before
    its log line, whose handler holds the render loop until the test has
    fetched /frame over 127.0.0.1."""
    obj, hdr = write_scene(str(tmp_path), "ball", make_icosphere(2, 1.2),
                           make_gradient_envmap(32, 64))
    argv = ["--scene", obj, "--envmap", hdr, "--width", "16", "--height",
            "12", "--bounces", "3", "--frames", "2", "--serve", "0",
            "--out", str(tmp_path / "live.png"), "--device", "cpu"]
    port, published, fetched, result = [], threading.Event(), \
        threading.Event(), []

    class Hold(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            m = re.match(r"live viewer at http://0\.0\.0\.0:(\d+)/", msg)
            if m:
                port.append(int(m.group(1)))
            elif msg.startswith('{"frame": 0,'):
                published.set()
                fetched.wait(60)

    hold = Hold()
    rt_log.addHandler(hold)
    try:
        worker = threading.Thread(target=lambda: result.append(run.main(argv)))
        worker.start()
        try:
            assert published.wait(60) and port and port[0] > 0
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port[0]}/frame", timeout=30) as r:
                assert r.headers["Content-Type"] == "image/png"
                assert r.headers["X-Frame-Id"] == "0"
                png = r.read()
        finally:
            fetched.set()
        worker.join(60)
        assert not worker.is_alive() and result == [0]
    finally:
        rt_log.removeHandler(hold)
    cfg = RenderConfig(width=16, height=12, max_refract_depth=3,
                       scene_path=obj, envmap_path=hdr)
    want = make_renderer(cfg, "cuda", "cpu")(
        scene_from_jax(load_scene(cfg)[0], "cpu"), orbit_camera(0.01, cfg))
    np.testing.assert_array_equal(decode_png_bytes(png),
                                  run.to_u8(want).numpy())
    # A live orbit writes no per-frame files unless --raw asks for them.
    assert not list(tmp_path.glob("live_*"))
