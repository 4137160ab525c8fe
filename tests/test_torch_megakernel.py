"""refraction_tpu_torch round module (kernels/megakernel.py) and the per-round
wavefront (integrator.render_pixels_mega, render.count_live_rays,
profile_rounds) vs the JAX megakernel, the JAX and port wavefronts and the
NumPy oracle.

On CPU tensors ``mega_round`` takes its plain version; the JAX side is the
Pallas ``mega_round`` in interpret mode. Flip budget (PARITY.md §4): the
Pallas kernel normalizes with rsqrt, uses polynomial atan2/acos and visits
clusters in another order, so a lane near a triangle edge or a texel
boundary may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rmse
from oracle.numpy_tracer import render_oracle
from refraction_tpu.camera import generate_rays as np_generate_rays
from refraction_tpu.camera import orbit_camera
from refraction_tpu.config import RenderConfig
from refraction_tpu.integrator import render_pixels as jax_render_pixels
from refraction_tpu.io.primitives import make_gradient_envmap, make_icosphere
from refraction_tpu.kernels.megakernel import mega_round as jax_mega_round
from refraction_tpu.ops.backends import xla_env_contribution, xla_intersect
from refraction_tpu.scene import build_scene, load_scene
from refraction_tpu_torch import profile_rounds
from refraction_tpu_torch.camera import generate_rays
from refraction_tpu_torch.fixtures import write_scene
from refraction_tpu_torch.integrator import (
    initial_state,
    render_pixels,
    render_pixels_mega,
)
from refraction_tpu_torch.kernels.megakernel import mega_round
from refraction_tpu_torch.ops.backends import get_backend
from refraction_tpu_torch.render import count_live_rays, sample_offsets
from refraction_tpu_torch.run import build_config, parse_args
from refraction_tpu_torch.scene import scene_from_jax

torch.set_num_threads(1)

LANES = 16384
LIVE_AGREE = 0.9999          # share of lanes with equal hit / child liveness
CHILD_ATOL = 1e-5            # child origin, direction, weight where they agree
RAD_TOL, MAX_RAD_FLIPS = 1e-3, 8
RMSE_BAR, MAX_BAR = 1e-4, 1e-3   # tests/test_golden.py
EAGER_RMSE = 1e-6
# (want_reflect, want_children) of the JAX kernel's three bodies
VARIANTS = {"full": (True, True), "norefl": (False, True),
            "missonly": (False, False)}


def _lanes(n, seed):
    """(8, n) lane state around the r=1.2 icosphere: outside lanes aimed at
    and past it from a shell, inside lanes from within it in any direction,
    and dead lanes; random weights."""
    rng = np.random.default_rng(seed)
    cull = rng.choice(np.float32([1.0, -1.0, 0.0]), n)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = u * rng.uniform(2.5, 4.0, (n, 1))
    d = rng.uniform(-1.8, 1.8, (n, 3)) - o
    inside = cull < 0
    o[inside] = rng.uniform(-0.6, 0.6, (int(inside.sum()), 3))
    d[inside] = rng.normal(size=(int(inside.sum()), 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wgt = rng.uniform(0.0, 1.0, n)
    return np.ascontiguousarray(
        np.concatenate([o.T, d.T, cull[None], wgt[None]]), np.float32)


def _jax_round(scene, state, limits, want_reflect, want_children):
    rows = state.shape[1] // 128
    planes = [jnp.asarray(x.reshape(rows, 128)) for x in state]
    res = jax_mega_round(
        scene.tri_packed, scene.tri_norm_packed, scene.cluster_bounds,
        scene.sub_bounds, scene.env_packed.reshape(-1, 128),
        jnp.asarray(limits, jnp.float32), *planes,
        env_h=scene.envmap.shape[0], env_w=scene.envmap.shape[1],
        want_reflect=want_reflect, want_children=want_children,
        interpret=True)
    res = [np.asarray(r).reshape(-1) for r in res]
    rad = np.stack(res[0:3], axis=-1)
    if not want_children:
        return rad, None
    # JAX outputs: hit point x3, refraction dir x3, cull, wgt, [reflection
    # dir x3, cull, wgt]; the port's next state holds the same rows.
    refr = np.stack(res[3:11])
    if not want_reflect:
        return rad, refr
    refl = np.stack(res[3:6] + res[11:16])
    return rad, np.concatenate([refr, refl], axis=1)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_mega_round_matches_jax_kernel(sphere_scene, variant):
    scene, _ = sphere_scene
    want_reflect, want_children = VARIANTS[variant]
    cfg = RenderConfig()
    limits = (cfg.secondary_tmin, cfg.secondary_tmax, cfg.ior,
              cfg.fresnel_r0)
    state = _lanes(LANES, seed=7)
    rad_j, kids_j = _jax_round(scene, state, limits, want_reflect,
                               want_children)
    before = mega_round.launches
    out = mega_round(scene_from_jax(scene, "cpu"), torch.from_numpy(state),
                     limits, want_reflect, want_children)
    assert mega_round.launches == before  # CPU tensors: the plain version
    rad = out.radiance.numpy()
    assert rad.shape == (LANES, 3)
    assert rad.max() > 0
    dead = state[6] == 0
    assert not rad[dead].any()
    flips = (np.abs(rad - rad_j).max(axis=-1) > RAD_TOL).sum()
    assert flips <= MAX_RAD_FLIPS, flips
    if not want_children:
        assert out.children is None
        return
    kids = out.children.numpy()
    assert kids.shape == kids_j.shape == (8, LANES * (1 + want_reflect))
    # Hit liveness: the hit point moves off the origin (t >= tmin > 0).
    hit = (kids[0:3, :LANES] != state[0:3]).any(axis=0)
    hit_j = (kids_j[0:3, :LANES] != state[0:3]).any(axis=0)
    assert (hit == hit_j).mean() >= LIVE_AGREE
    assert not hit[dead].any()
    alive, alive_j = kids[6] != 0, kids_j[6] != 0
    assert (alive == alive_j).mean() >= LIVE_AGREE
    if want_reflect:  # the reflection child lives on every hit
        np.testing.assert_array_equal(alive[LANES:], hit)
    same = np.tile(hit == hit_j, 1 + want_reflect) & (alive == alive_j)
    assert same.mean() >= LIVE_AGREE
    np.testing.assert_allclose(kids[:, same], kids_j[:, same], rtol=0,
                               atol=CHILD_ATOL)


@pytest.mark.parametrize("caps", [(1, 0), (2, 1), (5, 2)],
                         ids=["caps1-0", "caps2-1", "caps5-2"])
@pytest.mark.parametrize("name,angle", [("cube_scene", 0.3),
                                        ("sphere_scene", 0.85)])
def test_render_pixels_mega_matches_oracle_and_eager(name, angle, caps,
                                                     request):
    scene, _ = request.getfixturevalue(name)
    ts = scene_from_jax(scene, "cpu")
    cfg = RenderConfig(width=64, height=16, max_refract_depth=caps[0],
                       max_reflect_depth=caps[1])
    frame = orbit_camera(angle, cfg)
    o, d = np_generate_rays(frame, cfg.width, cfg.height, xp=np)
    o = torch.from_numpy(np.ascontiguousarray(o, np.float32))
    d = torch.from_numpy(np.ascontiguousarray(d, np.float32))
    img = render_pixels_mega(ts, o, d, cfg).numpy().reshape(16, 64, 3)
    ref = render_oracle(scene, cfg, frame=frame)
    assert ref.max() > 0
    assert rmse(img, ref) < RMSE_BAR
    assert np.abs(img - ref).max() < MAX_BAR
    be = get_backend("torch")
    eager = render_pixels(ts, o, d, cfg, be.intersect, be.env_contribution)
    assert rmse(img, eager.numpy().reshape(16, 64, 3)) < EAGER_RMSE


@pytest.mark.parametrize("caps", [(5, 2), (2, 1)], ids=["caps5-2", "caps2-1"])
def test_mega_stats_match_jax_wavefront(sphere_scene, caps):
    scene, _ = sphere_scene
    cfg = RenderConfig(width=48, height=36, max_refract_depth=caps[0],
                       max_reflect_depth=caps[1], backend="xla")
    o, d = np_generate_rays(orbit_camera(0.85, cfg), 48, 36, xp=np)
    fn = jax.jit(lambda sc, o_, d_: jax_render_pixels(
        sc, o_, d_, cfg, xla_intersect, xla_env_contribution,
        collect_stats=True))
    _, st_j = fn(jax.tree.map(jnp.asarray, scene), jnp.asarray(o),
                 jnp.asarray(d))
    _, st = render_pixels_mega(scene_from_jax(scene, "cpu"),
                               torch.from_numpy(np.ascontiguousarray(o)),
                               torch.from_numpy(np.ascontiguousarray(d)),
                               cfg, collect_stats=True)
    assert st["rays_traced"].dtype == torch.int64
    assert int(st["rays_traced"]) == int(st_j["rays_traced"])
    assert int(st["rays_traced"]) > 48 * 36  # some rays bounced
    assert st["slot_rounds"] == st_j["slot_rounds"]


def test_reflection_child_liveness_survives_weight_underflow():
    """Port of tests/test_megakernel.py's test of the same name: a
    reflection child whose weight w * R underflows to 0.0 is still alive,
    same side (the reference spawns it on every hit, RayTracing.hlsl:110)."""
    scene, _ = build_scene(make_icosphere(1), make_gradient_envmap(16, 32),
                           cluster_size=32)
    n = 16384
    state = np.zeros((8, n), np.float32)
    state[0] = 3.0     # from +x ...
    state[3] = -1.0    # ... at the sphere's centre: every lane hits
    state[6] = 1.0
    # The least float32 subnormal: w * R (R ~ 0.26 head-on) rounds to 0.0.
    state[7] = np.float32(1.4e-45)
    out = mega_round(scene_from_jax(scene, "cpu"), torch.from_numpy(state),
                     (1e-4, 100.0, 1.3, 0.00826446), True, True)
    l_cull = out.children[6, n:].numpy()
    l_wgt = out.children[7, n:].numpy()
    assert (l_wgt == 0.0).all()
    assert (l_cull == 1.0).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_unpadded_lanes_match_padded(sphere_scene, variant):
    """1000 lanes (not a multiple of 1024) give the real lanes of the same
    state padded to 1024 with dead lanes; the pad lanes stay dead."""
    ts = scene_from_jax(sphere_scene[0], "cpu")
    want_reflect, want_children = VARIANTS[variant]
    n, w = 1000, 1024
    padded = _lanes(w, seed=3)
    padded[6, n:] = 0.0
    limits = (1e-3, 1000.0, 1.3, 0.00826446)
    a = mega_round(ts, torch.from_numpy(padded[:, :n].copy()), limits,
                   want_reflect, want_children)
    b = mega_round(ts, torch.from_numpy(padded), limits, want_reflect,
                   want_children)
    torch.testing.assert_close(a.radiance, b.radiance[:n], rtol=0, atol=0)
    assert not b.radiance[n:].any()
    if not want_children:
        return
    cols = [slice(0, n)] + ([slice(n, 2 * n)] if want_reflect else [])
    pcols = [slice(0, n)] + ([slice(w, w + n)] if want_reflect else [])
    for c, pc in zip(cols, pcols):
        torch.testing.assert_close(a.children[:, c], b.children[:, pc],
                                   rtol=0, atol=0)
    assert not b.children[6:8, n:w].any()
    empty = mega_round(ts, torch.zeros(8, 0), limits, want_reflect,
                       want_children)
    assert empty.radiance.shape == (0, 3)
    assert empty.children.shape == (8, 0)


@pytest.mark.parametrize("spp", [1, 4])
def test_count_live_rays_counts_real_pixels_and_every_sample(sphere_scene,
                                                             spp):
    """count_live_rays equals the eager integrator's count over every
    sample's rays, and is lower than bench.py's count, which pads to
    32x32 tiles with edge-duplicated rays and scales the spp=1 count."""
    scene, _ = sphere_scene
    ts = scene_from_jax(scene, "cpu")
    w, h = 40, 20
    cfg = RenderConfig(width=w, height=h, spp=spp)
    frame = orbit_camera(0.01, cfg)
    got = count_live_rays(ts, cfg, frame, "cpu")
    be = get_backend("torch")
    want = 0
    for off in sample_offsets(spp):
        o, d = generate_rays(frame, w, h, "cpu", jitter=off)
        _, st = render_pixels(ts, o, d, cfg, be.intersect,
                              be.env_contribution, collect_stats=True)
        want += int(st["rays_traced"])
    assert got == want

    o, d = np_generate_rays(frame, w, h, xp=np)
    pad = ((0, 32 - h), (0, 64 - w), (0, 0))
    o = np.pad(o.reshape(h, w, 3), pad, mode="edge").reshape(-1, 3)
    d = np.pad(d.reshape(h, w, 3), pad, mode="edge").reshape(-1, 3)
    _, st = render_pixels(ts, torch.from_numpy(o.astype(np.float32)),
                          torch.from_numpy(d.astype(np.float32)), cfg,
                          be.intersect, be.env_contribution,
                          collect_stats=True)
    jax_style = int(st["rays_traced"]) * spp
    assert got < jax_style


def test_profile_rounds_cpu(tmp_path, capsys):
    obj, hdr = write_scene(str(tmp_path), "ball", make_icosphere(2, 1.2),
                           make_gradient_envmap(64, 128))
    argv = ["--scene", obj, "--envmap", hdr, "--width", "32", "--height",
            "16", "--bounces", "3", "--device", "cpu"]
    assert profile_rounds.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round ")]
    cfg = build_config(parse_args(argv))
    assert len(lines) == cfg.max_refract_depth + 1
    live = [int(ln.split(" live ")[1].split()[0]) for ln in lines]
    ms = [float(ln.split(" ms ")[1]) for ln in lines]
    assert all(m > 0 for m in ms)
    scene = scene_from_jax(load_scene(cfg)[0], "cpu")
    o, d = generate_rays(orbit_camera(0.01, cfg), 32, 16, "cpu")
    _, st = render_pixels_mega(scene, o, d, cfg, collect_stats=True)
    assert sum(live) == int(st["rays_traced"])
    assert live[0] == 32 * 16


def test_mega_round_checks_its_inputs(cube_scene):
    ts = scene_from_jax(cube_scene[0], "cpu")
    state = initial_state(torch.zeros(4, 3), torch.ones(4, 3))
    limits = (1e-3, 1000.0, 1.3, 0.00826446)
    with pytest.raises(ValueError, match="state"):
        mega_round(ts, state[:, ::2], limits, True, True)
    with pytest.raises(ValueError, match="state"):
        mega_round(ts, state.double(), limits, True, True)
    with pytest.raises(ValueError, match="state"):
        mega_round(ts, state[:7].contiguous(), limits, True, True)
    with pytest.raises(ValueError, match="limits"):
        mega_round(ts, state, limits[:3], True, True)
    with pytest.raises(ValueError, match="unsupported device"):
        mega_round(ts, state.to("meta"), limits, True, True)


def test_profile_rounds_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_rounds.main(["--device", "cuda"])
