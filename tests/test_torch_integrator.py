"""refraction_tpu_torch eager integrator vs the JAX wavefront integrator
(xla backend) on the same primary rays, and vs the NumPy oracle.

Bar from tests/test_golden.py: RMSE < 1e-4 and max abs error < 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rmse
from oracle.numpy_tracer import render_oracle
from refraction_tpu.camera import generate_rays, orbit_camera
from refraction_tpu.config import RenderConfig
from refraction_tpu.integrator import render_pixels as jax_render_pixels
from refraction_tpu.ops.backends import xla_env_contribution, xla_intersect
from refraction_tpu.render import sample_offsets
from refraction_tpu_torch.integrator import render_pixels
from refraction_tpu_torch.ops.backends import get_backend
from refraction_tpu_torch.scene import scene_from_jax

torch.set_num_threads(1)

RMSE_BAR, MAX_BAR = 1e-4, 1e-3


def _jax_pixels(scene, cfg, o, d, collect_stats=False):
    fn = jax.jit(lambda sc, o_, d_: jax_render_pixels(
        sc, o_, d_, cfg, xla_intersect, xla_env_contribution,
        collect_stats=collect_stats))
    return fn(jax.tree.map(jnp.asarray, scene), jnp.asarray(o), jnp.asarray(d))


def _torch_pixels(tscene, cfg, o, d, collect_stats=False):
    be = get_backend("torch")
    return render_pixels(tscene, torch.from_numpy(np.ascontiguousarray(o)),
                         torch.from_numpy(np.ascontiguousarray(d)), cfg,
                         be.intersect, be.env_contribution,
                         collect_stats=collect_stats)


# (scene fixture, angle, width, height, max_refract, max_reflect, spp)
CASES = [
    ("cube_scene", 0.3, 48, 36, 5, 2, 1),
    ("sphere_scene", 0.85, 48, 36, 5, 2, 1),
    ("sphere_scene", 0.5, 32, 24, 1, 0, 1),
    ("sphere_scene", 0.5, 32, 24, 2, 1, 1),
    ("sphere_scene", 0.5, 32, 24, 3, 2, 1),
    ("sphere_scene", 0.5, 32, 24, 5, 2, 1),
    ("cube_scene", 0.3, 32, 24, 5, 2, 4),
]


@pytest.mark.parametrize("case", CASES, ids=[
    "cube", "sphere", "caps1-0", "caps2-1", "caps3-2", "caps5-2", "spp4"])
def test_render_pixels_matches_jax_and_oracle(case, request):
    name, angle, w, h, mrd, mld, spp = case
    scene, _ = request.getfixturevalue(name)
    ts = scene_from_jax(scene, "cpu")
    cfg = RenderConfig(width=w, height=h, max_refract_depth=mrd,
                       max_reflect_depth=mld, spp=spp, backend="xla")
    frame = orbit_camera(angle, cfg)
    acc_t = np.zeros((h * w, 3), np.float64)
    acc_j = np.zeros_like(acc_t)
    acc_o = np.zeros((h, w, 3), np.float64)
    for off in sample_offsets(spp):
        jitter = None if spp == 1 else np.broadcast_to(off, (h * w, 2))
        o, d = generate_rays(frame, w, h, jitter=jitter, xp=np)
        acc_t += _torch_pixels(ts, cfg, o, d).numpy()
        acc_j += np.asarray(_jax_pixels(scene, cfg, o, d))
        acc_o += render_oracle(scene, cfg.replace(spp=1), frame=frame,
                               jitter=jitter)
    img_t = (acc_t / spp).reshape(h, w, 3)
    img_j = (acc_j / spp).reshape(h, w, 3)
    img_o = acc_o / spp
    assert img_o.max() > 0
    for ref in (img_j, img_o):
        assert rmse(img_t, ref) < RMSE_BAR
        assert np.abs(img_t - ref).max() < MAX_BAR


def test_collect_stats_match_jax(sphere_scene):
    scene, _ = sphere_scene
    ts = scene_from_jax(scene, "cpu")
    cfg = RenderConfig(width=48, height=36, backend="xla")
    o, d = generate_rays(orbit_camera(0.85, cfg), 48, 36, xp=np)
    rad_t, st_t = _torch_pixels(ts, cfg, o, d, collect_stats=True)
    rad_j, st_j = _jax_pixels(scene, cfg, o, d, collect_stats=True)
    assert int(st_t["rays_traced"]) == int(st_j["rays_traced"])
    assert int(st_t["rays_traced"]) > 48 * 36  # some rays bounced
    assert st_t["slot_rounds"] == st_j["slot_rounds"]
    np.testing.assert_array_equal(st_t["pixel_rays"].numpy(),
                                  np.asarray(st_j["pixel_rays"]))
    assert rmse(rad_t.numpy(), np.asarray(rad_j)) < RMSE_BAR
