"""refraction_tpu_torch math ops vs their JAX counterparts, on seeded inputs.

Shading, brute-force intersection and raygen run through the JAX
functions (``xp=jnp``) and their PyTorch ports; the closest-hit and env
kernel modules' CPU paths run against the Pallas kernels in interpret
mode, as the JAX package's own tests run them on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refraction_tpu.camera import generate_rays as jax_generate_rays
from refraction_tpu.camera import orbit_camera
from refraction_tpu.config import RenderConfig
from refraction_tpu.io.primitives import make_gradient_envmap
from refraction_tpu.kernels.envmap_pallas import pallas_env_contribution
from refraction_tpu.kernels.intersect_pallas import pallas_intersect
from refraction_tpu.ops import intersect as jax_intersect
from refraction_tpu.ops import shade as jax_shade
from refraction_tpu.render import sample_offsets as jax_sample_offsets
from refraction_tpu_torch.camera import generate_rays
from refraction_tpu_torch.kernels.envmap import env_contribution
from refraction_tpu_torch.kernels.intersect import closest_hit, cull_code
from refraction_tpu_torch.ops import intersect, shade
from refraction_tpu_torch.render import sample_offsets
from refraction_tpu_torch.scene import scene_from_jax

torch.set_num_threads(1)

RTOL = 1e-6          # float32 twins computed with the same formulas
DIR_ATOL = 1e-6      # unit vectors: RTOL of their length (XLA may round a
                     # small component one ulp of the larger ones apart)
ENV_AGREE = 0.9999   # libm atan2/acos may pick a neighbouring texel


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _random_rays(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = _unit(rng, n)
    wf = rng.random(n) < 0.5
    al = rng.random(n) < 0.8
    return o, d, wf, al


def test_shade_twins():
    rng = np.random.default_rng(0)
    n = 4096
    i, nrm = _unit(rng, n), _unit(rng, n)
    eta = np.where(rng.random(n) < 0.5, np.float32(1 / 1.3),
                   np.float32(1.3)).astype(np.float32)
    r0 = np.float32(RenderConfig().fresnel_r0)

    refl_t = shade.reflect_dir(_t(i), _t(nrm)).numpy()
    refl_j = np.asarray(jax_shade.reflect_dir(jnp.asarray(i), jnp.asarray(nrm), jnp))
    np.testing.assert_allclose(refl_t, refl_j, rtol=RTOL, atol=DIR_ATOL)

    ok_t, rd_t = shade.refract_dir(_t(i), _t(nrm), _t(eta))
    ok_j, rd_j = jax_shade.refract_dir(jnp.asarray(i), jnp.asarray(nrm),
                                       jnp.asarray(eta), jnp)
    ok_j = np.asarray(ok_j)
    assert (ok_t.numpy() == ok_j).all()
    assert 0 < ok_j.sum() < n  # both TIR and refraction occur
    np.testing.assert_allclose(rd_t.numpy()[ok_j], np.asarray(rd_j)[ok_j],
                               rtol=RTOL, atol=DIR_ATOL)

    cos = np.sum(i * nrm, axis=1).astype(np.float32)
    np.testing.assert_allclose(
        shade.fresnel_r(_t(cos), r0).numpy(),
        np.asarray(jax_shade.fresnel_r(jnp.asarray(cos), r0)), rtol=RTOL)
    np.testing.assert_allclose(
        shade.normalize(_t(i * 3.0)).numpy(),
        np.asarray(jax_shade.normalize(jnp.asarray(i * 3.0), jnp)), rtol=RTOL)


def test_envmap_texels_twin():
    rng = np.random.default_rng(1)
    env = make_gradient_envmap(64, 128)  # every texel distinct
    d = _unit(rng, 100_000)
    got = shade.envmap_color(_t(d), _t(env)).numpy()
    ref = np.asarray(jax_shade.envmap_color(jnp.asarray(d), jnp.asarray(env), jnp))
    same = (got == ref).all(axis=1)
    assert same.mean() >= ENV_AGREE, same.mean()


@pytest.mark.parametrize("scene_fixture", ["cube_scene", "sphere_scene"])
def test_intersect_twin(scene_fixture, request):
    scene, _ = request.getfixturevalue(scene_fixture)
    o, d, wf, _ = _random_rays(3000, seed=2)
    tmin, tmax = np.float32(1e-4), np.float32(100.0)
    h_t, t_t, i_t = intersect.intersect_closest(
        _t(o), _t(d), _t(scene.tri_a), _t(scene.tri_e1), _t(scene.tri_e2),
        1e-4, 100.0, _t(wf))
    h_j, t_j, i_j = map(np.asarray, jax_intersect.intersect_closest(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(scene.tri_a),
        jnp.asarray(scene.tri_e1), jnp.asarray(scene.tri_e2), tmin, tmax,
        jnp.asarray(wf), jnp))
    h_t, t_t, i_t = h_t.numpy(), t_t.numpy(), i_t.numpy()
    assert (h_t == h_j).all() and h_j.sum() > 100
    assert (i_t[h_j] == i_j[h_j]).all()
    np.testing.assert_allclose(t_t[h_j], t_j[h_j], rtol=RTOL)

    u_t, v_t = intersect.recompute_uv(
        _t(o[h_j]), _t(d[h_j]), _t(scene.tri_a), _t(scene.tri_e1),
        _t(scene.tri_e2), _t(i_j[h_j]))
    u_j, v_j = jax_intersect.recompute_uv(
        jnp.asarray(o[h_j]), jnp.asarray(d[h_j]), jnp.asarray(scene.tri_a),
        jnp.asarray(scene.tri_e1), jnp.asarray(scene.tri_e2),
        jnp.asarray(i_j[h_j]), jnp)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("jittered", [False, True])
def test_raygen_twin(jittered):
    cfg = RenderConfig(width=40, height=30)
    frame = orbit_camera(0.7, cfg)
    jitter = None
    if jittered:
        jitter = np.random.default_rng(3).random((40 * 30, 2)).astype(np.float32)
    o_t, d_t = generate_rays(frame, 40, 30, "cpu", jitter=jitter)
    o_j, d_j = jax_generate_rays(frame, 40, 30, jitter=None if jitter is None
                                 else jnp.asarray(jitter), xp=jnp)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=RTOL,
                               atol=DIR_ATOL)


@pytest.mark.parametrize("spp", list(range(1, 10)))
def test_sample_offsets_copy(spp):
    np.testing.assert_array_equal(sample_offsets(spp), jax_sample_offsets(spp))


@pytest.mark.parametrize("scene_fixture", ["cube_scene", "sphere_scene"])
def test_closest_hit_module_vs_pallas(scene_fixture, request):
    """kernels/intersect.py's CPU path vs the Pallas closest-hit kernel."""
    scene, _ = request.getfixturevalue(scene_fixture)
    ts = scene_from_jax(scene, "cpu")
    o, d, wf, al = _random_rays(1500, seed=4)
    t_t, i_t, n_t = closest_hit(ts, _t(o), _t(d), cull_code(_t(wf), _t(al)),
                                1e-4, 100.0)
    h_p, t_p, i_p, n_p = map(np.asarray, pallas_intersect(
        scene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(wf),
        jnp.asarray(al), jnp.float32(1e-4), jnp.float32(100.0),
        interpret=True))
    h_t = i_t.numpy() >= 0
    assert (h_t == h_p).all() and h_p.sum() > 50
    assert not h_t[~al].any()
    assert (i_t.numpy()[h_p] == i_p[h_p]).all()
    np.testing.assert_allclose(t_t.numpy()[h_p], t_p[h_p], rtol=RTOL)
    np.testing.assert_allclose(n_t.numpy()[h_p], n_p[h_p], rtol=1e-5, atol=1e-6)


def test_env_module_vs_pallas(sphere_scene):
    """kernels/envmap.py's CPU path vs the Pallas env kernel, whose
    polynomial atan2/acos may pick a neighbouring texel (the JAX package's
    own bar for it, tests/test_fastmath.py, is 99.9%)."""
    scene, _ = sphere_scene
    ts = scene_from_jax(scene, "cpu")
    rng = np.random.default_rng(5)
    n = 3000
    d = _unit(rng, n)
    w = np.where(rng.random(n) < 0.7, rng.random(n), 0.0).astype(np.float32)
    got = env_contribution(ts, _t(d), _t(w)).numpy()
    ref = np.asarray(pallas_env_contribution(
        scene, jnp.asarray(d), jnp.asarray(w), interpret=True))
    same = np.isclose(got, ref, atol=1e-6).all(axis=1)
    assert same.mean() > 0.999, same.mean()
    assert (got[w == 0] == 0).all()
