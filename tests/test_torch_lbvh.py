"""refraction_tpu_torch.bvh.lbvh (the LBVH traversal oracle) vs the JAX
package's `refraction_tpu.bvh.lbvh` and vs the port's brute force.

Tolerances: the build is held bit for bit (the same float32 steps, a
stable sort of the same codes). Traversal: XLA:CPU contracts the
triangle test's dot products into FMAs and the port rounds twice, so t is
held to atol 1e-5 and the winner to 99.9% of the hits (a winner can
differ only where two triangles are within that rounding of each other);
hit or miss must agree on every ray. The planted equal-t case is held
exactly: both walk the tree in the same order. Image bar from
tests/test_golden.py: RMSE < 1e-4 and max abs error < 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import rmse
from refraction_tpu.bvh import lbvh as jax_lbvh
from refraction_tpu.bvh.morton import morton3d_jnp
from refraction_tpu.io.primitives import (
    make_cube,
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu.scene import build_scene
from refraction_tpu_torch.bvh.lbvh import (
    LBVH,
    build_lbvh,
    lbvh_from_scene,
    lbvh_intersect,
    make_lbvh_backend,
)
from refraction_tpu_torch.bvh.morton import morton3d_torch
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.ops.backends import torch_intersect
from refraction_tpu_torch.render import make_renderer
from refraction_tpu_torch.integrator import render_image
from refraction_tpu_torch.kernels.envmap import env_contribution_plain
from refraction_tpu_torch.render import sample_offsets
from refraction_tpu_torch.scene import scene_from_jax

torch.set_num_threads(1)

T_ATOL, IDX_AGREE = 1e-5, 0.999
RMSE_BAR, MAX_BAR = 1e-4, 1e-3  # tests/test_golden.py
TMIN, TMAX = 1e-4, 100.0


@pytest.fixture(scope="module")
def scenes():
    """cube (cluster 8, 16 tris), icosphere 2 (cluster 32, 320 tris) and
    icosphere 3 at cluster 24 (1,296 tris: not a power of two, with the
    scene's own zero-area pad triangles)."""
    env = make_gradient_envmap()
    return {"cube": build_scene(make_cube(2.0), env, cluster_size=8)[0],
            "sphere": build_scene(make_icosphere(subdiv=2, radius=1.2), env,
                                  cluster_size=32)[0],
            "ico3_cs24": build_scene(make_icosphere(subdiv=3, radius=1.2),
                                     env, cluster_size=24)[0]}


SCENES = ["cube", "sphere", "ico3_cs24"]


def _rays(n, seed, spread=3.0):
    """tests/test_lbvh.py's rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    wf = rng.random(n) < 0.5
    return o, d, wf


def _jax_intersect(scene, o, d, wf):
    bvh = jax_lbvh.lbvh_from_scene(scene)
    res = jax.jit(lambda oo, dd, ww: jax_lbvh.lbvh_intersect(
        bvh, oo, dd, ww, jnp.float32(TMIN), jnp.float32(TMAX)))(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(wf))
    return tuple(np.asarray(x) for x in res)


def _torch_intersect(scene, o, d, wf):
    bvh = lbvh_from_scene(scene_from_jax(scene, "cpu"))
    res = lbvh_intersect(bvh, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(wf), TMIN, TMAX)
    return tuple(x.numpy() for x in res)


def test_morton_codes_equal_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 3, (4096, 3)).astype(np.float32)
    pts[:8] = [[-2, -2, -2], [3, 3, 3], [-2, 3, -2], [0, 0, 0],
               [3, -2, 3], [0.5, 0.5, 0.5], [-2, -2, 3], [3, 3, -2]]
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    ref = np.asarray(morton3d_jnp(jnp.asarray(pts), jnp.asarray(lo),
                                  jnp.asarray(hi), jnp))
    got = morton3d_torch(torch.from_numpy(pts), torch.from_numpy(lo),
                         torch.from_numpy(hi)).numpy()
    assert got.dtype == np.int64 and got.max() < 2 ** 30
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("name", SCENES)
def test_build_is_bit_equal_to_jax(scenes, name):
    scene = scenes[name]
    ref = jax_lbvh.lbvh_from_scene(scene)
    got = lbvh_from_scene(scene_from_jax(scene, "cpu"))
    assert got.num_leaves == ref.num_leaves and got.depth == ref.depth
    assert got.num_leaves & (got.num_leaves - 1) == 0
    for field in LBVH._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)


@pytest.mark.parametrize("name", SCENES)
def test_intersect_matches_jax_lbvh(scenes, name):
    o, d, wf = _rays(600, seed=3)
    h1, t1, i1 = _jax_intersect(scenes[name], o, d, wf)
    h2, t2, i2 = _torch_intersect(scenes[name], o, d, wf)
    assert h1.sum() > 0
    assert (h1 == h2).all()
    np.testing.assert_allclose(t2[h1], t1[h1], rtol=0, atol=T_ATOL)
    assert (i1[h1] == i2[h1]).mean() >= IDX_AGREE


@pytest.mark.parametrize("name", SCENES)
def test_intersect_matches_brute_force(scenes, name):
    o, d, wf = _rays(600, seed=3)
    ts = scene_from_jax(scenes[name], "cpu")
    h1, t1, i1, _ = torch_intersect(
        ts, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(wf),
        torch.ones(600, dtype=torch.bool), TMIN, TMAX)
    h1, t1, i1 = h1.numpy(), t1.numpy(), i1.numpy()
    h2, t2, i2 = _torch_intersect(scenes[name], o, d, wf)
    assert h1.sum() > 0
    assert (h1 == h2).all()
    np.testing.assert_allclose(t2[h1], t1[h1], rtol=0, atol=T_ATOL)
    assert (i1[h1] == i2[h1]).mean() >= IDX_AGREE


def test_equal_t_winner_is_the_jax_loops():
    """Two copies of one triangle: equal t on every ray through it. The
    JAX loop keeps the lowest *sorted* index; the port walks the same
    order, so its winner is the JAX one on every ray."""
    a = np.float32([[-1, -1, 0], [-1, -1, 0], [2, 2, 2], [-3, 1, 1],
                    [0.5, -2, -1]])
    e1 = np.float32([[2, 0, 0], [2, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    e2 = np.float32([[0, 2, 0], [0, 2, 0], [0, 1, 0], [0, 0, 1], [1, 0, 0]])
    rng = np.random.default_rng(5)
    n = 64
    xy = rng.uniform(-0.9, 0.9, (n, 2))
    xy = np.where(xy.sum(axis=1, keepdims=True) > -0.1, -xy[:, ::-1] - 0.1,
                  xy)  # inside the triangle: x + y <= -0.1
    o = np.concatenate([xy, np.full((n, 1), -2.0)], axis=1).astype(np.float32)
    d = np.tile(np.float32([[0, 0, 1]]), (n, 1))
    wf = np.zeros(n, bool)  # the copies face away from +z: det < 0
    ref_bvh = jax_lbvh.build_lbvh(jnp.asarray(a), jnp.asarray(e1),
                                  jnp.asarray(e2))
    ref = [np.asarray(x) for x in jax_lbvh.lbvh_intersect(
        ref_bvh, jnp.asarray(o), jnp.asarray(d), jnp.asarray(wf),
        jnp.float32(TMIN), jnp.float32(TMAX))]
    bvh = build_lbvh(torch.from_numpy(a), torch.from_numpy(e1),
                     torch.from_numpy(e2))
    got = [x.numpy() for x in lbvh_intersect(
        bvh, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(wf),
        TMIN, TMAX)]
    assert ref[0].all() and got[0].all()
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    assert set(got[2]) <= {0, 1}


def test_tree_structure(scenes):
    """tests/test_lbvh.py:45-58: every inner node's box holds its
    children's (inverted, empty, child boxes are held trivially)."""
    bvh = lbvh_from_scene(scene_from_jax(scenes["sphere"], "cpu"))
    leaves = bvh.num_leaves
    assert leaves & (leaves - 1) == 0
    assert bvh.node_lo.shape == (2 * leaves - 1, 3)
    lo, hi = bvh.node_lo.numpy(), bvh.node_hi.numpy()
    for node in range(leaves - 1):
        for child in (2 * node + 1, 2 * node + 2):
            if (lo[child] <= hi[child]).all():
                assert (lo[node] <= lo[child] + 1e-6).all()
                assert (hi[node] >= hi[child] - 1e-6).all()


def test_degenerate_padding_never_hits():
    """tests/test_lbvh.py:74-: an all-degenerate tree (5 triangles padded
    to 8 leaves) is never hit."""
    tri_a = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (5, 3)).astype(np.float32))
    zeros = torch.zeros(5, 3)
    bvh = build_lbvh(tri_a, zeros, zeros)
    assert bvh.num_leaves == 8
    o = torch.zeros(8, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(8, 1)
    hit, t, _ = lbvh_intersect(bvh, o, d, torch.ones(8, dtype=torch.bool),
                               TMIN, TMAX)
    assert not hit.any() and bool((t == np.float32(3e38)).all())


def test_pad_boxes_are_entered_but_never_hit():
    """The slab test is symmetric in lo and hi, so a pad leaf's inverted
    box [3e38, -3e38] is entered by every ray (the JAX build's comment says
    the opposite, lbvh.py:90-91); its zero-edge triangle keeps it from
    being hit. As in the JAX loop, the traversal walks such subtrees."""
    from refraction_tpu_torch.ops.intersect import _safe_inv, _slab

    tri_a = torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.0, 2.0, 0.0]])
    e1 = torch.tensor([[1.0, 0.0, 0.0]]).repeat(3, 1)
    e2 = torch.tensor([[0.0, 1.0, 0.0]]).repeat(3, 1)
    bvh = build_lbvh(tri_a, e1, e2)  # 3 triangles, 4 leaves: one pad
    assert bvh.num_leaves == 4
    pad_node = 2 * bvh.num_leaves - 2  # the last leaf
    box = torch.cat([bvh.node_lo[pad_node], bvh.node_hi[pad_node]]).repeat(
        4, 1)
    assert (box[:, :3] > box[:, 3:]).all()  # inverted
    o = torch.tensor([[5.0, 5.0, 5.0], [0.0, 0.0, -1.0], [-3.0, 2.0, 1.0],
                      [1e3, -1e3, 0.0]])
    d = torch.nn.functional.normalize(torch.tensor(
        [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.3, -0.2, 0.9], [0.0, 1.0, 0.0]]),
        dim=1)
    entered = _slab(box, o, _safe_inv(d), torch.full((4,), 1e-4),
                    torch.full((4,), 100.0))
    assert entered.all()
    # A ray away from the real triangles: the pad leaf is entered, not hit.
    hit, _, _ = lbvh_intersect(bvh, o[:1], d[:1], torch.ones(1, dtype=bool),
                               TMIN, TMAX)
    assert not hit.any()


def test_backend_renders_like_the_brute_force(scenes):
    """A 64x48 frame of the eager integrator over the LBVH backend against
    the `torch` backend (the brute force)."""
    scene = scene_from_jax(scenes["sphere"], "cpu")
    cfg = RenderConfig(width=64, height=48)
    frame = orbit_camera(0.6, cfg)
    ref = make_renderer(cfg, "torch", "cpu")(scene, frame).numpy()
    got = render_image(scene, frame, cfg, sample_offsets(1), "cpu",
                       make_lbvh_backend(scene),
                       env_contribution_plain).numpy()
    assert got.shape == (48, 64, 3) and ref.max() > 0
    assert rmse(got, ref) < RMSE_BAR
    assert np.abs(got - ref).max() < MAX_BAR


def test_backend_refuses_a_ray_mask(scenes):
    scene = scene_from_jax(scenes["cube"], "cpu")
    fn = make_lbvh_backend(scene)
    with pytest.raises(ValueError, match="0xff"):
        fn(scene, torch.zeros(2, 3), torch.ones(2, 3), torch.ones(2, dtype=bool),
           torch.ones(2, dtype=bool), TMIN, TMAX,
           ray_mask=torch.ones(2, dtype=torch.int32))
