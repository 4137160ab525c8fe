"""The frame kernel's group walk (csrc/traverse_group.cuh) on the CPU: its
plain twin in kernels/framekernel.py against the sequential pair compare
and the JAX brute force.

The kernel runs only on the card; what runs here is the twin of its
reduction: `order_key` (the float's key, whose unsigned order is the float
order) and `group_pair_min` (a sub's least (t, index) over a group's
lanes, lane j holding triangles j, j + G, ...). Walked sub after sub with
the kernel's pair compare against the running best, it must give the
winner of the one-thread walk's compare of one triangle after the other
and of ``refraction_tpu.ops.intersect.intersect_closest`` (an argmin: ties
go to the lowest index), on the same Möller–Trumbore values, exactly
(no tolerance). Equal-t duplicates are planted: copies of triangles later
in the table, in the same sub on other lanes and (for G = 4) on the same
lane, so the lower index must win.
"""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from refraction_tpu.ops.intersect import _cross, intersect_closest
from refraction_tpu_torch import RenderConfig
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.io.primitives import (
    make_cube, make_gradient_envmap, make_icosphere)
from refraction_tpu_torch.kernels import _build
from refraction_tpu_torch.kernels.framekernel import (
    FORM_LANES, GROUP, MAX_STACK, NO_KEY, TILE, build_scalars, frame_tiles,
    frame_tiles_group, fused_radiance, fused_radiance_group, group_pair_min,
    order_key)
from refraction_tpu_torch.render import sample_offsets
from refraction_tpu_torch.scene import build_scene, scene_from_jax

torch.set_num_threads(1)

SUB = 8  # triangles a sub (scene.SUB_TRIS)
TMIN, TMAX = np.float32(1e-4), np.float32(100.0)
F32 = st.floats(width=32, allow_nan=False, allow_subnormal=True)
NONNEG = st.floats(min_value=0.0, width=32, allow_nan=False,
                   allow_subnormal=True)


def _key(x: float) -> int:
    return int(order_key(torch.tensor([x], dtype=torch.float32))[0])


@settings(max_examples=300, deadline=None, database=None)
@given(NONNEG, NONNEG)
@example(0.0, 1e-45)
@example(1e-45, 1.1754942e-38)
@example(3.4028235e38, float("inf"))
@example(0.0, -0.0)
def test_order_key_keeps_the_order_of_non_negative_floats(a, b):
    a, b = float(np.float32(a)), float(np.float32(b))
    assert (a <= b) == (_key(a) <= _key(b))
    assert (a == b) == (_key(a) == _key(b))
    assert _key(a) < NO_KEY


@settings(max_examples=300, deadline=None, database=None)
@given(F32, F32)
@example(-0.0, 0.0)
@example(float("-inf"), -3.4028235e38)
@example(-1e-45, 1e-45)
def test_order_key_keeps_the_order_of_every_float_but_nan(a, b):
    a, b = float(np.float32(a)), float(np.float32(b))
    assert (a <= b) == (_key(a) <= _key(b))
    assert (a == b) == (_key(a) == _key(b))


@pytest.mark.parametrize("g", [8, 4])
def test_group_pair_min_takes_the_lowest_index_of_the_least_t(g):
    """Hand-made subs: equal t on two lanes, on one lane (G = 4), -0 and
    +0 (equal), a miss beside them; and a sub with no hit."""
    inf = float("inf")
    t = torch.tensor([[3.0, 2.0, 5.0, 2.0, 9.0, 2.0, 7.0, 2.0],
                      [1.0, -0.0, 0.0, 4.0, 0.0, 8.0, -0.0, 6.0],
                      [inf, 5.0, 5.0, inf, 4.0, 4.0, 3.0, 3.0],
                      [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]])
    hit = torch.tensor([[1, 1, 1, 1, 1, 1, 1, 1],
                        [0, 1, 1, 1, 1, 1, 1, 1],
                        [1, 0, 1, 1, 1, 1, 0, 1],
                        [0, 0, 0, 0, 0, 0, 0, 0]], dtype=torch.bool)
    found, t_w, idx = group_pair_min(t, hit, 16, g)
    assert found.tolist() == [True, True, True, False]
    assert idx[:3].tolist() == [17, 17, 23]
    assert t_w[:3].tolist() == [2.0, 0.0, 3.0]
    assert str(float(t_w[1])) == "-0.0"  # the winning lane's own t


def _triangles(name: str, rng):
    """(T, 3, 3) corners: the mesh, padded to whole subs with copies of
    picked triangles, then two subs of copies, each [p0 p1 p2 p3 p0 p1 p2
    p3] (a copy on lane j + 4: another lane at G = 8, the same lane at
    G = 4); the picked indices; the mesh's triangle count."""
    mesh = make_cube(2.0) if name == "cube" else make_icosphere(2, 1.2)
    pos = mesh.positions.astype(np.float32)
    pick = rng.permutation(len(pos))[:8]
    dup = np.concatenate([pick[:4], pick[:4], pick[4:], pick[4:]])
    pad = (-len(pos)) % SUB
    tris = np.concatenate([pos, pos[pick[:pad]], pos[dup]])
    return tris, pick, len(pos)


def _rays(tris: np.ndarray, pick, n: int, rng):
    """Half the rays aimed at a point inside a picked triangle (so its
    duplicates tie), half at random points near the mesh; random sides."""
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o *= np.float32(4.0) / np.linalg.norm(o, axis=1, keepdims=True)
    w = rng.dirichlet(np.ones(3), n).astype(np.float32)
    at = tris[rng.choice(pick, n)]
    target = np.einsum("nk,nkc->nc", w, at).astype(np.float32)
    half = n // 2
    target[half:] = rng.uniform(-1.5, 1.5, (n - half, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    front = rng.random(n) < 0.75
    return o, d.astype(np.float32), front


def _pair_values(o, d, a, e1, e2, front):
    """Möller–Trumbore of every (ray, triangle) pair with the JAX brute
    force's float32 operations: t and whether the pair passes every test
    but the tmax bound (which the running best's start enforces)."""
    dd = d[:, None, :]
    pvec = _cross(dd, e2[None], np)
    det = np.sum(e1[None] * pvec, axis=-1)
    accept = np.where(front[:, None], det > 0, det < 0)
    inv_det = np.float32(1.0) / np.where(det == 0, np.float32(1.0), det)
    tvec = o[:, None, :] - a[None]
    u = np.sum(tvec * pvec, axis=-1) * inv_det
    qvec = _cross(tvec, e1[None], np)
    v = np.sum(dd * qvec, axis=-1) * inv_det
    t = np.sum(e2[None] * qvec, axis=-1) * inv_det
    hit = (accept & (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
           & (t >= TMIN))
    return t, hit


def _group_walk(t, hit, g):
    """Sub after sub: the group's pair minimum, then the kernel's pair
    compare against the running best (best_t from the float after tmax)."""
    n = t.shape[0]
    best_t = torch.full((n,), float(np.nextafter(TMAX, np.inf)))
    best_i = torch.full((n,), -1, dtype=torch.int64)
    for first in range(0, t.shape[1], SUB):
        found, tc, ic = group_pair_min(t[:, first:first + SUB],
                                       hit[:, first:first + SUB], first, g)
        take = found & ((tc < best_t) | ((tc == best_t) & (ic < best_i)))
        best_t = torch.where(take, tc, best_t)
        best_i = torch.where(take, ic, best_i)
    return best_t, best_i


def _sequential(t, hit):
    """The one-thread walk's compare, one triangle after the other."""
    n = t.shape[0]
    best_t = np.full(n, np.nextafter(TMAX, np.inf), np.float32)
    best_i = np.full(n, -1, np.int64)
    for k in range(t.shape[1]):
        take = hit[:, k] & ((t[:, k] < best_t)
                            | ((t[:, k] == best_t) & (k < best_i)))
        best_t = np.where(take, t[:, k], best_t)
        best_i = np.where(take, k, best_i)
    return best_t, best_i


@pytest.mark.parametrize("g", [8, 4])
@pytest.mark.parametrize("name", ["cube", "icosphere"])
def test_group_walk_twin_equals_sequential_compare_and_jax(name, g):
    rng = np.random.default_rng(12)
    tris, pick, n_mesh = _triangles(name, rng)
    a = tris[:, 0]
    e1 = (tris[:, 1] - tris[:, 0]).astype(np.float32)
    e2 = (tris[:, 2] - tris[:, 0]).astype(np.float32)
    o, d, front = _rays(tris, pick, 512, rng)
    t, hit = _pair_values(o, d, a, e1, e2, front)

    gt, gi = _group_walk(torch.from_numpy(t), torch.from_numpy(hit), g)
    st_, si = _sequential(t, hit)
    jhit, jt, ji = intersect_closest(o, d, a, e1, e2, TMIN, TMAX, front, np)

    g_hit = (gi >= 0).numpy()
    np.testing.assert_array_equal(gi.numpy(), si)
    np.testing.assert_array_equal(gt.numpy()[g_hit], st_[g_hit])
    np.testing.assert_array_equal(g_hit, jhit)
    np.testing.assert_array_equal(gi.numpy()[g_hit], ji[jhit])
    np.testing.assert_array_equal(gt.numpy()[g_hit], jt[jhit])
    # The planted ties are exercised: winners with an equal-t copy of
    # higher index further down the table, and no copy ever wins.
    assert int(np.isin(gi.numpy(), pick).sum()) >= 50
    assert not bool((gi.numpy() >= n_mesh).any())


def test_group_forms_take_the_plain_version_on_cpu():
    """On CPU tensors the group form's wrappers are the plain versions: the
    image of fused_radiance and the buffer of frame_tiles, no launch
    counted; lanes other than 4 and 8 are refused."""
    scene = scene_from_jax(build_scene(make_icosphere(1, 1.2),
                                       make_gradient_envmap(16, 32), 8)[0],
                           "cpu")
    cfg = RenderConfig(width=40, height=8, max_refract_depth=3)
    scal = build_scalars(orbit_camera(0.3, cfg), cfg, sample_offsets(1),
                         "cpu")
    counts = (fused_radiance_group.launches, frame_tiles_group.launches)
    want = fused_radiance(scene, scal, cfg)
    want_tiles = frame_tiles(scene, scal, cfg, 2, 1, 1, 2)
    for lanes in (8, 4):
        assert torch.equal(fused_radiance_group(scene, scal, cfg, lanes),
                           want)
        assert torch.equal(frame_tiles_group(scene, scal, cfg, 2, 1, 1, 2,
                                             lanes), want_tiles)
    assert (fused_radiance_group.launches,
            frame_tiles_group.launches) == counts
    with pytest.raises(ValueError, match="lanes"):
        fused_radiance_group(scene, scal, cfg, 3)
    with pytest.raises(ValueError, match="lanes"):
        frame_tiles_group(scene, scal, cfg, 2, 1, 1, 2, 16)


def test_constants_and_entries_match_the_cuda_source():
    """MAX_STACK and TILE are frame.cu's RT_MAX_STACK and RT_TILE, the
    form table names the lanes frame.cu instantiates, and every frame
    entry the wrappers call is declared with as many arguments as
    _build.SIGNATURES gives it."""
    src = open(os.path.join(_build.CSRC, "frame.cu")).read()
    defs = dict(re.findall(r"#define (RT_\w+) (\d+)", src))
    assert (int(defs["RT_MAX_STACK"]), int(defs["RT_TILE"])) == (MAX_STACK,
                                                                 TILE)
    assert FORM_LANES == {"thread": 1, "group8": GROUP, "group4": 4}
    for g in (4, 8):
        assert f"rt_group_launch<{g}>" in src
    params = re.search(r"#define RT_FRAME_PARAMS(.*?)\n#define", src,
                       re.S).group(1)
    n_frame = params.count(",") + 1
    for entry, lead, extra in (("rt_frame", "", 1), ("rt_frame_tiles", "", 5),
                               ("rt_frame_group", "int lanes, ", 2),
                               ("rt_frame_tiles_group", "int lanes, ", 6)):
        assert re.search(rf'extern "C" int {entry}\({lead}RT_FRAME_PARAMS',
                         src), entry
        assert len(_build.SIGNATURES[entry]) == n_frame + extra, entry
    assert len(_build.SIGNATURES["rt_frame_occupancy"]) == 3
