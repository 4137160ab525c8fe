"""The traversal work counter (ops.intersect.traversal_work) and the bounds
built on it: the per-ray box and triangle tests, held against a plain walk
over the whole table, and the frame-level sums against the live ray
count."""

import numpy as np
import pytest
import torch

from refraction_tpu_torch import bounds
from refraction_tpu_torch.camera import orbit_camera
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.io.primitives import make_gradient_envmap, make_icosphere
from refraction_tpu_torch.kernels.intersect import closest_hit_plain
from refraction_tpu_torch.ops.intersect import traversal_work
from refraction_tpu_torch.render import count_live_rays, frame_traversal_work
from refraction_tpu_torch.scene import SUPER_CLUSTERS, build_scene, scene_from_jax

torch.set_num_threads(1)


def _scene(subdiv, cs):
    return scene_from_jax(build_scene(make_icosphere(subdiv, 1.2),
                                      make_gradient_envmap(16, 32), cs)[0], "cpu")


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [0, 1, 0]]  # axis-parallel
    cull = rng.choice(np.float32([1.0, -1.0, 0.0]), n)
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(cull)


def _overlap(box, o, d, tmin, tmax):
    """The traversal's slab test, written out per ray in float32."""
    with np.errstate(divide="ignore"):
        mag = np.maximum(np.abs(d), np.float32(1e-30))
        inv = np.where(d < 0, -np.float32(1) / mag, np.float32(1) / mag)
    a, b = (box[:3] - o) * inv, (box[3:] - o) * inv
    enter = max(np.minimum(a, b).max(), np.float32(tmin))
    leave = min(np.maximum(a, b).min(), np.float32(tmax))
    return enter <= leave


def _table_walk(scene, o, d, tmin, t_hit, cull):
    """Per ray: every box of the table on [tmin, t_hit], level by level."""
    root, sup, cl, sb = (x.numpy() for x in (
        scene.root_bounds, scene.super_bounds, scene.cluster_bounds,
        scene.sub_bounds))
    spc = scene.cluster_size // scene.sub_tris
    out = np.zeros((o.shape[0], 5), np.int64)

    def inside(ov, parents, n_child):
        return [c for p in parents if ov(p[1])
                for c in range(p[0] * SUPER_CLUSTERS,
                               min((p[0] + 1) * SUPER_CLUSTERS, n_child))]

    for i in range(o.shape[0]):
        if cull[i] == 0:
            continue
        ov = lambda box: _overlap(box, o[i], d[i], tmin, t_hit[i])  # noqa: E731
        if len(root):
            out[i, 0] = len(root)
            supers = inside(ov, enumerate(root), len(sup))
        else:
            supers = list(range(len(sup)))
        if len(sup):
            out[i, 1] = len(supers)
            cands = inside(ov, ((s, sup[s]) for s in supers), len(cl))
        else:
            cands = list(range(len(cl)))
        out[i, 2] = len(cands)
        for c in (c for c in cands if ov(cl[c])):
            out[i, 3] += spc
            out[i, 4] += scene.sub_tris * sum(
                ov(sb[s]) for s in range(c * spc, (c + 1) * spc))
    return out


@pytest.mark.parametrize("subdiv,cs", [(2, 32), (2, 8), (3, 8), (5, 8)],
                         ids=["flat", "supers", "supers-5", "roots"])
def test_counts_equal_the_full_table_walk(subdiv, cs):
    scene = _scene(subdiv, cs)
    assert (scene.num_supers > 0) == (cs == 8)
    assert scene.num_roots == (3 if subdiv == 5 else 0)
    o, d, cull = _rays(96, subdiv)
    t_hit = torch.full((96,), float("inf"))
    got = traversal_work(scene, o, d, 1e-3, t_hit, cull)
    want = _table_walk(scene, o.numpy(), d.numpy(), 1e-3, t_hit.numpy(),
                       cull.numpy())
    keys = ("root_tests", "super_tests", "cluster_tests", "sub_tests",
            "mt_tests")
    np.testing.assert_array_equal(np.stack([got[k].numpy() for k in keys], 1),
                                  want)
    assert int(got["mt_tests"].sum()) > 0
    if scene.num_roots:  # a ray tests only the supers of the roots it crosses
        live = int((cull != 0).sum())
        assert 0 < int(got["super_tests"].sum()) < live * scene.num_supers


@pytest.mark.parametrize("cs", [32, 8])
def test_a_ray_that_hits_tests_its_triangle(cs):
    scene = _scene(2, cs)
    o, d, cull = _rays(512, 7)
    t, idx, _ = closest_hit_plain(scene, o, d, cull, 1e-4, 100.0)
    hit = idx >= 0
    assert int(hit.sum()) > 20
    t_hit = torch.where(hit, t, torch.full_like(t, 100.0))
    work = traversal_work(scene, o, d, 1e-4, t_hit, cull)
    assert bool((work["mt_tests"][hit] >= 1).all())
    # Stopping at the hit never needs more than the open-ended walk.
    full = traversal_work(scene, o, d, 1e-4, torch.full_like(t, float("inf")),
                          cull)
    for k in work:
        assert bool((work[k] <= full[k]).all()), k
    assert bool((work["mt_tests"][cull == 0] == 0).all())


def test_frame_work_counts_every_live_ray_and_bounds_it():
    scene = _scene(2, 8)
    cfg = RenderConfig(width=12, height=9, spp=2)
    frame = orbit_camera(0.3, cfg)
    levels = frame_traversal_work(scene, cfg, frame, "cpu")
    assert len(levels) == cfg.max_refract_depth + 1
    assert sum(lv["rays"] for lv in levels) == count_live_rays(
        scene, cfg, frame, "cpu")
    assert levels[0]["rays"] == cfg.width * cfg.height * cfg.spp
    b = bounds.frame_bound(scene, cfg, levels)
    assert b["ops"] == bounds.traversal_ops(b["work"]) > 0
    assert b["bound_ms"] == max(b["ops_ms"], b["bytes_ms"])
    assert b["bound_by"] in ("operations", "bytes")
    r = bounds.round_bound(scene, cfg.replace(spp=1), levels)
    assert r["bytes"] > b["bytes"]


def test_bound_picks_the_larger_side():
    assert bounds.bound(67e9, 0)["bound_by"] == "operations"
    b = bounds.bound(1.0, 3.35e9)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(1.0)
    assert bounds.bound(67e9, 0)["bound_ms"] == pytest.approx(1.0)
