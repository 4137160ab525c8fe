"""The frame kernel's instance walk (csrc/traverse_f2b.cuh
RT_WALK_INSTANCES) on the card: a two-level scene's instance roots and
boxes over shared BLASes.

- ``instance_hit`` (the walk on a batch of rays) against its eager twin,
  ``instance_hit_plain``: the same (hit, instance, triangle), t and
  normal on every ray, on test scenes (a mirror, an explicit 3x4,
  touching boxes, instances that tie on every hit, a BLAS of 2,560
  clusters) and on the benchmark's ``rtiow_glass`` deployment (484
  instances under 16 instance roots);
- the frame (``fused_radiance`` on the two-level scene, counted under
  ``walks["instances"]``) against the eager integrator over the same
  scene within the GPU tier's image bar, and against the frame of its
  bake, the single-mesh scene every other path renders, which differs
  from it by rounding (GEOMETRY_SHARE);
- the instance's registers and resident warps (``frame_occupancy``)."""

import functools

import numpy as np
import pytest
import torch

from refraction_tpu_torch.camera import generate_rays, orbit_camera
from refraction_tpu_torch.config import RenderConfig
from refraction_tpu_torch.integrator import render_image
from refraction_tpu_torch.io.primitives import (
    make_cube,
    make_gradient_envmap,
    make_icosphere,
)
from refraction_tpu_torch.kernels.framekernel import (
    build_scalars,
    frame_occupancy,
    fused_radiance,
    walk_levels,
)
from refraction_tpu_torch.kernels.intersect import (
    closest_hit,
    cull_code,
    instance_hit,
    instance_hit_plain,
)
from refraction_tpu_torch.ops.backends import (
    cuda_env_contribution,
    cuda_intersect,
    instance_intersect,
)
from refraction_tpu_torch.render import sample_offsets
from refraction_tpu_torch.scene import (
    Instance,
    build_instanced_scene,
    instance_transform,
    scene_from_jax,
)
from rtbench import harness, spec
from test_torch_kernels import PIX_TOL, _img_ok

pytestmark = pytest.mark.cuda

BALL = make_icosphere(2, 0.8)
CUBE = make_cube(1.0)


def _test_scenes():
    twin = instance_transform((0.3, -0.2, 0.1), 0.9, 12.0)
    big = make_icosphere(5, 1.2)
    return {
        "mixed": ([Instance(BALL, instance_transform((-1.0, 0.0, 0.0), 1.0,
                                                     30.0)),
                   Instance(CUBE, instance_transform((1.1, 0.0, 0.0),
                                                     [1.0, 0.5, 2.0], 20.0)),
                   Instance(BALL, np.array([[-0.9, 0, 0, 0.2], [0, 1, 0, 1.4],
                                            [0, 0, 0.7, -0.3]], np.float32)),
                   Instance(CUBE, np.array([[0.5, 0.1, 0, 0],
                                            [0, 0.433, -0.25, -1.3],
                                            [0.05, 0.25, 0.433, 0.4]],
                                           np.float32))], None),
        "touching": ([Instance(BALL, instance_transform((-0.8, 0.0, 0.0))),
                      Instance(BALL, instance_transform((0.8, 0.0, 0.0))),
                      Instance(CUBE, instance_transform((1.5, 0.7, 0.3), 0.5,
                                                        17.0))], None),
        "ties": ([Instance(BALL, twin), Instance(BALL, twin.copy()),
                  Instance(CUBE, instance_transform((-1.6, 0.0, 0.0), 0.5))],
                 None),
        # 2,560 clusters under 80 supers a BLAS: supers in groups of 32.
        "big_blas": ([Instance(big, instance_transform((-1.3, 0, 0), 1.0,
                                                       10.0)),
                      Instance(big, instance_transform((1.3, 0.2, 0), 0.8,
                                                       50.0))], 8),
    }


def _check_walk(ts, o, d, seed):
    g = np.random.default_rng(seed)
    n = o.shape[0]
    for tmin, tmax in ((1e-4, 100.0), (1e-3, 1000.0)):
        cull = torch.tensor(g.choice(np.float32([-1, 0, 1]), n),
                            device=o.device)
        before = instance_hit.launches
        t, key, normal = instance_hit(ts, o, d, cull, tmin, tmax)
        assert instance_hit.launches == before + 1
        t_p, key_p, normal_p = instance_hit_plain(ts, o, d, cull, tmin, tmax)
        hit = key >= 0
        assert int(hit.sum()) > 100
        assert torch.equal(key, key_p)
        assert torch.equal(t[hit], t_p[hit]) and torch.isinf(t[~hit]).all()
        assert torch.equal(normal, normal_p)


def _scene_rays(host, n, seed, dev):
    g = np.random.default_rng(seed)
    lo, hi = host.inst_bounds[:, :3], host.inst_bounds[:, 3:]
    o = np.concatenate([g.uniform(lo.min(0) - 1, hi.max(0) + 1, (n, 3))]
                       + [g.uniform(lo[k], hi[k], (n // 8, 3))
                          for k in range(min(len(lo), 32))])
    d = g.normal(size=o.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("name", sorted(_test_scenes()))
def test_instance_walk_matches_its_twin(cuda, name):
    insts, cs = _test_scenes()[name]
    host, _ = build_instanced_scene(insts, make_gradient_envmap(), cs)
    ts = scene_from_jax(host, cuda)
    o, d = _scene_rays(host, 20000, 1, cuda)
    _check_walk(ts, o, d, 2)
    if name == "ties":
        inst, _ = ts.owners(instance_hit_plain(
            ts, o, d, torch.ones(o.shape[0], device=cuda), 1e-4, 100.0)[1])
        assert int((inst == 1).sum()) == 0 and int((inst == 0).sum()) > 0


@functools.lru_cache(maxsize=1)
def _rtiow(device):
    """The benchmark's rtiow_glass scene, built once for the module."""
    cell = spec.load_cell("rtiow_glass.orbit")
    return harness.Program(cell.config, 2 ** 31 + 505, device)


@pytest.fixture
def rtiow(cuda):
    return _rtiow(cuda)


def test_rtiow_glass_walk_matches_its_twin(cuda, rtiow):
    """The deployment's scene: primary rays of two views and rays from
    inside the instance boxes."""
    ts = rtiow.scene
    lv = walk_levels(ts)
    assert (lv["walk"], lv["instances"], lv["instance_roots"]) == (
        "instances", 484, 16)
    rays = [generate_rays(orbit_camera(a, rtiow.cfg), 240, 135, cuda)
            for a in (0.2, 3.3)]
    o = torch.cat([r[0] for r in rays] + [_scene_rays(ts.host, 8000, 3,
                                                      cuda)[0]])
    d = torch.cat([r[1] for r in rays] + [_scene_rays(ts.host, 8000, 3,
                                                      cuda)[1]])
    _check_walk(ts, o.contiguous(), d.contiguous(), 4)


def _world_tables64(host, dev):
    """Each BLAS's triangles (A, B, C) in float64 as its table holds them
    (A, A + e1, A + e2), on ``dev``."""
    out = []
    for b in host.blas:
        tri = torch.tensor(b.tri_packed, dtype=torch.float64, device=dev)
        a = tri[:, 0:3]
        out.append((a, a + tri[:, 3:6], a + tri[:, 6:9]))
    return out


def _moved64(tables, host, inst, tri):
    """(a, e1, e2) in float64 world space of triangle ``tri`` of instance
    ``inst`` (spec order) on each row: the BLAS's corners through the
    instance's object-to-world 3x4 in float64, as the bake is defined."""
    dev = inst.device
    m = torch.tensor(host.object_to_world, dtype=torch.float64,
                     device=dev)[inst]
    which = torch.tensor(host.inst_blas, device=dev).long()[inst]
    corners = [torch.zeros(inst.shape[0], 3, dtype=torch.float64,
                           device=dev) for _ in range(3)]
    for b, tab in enumerate(tables):
        at = which == b
        for k in range(3):
            corners[k][at] = tab[k][tri[at]]
    w = [torch.einsum("nij,nj->ni", m[:, :, :3], p) + m[:, :, 3]
         for p in corners]
    return w[0], w[1] - w[0], w[2] - w[0]


def _cross(x, y):
    return torch.stack([x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1],
                        x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2],
                        x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]], -1)


def _mt64(o, d, a, e1, e2):
    """Moller-Trumbore in float64, broadcast over rays (o, d) and
    triangles (a, e1, e2): (det, u, v, t)."""
    p = _cross(d, e2)
    det = (e1 * p).sum(-1)
    tv = o - a
    q = _cross(tv, e1)
    return (det, (tv * p).sum(-1) / det, (d * q).sum(-1) / det,
            (e2 * q).sum(-1) / det)


def _brute64(host, ts, tables, o, d, cull, tmin, tmax):
    """The closest hit over the float64 bake: per instance whose float64
    world box (of its own moved corners) the ray's segment meets, every
    triangle of it; faces by the world determinant's sign (the bake's, a
    mirror's included); the lowest key on equal t. (t, key) in float64
    and int64, inf and -1 on a miss."""
    n, dev = o.shape[0], o.device
    o64, d64 = o.double(), d.double()
    inv = 1.0 / torch.where(d64 == 0, torch.full_like(d64, 1e-300), d64)
    best_t = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
    best_k = torch.full((n,), -1, dtype=torch.int64, device=dev)
    o2w = torch.tensor(host.object_to_world, dtype=torch.float64,
                       device=dev)
    for j in range(host.num_instances):
        lin, off = o2w[j, :, :3], o2w[j, :, 3]
        a, b, c = (p @ lin.T + off for p in tables[host.inst_blas[j]])
        e1, e2 = b - a, c - a
        n_tri = a.shape[0]
        pts = torch.cat([a, b, c])
        lo, hi = pts.amin(0), pts.amax(0)
        pad = 1e-9 * float(pts.abs().max())
        t0, t1 = (lo - pad - o64) * inv, (hi + pad - o64) * inv
        near = torch.minimum(t0, t1).amax(1).clamp_min(tmin)
        far = torch.maximum(t0, t1).amin(1).clamp_max(tmax)
        rows = torch.nonzero((cull != 0) & (near <= far)).squeeze(1)
        step = max(1, 2 ** 23 // n_tri)
        for s in range(0, rows.numel(), step):
            r = rows[s:s + step]
            det, u, v, t = _mt64(o64[r, None], d64[r, None], a[None],
                                 e1[None], e2[None])
            c = cull[r, None]
            ok = (torch.where(c > 0, det > 0, det < 0) & (u >= 0) & (v >= 0)
                  & (u + v <= 1) & (t >= tmin) & (t <= tmax))
            t = torch.where(ok, t, torch.full_like(t, float("inf")))
            tb, i = torch.min(t, dim=1)
            k = int(ts.key_bases[j]) + i
            win = torch.isfinite(tb) & ((tb < best_t[r]) | (
                (tb == best_t[r]) & (k < best_k[r])))
            best_t[r[win]], best_k[r[win]] = tb[win], k[win]
    return best_t, best_k


def _margin64(host, ts, tables, o, d, key):
    """(barycentric margin min(u, v, 1 - u - v), |cos| of the incidence,
    t) in float64 of each ray against the triangle of its ``key``."""
    inst, tri = ts.owners(key)
    a, e1, e2 = _moved64(tables, host, inst, tri)
    det, u, v, t = _mt64(o.double(), d.double(), a, e1, e2)
    nrm = _cross(e1, e2)
    cos = (nrm * d.double()).sum(-1).abs() / nrm.norm(dim=-1)
    return torch.minimum(torch.minimum(u, v), 1 - u - v), cos, t


def _traced_rays(ts, cfg, angles, dev):
    """Every level's rays of the eager integrator over the two levels
    (`instance_intersect`) at ``cfg``'s shape: [(o, d, cull, tmin, tmax)]
    of the live rays, primaries first."""
    out = []

    def recording(scene, o, d, want_front, alive, tmin, tmax):
        live = torch.nonzero(alive).squeeze(1)
        out.append((o[live].contiguous(), d[live].contiguous(),
                    cull_code(want_front, alive)[live].contiguous(), tmin,
                    tmax))
        return instance_intersect(scene, o, d, want_front, alive, tmin, tmax)

    for angle in angles:
        render_image(ts, orbit_camera(angle, cfg), cfg,
                     sample_offsets(cfg.spp), dev, recording,
                     cuda_env_contribution)
    return out


# Barycentric margin under which a ray grazes its triangle's edge: the
# float32 rounding of an instance's object-space ray (coordinates to ~150
# at the small spheres' scale of 6) or of the bake's world triangles moves
# a crossing by ~1e-5 of the coordinates, ~1e-3 of a small sphere's
# triangle edge.
GRAZE_MARGIN = 1e-2
# Relative gap in float64 t under which two surfaces tie for a ray: where
# rtiow_glass's overlapping small spheres cross (37 pairs overlap, as the
# book's jittered grid lets them); float32 t is good to ~1e-7.
TIE_T = 1e-5
# |cos| of the incidence under which a ray meets its triangle edge-on: the
# sign of the determinant, which decides the face, rounds there.
EDGE_ON_COS = 1e-3


def test_rtiow_glass_walk_meets_the_float64_bake_but_where_rays_graze(
        cuda, rtiow):
    """On rtiow_glass's own rays, the primary rays of two views and every
    secondary ray the eager integrator spawns over the two levels, the
    walk's twin (`instance_hit_plain`) against a float64 brute force over
    the bake (independent of the walk: world triangles, world boxes and
    Moller-Trumbore in float64): the winner's key differs only on rays
    that cross the exact or the walk's triangle within GRAZE_MARGIN of an
    edge or meet it edge-on (EDGE_ON_COS), or where the two winners'
    float64 t tie within TIE_T. The
    float32 bake (the closest-hit kernel over the single-mesh scene) is
    read the same way, on hit and t, for comparison."""
    ts, host = rtiow.scene, rtiow.scene.host
    cfg = rtiow.cfg.replace(width=240, height=135)
    tables = _world_tables64(host, cuda)
    bake = ts.baked()
    counts = {"rays": 0, "hits": 0, "graze_hits": 0, "walk_key": 0,
              "graze": 0, "tie": 0, "edge_on": 0, "other": 0, "walk_t": 0,
              "bake_t": 0}
    worst = []
    inf = float("inf")
    for level, (o, d, cull, tmin, tmax) in enumerate(
            _traced_rays(ts, cfg, (0.2, 3.3), cuda)):
        t, key, _ = instance_hit_plain(ts, o, d, cull, tmin, tmax)
        t64, key64 = _brute64(host, ts, tables, o, d, cull, tmin, tmax)
        tb, ib, _ = closest_hit(bake, o, d, cull, tmin, tmax)
        key = key.long()
        hit, hit64 = key >= 0, key64 >= 0
        far = hit & hit64 & ((t.double() - t64).abs() > 1e-4 * t64)
        far_b = (ib >= 0) & hit64 & ((tb.double() - t64).abs() > 1e-4 * t64)
        m64 = _margin64(host, ts, tables, o[hit64], d[hit64],
                        key64[hit64])[0]
        bad = torch.nonzero(key != key64).squeeze(1)
        m_w, c_w, t_w = _margin64(host, ts, tables, o[bad], d[bad],
                                  key[bad].clamp_min(0))
        m_x, c_x, t_x = _margin64(host, ts, tables, o[bad], d[bad],
                                  key64[bad].clamp_min(0))
        hw, hx = key[bad] >= 0, key64[bad] >= 0
        graze = torch.minimum(torch.where(hw, m_w.abs(), inf),
                              torch.where(hx, m_x.abs(), inf))
        tie = hw & hx & ((t_w - t_x).abs() <= TIE_T * t_x) & ~(
            graze < GRAZE_MARGIN)
        edge_on = ((hw & (c_w < EDGE_ON_COS)) | (hx & (c_x < EDGE_ON_COS))
                   ) & ~(graze < GRAZE_MARGIN) & ~tie
        near = (graze < GRAZE_MARGIN) | tie | edge_on
        for r in torch.nonzero(~near).squeeze(1).tolist():
            print("other:", level, tmin, tmax, float(cull[bad[r]]),
                  int(key[bad[r]]), int(key64[bad[r]]), float(t[bad[r]]),
                  float(t64[bad[r]]), float(t_w[r]), float(t_x[r]),
                  float(m_w[r]), float(m_x[r]), float(c_w[r]),
                  float(c_x[r]), ts.owners(key[bad[r]].view(1)),
                  ts.owners(key64[bad[r]].view(1)), float(tb[bad[r]]))
        for name, n in (("rays", o.shape[0]), ("hits", hit64.sum()),
                        ("graze_hits", (m64 < GRAZE_MARGIN).sum()),
                        ("walk_key", bad.numel()),
                        ("graze", (graze < GRAZE_MARGIN).sum()),
                        ("tie", tie.sum()), ("edge_on", edge_on.sum()),
                        ("other", (~near).sum()),
                        ("walk_t", ((hit != hit64) | far).sum()),
                        ("bake_t", (((ib >= 0) != hit64) | far_b).sum())):
            counts[name] += int(n)
        worst += graze[graze < GRAZE_MARGIN].tolist()
        print(f"level {level}: {bad.numel()} of {o.shape[0]} keys differ: "
              f"{int((graze < GRAZE_MARGIN).sum())} grazing, "
              f"{int(tie.sum())} tied, {int(edge_on.sum())} edge-on")
    print({**counts, "worst_margin": max(worst, default=0.0)})
    assert counts["rays"] > 100000 and counts["hits"] > 30000
    assert counts["other"] == 0, counts
    assert counts["walk_key"] <= counts["graze_hits"] // 10


# Share of pixels a frame of the two-level scene may differ from its bake's
# by more than PIX_TOL: the instance walk meets each triangle in object
# space and the bake in world space, so their t, normals and hit tests
# differ by rounding, and a glass path that grazes an edge or a silhouette
# goes another way in one than in the other. Readings on an H100 (13
# angles a scene, two seeds): rtiow_glass 1920x1080 0.308-0.406%, the
# test scenes at 256x192 at most 0.006% (3 pixels); each limit ~1.5x and
# ~8x over them.
GEOMETRY_SHARE = {"rtiow_glass": 0.006, "mixed": 0.0005, "big_blas": 0.0005}


@pytest.mark.parametrize("name, angle", [
    ("mixed", 0.4), ("mixed", 2.0), ("big_blas", 0.4), ("big_blas", 2.0),
    ("rtiow_glass", 0.2), ("rtiow_glass", 1.1), ("rtiow_glass", 3.3)])
def test_frame_matches_the_eager_integrator_and_the_bake(cuda, name, angle):
    """The instance walk's frame (``walks["instances"]``) against the
    eager integrator over the same two-level scene
    (`ops.backends.instance_intersect`) within the image bar; the bake's
    frame (counted under its own walk) against the eager integrator over
    the bake within the same bar; and the two frames within
    GEOMETRY_SHARE of each other."""
    if name == "rtiow_glass":  # 1080p, spp 1, caps 5/2
        prog = _rtiow(cuda)
        ts, cfg = prog.scene, prog.cfg
    else:
        insts, cs = _test_scenes()[name]
        ts = scene_from_jax(build_instanced_scene(
            insts, make_gradient_envmap(), cs)[0], cuda)
        cfg = RenderConfig(width=256, height=192, max_refract_depth=5)
    bake = ts.baked()
    frame = orbit_camera(angle, cfg)
    offsets = sample_offsets(cfg.spp)
    scal = build_scalars(frame, cfg, offsets, cuda)
    before = dict(fused_radiance.walks)
    walked = fused_radiance(ts, scal, cfg)
    baked = fused_radiance(bake, scal, cfg)
    assert fused_radiance.walks["instances"] == before["instances"] + 1
    assert sum(fused_radiance.walks.values()) == sum(before.values()) + 2
    eager = render_image(ts, frame, cfg, offsets, cuda, instance_intersect,
                         cuda_env_contribution)
    eager_bake = render_image(bake, frame, cfg, offsets, cuda,
                              cuda_intersect, cuda_env_contribution)
    ok, numbers = _img_ok(walked, eager)
    assert ok, numbers
    ok, numbers = _img_ok(baked, eager_bake)
    assert ok, numbers
    off = (walked - baked).abs().amax(dim=-1) > PIX_TOL
    print(f"{name} at {angle}: {float(off.double().mean()):.5f} of pixels "
          "off the bake's frame")
    assert float(off.double().mean()) <= GEOMETRY_SHARE[name]
    assert float(walked.mean()) > 0


def test_instance_walk_occupancy(cuda):
    """The instance walk's registers, local memory and resident warps,
    printed beside the other walks'."""
    occ = {w: frame_occupancy(w, cuda)
           for w in ("flat", "supers", "roots", "instances")}
    print({w: (o["registers"], o["warps_per_sm"], o["local_bytes"])
           for w, o in occ.items()})
    assert occ["instances"]["blocks_per_sm"] >= 1
    assert occ["instances"]["threads_per_block"] == 128
