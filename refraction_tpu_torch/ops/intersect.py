"""Brute-force Möller–Trumbore closest hit in PyTorch: port of
`refraction_tpu/ops/intersect.py` (intersect_closest, recompute_uv).

This is the plain version of the CUDA traversal (kernels/intersect.py):
every ray against every triangle, in ray chunks that bound the
(chunk, T) temporaries.

Semantics, as in the JAX/numpy version:

- a hit is front-facing iff ``det = dot(e1, cross(D, e2)) > 0``; rays with
  ``want_front`` accept only front faces, the others only back faces;
- the range test is inclusive, ``tmin <= t <= tmax``;
- ties go to the lowest triangle index (``argmin`` returns the first);
- zero-area pad triangles have ``det == 0`` and never hit;
- with ``tri_mask`` and ``ray_mask`` (DXR instance visibility), triangle
  j is testable by ray i iff ``tri_mask[j] & ray_mask[i] != 0``.
"""

from __future__ import annotations

import torch

from refraction_tpu_torch.ops.shade import dot3, f32
from refraction_tpu_torch.scene import SUPER_CLUSTERS

# Elements of one (chunk, T) temporary; the chunk of rays follows from T.
_CHUNK_ELEMS = 2 ** 23
_BIG = f32(3.0e38)

# FP32 operations of one test, counted from the CUDA traversal
# (csrc/traverse_f2b.cuh; the library is built with -fmad=false, so each
# is one instruction; a divide counts as one):
#   box slab test (rt_overlaps, traverse_f2b.cuh:90-100): 6 subtracts,
#     6 multiplies, 6 per-axis min/max, 3 max + 3 min for enter/leave,
#     1 compare = 25;
#   Möller–Trumbore (traverse_f2b.cuh:170-186): pvec 9, det 5, cull
#     compare 1, 1 divide, tvec 3, u 6, qvec 9, v 6, t 6, 5 compares +
#     1 add = 52 (the tie-break compare of equal t is not counted).
BOX_TEST_OPS = 25
MT_TEST_OPS = 52
# Rays per chunk of traversal_work (bounds its pair temporaries).
_WORK_CHUNK = 2 ** 15


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _closest_block(origins, dirs, tri_a, tri_e1, tri_e2, tmin, tmax,
                   want_front, tri_mask, ray_mask):
    d = dirs[:, None, :]
    pvec = _cross(d, tri_e2[None])
    det = dot3(tri_e1[None], pvec)
    accept = torch.where(want_front[:, None], det > 0, det < 0)
    if ray_mask is not None:
        accept = accept & ((tri_mask[None, :] & ray_mask[:, None]) != 0)
    safe_det = torch.where(det == 0, torch.ones_like(det), det)
    inv_det = 1.0 / safe_det
    tvec = origins[:, None, :] - tri_a[None]
    u = dot3(tvec, pvec) * inv_det
    qvec = _cross(tvec, tri_e1[None])
    v = dot3(d, qvec) * inv_det
    t = dot3(tri_e2[None], qvec) * inv_det
    hit = (accept & (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
           & (t >= tmin) & (t <= tmax))
    t_sel = torch.where(hit, t, torch.full_like(t, _BIG))
    t_best, idx = torch.min(t_sel, dim=1)
    return t_best < _BIG, t_best, idx.to(torch.int32)


def intersect_closest(origins, dirs, tri_a, tri_e1, tri_e2, tmin: float,
                      tmax: float, want_front, tri_mask=None, ray_mask=None):
    """Closest hit of N rays: (hit (N,) bool, t (N,), tri_idx (N,) int32).

    ``origins``/``dirs`` (N, 3) float32, ``tri_*`` (T, 3), ``want_front``
    (N,) bool; ``tmin``/``tmax`` are rounded to float32. Where ``hit`` is
    False, ``t`` is 3e38 and ``tri_idx`` is 0. ``tri_mask`` (T,) and
    ``ray_mask`` (N,) int32 come together or not at all.
    """
    if (tri_mask is None) != (ray_mask is None):
        raise ValueError("tri_mask and ray_mask: give both or neither")
    tmin, tmax = f32(tmin), f32(tmax)
    n = origins.shape[0]
    chunk = max(1, _CHUNK_ELEMS // max(int(tri_a.shape[0]), 1))
    if n <= chunk:
        return _closest_block(origins, dirs, tri_a, tri_e1, tri_e2, tmin,
                              tmax, want_front, tri_mask, ray_mask)
    parts = [
        _closest_block(origins[s:s + chunk], dirs[s:s + chunk], tri_a,
                       tri_e1, tri_e2, tmin, tmax, want_front[s:s + chunk],
                       tri_mask,
                       None if ray_mask is None else ray_mask[s:s + chunk])
        for s in range(0, n, chunk)
    ]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def recompute_uv(origins, dirs, tri_a, tri_e1, tri_e2, idx):
    """Barycentrics (u, v) of each ray against its chosen triangle ``idx``."""
    idx = idx.to(torch.int64)
    a, e1, e2 = tri_a[idx], tri_e1[idx], tri_e2[idx]
    pvec = _cross(dirs, e2)
    det = dot3(e1, pvec)
    inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    tvec = origins - a
    u = dot3(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = dot3(dirs, qvec) * inv_det
    return u, v


def interpolate_normal(tri_norm_packed, idx, u, v):
    """Unnormalized shading normal ``nA + u (nB - nA) + v (nC - nA)`` of
    triangle ``idx`` from the (T, 9) ``[nA | nB-nA | nC-nA]`` table."""
    rows = tri_norm_packed[idx.to(torch.int64)]
    return (rows[:, 0:3] + u[:, None] * rows[:, 3:6]
            + v[:, None] * rows[:, 6:9])


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    """rt_safe_inv: 1 / d with |d| clamped to 1e-30, sign kept."""
    mag = torch.clamp_min(d.abs(), 1e-30)
    one = torch.ones_like(d)
    return torch.where(d < 0, -one / mag, one / mag)


def _slab(box: torch.Tensor, o: torch.Tensor, inv: torch.Tensor,
          tmin: torch.Tensor, tmax: torch.Tensor) -> torch.Tensor:
    """rt_slab on paired rows: box (P, 6) [lo | hi], o / inv (P, 3),
    tmin / tmax (P,): inclusive overlap on [tmin, tmax]."""
    a = (box[:, :3] - o) * inv
    b = (box[:, 3:] - o) * inv
    enter = torch.maximum(torch.minimum(a, b).amax(dim=1), tmin)
    leave = torch.minimum(torch.maximum(a, b).amin(dim=1), tmax)
    return enter <= leave


def _overlapping(boxes, rays, cand_ray, cand_box):
    """(ray, box) candidate pairs -> the pairs whose box the ray overlaps."""
    o, inv, tmin, tmax = rays
    hit = _slab(boxes[cand_box], o[cand_ray], inv[cand_ray], tmin[cand_ray],
                tmax[cand_ray])
    return cand_ray[hit], cand_box[hit]


def _children(r, parent, n_child):
    """(ray, box) pairs -> (ray, child box) pairs, the children of box p
    being [32 p, 32 p + 32) of the ``n_child`` boxes one level down."""
    first = parent * SUPER_CLUSTERS
    size = torch.clamp(n_child - first, max=SUPER_CLUSTERS)
    start = torch.cumsum(size, 0) - size
    pos = torch.arange(int(size.sum()), device=r.device)
    return (r.repeat_interleave(size),
            first.repeat_interleave(size) + pos - start.repeat_interleave(size))


def traversal_work(scene, o: torch.Tensor, d: torch.Tensor, tmin,
                   t_hit: torch.Tensor, cull: torch.Tensor) -> dict:
    """The box and triangle tests N rays need under the scene's hierarchy,
    whatever the visit order: per ray (N,) int64 counts

    - ``root_tests``: every root box (scenes with roots), else 0;
    - ``super_tests``: the supers of the roots the ray overlaps on
      ``[tmin, t_hit]``, or every super box when there are no roots;
    - ``cluster_tests``: the clusters of the supers it overlaps there, or
      every cluster when there are no supers;
    - ``sub_tests``: the sub boxes of the clusters it overlaps there;
    - ``mt_tests``: the triangles of the subs it overlaps there.

    ``t_hit`` is the ray's closest hit t (``tmax`` for a miss), ``tmin`` a
    float or (N,) tensor, ``cull`` the traversal's operand (0: a dead ray,
    no work). Overlap is the traversal's inclusive slab test (`_slab`).
    Times BOX_TEST_OPS and MT_TEST_OPS, the counts give the FP32 work of a
    frame (render.frame_traversal_work)."""
    n, dev = o.shape[0], o.device
    out = {k: torch.zeros(n, dtype=torch.int64, device=dev)
           for k in ("root_tests", "super_tests", "cluster_tests", "sub_tests",
                     "mt_tests")}
    tmin = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(n)
    t_hit = t_hit.to(torch.float32)
    inv_all = _safe_inv(d)
    # The box levels from the top, each with its table and its test count.
    levels = [(scene.root_bounds, "root_tests"),
              (scene.super_bounds, "super_tests"),
              (scene.cluster_bounds, "cluster_tests")]
    levels = [lv for lv in levels if lv[0].shape[0]]
    spc = scene.cluster_size // scene.sub_tris
    for s in range(0, n, _WORK_CHUNK):
        live = torch.nonzero(cull[s:s + _WORK_CHUNK] != 0).squeeze(1) + s
        if live.numel() == 0:
            continue
        rays = (o[live], inv_all[live], tmin[live], t_hit[live])
        local = torch.arange(live.numel(), device=dev)
        # Every box of the top level, then the children of those crossed.
        r, c = torch.cartesian_prod(
            local, torch.arange(levels[0][0].shape[0], device=dev)).T
        for k, (boxes, key) in enumerate(levels):
            if k:
                r, c = _children(r, c, boxes.shape[0])
            out[key].index_add_(0, live[r], torch.ones_like(r))
            r, c = _overlapping(boxes, rays, r, c)
        out["sub_tests"].index_add_(0, live[r], torch.full_like(r, spc))
        r = r.repeat_interleave(spc)
        sub = (c[:, None] * spc + torch.arange(spc, device=dev)).reshape(-1)
        r, sub = _overlapping(scene.sub_bounds, rays, r, sub)
        out["mt_tests"].index_add_(0, live[r],
                                   torch.full_like(r, scene.sub_tris))
    return out
