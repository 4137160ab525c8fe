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
# The instance walk's move of a ray into an instance's object space
# (traverse_f2b.cuh, visit_instance): the origin through the 3x4, 9
# multiplies and 9 adds, the direction through its 3x3, 9 multiplies and
# 6 adds (the inverses of the direction are not counted, as the world
# ray's are not).
XFORM_OPS = 33
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


def _tree_work(levels, rays, rows, r, out):
    """Count into ``out`` (at ``rows[r]``) the box tests of ray rows ``r``
    (indices into ``rays``) under ``levels``, [(boxes, key), ...] from the
    top: every box of the top level, then the children of those crossed.
    Returns the (ray row, box) pairs of the last level whose box the ray
    overlaps."""
    c = None
    for k, (boxes, key) in enumerate(levels):
        if k:
            r, c = _children(r, c, boxes.shape[0])
        else:
            top = torch.arange(boxes.shape[0], device=r.device)
            r, c = r.repeat_interleave(top.numel()), top.repeat(r.numel())
        out[key].index_add_(0, rows[r], torch.ones_like(r))
        r, c = _overlapping(boxes, rays, r, c)
    return r, c


def _mesh_work(levels, sub_bounds, spc, sub_tris, rays, rows, r, out):
    """Count into ``out`` the box and triangle tests of ray rows ``r`` under
    one mesh's ``levels`` (roots, supers, clusters, the non-empty ones),
    its sub boxes (``spc`` a cluster) and triangles (``sub_tris`` a
    sub)."""
    r, c = _tree_work(levels, rays, rows, r, out)
    out["sub_tests"].index_add_(0, rows[r], torch.full_like(r, spc))
    r = r.repeat_interleave(spc)
    sub = (c[:, None] * spc
           + torch.arange(spc, device=r.device)).reshape(-1)
    r, sub = _overlapping(sub_bounds, rays, r, sub)
    out["mt_tests"].index_add_(0, rows[r], torch.full_like(r, sub_tris))


def to_object_space(x, o, d):
    """The rays (o, d) moved into object space by world-to-object 3x4
    rows ``x`` (row-major, (12,) for every ray or (N, >= 12) one a ray),
    in the instance walk's float32 operation order (traverse_f2b.cuh,
    visit_instance): (origins, directions), the directions not
    renormalised, so that t along them is the world t."""
    lo = torch.stack([x[..., 4 * k] * o[:, 0] + x[..., 4 * k + 1] * o[:, 1]
                      + x[..., 4 * k + 2] * o[:, 2] + x[..., 4 * k + 3]
                      for k in range(3)], dim=1)
    ld = torch.stack([x[..., 4 * k] * d[:, 0] + x[..., 4 * k + 1] * d[:, 1]
                      + x[..., 4 * k + 2] * d[:, 2] for k in range(3)], dim=1)
    return lo, ld


def _object_rays(scene, j, o, d, tmin, t_hit):
    """The rays (o, d) moved into instance slot ``j``'s object space (per
    pair), as the instance walk moves them: the operands `_overlapping`
    takes."""
    lo, ld = to_object_space(scene.inst_xform[j], o, d)
    return lo, _safe_inv(ld), tmin, t_hit


def _instance_work(scene, o, d, tmin, t_hit, live, out) -> None:
    """The instance walk's tests of the live rays: instance roots and
    boxes (world space), a ray transform for each instance box overlapped,
    then each such instance's BLAS as `_mesh_work` counts it, in object
    space."""
    rays = (o[live], _safe_inv(d[live]), tmin[live], t_hit[live])
    levels = [(scene.inst_roots, "instance_root_tests"),
              (scene.inst_bounds, "instance_tests")]
    levels = [lv for lv in levels if lv[0].shape[0]]
    local = torch.arange(live.numel(), device=o.device)
    r, j = _tree_work(levels, rays, live, local, out)
    out["transforms"].index_add_(0, live[r], torch.ones_like(r))
    info = torch.as_tensor(scene.inst_info_host, device=o.device)
    for tri0 in torch.unique(info[:, 0]).tolist():
        at = info[j, 0] == tri0
        rr, jj = r[at], j[at]
        if rr.numel() == 0:
            continue
        _, cl, sub, sup, n_sup, n_cl, spc, _, _ = info[jj[0]].tolist()
        obj = _object_rays(scene, jj, o[live[rr]], d[live[rr]],
                           rays[2][rr], rays[3][rr])
        blas = [(scene.super_bounds[sup:sup + n_sup], "super_tests"),
                (scene.cluster_bounds[cl:cl + n_cl], "cluster_tests")]
        _mesh_work(blas, scene.sub_bounds[sub:sub + n_cl * spc], spc,
                   scene.sub_tris, obj, live[rr],
                   torch.arange(rr.numel(), device=o.device), out)


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

    A two-level scene (`scene.InstancedTorchScene`, the frame kernel's
    instance walk) adds ``instance_root_tests`` (every instance root),
    ``instance_tests`` (the instance boxes of the roots overlapped, or
    every one without roots) and ``transforms`` (a ray moved into the
    object space of each instance box it overlaps), and counts each such
    instance's BLAS as above, every super of it first, in object space.

    ``t_hit`` is the ray's closest hit t (``tmax`` for a miss), ``tmin`` a
    float or (N,) tensor, ``cull`` the traversal's operand (0: a dead ray,
    no work). Overlap is the traversal's inclusive slab test (`_slab`).
    Times BOX_TEST_OPS, MT_TEST_OPS and XFORM_OPS, the counts give the FP32
    work of a frame (render.frame_traversal_work): the port's own count of
    its walk (bounds.py), which moves when the walk's tables do; rtbench's
    roofline is the benchmark's fixed yardstick."""
    n, dev = o.shape[0], o.device
    keys = ["root_tests", "super_tests", "cluster_tests", "sub_tests",
            "mt_tests"]
    instanced = scene.num_instances > 0
    if instanced:
        keys += ["instance_root_tests", "instance_tests", "transforms"]
    out = {k: torch.zeros(n, dtype=torch.int64, device=dev) for k in keys}
    tmin = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(n)
    t_hit = t_hit.to(torch.float32)
    inv_all = _safe_inv(d)
    # The box levels from the top, each with its table and its test count.
    if not instanced:
        levels = [(scene.root_bounds, "root_tests"),
                  (scene.super_bounds, "super_tests"),
                  (scene.cluster_bounds, "cluster_tests")]
        levels = [lv for lv in levels if lv[0].shape[0]]
        spc = scene.cluster_size // scene.sub_tris
    for s in range(0, n, _WORK_CHUNK):
        live = torch.nonzero(cull[s:s + _WORK_CHUNK] != 0).squeeze(1) + s
        if live.numel() == 0:
            continue
        if instanced:
            _instance_work(scene, o, d, tmin, t_hit, live, out)
            continue
        rays = (o[live], inv_all[live], tmin[live], t_hit[live])
        _mesh_work(levels, scene.sub_bounds, spc, scene.sub_tris, rays, live,
                   torch.arange(live.numel(), device=dev), out)
    return out
