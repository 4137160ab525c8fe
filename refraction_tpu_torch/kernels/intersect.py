"""Closest-hit kernel wrapper (``csrc/closest_hit.cu`` around
``csrc/traverse_f2b.cuh``): port of `refraction_tpu.kernels.intersect_pallas`
``pallas_intersect`` / ``_pallas_closest``.

``closest_hit`` launches the kernel for CUDA tensors and takes the plain
version, ``closest_hit_plain`` (the brute force of ops/intersect.py), for
CPU tensors. Results on a miss or a dead ray: ``t = +inf``, ``idx = -1``,
``normal = 0``.

``instance_hit`` is the frame kernel's instance walk over a two-level
scene (`scene.InstancedTorchScene`, RT_WALK_INSTANCES) on a batch of
rays, with the same contract but ``idx`` the winner's key
(`InstancedTorchScene.owners` names its instance and triangle); its plain
version is ``instance_hit_plain``, the walk's eager twin.
"""

from __future__ import annotations

import torch

from refraction_tpu_torch.kernels._build import launch
from refraction_tpu_torch.ops.intersect import (
    _safe_inv,
    _slab,
    interpolate_normal,
    intersect_closest,
    recompute_uv,
    to_object_space,
)
from refraction_tpu_torch.ops.shade import f32
from refraction_tpu_torch.scene import level_sizes


def cull_code(want_front: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """The traversal's per-ray cull operand: +1 accepts front faces,
    -1 back faces, 0 marks a dead ray."""
    one = torch.ones(want_front.shape, dtype=torch.float32,
                     device=want_front.device)
    return torch.where(alive, torch.where(want_front, one, -one),
                       torch.zeros_like(one))


def check_scene_tables(scene, device: torch.device) -> None:
    """The traversal's tables: float32, contiguous, on ``device``, and
    shaped as root, super, cluster and sub boxes of whole triangle
    blocks."""
    t = scene.num_tris
    n_roots, n_supers = level_sizes(scene.num_clusters)
    shapes = {"tri_packed": (t, 9), "tri_norm_packed": (t, 9),
              "root_bounds": (n_roots, 6),
              "super_bounds": (n_supers, 6),
              "cluster_bounds": (scene.num_clusters, 6),
              "sub_bounds": (t // scene.sub_tris, 6)}
    for name, shape in shapes.items():
        x = getattr(scene, name)
        if (x.device != device or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"scene.{name}: want contiguous float32 {shape} on {device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if t % scene.num_clusters or scene.cluster_size % scene.sub_tris:
        raise ValueError(
            f"{t} triangles do not split into {scene.num_clusters} clusters "
            f"of whole {scene.sub_tris}-triangle subs")


def _check_rays(origins, dirs, cull):
    n = origins.shape[0]
    for name, x, shape, dtype in (("origins", origins, (n, 3), torch.float32),
                                  ("dirs", dirs, (n, 3), torch.float32),
                                  ("cull", cull, (n,), torch.float32)):
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device != origins.device or not x.is_contiguous()):
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on "
                f"{origins.device}, got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}")


def closest_hit_plain(scene, origins, dirs, cull, tmin: float, tmax: float):
    """Brute-force (t, idx, normal) with the kernel's output contract."""
    hit, t, idx = intersect_closest(origins, dirs, scene.tri_a, scene.tri_e1,
                                    scene.tri_e2, tmin, tmax, cull > 0)
    hit = hit & (cull != 0)
    u, v = recompute_uv(origins, dirs, scene.tri_a, scene.tri_e1,
                        scene.tri_e2, idx)
    normal = interpolate_normal(scene.tri_norm_packed, idx, u, v)
    return (torch.where(hit, t, torch.full_like(t, float("inf"))),
            torch.where(hit, idx, torch.full_like(idx, -1)),
            torch.where(hit[:, None], normal, torch.zeros_like(normal)))


def closest_hit(scene, origins, dirs, cull, tmin: float, tmax: float):
    """Closest hit of N rays: (t (N,), idx (N,) int32, normal (N, 3)).

    ``origins``/``dirs`` (N, 3) and ``cull`` (N,) float32 contiguous
    tensors (see `cull_code`); the normal is the winner's unnormalized
    interpolated shading normal.
    """
    _check_rays(origins, dirs, cull)
    if origins.device.type == "cpu":
        return closest_hit_plain(scene, origins, dirs, cull, tmin, tmax)
    if origins.device.type != "cuda":
        raise ValueError(f"closest_hit: unsupported device {origins.device}")
    check_scene_tables(scene, origins.device)
    n = origins.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=origins.device)
    idx = torch.empty(n, dtype=torch.int32, device=origins.device)
    normal = torch.empty(n, 3, dtype=torch.float32, device=origins.device)
    if n == 0:
        return t, idx, normal
    launch("rt_closest_hit", origins.device,
           scene.tri_packed.data_ptr(), scene.tri_norm_packed.data_ptr(),
           scene.root_bounds.data_ptr(), scene.super_bounds.data_ptr(),
           scene.cluster_bounds.data_ptr(), scene.sub_bounds.data_ptr(),
           origins.data_ptr(), dirs.data_ptr(), cull.data_ptr(), n,
           f32(tmin), f32(tmax), scene.num_roots, scene.num_supers,
           scene.num_clusters, scene.cluster_size, scene.sub_tris,
           t.data_ptr(), idx.data_ptr(), normal.data_ptr())
    closest_hit.launches += 1
    return t, idx, normal


closest_hit.launches = 0


def instance_hit_plain(scene, origins, dirs, cull, tmin: float, tmax: float):
    """The instance walk's eager twin: per instance (table order) whose
    world box the ray meets on [tmin, tmax], the ray moved into object
    space by the instance's world-to-object 3x4 in the kernel's float32
    operation order (direction not renormalised), the brute force over
    its BLAS with the faces flipped where the transform mirrors, and the
    best kept on the pair compare of (t, key); the winner's normal
    interpolated in object space and taken to world space by the normal
    matrix. The walk prunes by boxes conservatively and keeps the same
    winner whatever its order, so this gives what it gives: (t, key,
    normal) with `closest_hit`'s contract."""
    n, dev = origins.shape[0], origins.device
    tmin32 = torch.full((n,), f32(tmin), device=dev)
    tmax32 = torch.full((n,), f32(tmax), device=dev)
    best_t = torch.full((n,), float("inf"), device=dev)
    best_k = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_j = torch.zeros(n, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, device=dev)
    best_v = torch.zeros(n, device=dev)
    inv = _safe_inv(dirs)
    info = scene.inst_info_host.tolist()
    sub_tris = scene.sub_tris
    for j in range(scene.num_instances):
        box = scene.inst_bounds[j].expand(n, 6)
        rows = torch.nonzero((cull != 0) & _slab(box, origins, inv, tmin32,
                                                 tmax32)).squeeze(1)
        if rows.numel() == 0:
            continue
        tri0, _, _, _, _, n_cl, spc, key, flip = info[j]
        lo, ld = to_object_space(scene.inst_xform[j], origins[rows],
                                 dirs[rows])
        tri = scene.tri_packed[tri0:tri0 + n_cl * spc * sub_tris]
        a, e1, e2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
        front = (cull[rows] > 0) != bool(flip)
        hit, t, idx = intersect_closest(lo, ld, a, e1, e2, tmin, tmax, front)
        k = key + idx.to(torch.int64)
        cur_t, cur_k = best_t[rows], best_k[rows]
        win = hit & ((t < cur_t) | ((t == cur_t) & (k < cur_k)))
        u, v = recompute_uv(lo, ld, a, e1, e2, idx)
        at = rows[win]
        best_t[at], best_k[at], best_j[at] = t[win], k[win], j
        best_u[at], best_v[at] = u[win], v[win]
    hit = best_k >= 0
    tri0 = scene.inst_info[best_j, 0].to(torch.int64)
    local = best_k - scene.inst_info[best_j, 7].to(torch.int64)
    n_obj = interpolate_normal(scene.tri_norm_packed, torch.where(
        hit, tri0 + local, torch.zeros_like(local)), best_u, best_v)
    m = scene.inst_xform[best_j, 12:21]
    normal = torch.stack([m[:, 3 * r] * n_obj[:, 0] + m[:, 3 * r + 1]
                          * n_obj[:, 1] + m[:, 3 * r + 2] * n_obj[:, 2]
                          for r in range(3)], dim=1)
    return (best_t, torch.where(hit, best_k, -1).to(torch.int32),
            torch.where(hit[:, None], normal, torch.zeros_like(normal)))


def instance_hit(scene, origins, dirs, cull, tmin: float, tmax: float):
    """Closest hit of N rays in a two-level scene through the frame
    kernel's instance walk: (t (N,), key (N,) int32, normal (N, 3)), as
    `closest_hit` returns them with the key in place of the index. On CPU
    tensors its plain version, `instance_hit_plain`."""
    _check_rays(origins, dirs, cull)
    if origins.device.type == "cpu":
        return instance_hit_plain(scene, origins, dirs, cull, tmin, tmax)
    if origins.device.type != "cuda":
        raise ValueError(f"instance_hit: unsupported device {origins.device}")
    n = origins.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=origins.device)
    idx = torch.empty(n, dtype=torch.int32, device=origins.device)
    normal = torch.empty(n, 3, dtype=torch.float32, device=origins.device)
    if n == 0:
        return t, idx, normal
    launch("rt_instance_hit", origins.device,
           scene.tri_packed.data_ptr(), scene.tri_norm_packed.data_ptr(),
           scene.super_bounds.data_ptr(), scene.cluster_bounds.data_ptr(),
           scene.sub_bounds.data_ptr(), scene.inst_bounds.data_ptr(),
           scene.inst_roots.data_ptr(), scene.inst_xform.data_ptr(),
           scene.inst_info.data_ptr(), scene.num_instances,
           scene.num_inst_roots, scene.sub_tris, origins.data_ptr(),
           dirs.data_ptr(), cull.data_ptr(), n, f32(tmin), f32(tmax),
           t.data_ptr(), idx.data_ptr(), normal.data_ptr())
    instance_hit.launches += 1
    return t, idx, normal


instance_hit.launches = 0
