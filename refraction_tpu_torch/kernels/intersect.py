"""Closest-hit kernel wrapper (``csrc/closest_hit.cu`` around
``csrc/traverse_f2b.cuh``): port of `refraction_tpu.kernels.intersect_pallas`
``pallas_intersect`` / ``_pallas_closest``.

``closest_hit`` launches the kernel for CUDA tensors and takes the plain
version, ``closest_hit_plain`` (the brute force of ops/intersect.py), for
CPU tensors. Results on a miss or a dead ray: ``t = +inf``, ``idx = -1``,
``normal = 0``.
"""

from __future__ import annotations

import torch

from refraction_tpu_torch.kernels._build import launch
from refraction_tpu_torch.ops.intersect import (
    interpolate_normal,
    intersect_closest,
    recompute_uv,
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
