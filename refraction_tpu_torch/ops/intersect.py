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

# Elements of one (chunk, T) temporary; the chunk of rays follows from T.
_CHUNK_ELEMS = 2 ** 23
_BIG = f32(3.0e38)


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
