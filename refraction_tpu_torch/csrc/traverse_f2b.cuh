// Closest-hit traversal of one ray: the device function of the frame
// kernel (frame.cu), the closest-hit kernel (closest_hit.cu) and the round
// kernel (round.cu).
//
// Replaces refraction_tpu/kernels/intersect_pallas.py::traverse_tile
// (388-1290), which traces an (8,128) tile of rays at once over a 3-level
// box hierarchy with bitmask-gated visits, and the near-to-far cluster
// order that the TPU frame path gets from a per-frame table permutation
// (framekernel.py::front_to_back_scene, 975-1035). Here one thread walks
// one ray; the order is per ray and idx stays in table order. Three
// instances, chosen by the caller from the scene:
//
//   RT_WALK_ROOTS (the scene has root boxes, 2-32 of them: 33-1,024
//   supers): roots, near to far; stop at the first whose entry is past
//   best_t
//       their 32 supers, near to far, the same
//         then as RT_WALK_SUPERS below a super
//   RT_WALK_SUPERS (super boxes and no roots: 33-1,024 clusters, or more
//   than 32,768): supers, near to far (in groups of 32); stop at the
//   first whose entry is past best_t
//       their 32 clusters, near to far, the same
//         their subs, near to far (in groups of 64), the same
//           Möller–Trumbore on each of the sub's triangles
//   RT_WALK_FLAT (at most 32 clusters, no supers):
//     clusters, then their subs, in table order: each slab-tested against
//     [tmin, best_t] when its turn comes
//       Möller–Trumbore on each of the sub's triangles
//
// A near-to-far group slab-tests its (at most 32 or 64) boxes once into a
// mask, then picks the set bit of least entry distance (recomputed from
// the box, so no per-ray array sits in local memory), visits it, and stops
// at the first pick whose entry is past best_t: every later pick enters
// later still. On the H100 ordering pays only where there are supers: at
// the 81,920-triangle scene it cut the frame kernel by 39%, while on a
// 10-cluster scene the picking and the registers it holds cost more than
// the boxes it skipped (PERF.md, PR 4), hence the flat instance.
// A root is a node of the build's split (scene.build_scene), so one root
// box stands for 32 supers that a miss would otherwise test one by one,
// and the near root is entered before the far one.
//
// Winners do not depend on the order: a triangle wins on the pair compare
// t < best_t || (t == best_t && k < best_i), so equal t go to the lowest
// table index, as the brute force's argmin does (ops/intersect.py), and a
// box is opened while its entry is <= best_t, so a box that may hold an
// equal-t, lower-index triangle is still opened. best_t starts at the
// float after tmax, which makes the range test inclusive (t <= tmax), as
// the oracle's is. The slab test is inclusive (enter <= leave) with |d|
// clamped to 1e-30, so zero-thickness boxes (axis-aligned faces) stay
// visible.
//
// Bound on the H100: FP32 operations, 25 per box test and 52 per
// Möller–Trumbore test (counted in ops/intersect.py, which counts the work
// each ray needs under this hierarchy); the tables are small and
// read-only and are read through the read-only data cache (__ldg).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

struct RtHit {
  float t;    // winner's distance; +inf on a miss
  int idx;    // winner's triangle index in table order; -1 on a miss
  float nx, ny, nz;  // unnormalized interpolated shading normal
};

// The scene's tables in global memory and their sizes.
struct RtScene {
  const float* supers;    // (n_supers, 6) [lo | hi]; super s = clusters [32s, 32s+32)
  const float* clusters;  // (n_clusters, 6)
  const float* subs;      // (T / sub_tris, 6)
  const float* tri;       // (T, 9) [A | e1 | e2]
  const float* norm;      // (T, 9) [nA | nB-nA | nC-nA]
  int n_supers, n_clusters, subs_per_cluster, sub_tris;
  const float* roots;     // (n_roots, 6); root q = supers [32q, 32q+32)
  int n_roots;
};

enum RtWalk { RT_WALK_FLAT = 0, RT_WALK_SUPERS = 1, RT_WALK_ROOTS = 2 };

#define RT_SUPER_CLUSTERS 32

struct RtRayOps {
  float ox, oy, oz, ix, iy, iz, tmin;
};

__device__ __forceinline__ float rt_safe_inv(float c) {
  const float mag = fmaxf(fabsf(c), 1e-30f);
  return c < 0.0f ? -1.0f / mag : 1.0f / mag;
}

// Entry distance into box b = [lo xyz | hi xyz], clamped below at tmin.
__device__ __forceinline__ float rt_entry(const float* b, const RtRayOps& r) {
  const float ax = (__ldg(b + 0) - r.ox) * r.ix, bx = (__ldg(b + 3) - r.ox) * r.ix;
  const float ay = (__ldg(b + 1) - r.oy) * r.iy, by = (__ldg(b + 4) - r.oy) * r.iy;
  const float az = (__ldg(b + 2) - r.oz) * r.iz, bz = (__ldg(b + 5) - r.oz) * r.iz;
  return fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fmaxf(fminf(az, bz), r.tmin));
}

// Conservative ray/box overlap on [tmin, tmax].
__device__ __forceinline__ bool rt_overlaps(const float* b, const RtRayOps& r,
                                            float tmax) {
  const float ax = (__ldg(b + 0) - r.ox) * r.ix, bx = (__ldg(b + 3) - r.ox) * r.ix;
  const float ay = (__ldg(b + 1) - r.oy) * r.iy, by = (__ldg(b + 4) - r.oy) * r.iy;
  const float az = (__ldg(b + 2) - r.oz) * r.iz, bz = (__ldg(b + 5) - r.oz) * r.iz;
  const float enter = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                            fmaxf(fminf(az, bz), r.tmin));
  const float leave = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                            fminf(fmaxf(az, bz), tmax));
  return enter <= leave;
}

// Visit boxes [first, first + n), n <= bits of Mask, that the ray
// overlaps on [tmin, best_t], near to far, each while its entry is
// <= best_t. visit(i) may lower best_t; it returns true to end the walk
// (any-hit).
template <typename Mask = unsigned, typename Visit>
__device__ __forceinline__ bool rt_near_to_far(const float* boxes, int first,
                                               int n, const RtRayOps& r,
                                               const float& best_t,
                                               Visit&& visit) {
  Mask mask = 0;
  for (int i = 0; i < n; ++i)
    if (rt_overlaps(boxes + 6 * (first + i), r, best_t)) mask |= Mask(1) << i;
  while (mask) {
    float e_min = CUDART_INF_F;
    int i_min = 0;
    for (Mask rest = mask; rest; rest &= rest - 1) {
      const int i = __ffsll((long long)rest) - 1;
      const float e = rt_entry(boxes + 6 * (first + i), r);
      if (e < e_min) { e_min = e; i_min = i; }
    }
    if (!(e_min <= best_t)) break;
    mask &= ~(Mask(1) << i_min);
    if (visit(first + i_min)) return true;
  }
  return false;
}

// Visit boxes [first, first + n) in table order, each that the ray
// overlaps on [tmin, best_t] when its turn comes.
template <typename Visit>
__device__ __forceinline__ bool rt_in_order(const float* boxes, int first,
                                            int n, const RtRayOps& r,
                                            const float& best_t,
                                            Visit&& visit) {
  for (int i = first; i < first + n; ++i)
    if (rt_overlaps(boxes + 6 * i, r, best_t) && visit(i)) return true;
  return false;
}

// Closest hit of ray (o, d). cull = +1 accepts front faces (det > 0),
// -1 back faces (det < 0), 0 is a dead ray (a miss). With any_hit the
// walk stops at the first accepted triangle and idx/normal are not
// resolved (idx = 0 on a hit): the depth-cap round only needs hit or
// miss. WALK must be RT_WALK_ROOTS when sc.n_roots > 0 (at most 32),
// else RT_WALK_SUPERS when sc.n_supers > 0, else RT_WALK_FLAT.
template <int WALK>
__device__ __forceinline__ RtHit rt_closest_hit(
    const RtScene& sc, float ox, float oy, float oz, float dx, float dy,
    float dz, float cull, float tmin, float tmax, bool any_hit) {
  RtHit h;
  h.t = CUDART_INF_F;
  h.idx = -1;
  h.nx = 0.0f; h.ny = 0.0f; h.nz = 0.0f;
  if (cull == 0.0f) return h;

  const RtRayOps r{ox, oy, oz, rt_safe_inv(dx), rt_safe_inv(dy),
                   rt_safe_inv(dz), tmin};
  const bool front = cull > 0.0f;
  float best_t = nextafterf(tmax, CUDART_INF_F);
  int best_i = -1;
  float best_u = 0.0f, best_v = 0.0f;

  auto visit_sub = [&](int s) -> bool {
    const int k_end = (s + 1) * sc.sub_tris;
    for (int k = s * sc.sub_tris; k < k_end; ++k) {
      const float* p = sc.tri + 9 * k;
      const float a0 = __ldg(p + 0), a1 = __ldg(p + 1), a2 = __ldg(p + 2);
      const float e10 = __ldg(p + 3), e11 = __ldg(p + 4), e12 = __ldg(p + 5);
      const float e20 = __ldg(p + 6), e21 = __ldg(p + 7), e22 = __ldg(p + 8);
      // pvec = cross(D, e2); det = dot(e1, pvec)
      const float px = dy * e22 - dz * e21;
      const float py = dz * e20 - dx * e22;
      const float pz = dx * e21 - dy * e20;
      const float det = e10 * px + e11 * py + e12 * pz;
      if (front ? !(det > 0.0f) : !(det < 0.0f)) continue;
      const float inv_det = 1.0f / det;
      const float tvx = ox - a0, tvy = oy - a1, tvz = oz - a2;
      const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
      // qvec = cross(tvec, e1)
      const float qx = tvy * e12 - tvz * e11;
      const float qy = tvz * e10 - tvx * e12;
      const float qz = tvx * e11 - tvy * e10;
      const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float t = (e20 * qx + e21 * qy + e22 * qz) * inv_det;
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin &&
          (t < best_t || (t == best_t && k < best_i))) {
        best_t = t;
        best_i = k;
        best_u = u;
        best_v = v;
        if (any_hit) return true;
      }
    }
    return false;
  };
  auto visit_cluster = [&](int c) -> bool {
    if (WALK != RT_WALK_FLAT) {
      for (int g = 0; g < sc.subs_per_cluster; g += 64)
        if (rt_near_to_far<unsigned long long>(
                sc.subs, c * sc.subs_per_cluster + g,
                min(64, sc.subs_per_cluster - g), r, best_t, visit_sub))
          return true;
      return false;
    }
    return rt_in_order(sc.subs, c * sc.subs_per_cluster, sc.subs_per_cluster,
                       r, best_t, visit_sub);
  };
  auto visit_super = [&](int s) -> bool {
    const int first = s * RT_SUPER_CLUSTERS;
    return rt_near_to_far(sc.clusters, first,
                          min(RT_SUPER_CLUSTERS, sc.n_clusters - first), r,
                          best_t, visit_cluster);
  };
  auto visit_root = [&](int q) -> bool {
    const int first = q * RT_SUPER_CLUSTERS;
    return rt_near_to_far(sc.supers, first,
                          min(RT_SUPER_CLUSTERS, sc.n_supers - first), r,
                          best_t, visit_super);
  };
  if (WALK == RT_WALK_ROOTS) {
    // At most 32 roots (scene.level_sizes), so one near-to-far pick.
    rt_near_to_far(sc.roots, 0, sc.n_roots, r, best_t, visit_root);
  } else if (WALK == RT_WALK_SUPERS) {
    // Supers in groups of 32 (more than 32,768 clusters, which keep no
    // roots: groups in order).
    for (int g = 0; g < sc.n_supers; g += RT_SUPER_CLUSTERS)
      if (rt_near_to_far(sc.supers, g, min(RT_SUPER_CLUSTERS, sc.n_supers - g),
                         r, best_t, visit_super))
        break;
  } else {
    rt_in_order(sc.clusters, 0, sc.n_clusters, r, best_t, visit_cluster);
  }

  if (best_i >= 0) {
    h.t = best_t;
    if (any_hit) {
      h.idx = 0;
      return h;
    }
    const float* n = sc.norm + 9 * best_i;
    h.idx = best_i;
    h.nx = __ldg(n + 0) + best_u * __ldg(n + 3) + best_v * __ldg(n + 6);
    h.ny = __ldg(n + 1) + best_u * __ldg(n + 4) + best_v * __ldg(n + 7);
    h.nz = __ldg(n + 2) + best_u * __ldg(n + 5) + best_v * __ldg(n + 8);
  }
  return h;
}
