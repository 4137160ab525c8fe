// Closest-hit traversal of one ray: the device function of the frame
// kernel (frame.cu), the closest-hit kernel (closest_hit.cu) and the round
// kernel (round.cu).
//
// Replaces refraction_tpu/kernels/intersect_pallas.py::traverse_tile
// (388-1290), which traces an (8,128) tile of rays at once over a 3-level
// box hierarchy with bitmask-gated visits, and the near-to-far cluster
// order that the TPU frame path gets from a per-frame table permutation
// (framekernel.py::front_to_back_scene, 975-1035). Here one thread walks
// one ray; the order is per ray and idx stays in table order. Four
// instances, chosen by the caller from the scene:
//
//   RT_WALK_INSTANCES (a two-level scene: instances over shared BLASes,
//   as DXR's TLAS over BLASes, RefractionDemo.cpp:272-361): instance
//   roots (boxes over runs of 32 instance boxes), near to far, in groups
//   of 32; stop at the first whose entry is past best_t
//       their instance boxes (world space), near to far, the same
//         the ray moved into the instance's object space by its
//         world-to-object 3x4, the direction not renormalised, so a hit's
//         t is the world t
//           the BLAS's own tables as RT_WALK_SUPERS below (every BLAS
//           has at least one super)
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
// table index, as the brute force's argmin does (ops/intersect.py); in the
// instance walk k is the triangle's key, its BLAS table index plus the
// instance's key base (the instances' BLAS tables laid end to end in spec
// order), so equal t go to the lowest instance, then the lowest triangle
// of its BLAS's table. A mirroring transform (negative determinant) flips
// which faces the walk accepts in object space, so an instance keeps the
// facing its baked copy has in world space. The winner's shading normal
// is interpolated in object space and taken to world space by the
// instance's normal matrix (the inverse-transpose), unnormalised. And a
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

enum RtWalk {
  RT_WALK_FLAT = 0,
  RT_WALK_SUPERS = 1,
  RT_WALK_ROOTS = 2,
  RT_WALK_INSTANCES = 3
};

// A two-level scene (RT_WALK_INSTANCES): the tables of RtScene are every
// BLAS's, one after another, and the top level lies over them. The
// single-mesh walks read RtScene alone, so they keep the instructions they
// had before there was a top level.
struct RtInstScene : RtScene {
  const float* inst_boxes;  // (n_inst, 6) padded world boxes, table order
  const float* inst_roots;  // (n_inst_roots, 6); root q = boxes [32q, 32q+32)
  const float* inst_xform;  // (n_inst, RT_INST_XFORM) [world->object | normal]
  const int* inst_info;     // (n_inst, RT_INST_INFO), RtInstInfo fields
  int n_inst, n_inst_roots;
};

// The scene a walk reads.
template <int WALK>
struct RtSceneOf {
  typedef RtScene type;
};
template <>
struct RtSceneOf<RT_WALK_INSTANCES> {
  typedef RtInstScene type;
};

#define RT_SUPER_CLUSTERS 32
// Per instance: float [world->object 3x4 row-major | normal 3x3 row-major]
// and int RtInstInfo (scene.INST_XFORM, scene.INST_INFO).
#define RT_INST_XFORM 21
#define RT_INST_INFO 9
enum RtInstInfo {
  RT_INST_TRI = 0,      // offset of the BLAS's triangles in tri / norm
  RT_INST_CLUSTER = 1,  // of its cluster boxes
  RT_INST_SUB = 2,      // of its sub boxes
  RT_INST_SUPER = 3,    // of its super boxes
  RT_INST_N_SUPERS = 4,
  RT_INST_N_CLUSTERS = 5,
  RT_INST_SPC = 6,      // subs a cluster
  RT_INST_KEY = 7,      // key base: the key of the BLAS's triangle 0
  RT_INST_FLIP = 8      // 1 where the transform mirrors
};

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

// The walk WALK (flat, supers or roots) of one mesh's tables for the ray
// (o, d), r its operands: each triangle of an opened sub that the ray
// meets on [tmin, best_t] from the side `front` names replaces the best
// on the pair compare of (t, key + its table index). With any_hit the
// walk ends at the first accepted triangle (best_i >= 0 then).
template <int WALK>
__device__ __forceinline__ void rt_walk_mesh(
    const RtScene& sc, const RtRayOps& r, float ox, float oy, float oz,
    float dx, float dy, float dz, bool front, float tmin, bool any_hit,
    int key, float& best_t, int& best_i, float& best_u, float& best_v) {
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
          (t < best_t || (t == best_t && key + k < best_i))) {
        best_t = t;
        best_i = key + k;
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
}

// Closest hit of ray (o, d). cull = +1 accepts front faces (det > 0),
// -1 back faces (det < 0), 0 is a dead ray (a miss). With any_hit the
// walk stops at the first accepted triangle and idx/normal are not
// resolved (idx = 0 on a hit): the depth-cap round only needs hit or
// miss. WALK must be RT_WALK_INSTANCES for a two-level scene (sc.n_inst
// > 0; idx is then the winner's key), else RT_WALK_ROOTS when
// sc.n_roots > 0 (at most 32), else RT_WALK_SUPERS when sc.n_supers > 0,
// else RT_WALK_FLAT.
template <int WALK>
__device__ __forceinline__ RtHit rt_closest_hit(
    const typename RtSceneOf<WALK>::type& sc, float ox, float oy, float oz, float dx, float dy,
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

  if constexpr (WALK == RT_WALK_INSTANCES) {
    int best_j = -1;  // the winner's instance (table slot)
    auto visit_instance = [&](int j) -> bool {
      const float* x = sc.inst_xform + RT_INST_XFORM * j;
      const int* b = sc.inst_info + RT_INST_INFO * j;
      const float lox = __ldg(x + 0) * ox + __ldg(x + 1) * oy +
                        __ldg(x + 2) * oz + __ldg(x + 3);
      const float loy = __ldg(x + 4) * ox + __ldg(x + 5) * oy +
                        __ldg(x + 6) * oz + __ldg(x + 7);
      const float loz = __ldg(x + 8) * ox + __ldg(x + 9) * oy +
                        __ldg(x + 10) * oz + __ldg(x + 11);
      const float ldx = __ldg(x + 0) * dx + __ldg(x + 1) * dy +
                        __ldg(x + 2) * dz;
      const float ldy = __ldg(x + 4) * dx + __ldg(x + 5) * dy +
                        __ldg(x + 6) * dz;
      const float ldz = __ldg(x + 8) * dx + __ldg(x + 9) * dy +
                        __ldg(x + 10) * dz;
      const int tri0 = __ldg(b + RT_INST_TRI);
      const RtScene blas{sc.supers + 6 * __ldg(b + RT_INST_SUPER),
                         sc.clusters + 6 * __ldg(b + RT_INST_CLUSTER),
                         sc.subs + 6 * __ldg(b + RT_INST_SUB),
                         sc.tri + 9 * tri0,
                         sc.norm + 9 * tri0,
                         __ldg(b + RT_INST_N_SUPERS),
                         __ldg(b + RT_INST_N_CLUSTERS),
                         __ldg(b + RT_INST_SPC),
                         sc.sub_tris};
      const RtRayOps lr{lox, loy, loz, rt_safe_inv(ldx), rt_safe_inv(ldy),
                        rt_safe_inv(ldz), tmin};
      const int before = best_i;
      rt_walk_mesh<RT_WALK_SUPERS>(
          blas, lr, lox, loy, loz, ldx, ldy, ldz,
          front != (__ldg(b + RT_INST_FLIP) != 0), tmin, any_hit,
          __ldg(b + RT_INST_KEY), best_t, best_i, best_u, best_v);
      if (best_i != before) best_j = j;
      // any_hit: the first accepted triangle ends the whole walk.
      return any_hit && best_i >= 0;
    };
    auto visit_instance_root = [&](int q) -> bool {
      const int first = q * RT_SUPER_CLUSTERS;
      return rt_near_to_far(sc.inst_boxes, first,
                            min(RT_SUPER_CLUSTERS, sc.n_inst - first), r,
                            best_t, visit_instance);
    };
    if (sc.n_inst_roots > 0) {
      for (int g = 0; g < sc.n_inst_roots; g += RT_SUPER_CLUSTERS)
        if (rt_near_to_far(sc.inst_roots, g,
                           min(RT_SUPER_CLUSTERS, sc.n_inst_roots - g), r,
                           best_t, visit_instance_root))
          break;
    } else {  // at most 32 instances, no roots (scene.box_runs)
      rt_near_to_far(sc.inst_boxes, 0, sc.n_inst, r, best_t, visit_instance);
    }
    if (best_i >= 0) {
      h.t = best_t;
      if (any_hit) {
        h.idx = 0;
        return h;
      }
      const int* b = sc.inst_info + RT_INST_INFO * best_j;
      const float* n = sc.norm + 9 * (__ldg(b + RT_INST_TRI) + best_i -
                                      __ldg(b + RT_INST_KEY));
      const float n0 = __ldg(n + 0) + best_u * __ldg(n + 3) + best_v * __ldg(n + 6);
      const float n1 = __ldg(n + 1) + best_u * __ldg(n + 4) + best_v * __ldg(n + 7);
      const float n2 = __ldg(n + 2) + best_u * __ldg(n + 5) + best_v * __ldg(n + 8);
      const float* m = sc.inst_xform + RT_INST_XFORM * best_j + 12;
      h.idx = best_i;
      h.nx = __ldg(m + 0) * n0 + __ldg(m + 1) * n1 + __ldg(m + 2) * n2;
      h.ny = __ldg(m + 3) * n0 + __ldg(m + 4) * n1 + __ldg(m + 5) * n2;
      h.nz = __ldg(m + 6) * n0 + __ldg(m + 7) * n1 + __ldg(m + 8) * n2;
    }
  } else {
    rt_walk_mesh<WALK>(sc, r, ox, oy, oz, dx, dy, dz, front, tmin, any_hit,
                       0, best_t, best_i, best_u, best_v);
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
  }
  return h;
}
