// Closest-hit traversal of one ray by a group of G lanes of one warp: the
// device function of the frame kernel's group form (frame.cu
// rt_frame_group, rt_frame_tiles_group), an instrument on no main path.
// traverse_f2b.cuh walks a ray on one thread and stays the walk of the
// frame, closest-hit and round kernels.
//
// Replaces, with traverse_f2b.cuh, refraction_tpu/kernels/
// intersect_pallas.py::traverse_tile (388-1290) inside the frame kernel.
//
// Why a group: with one thread per ray, a ray is one dependent chain of
// loads, slab tests and Möller–Trumbore tests, and a warp executes the
// union of 32 independent walks. At the demo a frame ends on the chain of
// its slowest pixels (the sphere's centre tile alone takes 55% of the
// frame alone; PERF.md §6); at 1080p on 81,920 triangles the kernel sits at
// 12% of its operations bound. A group of G lanes cuts the chain by the
// box and triangle tests it runs side by side, and a warp carries 32 / G
// walks instead of 32. Measured (PERF.md §6 row 1): the chain fell about
// 2.2x at G = 8 and every frame took 2.4-3.8x longer, since the kernel is
// bound by the latency of its walks and an SM then holds 6-14x fewer.
//
// The group computes exactly what rt_closest_hit<WALK> computes, and
// visits the same boxes in the same order:
//
//   box groups, near to far (supers, their clusters, their subs; at most
//   32, 32 and 64 boxes): lane j slab-tests boxes j, j + G, ... once and
//   keeps their entry keys in registers (K = boxes / G each); the mask is
//   the test on [tmin, best_t] at the group's start, as rt_near_to_far's.
//   Each pick is the group's least (entry, index), two __reduce_min_sync:
//   the key, then the index among equal keys; the walk stops at the first
//   pick whose entry is past best_t. rt_near_to_far picks the same box
//   (strict < over ascending indices: equal entries go to the lowest
//   index) and recomputes every remaining entry on each pick; here no
//   entry is recomputed.
//
//   boxes in table order (the flat walk): G boxes at a time, each lane
//   keeps its box's entry and exit; a ballot gives the chunk's boxes that
//   overlap at the current best_t, and after each visit the later boxes
//   of the chunk are tested again at the lowered best_t (one ballot). So
//   each box is tested at the best_t of its turn, as rt_in_order does.
//
//   a sub: lane j runs Möller–Trumbore on triangles s * 8 + j, + G, ...
//   with traverse_f2b.cuh's arithmetic line for line (the library is
//   built with -fmad=false), keeps its least (t, index), and the group
//   takes the least (t, index) over its lanes; t, u and v come from the
//   winning lane (__shfl_sync). The pair compare against the running best
//   is the one-thread walk's. The least over a sub and then against the
//   best is the same pair as the one-thread walk's compare of one
//   triangle after the other, so every lane ends with that walk's best_t
//   and best_i, and the normal is computed from the same u and v.
//
// any_hit returns after the sub that holds an accepted triangle (the
// one-thread walk returns at that triangle): only hit or miss is resolved,
// and h.t is the sub's least t, not the first accepted one's.
//
// Order keys (rt_order_key): -0 folded onto +0 (x + 0), then the sign-flip
// (negatives: all bits inverted; the rest: the sign bit set), so unsigned
// order is float order for every float but NaN, and RT_NO_KEY sorts after
// every key. Entries are never NaN (fmaxf with tmin drops a NaN slab);
// a NaN t fails t >= tmin. kernels/framekernel.py holds the plain twin of
// the key and of the lane reduction (order_key, group_pair_min).
//
// Every lane of a group runs the same control flow on identical values:
// lane-dependent work (a lane's boxes and triangles) is predicated inside
// a loop and rejoins before each collective, and every collective names
// the group's lanes only (RtGroup::mask), never the whole warp, since the
// warp's 32 / G groups walk different rays.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "traverse_f2b.cuh"

#define RT_NO_KEY 0xffffffffu

// G consecutive lanes of a warp (G divides 32) that walk one ray.
template <int G>
struct RtGroup {
  unsigned mask;  // the group's lanes in the warp
  int base;       // its first lane
  int lane;       // this thread's lane in the group, 0..G-1
};

// The group of the calling thread; blockDim.x must be a multiple of 32
// and the block one-dimensional.
template <int G>
__device__ __forceinline__ RtGroup<G> rt_group() {
  static_assert(G >= 2 && G <= 32 && (32 % G) == 0, "G must divide 32");
  const int l = (int)(threadIdx.x & 31u);
  const int base = l & ~(G - 1);
  const unsigned lanes = G == 32 ? 0xffffffffu : ((1u << G) - 1u);
  return RtGroup<G>{lanes << base, base, l - base};
}

__device__ __forceinline__ unsigned rt_order_key(float x) {
  const unsigned b = __float_as_uint(x + 0.0f);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

// The group's ballot of pred, as bits 0..G-1.
template <int G>
__device__ __forceinline__ unsigned rt_group_ballot(const RtGroup<G>& g,
                                                    bool pred) {
  return (__ballot_sync(g.mask, pred) & g.mask) >> g.base;
}

// The least index among the group's lanes whose key equals the group's
// least key; key_min receives that key (RT_NO_KEY: no lane has one).
template <int G>
__device__ __forceinline__ int rt_group_argmin(const RtGroup<G>& g,
                                               unsigned key, int idx,
                                               unsigned* key_min) {
  const unsigned k = __reduce_min_sync(g.mask, key);
  *key_min = k;
  return (int)__reduce_min_sync(g.mask, key == k ? (unsigned)idx : RT_NO_KEY);
}

// Entry (clamped below at tmin, as rt_entry) and exit (not clamped above)
// of box b: rt_overlaps(b, r, tmax) is enter <= fminf(leave, tmax), since
// fminf is associative over non-NaN values and drops a NaN.
__device__ __forceinline__ void rt_slab(const float* b, const RtRayOps& r,
                                        float* enter, float* leave) {
  const float ax = (__ldg(b + 0) - r.ox) * r.ix, bx = (__ldg(b + 3) - r.ox) * r.ix;
  const float ay = (__ldg(b + 1) - r.oy) * r.iy, by = (__ldg(b + 4) - r.oy) * r.iy;
  const float az = (__ldg(b + 2) - r.oz) * r.iz, bz = (__ldg(b + 5) - r.oz) * r.iz;
  *enter = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                 fmaxf(fminf(az, bz), r.tmin));
  *leave = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
}

// rt_near_to_far for the group: boxes [first, first + n), n <= G * K.
template <int G, int K, typename Visit>
__device__ __forceinline__ bool rt_group_near_to_far(
    const RtGroup<G>& g, const float* boxes, int first, int n,
    const RtRayOps& r, const float& best_t, Visit&& visit) {
  unsigned key[K];  // entry key of box lane + G k; RT_NO_KEY: none or taken
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = g.lane + G * k;
    key[k] = RT_NO_KEY;
    if (i < n) {
      float enter, leave;
      rt_slab(boxes + 6 * (first + i), r, &enter, &leave);
      if (enter <= fminf(leave, best_t)) key[k] = rt_order_key(enter);
    }
  }
  for (;;) {
    unsigned mine = RT_NO_KEY;
    int mine_i = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (key[k] < mine) { mine = key[k]; mine_i = g.lane + G * k; }
    unsigned e;
    const int i = rt_group_argmin(g, mine, mine_i, &e);
    // No box left, or the nearest entry is past best_t (key order is
    // float order, so this is !(entry <= best_t)).
    if (e == RT_NO_KEY || e > rt_order_key(best_t)) return false;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (g.lane + G * k == i) key[k] = RT_NO_KEY;
    if (visit(first + i)) return true;
  }
}

// rt_in_order for the group: boxes [first, first + n) in table order, each
// tested at the best_t of its turn.
template <int G, typename Visit>
__device__ __forceinline__ bool rt_group_in_order(
    const RtGroup<G>& g, const float* boxes, int first, int n,
    const RtRayOps& r, const float& best_t, Visit&& visit) {
  for (int c = 0; c < n; c += G) {
    float enter = CUDART_INF_F, leave = -CUDART_INF_F;  // past the end
    if (c + g.lane < n)
      rt_slab(boxes + 6 * (first + c + g.lane), r, &enter, &leave);
    unsigned todo = rt_group_ballot(g, enter <= fminf(leave, best_t));
    while (todo) {
      const int j = __ffs(todo) - 1;
      if (visit(first + c + j)) return true;
      todo &= ~((2u << j) - 1u);  // the boxes after j
      if (todo) todo &= rt_group_ballot(g, enter <= fminf(leave, best_t));
    }
  }
  return false;
}

// rt_closest_hit<WALK> walked by the group g: every lane returns the same
// hit. WALK must be RT_WALK_SUPERS exactly when sc.n_supers > 0.
template <int G, int WALK>
__device__ __forceinline__ RtHit rt_group_closest_hit(
    const RtScene& sc, const RtGroup<G>& g, float ox, float oy, float oz,
    float dx, float dy, float dz, float cull, float tmin, float tmax,
    bool any_hit) {
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
    unsigned c_key = RT_NO_KEY;
    int c_i = 0;
    float c_t = 0.0f, c_u = 0.0f, c_v = 0.0f;
    const int k_first = s * sc.sub_tris, k_end = k_first + sc.sub_tris;
    for (int k = k_first + g.lane; k < k_end; k += G) {
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
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin) {
        const unsigned key = rt_order_key(t);
        if (key < c_key) {  // ascending k: equal t keeps the lowest index
          c_key = key; c_i = k; c_t = t; c_u = u; c_v = v;
        }
      }
    }
    unsigned key;
    const int k = rt_group_argmin(g, c_key, c_i, &key);
    if (key == RT_NO_KEY) return false;
    const int src = g.base + (k - k_first) % G;
    const float t = __shfl_sync(g.mask, c_t, src);
    const float u = __shfl_sync(g.mask, c_u, src);
    const float v = __shfl_sync(g.mask, c_v, src);
    if (t < best_t || (t == best_t && k < best_i)) {
      best_t = t;
      best_i = k;
      best_u = u;
      best_v = v;
      if (any_hit) return true;
    }
    return false;
  };
  auto visit_cluster = [&](int c) -> bool {
    if (WALK == RT_WALK_SUPERS) {
      for (int s = 0; s < sc.subs_per_cluster; s += 64)
        if (rt_group_near_to_far<G, 64 / G>(
                g, sc.subs, c * sc.subs_per_cluster + s,
                min(64, sc.subs_per_cluster - s), r, best_t, visit_sub))
          return true;
      return false;
    }
    return rt_group_in_order(g, sc.subs, c * sc.subs_per_cluster,
                             sc.subs_per_cluster, r, best_t, visit_sub);
  };
  auto visit_super = [&](int s) -> bool {
    const int first = s * RT_SUPER_CLUSTERS;
    return rt_group_near_to_far<G, RT_SUPER_CLUSTERS / G>(
        g, sc.clusters, first, min(RT_SUPER_CLUSTERS, sc.n_clusters - first),
        r, best_t, visit_cluster);
  };
  if (WALK == RT_WALK_SUPERS) {
    for (int s = 0; s < sc.n_supers; s += RT_SUPER_CLUSTERS)
      if (rt_group_near_to_far<G, RT_SUPER_CLUSTERS / G>(
              g, sc.supers, s, min(RT_SUPER_CLUSTERS, sc.n_supers - s), r,
              best_t, visit_super))
        break;
  } else {
    rt_group_in_order(g, sc.clusters, 0, sc.n_clusters, r, best_t,
                      visit_cluster);
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
