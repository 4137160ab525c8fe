// Closest-hit traversal of one ray: the device function shared by the
// closest-hit kernel (closest_hit.cu) and the frame kernel (frame.cu).
//
// Replaces refraction_tpu/kernels/intersect_pallas.py::traverse_tile
// (388-1290), which traces an (8,128) tile of rays at once over a 3-level
// box hierarchy with bitmask-gated visits. Here one thread walks one ray:
//
//   for each cluster c in ascending table order:
//     slab test of its box against [tmin, best_t]
//     for each sub box of `sub_tris` triangles in the cluster, ascending:
//       slab test against [tmin, best_t]
//       Möller–Trumbore on each triangle, ascending
//
// Ascending order plus the strict `t < best_t` update reproduces the
// reference's argmin-first tie rule (ops/intersect.py), so `idx` indexes
// the same table order as the oracle. best_t starts at the float after
// tmax, which makes the range test inclusive (t <= tmax), as the oracle's
// is. The slab test is inclusive (enter <= leave) with |d| clamped to
// 1e-30, so zero-thickness boxes (axis-aligned faces) stay visible.
//
// Bound on the H100: the walk is latency-bound (dependent global loads of
// box and triangle rows, divergent visit sets across a warp), not
// arithmetic-bound. The tables are small and read-only, so the design
// leans on L1/L2 and __ldg; the cluster level skips whole 8*cs-byte
// blocks of triangles for most rays. Ordering clusters near-to-far (the
// TPU path's per-frame permutation) is deliberately not ported: without
// it the winner index needs no remapping.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

struct RtHit {
  float t;    // winner's distance; +inf on a miss
  int idx;    // winner's triangle index in table order; -1 on a miss
  float nx, ny, nz;  // unnormalized interpolated shading normal
};

__device__ __forceinline__ float rt_safe_inv(float c) {
  const float mag = fmaxf(fabsf(c), 1e-30f);
  return c < 0.0f ? -1.0f / mag : 1.0f / mag;
}

// Conservative ray/box overlap on [tmin, tmax]; b = [lo xyz | hi xyz].
__device__ __forceinline__ bool rt_slab(const float* __restrict__ b,
                                        float ox, float oy, float oz,
                                        float ix, float iy, float iz,
                                        float tmin, float tmax) {
  const float ax = (__ldg(b + 0) - ox) * ix, bx = (__ldg(b + 3) - ox) * ix;
  const float ay = (__ldg(b + 1) - oy) * iy, by = (__ldg(b + 4) - oy) * iy;
  const float az = (__ldg(b + 2) - oz) * iz, bz = (__ldg(b + 5) - oz) * iz;
  const float enter = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)),
                            fmaxf(fminf(az, bz), tmin));
  const float leave = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)),
                            fminf(fmaxf(az, bz), tmax));
  return enter <= leave;
}

// Closest hit of ray (o, d). cull = +1 accepts front faces (det > 0),
// -1 back faces (det < 0). With any_hit the walk stops at the first
// accepted triangle and idx/normal are not resolved (idx = 0 on a hit):
// the depth-cap round only needs hit or miss.
__device__ __forceinline__ RtHit rt_closest_hit(
    const float* __restrict__ tri, const float* __restrict__ norm,
    const float* __restrict__ clusters, const float* __restrict__ subs,
    int n_clusters, int cluster_size, int sub_tris,
    float ox, float oy, float oz, float dx, float dy, float dz,
    float cull, float tmin, float tmax, bool any_hit) {
  RtHit h;
  h.t = CUDART_INF_F;
  h.idx = -1;
  h.nx = 0.0f; h.ny = 0.0f; h.nz = 0.0f;
  if (cull == 0.0f) return h;

  const float ix = rt_safe_inv(dx), iy = rt_safe_inv(dy), iz = rt_safe_inv(dz);
  const bool front = cull > 0.0f;
  const int subs_per_cluster = cluster_size / sub_tris;
  float best_t = nextafterf(tmax, CUDART_INF_F);
  int best_i = -1;
  float best_u = 0.0f, best_v = 0.0f;

  for (int c = 0; c < n_clusters; ++c) {
    if (!rt_slab(clusters + 6 * c, ox, oy, oz, ix, iy, iz, tmin, best_t))
      continue;
    const int s_end = (c + 1) * subs_per_cluster;
    for (int s = c * subs_per_cluster; s < s_end; ++s) {
      if (!rt_slab(subs + 6 * s, ox, oy, oz, ix, iy, iz, tmin, best_t))
        continue;
      const int k_end = (s + 1) * sub_tris;
      for (int k = s * sub_tris; k < k_end; ++k) {
        const float* p = tri + 9 * k;
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
            t < best_t) {
          best_t = t;
          best_i = k;
          best_u = u;
          best_v = v;
          if (any_hit) {
            h.t = t;
            h.idx = 0;
            return h;
          }
        }
      }
    }
  }
  if (best_i >= 0) {
    const float* n = norm + 9 * best_i;
    h.t = best_t;
    h.idx = best_i;
    h.nx = __ldg(n + 0) + best_u * __ldg(n + 3) + best_v * __ldg(n + 6);
    h.ny = __ldg(n + 1) + best_u * __ldg(n + 4) + best_v * __ldg(n + 7);
    h.nz = __ldg(n + 2) + best_u * __ldg(n + 5) + best_v * __ldg(n + 8);
  }
  return h;
}
