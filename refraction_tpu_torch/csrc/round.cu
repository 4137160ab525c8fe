// One wavefront bounce round: closest hit, env radiance for misses, and the
// ClosestHit shading that emits the children, one thread per lane.
//
// Replaces refraction_tpu/kernels/megakernel.py::mega_round (pallas_call at
// 232) and its kernel bodies _mega_kernel (43), _mega_kernel_norefl (266)
// and _mega_kernel_missonly (282), as one kernel templated on the variant:
//
//   RT_ROUND_FULL      radiance + refraction child + reflection child
//   RT_ROUND_CHILDREN  radiance + refraction child
//   RT_ROUND_RADIANCE  radiance only (the depth-cap round; hits add black)
//
// Lane state is SoA, eight float32 rows of length W in one (8, W) tensor:
// ox oy oz dx dy dz cull wgt, with cull = +1 outside, -1 inside, 0 dead.
// Per lane:
//   rad   = wgt * env[texel(d)] on a live miss, else 0      -> rad (W, 3)
//   refraction child (lane i of the next state):
//     o = hit point (o where there is no hit), d = refract(d, n', eta),
//     cull = -cull, wgt = wgt * (1 - R); dead (cull 0, wgt 0,
//     d = (0, 1, 0)) on TIR, a miss or a dead parent
//   reflection child (lane W + i), full variant only:
//     d = reflect(d, n'), cull = cull, wgt = wgt * R, alive on EVERY hit,
//     TIR included; its liveness comes from the hit, never from the weight,
//     which may underflow to 0 (megakernel.py:185-190)
// The next state is (8, W_out) with W_out = 2W (full) or W (children), so
// the host does no concatenation: the JAX integrator's
// concatenate([refraction, reflection]) layout is written in place.
//
// The TPU kernel's layouts are dropped: the (rows, 128) tiling, the
// 1024-lane padding and GROUP, the roll-tree tile gates and env_packed.
// W may be any length >= 0; the map is the float32 (H, W, 3) envmap.
// eta = 1/ior is computed in float32 from the float32 ior, as the JAX
// kernel does.
//
// Bound on the H100: traversal latency (dependent table loads, divergent
// visit sets across a warp) in the early rounds; in the late rounds most
// lanes are dead, and the round is bound by its state traffic: 32 bytes
// read and up to 12 + 64 bytes written per lane. This first version is the
// plain mapping (128-thread blocks, state straight from global memory);
// compacting live lanes is later work. The traversal is traverse_f2b.cuh's,
// in its flat or supers instance as the scene has super boxes or not.

#include <cuda_runtime.h>

#include "envmap.cuh"
#include "shade.cuh"
#include "traverse_f2b.cuh"

enum RtRoundVariant { RT_ROUND_FULL = 0, RT_ROUND_CHILDREN = 1,
                      RT_ROUND_RADIANCE = 2 };

template <int V, int WALK>
__global__ void __launch_bounds__(128) rt_round_kernel(
    float tmin, float tmax, float ior, float r0,
    const float* __restrict__ tri, const float* __restrict__ norm,
    const float* __restrict__ supers, const float* __restrict__ clusters,
    const float* __restrict__ subs, const float* __restrict__ env,
    const float* __restrict__ state, int w, float* __restrict__ rad,
    float* __restrict__ next, int n_supers, int n_clusters, int cluster_size,
    int sub_tris, int env_h, int env_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const size_t W = (size_t)w;
  const float ox = state[i], oy = state[W + i], oz = state[2 * W + i];
  const float dx = state[3 * W + i], dy = state[4 * W + i],
              dz = state[5 * W + i];
  const float cull = state[6 * W + i], wgt = state[7 * W + i];

  // Dead lanes (cull == 0) come back as a miss with idx -1.
  const RtScene scene{supers, clusters, subs, tri, norm, n_supers,
                      n_clusters, cluster_size / sub_tris, sub_tris};
  const RtHit h = rt_closest_hit<WALK>(scene, ox, oy, oz, dx, dy, dz, cull,
                                       tmin, tmax, V == RT_ROUND_RADIANCE);
  const bool hit = h.idx >= 0;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (cull != 0.0f && !hit && wgt > 0.0f) {  // miss shader (hlsl:127-137)
    const int f = rt_env_texel(dx, dy, dz, env_h, env_w);
    cr = wgt * __ldg(env + 3 * f);
    cg = wgt * __ldg(env + 3 * f + 1);
    cb = wgt * __ldg(env + 3 * f + 2);
  }
  rad[3 * (size_t)i] = cr;
  rad[3 * (size_t)i + 1] = cg;
  rad[3 * (size_t)i + 2] = cb;
  if (V == RT_ROUND_RADIANCE) return;

  // Children. Defaults: a dead ray at the parent's origin pointing +y.
  const size_t WO = V == RT_ROUND_FULL ? 2 * W : W;
  float hx = ox, hy = oy, hz = oz;
  float3 tr = make_float3(0.0f, 1.0f, 0.0f), fl = tr;
  float t_cull = 0.0f, t_wgt = 0.0f, f_cull = 0.0f, f_wgt = 0.0f;
  if (hit) {
    const bool outside = cull > 0.0f;
    const RtSurface sf = rt_surface(h, ox, oy, oz, dx, dy, dz, outside);
    const float fres = rt_fresnel(sf, r0 * (1.0f - r0));
    hx = sf.hx; hy = sf.hy; hz = sf.hz;
    if (rt_refract(sf, dx, dy, dz, outside ? 1.0f / ior : ior, &tr)) {
      t_cull = -cull;
      t_wgt = wgt * (1.0f - fres);
    }
    if (V == RT_ROUND_FULL) {
      fl = rt_reflect(sf, dx, dy, dz);
      f_cull = cull;
      f_wgt = wgt * fres;
    }
  }
  const float ts[8] = {hx, hy, hz, tr.x, tr.y, tr.z, t_cull, t_wgt};
#pragma unroll
  for (int k = 0; k < 8; ++k) next[k * WO + i] = ts[k];
  if (V == RT_ROUND_FULL) {
    const float fs[8] = {hx, hy, hz, fl.x, fl.y, fl.z, f_cull, f_wgt};
#pragma unroll
    for (int k = 0; k < 8; ++k) next[k * WO + W + i] = fs[k];
  }
}

// rad: (w, 3). next: (8, 2w) for the full variant, (8, w) for children
// only, unused (may be null) for radiance only. Returns a cudaError_t.
extern "C" int rt_round(float tmin, float tmax, float ior, float r0,
                        const float* tri, const float* norm,
                        const float* supers, const float* clusters,
                        const float* subs, const float* env,
                        const float* state, int w, float* rad, float* next,
                        int variant, int n_supers, int n_clusters,
                        int cluster_size, int sub_tris, int env_h, int env_w,
                        void* stream) {
  if (w <= 0) return 0;
  const int block = 128;
  const int grid = (w + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
#define RT_ROUND_LAUNCH(V)                                                  \
  if (n_supers > 0)                                                         \
    RT_ROUND_LAUNCH_WALK(V, RT_WALK_SUPERS);                                \
  else                                                                      \
    RT_ROUND_LAUNCH_WALK(V, RT_WALK_FLAT)
#define RT_ROUND_LAUNCH_WALK(V, WALK)                                       \
  rt_round_kernel<V, WALK><<<grid, block, 0, s>>>(                          \
      tmin, tmax, ior, r0, tri, norm, supers, clusters, subs, env, state,   \
      w, rad, next, n_supers, n_clusters, cluster_size, sub_tris, env_h,     \
      env_w)
  switch (variant) {
    case RT_ROUND_FULL: RT_ROUND_LAUNCH(RT_ROUND_FULL); break;
    case RT_ROUND_CHILDREN: RT_ROUND_LAUNCH(RT_ROUND_CHILDREN); break;
    case RT_ROUND_RADIANCE: RT_ROUND_LAUNCH(RT_ROUND_RADIANCE); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_ROUND_LAUNCH
#undef RT_ROUND_LAUNCH_WALK
  return (int)cudaGetLastError();
}
