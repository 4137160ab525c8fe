// One wavefront bounce round: closest hit, env radiance for misses, and the
// ClosestHit shading that emits the children, one thread per lane.
//
// Replaces refraction_tpu/kernels/megakernel.py::mega_round (pallas_call at
// 232) and its kernel bodies _mega_kernel (43), _mega_kernel_norefl (266)
// and _mega_kernel_missonly (282), as one lane body templated on the
// variant:
//
//   RT_ROUND_FULL      radiance + refraction child + reflection child
//   RT_ROUND_CHILDREN  radiance + refraction child
//   RT_ROUND_RADIANCE  radiance only (the depth-cap round; hits add black)
//
// Lane state is SoA, eight float32 rows of a common row length (the
// stride): ox oy oz dx dy dz cull wgt, with cull = +1 outside, -1 inside,
// 0 dead. Per lane (rt_round_lane):
//   rad   = wgt * env[texel(d)] on a live miss, else 0
//   refraction child: o = hit point (o where there is no hit),
//     d = refract(d, n', eta), cull = -cull, wgt = wgt * (1 - R); dead
//     (cull 0, wgt 0, d = (0, 1, 0)) on TIR, a miss or a dead parent
//   reflection child, full variant only: d = reflect(d, n'), cull = cull,
//     wgt = wgt * R, alive on EVERY hit, TIR included; its liveness comes
//     from the hit, never from the weight, which may underflow to 0
//     (megakernel.py:185-190)
//
// The lane body runs under two output layouts:
//
//   static (rt_round_kernel, entry rt_round; the JAX mega_round's layout):
//     W lanes in, every lane out: rad (W, 3) at i, and the next state
//     (8, W_out), W_out = 2W (full) or W (children), with the refraction
//     child of lane i at i and its reflection child at W + i, dead or
//     alive: the JAX integrator's concatenate([refraction, reflection]).
//   compacted (rt_round_queue_kernel, entry rt_round_queue): a queue of
//     `count` live lanes, each with its slot id, its index in the static
//     layout above (pixel = slot % N, j = slot / N its place among the
//     pixel's lanes). The round's miss radiance reaches the (N, 3) running
//     radiance as the static layout's per-pixel sum (below), and only
//     live children are appended to the next queue: the refraction child
//     keeps slot s, the reflection child takes s + W (W = the round's
//     static width), their static positions. The kernel reads `count` from
//     device memory, so the host never waits for it.
//
// The TPU kernel's layouts are dropped: the (rows, 128) tiling, the
// 1024-lane padding and GROUP, the roll-tree tile gates and env_packed.
// The map is the float32 (H, W, 3) envmap. eta = 1/ior is computed in
// float32 from the float32 ior, as the JAX kernel does.
//
// Bound on the H100: traversal latency (dependent table loads, divergent
// visit sets across a warp) while many lanes live; the static layout then
// spends its late rounds on dead lanes, each still reading 32 bytes of
// state and writing 12 + 64. The compacted layout moves only live lanes:
// 36 bytes in, 12 of radiance and 36 per live child out, and a round with
// no live lane is a launch whose warps exit at once. Children are
// appended with one atomicAdd per warp (ballots give each lane its
// offset), so a warp's children land contiguously and the writes stay
// coalesced. The traversal is traverse_f2b.cuh's, in its flat, supers or
// roots instance as the scene has super boxes, root boxes, or neither.
//
// A pixel's misses are summed in slot order, whatever the queue order. The
// static layout adds a round to the running radiance as
//   radiance + (((0 + r_0) + r_1) + ... + r_(J-1)),   J = W / N,
// with r_j the radiance at slot j*N + pixel, +0.0 on a dead lane, a hit or
// a miss of weight 0. Where a round has one lane per pixel (W <= N, round
// 0) the queued lane adds its radiance to the running radiance itself: no
// other lane touches the pixel. Elsewhere a missing lane of weight > 0
// stores its radiance at slab[slot] (a (W, 3) scratch, written only there,
// never zeroed) and sets bit j of mask[pixel] with atomicOr; then
// rt_fold_round_kernel, one thread per pixel, adds the slab entries of the
// set bits to +0.0 in ascending j, adds that sum to the running radiance
// and clears the mask. No float goes through an atomic, so the sum is the
// same on every run and subnormals are kept. Skipping an unset slot equals
// the static layout's adding its +0.0: a sum that starts at +0.0 is never
// -0.0 (x + y is -0.0 only when both are), and x + (+0.0) == x for every
// other x, so neither the round sum nor the running radiance can tell.
// (The radiance itself is never -0.0 either: a weight > 0 times a map
// texel >= 0.) A pixel with no bit set keeps its radiance: r + (+0.0).

#include <cuda_runtime.h>

#include "envmap.cuh"
#include "shade.cuh"
#include "traverse_f2b.cuh"

enum RtRoundVariant { RT_ROUND_FULL = 0, RT_ROUND_CHILDREN = 1,
                      RT_ROUND_RADIANCE = 2 };

// What a round reads besides the lane state.
struct RtRoundArgs {
  RtScene scene;
  const float* env;
  int env_h, env_w;
  float tmin, tmax, ior, r0;
};

// One lane's results. A dead child has cull 0, weight 0, d = (0, 1, 0).
struct RtLaneOut {
  float cr, cg, cb;    // weighted env radiance of a live miss, else 0
  bool missed;         // a live miss of weight > 0: cr cg cb are its radiance
  float hx, hy, hz;    // the children's origin: the hit point, else o
  float3 tr, fl;       // refraction / reflection directions
  float t_cull, t_wgt, f_cull, f_wgt;
};

// The round's work for lane i of an SoA state of row length `stride`.
template <int V, int WALK>
__device__ __forceinline__ RtLaneOut rt_round_lane(const RtRoundArgs& a,
                                                   const float* state,
                                                   size_t stride, int i) {
  const float ox = state[i], oy = state[stride + i],
              oz = state[2 * stride + i];
  const float dx = state[3 * stride + i], dy = state[4 * stride + i],
              dz = state[5 * stride + i];
  const float cull = state[6 * stride + i], wgt = state[7 * stride + i];

  RtLaneOut r;
  // Dead lanes (cull == 0) come back as a miss with idx -1.
  const RtHit h = rt_closest_hit<WALK>(a.scene, ox, oy, oz, dx, dy, dz, cull,
                                       a.tmin, a.tmax,
                                       V == RT_ROUND_RADIANCE);
  const bool hit = h.idx >= 0;
  r.cr = r.cg = r.cb = 0.0f;
  r.missed = cull != 0.0f && !hit && wgt > 0.0f;
  if (r.missed) {  // miss shader (hlsl:127-137)
    const int f = rt_env_texel(dx, dy, dz, a.env_h, a.env_w);
    r.cr = wgt * __ldg(a.env + 3 * f);
    r.cg = wgt * __ldg(a.env + 3 * f + 1);
    r.cb = wgt * __ldg(a.env + 3 * f + 2);
  }
  // Children. Defaults: a dead ray at the parent's origin pointing +y.
  r.hx = ox; r.hy = oy; r.hz = oz;
  r.tr = make_float3(0.0f, 1.0f, 0.0f);
  r.fl = r.tr;
  r.t_cull = r.t_wgt = r.f_cull = r.f_wgt = 0.0f;
  if (V == RT_ROUND_RADIANCE || !hit) return r;
  const bool outside = cull > 0.0f;
  const RtSurface sf = rt_surface(h, ox, oy, oz, dx, dy, dz, outside);
  const float fres = rt_fresnel(sf, a.r0 * (1.0f - a.r0));
  r.hx = sf.hx; r.hy = sf.hy; r.hz = sf.hz;
  if (rt_refract(sf, dx, dy, dz, outside ? 1.0f / a.ior : a.ior, &r.tr)) {
    r.t_cull = -cull;
    r.t_wgt = wgt * (1.0f - fres);
  }
  if (V == RT_ROUND_FULL) {
    r.fl = rt_reflect(sf, dx, dy, dz);
    r.f_cull = cull;
    r.f_wgt = wgt * fres;
  }
  return r;
}

__device__ __forceinline__ void rt_put_lane(float* state, size_t stride,
                                            size_t i, float hx, float hy,
                                            float hz, float3 d, float cull,
                                            float wgt) {
  const float v[8] = {hx, hy, hz, d.x, d.y, d.z, cull, wgt};
#pragma unroll
  for (int k = 0; k < 8; ++k) state[k * stride + i] = v[k];
}

// Static layout: lane i of w; rad (w, 3); next (8, 2w) | (8, w) | unused.
template <int V, int WALK>
__global__ void __launch_bounds__(128) rt_round_kernel(
    RtRoundArgs a, const float* __restrict__ state, int w,
    float* __restrict__ rad, float* __restrict__ next) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= w) return;
  const size_t W = (size_t)w;
  const RtLaneOut r = rt_round_lane<V, WALK>(a, state, W, i);
  rad[3 * (size_t)i] = r.cr;
  rad[3 * (size_t)i + 1] = r.cg;
  rad[3 * (size_t)i + 2] = r.cb;
  if (V == RT_ROUND_RADIANCE) return;
  const size_t WO = V == RT_ROUND_FULL ? 2 * W : W;
  rt_put_lane(next, WO, i, r.hx, r.hy, r.hz, r.tr, r.t_cull, r.t_wgt);
  if (V == RT_ROUND_FULL)
    rt_put_lane(next, WO, W + i, r.hx, r.hy, r.hz, r.fl, r.f_cull, r.f_wgt);
}

// Compacted layout: the first *count lanes of an SoA state of row length
// cap, with their slots (distinct and below `width`). Miss radiance: where
// width <= n_pix, added to rad (n_pix, 3) at the lane's pixel; elsewhere
// stored at slab (width, 3) row `slot` with bit slot / n_pix of
// mask[pixel] set, for rt_fold_round_kernel (see the header). Live lanes
// are counted into pixel_rays (n_pix,) when it is not null; live children
// are appended to next (8, next_cap) / next_slot / *next_count.
// A warp-uniform loop over the queue in steps of the grid's threads.
template <int V, int WALK>
__global__ void __launch_bounds__(128) rt_round_queue_kernel(
    RtRoundArgs a, const float* __restrict__ state,
    const int* __restrict__ slot, const int* __restrict__ count_in, int cap,
    int width, int n_pix, float* __restrict__ rad, float* __restrict__ slab,
    int* __restrict__ mask, int* __restrict__ pixel_rays,
    float* __restrict__ next, int* __restrict__ next_slot,
    int* __restrict__ next_count, int next_cap) {
  const int count = *count_in;
  const bool lone = width <= n_pix;  // at most one lane per pixel
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int step = gridDim.x * blockDim.x;
  for (int first = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       first < count; first += step) {
    const int i = first + lane;
    const bool valid = i < count;
    RtLaneOut r{};
    int s = 0;
    if (valid) {
      s = slot[i];
      r = rt_round_lane<V, WALK>(a, state, (size_t)cap, i);
      const int p = s % n_pix;
      if (r.missed && lone) {
        float* dst = rad + 3 * (size_t)p;
        dst[0] += r.cr;
        dst[1] += r.cg;
        dst[2] += r.cb;
      } else if (r.missed) {
        float* dst = slab + 3 * (size_t)s;
        dst[0] = r.cr;
        dst[1] = r.cg;
        dst[2] = r.cb;
        atomicOr(mask + p, (int)(1u << (s / n_pix)));
      }
      if (pixel_rays != nullptr) atomicAdd(pixel_rays + p, 1);
    }
    if (V == RT_ROUND_RADIANCE) continue;
    const bool t_live = valid && r.t_cull != 0.0f;
    const bool f_live = V == RT_ROUND_FULL && valid && r.f_cull != 0.0f;
    const unsigned mt = __ballot_sync(0xffffffffu, t_live);
    const unsigned mf = __ballot_sync(0xffffffffu, f_live);
    const int nt = __popc(mt), total = nt + __popc(mf);
    if (total == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(next_count, total);
    base = __shfl_sync(0xffffffffu, base, 0);
    // A count past the capacity is a fault the caller sees in next_count;
    // nothing is written past the buffers.
    const int pt = base + __popc(mt & below);
    const int pf = base + nt + __popc(mf & below);
    if (t_live && pt < next_cap) {
      rt_put_lane(next, (size_t)next_cap, pt, r.hx, r.hy, r.hz, r.tr,
                  r.t_cull, r.t_wgt);
      next_slot[pt] = s;
    }
    if (f_live && pf < next_cap) {
      rt_put_lane(next, (size_t)next_cap, pf, r.hx, r.hy, r.hz, r.fl,
                  r.f_cull, r.f_wgt);
      next_slot[pf] = s + width;
    }
  }
}

// The round sum of a compacted round of more than one lane per pixel: per
// pixel p with mask[p] != 0, the slab rows j * n_pix + p of the set bits j
// added to +0.0 in ascending j, that sum added to rad[p], the mask cleared.
__global__ void __launch_bounds__(256) rt_fold_round_kernel(
    const float* __restrict__ slab, int* __restrict__ mask, int n_pix,
    float* __restrict__ rad) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  unsigned m = (unsigned)mask[p];
  if (m == 0u) return;
  mask[p] = 0;
  float sr = 0.0f, sg = 0.0f, sb = 0.0f;
  while (m != 0u) {
    const int j = __ffs(m) - 1;
    m &= m - 1u;
    const float* src = slab + 3 * ((size_t)j * n_pix + p);
    sr += src[0];
    sg += src[1];
    sb += src[2];
  }
  float* dst = rad + 3 * (size_t)p;
  dst[0] += sr;
  dst[1] += sg;
  dst[2] += sb;
}

static RtRoundArgs rt_round_args(float tmin, float tmax, float ior, float r0,
                                 const float* tri, const float* norm,
                                 const float* roots, const float* supers,
                                 const float* clusters, const float* subs,
                                 const float* env, int n_roots, int n_supers,
                                 int n_clusters, int cluster_size,
                                 int sub_tris, int env_h, int env_w) {
  return RtRoundArgs{
      RtScene{supers, clusters, subs, tri, norm, n_supers, n_clusters,
              cluster_size / sub_tris, sub_tris, roots, n_roots},
      env, env_h, env_w, tmin, tmax, ior, r0};
}

// Instantiates LAUNCH(V, WALK) for the scene's walk.
#define RT_ROUND_WALK(LAUNCH, V)                                             \
  if (n_roots > 0) LAUNCH(V, RT_WALK_ROOTS);                                 \
  else if (n_supers > 0) LAUNCH(V, RT_WALK_SUPERS);                          \
  else LAUNCH(V, RT_WALK_FLAT)

// Instantiates LAUNCH(V, WALK) for the variant and the scene's walk.
#define RT_ROUND_DISPATCH(LAUNCH)                                            \
  switch (variant) {                                                         \
    case RT_ROUND_FULL:                                                      \
      RT_ROUND_WALK(LAUNCH, RT_ROUND_FULL);                                  \
      break;                                                                 \
    case RT_ROUND_CHILDREN:                                                  \
      RT_ROUND_WALK(LAUNCH, RT_ROUND_CHILDREN);                              \
      break;                                                                 \
    case RT_ROUND_RADIANCE:                                                  \
      RT_ROUND_WALK(LAUNCH, RT_ROUND_RADIANCE);                              \
      break;                                                                 \
    default: return (int)cudaErrorInvalidValue;                              \
  }

// rad: (w, 3). next: (8, 2w) for the full variant, (8, w) for children
// only, unused (may be null) for radiance only. Returns a cudaError_t.
extern "C" int rt_round(float tmin, float tmax, float ior, float r0,
                        const float* tri, const float* norm,
                        const float* roots, const float* supers,
                        const float* clusters, const float* subs,
                        const float* env, const float* state, int w,
                        float* rad, float* next, int variant, int n_roots,
                        int n_supers, int n_clusters, int cluster_size,
                        int sub_tris, int env_h, int env_w, void* stream) {
  if (w <= 0) return 0;
  const RtRoundArgs a =
      rt_round_args(tmin, tmax, ior, r0, tri, norm, roots, supers, clusters,
                    subs, env, n_roots, n_supers, n_clusters, cluster_size,
                    sub_tris, env_h, env_w);
  const int block = 128;
  const int grid = (w + block - 1) / block;
  cudaStream_t s = (cudaStream_t)stream;
#define RT_ROUND_LAUNCH(V, WALK) \
  rt_round_kernel<V, WALK><<<grid, block, 0, s>>>(a, state, w, rad, next)
  RT_ROUND_DISPATCH(RT_ROUND_LAUNCH)
#undef RT_ROUND_LAUNCH
  return (int)cudaGetLastError();
}

// The compacted round over the queue (state (8, cap), slot (cap,), *count)
// of a round of static width `width` (<= cap). Where width <= n_pix the
// misses are added to rad (n_pix, 3) and slab and mask are unused (may be
// null); elsewhere they go to slab (>= width rows of 3) and mask (n_pix,
// all 0 on entry), and the caller runs rt_fold_round next. pixel_rays
// (n_pix,) counts when not null, and live children are appended
// to (next (8, next_cap), next_slot (next_cap,), *next_count) for the full
// and children variants (unused, may be null, for radiance only). One
// launch even when the queue is empty. The host does not know the count,
// so the grid covers `width` lanes, the most the queue can hold, up to
// `max_blocks` blocks (the caller passes 32 per SM: 4,224 on the H100);
// warps past the count exit at once. Measured against a grid of exactly
// `width` lanes (empty rounds then retire ~24 k blocks, ~0.02 ms) and an
// occupancy-sized grid (the grid-stride loop balances the divergent
// traversal worse: +10% at the large scene), this was fastest at both
// cells (PERF.md). Returns a cudaError_t.
extern "C" int rt_round_queue(float tmin, float tmax, float ior, float r0,
                              const float* tri, const float* norm,
                              const float* roots, const float* supers,
                              const float* clusters, const float* subs,
                              const float* env, const float* state,
                              const int* slot, const int* count, int cap,
                              int width, int n_pix, float* rad, float* slab,
                              int* mask, int* pixel_rays, float* next,
                              int* next_slot, int* next_count, int next_cap,
                              int variant, int n_roots, int n_supers,
                              int n_clusters, int cluster_size, int sub_tris,
                              int env_h, int env_w, int max_blocks,
                              void* stream) {
  if (max_blocks <= 0 || n_pix <= 0) return (int)cudaErrorInvalidValue;
  // One mask bit per lane of a pixel.
  if (width > n_pix &&
      (slab == nullptr || mask == nullptr || (width - 1) / n_pix >= 32))
    return (int)cudaErrorInvalidValue;
  const RtRoundArgs a =
      rt_round_args(tmin, tmax, ior, r0, tri, norm, roots, supers, clusters,
                    subs, env, n_roots, n_supers, n_clusters, cluster_size,
                    sub_tris, env_h, env_w);
  const int block = 128;
  const int full = width > block ? (width + block - 1) / block : 1;
  const int grid = full < max_blocks ? full : max_blocks;
  cudaStream_t s = (cudaStream_t)stream;
#define RT_QUEUE_LAUNCH(V, WALK)                                            \
  rt_round_queue_kernel<V, WALK><<<grid, block, 0, s>>>(                    \
      a, state, slot, count, cap, width, n_pix, rad, slab, mask,            \
      pixel_rays, next, next_slot, next_count, next_cap)
  RT_ROUND_DISPATCH(RT_QUEUE_LAUNCH)
#undef RT_QUEUE_LAUNCH
  return (int)cudaGetLastError();
}

// Folds the slab rows that mask (n_pix,) names into rad (n_pix, 3) and
// clears the mask (rt_fold_round_kernel). Returns a cudaError_t.
extern "C" int rt_fold_round(const float* slab, int* mask, int n_pix,
                             float* rad, void* stream) {
  if (n_pix <= 0) return 0;
  const int block = 256;
  rt_fold_round_kernel<<<(n_pix + block - 1) / block, block, 0,
                         (cudaStream_t)stream>>>(slab, mask, n_pix, rad);
  return (int)cudaGetLastError();
}
