// Whole frame in one launch: raygen, the bounded refraction/reflection tree,
// closest hit, env miss radiance and the spp average, one thread per pixel.
//
// Replaces refraction_tpu/kernels/framekernel.py::frame_call (724-925,
// pallas_call at 917) and its kernel bodies _frame_kernel (106) and the
// layout variants _frame_kernel_coded (662), _frame_kernel_bcast (670),
// _frame_kernel_bcast_coded (678), _frame_kernel_streamed (686) and
// _frame_kernel_streamed_coded (697). The variants differ only in where the
// TPU keeps operands (scalar memory vs streamed records from HBM, coded vs
// float env, a broadcast triangle table); this kernel reads the float
// tables from global memory at any size, so it computes what all six do.
//
// The TPU kernel keeps a 32x32 tile's ray front in a VMEM slot pool and
// runs it level by level (widths 1, 2, 4, ...). On the H100 each thread
// runs its pixel's tree depth-first with an explicit stack of pending rays
// (origin, direction, weight, side, count): popping a ray traces it; a miss
// adds weight * env; a hit below the depth cap pushes the refraction child
// (weight * (1 - R), side flipped, none on TIR) and, while
// count < max_reflect, the reflection child (weight * R, same side, pushed
// on every hit, TIR included). Each branching level leaves at most one
// pending sibling, so the stack never holds more than
// min(max_reflect, max_refract) + 1 rays; the wrapper checks that against
// RT_MAX_STACK. The result is written straight into the (H, W, 3) image,
// times 1/spp. The shading is shade.cuh's, shared with the round kernel.
//
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700 W; bounds.py over the
// traversal work of the frame's rays): FP32 operations, not bytes. Demo
// (1,280 tris, 1024x768, 5/2 bounces): 1.85 G operations, 0.028 ms,
// against 35 MB, 0.010 ms; large (81,920 tris, 1920x1080, 4 bounces):
// 8.4 G operations, 0.125 ms, against 56 MB, 0.017 ms. The first version
// ran at 12% and 7% of those bounds: it slab-tested every cluster box of
// the table for every ray (160 at large) and opened far clusters, with all
// their subs and triangles, before the near hit could prune them.
//
// The design (PERF.md, PR 4, measured step by step): the traversal is
// traverse_f2b.cuh's, in three instances chosen at launch from the scene.
// Scenes with super boxes (more than 32 clusters) walk supers, their
// clusters and their subs near to far, so the nearest hit prunes what
// lies behind it; scenes of 33-1,024 supers (1,025-32,768 clusters) walk
// root boxes over runs of 32 supers above them, near to far too; smaller
// scenes walk their boxes in table order, where ordering cost more than
// it saved (the demo's 10 clusters of 16 subs). At
// scene.auto_cluster_size only meshes of up to 4,096 triangles (the
// demo's bands) build 32 clusters or fewer and walk flat, and meshes of
// 524,289-16,777,216 triangles walk roots; every other mesh walks
// supers. Measured and not kept: tables staged in shared
// memory (the demo tables fit in L1 already; 50-96 KB of shared memory per
// block cut the resident warps), a persistent grid pulling 16x2 or 16x8
// tiles from an atomic counter, and launch bounds that lift the register
// cap (95 registers without spills ran slower than 56 with 64 B of spills:
// fewer resident warps). The grid is one 16x8 block per 16x8 pixels, so a
// warp covers a compact 16x2 patch of similar rays; the stack lives in
// local memory (L1-resident).
//
// A group of 4 or 8 lanes walking each ray was measured and lost
// 2.4-3.8x at every cell (PERF.md §6 row 1): the kernel is bound by the
// latency of its walks, and a group keeps fewer walks in flight an SM.
//
// Pixel-DP (parallel/sharding.make_fused_sharded_renderer): the second
// entry, rt_frame_tiles, renders n_local global 32x32 tiles with ids
// j * tile_stride + tile_base (a shard's round-robin slice of the padded
// tile grid, framekernel.py:151-158), into a compact (n_local, 32, 32, 3)
// buffer: eight 16x8 blocks per tile, so each warp keeps the compact 16x2
// patch above. Tile ids >= n_tiles_real (the grid's round-up padding) and
// pixels outside the image write zeros. The JAX kernel takes the shard
// base as a scalar appended to the scalar vector (a TPU SMEM detail);
// here base and stride are kernel arguments. Each pixel runs rt_pixel as
// in rt_frame, so a shard's pixels equal the single launch's bit for bit.
//
// Scalar vector layout (as framekernel.py:96-103):
//   [0:9]   proj_inv rows 0..2 of columns (0, 1, 3)
//   [9:12]  camera origin
//   [12:16] tmin/tmax primary, tmin/tmax secondary
//   [16]    ior      [17] fresnel r0
//   [18:18+2*spp] sub-pixel jitter (x, y) per sample

#include <cuda_runtime.h>

#include "envmap.cuh"
#include "shade.cuh"
#include "traverse_f2b.cuh"

#define RT_MAX_STACK 8
#define RT_TILE 32  // pixel-DP tile edge (framekernel.py TILE_H = TILE_W)

struct RtRay {
  float ox, oy, oz, dx, dy, dz, w, cull;  // cull: +1 outside, -1 inside
  int count;
};

// Radiance of one pixel: spp samples of its bounce tree, averaged; each
// ray's closest hit is traverse_f2b.cuh's walk WALK.
template <int WALK>
__device__ __forceinline__ float3 rt_pixel(const RtScene& scene,
                                           const float* __restrict__ sc,
                                           const float* __restrict__ env,
                                           int px, int py, int width,
                                           int height, int spp, float inv_spp,
                                           int max_refract, int max_reflect,
                                           int env_h, int env_w) {
  const float tmin_p = sc[12], tmax_p = sc[13];
  const float tmin_s = sc[14], tmax_s = sc[15];
  const float ior = sc[16], r0 = sc[17];
  const float eta_out = 1.0f / ior;  // entering the dielectric
  const float fres_scale = r0 * (1.0f - r0);

  RtRay stack[RT_MAX_STACK];
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    // Raygen (camera.py:98-135): no w-divide, DirectX y flip.
    const float jx = sc[18 + 2 * s], jy = sc[19 + 2 * s];
    const float sx = ((float)px + jx) / (float)width * 2.0f - 1.0f;
    const float sy = -(((float)py + jy) / (float)height * 2.0f - 1.0f);
    const float rx = sc[0] * sx + sc[1] * sy + sc[2];
    const float ry = sc[3] * sx + sc[4] * sy + sc[5];
    const float rz = sc[6] * sx + sc[7] * sy + sc[8];
    const float inv_len = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz);

    int sp = 0;
    stack[sp++] = RtRay{sc[9], sc[10], sc[11], rx * inv_len, ry * inv_len,
                        rz * inv_len, 1.0f, 1.0f, 0};
    while (sp > 0) {
      const RtRay r = stack[--sp];
      const bool primary = r.count == 0;
      const bool at_cap = r.count == max_refract;
      const RtHit h = rt_closest_hit<WALK>(
          scene, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.cull,
          primary ? tmin_p : tmin_s, primary ? tmax_p : tmax_s, at_cap);
      if (h.idx < 0) {
        if (r.w > 0.0f) {  // miss shader (RayTracing.hlsl:127-137)
          const int f = rt_env_texel(r.dx, r.dy, r.dz, env_h, env_w);
          acc_r += r.w * __ldg(env + 3 * f);
          acc_g += r.w * __ldg(env + 3 * f + 1);
          acc_b += r.w * __ldg(env + 3 * f + 2);
        }
        continue;
      }
      if (at_cap) continue;  // hits at the cap add black (hlsl:82)

      // ClosestHit (RayTracing.hlsl:79-123), as integrator._shade_hits.
      const bool outside = r.cull > 0.0f;
      const RtSurface sf =
          rt_surface(h, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, outside);
      const float fres = rt_fresnel(sf, fres_scale);

      if (r.count < max_reflect) {  // reflection child, every hit
        const float3 f = rt_reflect(sf, r.dx, r.dy, r.dz);
        stack[sp++] = RtRay{sf.hx, sf.hy, sf.hz, f.x, f.y, f.z, r.w * fres,
                            r.cull, r.count + 1};
      }
      float3 tr;  // refraction child; none on TIR
      if (rt_refract(sf, r.dx, r.dy, r.dz, outside ? eta_out : ior, &tr)) {
        stack[sp++] = RtRay{sf.hx, sf.hy, sf.hz, tr.x, tr.y, tr.z,
                            r.w * (1.0f - fres), -r.cull, r.count + 1};
      }
    }
  }
  return make_float3(acc_r * inv_spp, acc_g * inv_spp, acc_b * inv_spp);
}

// The arguments every frame kernel takes first, in the C entries' order.
#define RT_FRAME_PARAMS                                                       \
  const float *__restrict__ sc, const float *__restrict__ tri,               \
      const float *__restrict__ norm, const float *__restrict__ supers,      \
      const float *__restrict__ clusters, const float *__restrict__ subs,    \
      const float *__restrict__ env, float *__restrict__ out, int width,     \
      int height, int spp, float inv_spp, int max_refract, int max_reflect,  \
      int n_supers, int n_clusters, int cluster_size, int sub_tris,          \
      int env_h, int env_w
#define RT_FRAME_ARGS                                                         \
  sc, tri, norm, supers, clusters, subs, env, out, width, height, spp,       \
      inv_spp, max_refract, max_reflect, n_supers, n_clusters, cluster_size, \
      sub_tris, env_h, env_w
// The root boxes come last, after a kernel's other arguments, so that the
// flat and supers instances, which never read them, keep the parameter
// offsets, and so the instructions, they had before there were roots.
#define RT_ROOT_PARAMS const float *__restrict__ roots, int n_roots
#define RT_SCENE                                                              \
  RtScene {                                                                   \
    supers, clusters, subs, tri, norm, n_supers, n_clusters,                 \
        cluster_size / sub_tris, sub_tris, roots, n_roots                     \
  }

// ---- rt_frame, rt_frame_tiles ----------------------------------------

// One thread per pixel; block (16, 8), a warp on a compact 16x2 patch; the
// stack in local memory (L1-resident).
template <int WALK>
__global__ void __launch_bounds__(128) rt_frame_kernel(RT_FRAME_PARAMS,
                                                       RT_ROOT_PARAMS) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const float3 c = rt_pixel<WALK>(
      RT_SCENE, sc, env, px, py, width, height, spp, inv_spp, max_refract,
      max_reflect, env_h, env_w);
  float* o = out + 3 * ((size_t)py * width + px);
  o[0] = c.x;
  o[1] = c.y;
  o[2] = c.z;
}

extern "C" int rt_frame(RT_FRAME_PARAMS, RT_ROOT_PARAMS, void* stream) {
  const dim3 block(16, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  if (n_roots > 0) {
    rt_frame_kernel<RT_WALK_ROOTS><<<grid, block, 0, (cudaStream_t)stream>>>(
        RT_FRAME_ARGS, roots, n_roots);
  } else if (n_supers > 0) {
    rt_frame_kernel<RT_WALK_SUPERS><<<grid, block, 0, (cudaStream_t)stream>>>(
        RT_FRAME_ARGS, roots, n_roots);
  } else {
    rt_frame_kernel<RT_WALK_FLAT><<<grid, block, 0, (cudaStream_t)stream>>>(
        RT_FRAME_ARGS, roots, n_roots);
  }
  return (int)cudaGetLastError();
}

// The pixel-DP entry: block (16, 8), grid (2, 4, n_local); block z renders
// local tile j = global tile j * tile_stride + tile_base.
template <int WALK>
__global__ void __launch_bounds__(128) rt_frame_tiles_kernel(
    RT_FRAME_PARAMS, int tile_stride, int tile_base, int n_tiles_real,
    RT_ROOT_PARAMS) {
  const int lx = blockIdx.x * blockDim.x + threadIdx.x;  // 0..31 in the tile
  const int ly = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.z;
  const int tile = j * tile_stride + tile_base;
  const int tiles_x = (width + RT_TILE - 1) / RT_TILE;
  const int ty = tile / tiles_x;
  const int px = (tile - ty * tiles_x) * RT_TILE + lx;
  const int py = ty * RT_TILE + ly;
  float3 c = make_float3(0.0f, 0.0f, 0.0f);
  if (tile < n_tiles_real && px < width && py < height) {
    c = rt_pixel<WALK>(RT_SCENE, sc, env, px, py, width, height, spp,
                       inv_spp, max_refract, max_reflect, env_h, env_w);
  }
  float* o = out + 3 * (((size_t)j * RT_TILE + ly) * RT_TILE + lx);
  o[0] = c.x;
  o[1] = c.y;
  o[2] = c.z;
}

extern "C" int rt_frame_tiles(RT_FRAME_PARAMS, int tile_stride,
                              int tile_base, int n_local, int n_tiles_real,
                              RT_ROOT_PARAMS, void* stream) {
  if (n_local < 1) return (int)cudaSuccess;
  const dim3 block(16, 8);
  const dim3 grid(RT_TILE / block.x, RT_TILE / block.y, n_local);
#define RT_TILES_LAUNCH(WALK)                                                 \
  rt_frame_tiles_kernel<WALK><<<grid, block, 0, (cudaStream_t)stream>>>(      \
      RT_FRAME_ARGS, tile_stride, tile_base, n_tiles_real, roots, n_roots)
  if (n_roots > 0) {
    RT_TILES_LAUNCH(RT_WALK_ROOTS);
  } else if (n_supers > 0) {
    RT_TILES_LAUNCH(RT_WALK_SUPERS);
  } else {
    RT_TILES_LAUNCH(RT_WALK_FLAT);
  }
#undef RT_TILES_LAUNCH
  return (int)cudaGetLastError();
}

// ---- occupancy of rt_frame_kernel -----------------------------------

// out[0..3] = resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers a thread,
// local memory bytes a thread, threads a block; of rt_frame_kernel in walk
// RT_WALK_FLAT, RT_WALK_SUPERS or RT_WALK_ROOTS.
extern "C" int rt_frame_occupancy(int walk, int* out) {
  const void* fn = walk == RT_WALK_ROOTS
                       ? (const void*)rt_frame_kernel<RT_WALK_ROOTS>
                   : walk == RT_WALK_SUPERS
                       ? (const void*)rt_frame_kernel<RT_WALK_SUPERS>
                       : (const void*)rt_frame_kernel<RT_WALK_FLAT>;
  const int threads = 128;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads, 0);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = threads;
  return (int)err;
}
