// Traversal instrument: the cost of one 8-triangle sub visit, in two forms.
// Both kernels run V sub visits against R rays, one thread per ray, with a
// register-carried winner (t, i, u, v); visit s reads sub record s % 64 and
// names its triangles s*8 + k. Misses end at t = 1e30, i = 0.
//
//   rt_mt_visits    replaces tools/mxu_mt_bench.py::_vpu_kernel (44-93):
//                   Möller–Trumbore per triangle from the 72-word records
//                   a[3] e1[3] e2[3] (x 8), with inv_det = 1/det and
//                   products (not the divide form of ops/intersect.py);
//                   accept det*cull > 0, u >= 0, v >= 0, u + v <= 1,
//                   t >= 1e-3; strict t < best.
//   rt_woop_visits  replaces tools/mxu_mt_bench.py::_mxu_kernel (96-145):
//                   per visit the 48 outputs W[(s%64)*48 + r, :] . K with
//                   K = [ox oy oz 1 dx dy dz 0] (o'xyz then d'xyz, 8 rows
//                   each), then t = -o'z/d'z, u = o'x + t d'x,
//                   v = o'y + t d'y, the accept test with d'z*cull > 0,
//                   and the packed-key min (bits(tt) & ~7) | k over the 8
//                   triangles: near-equal t fall to the lower k, as the TPU
//                   kernel's sublane roll-tree does (113-121). Then the
//                   winner's untruncated t and a strict t < best.
//
// The TPU kernels' (8, 128) ray planes become one thread per ray; the
// roll-tree over the 8 triangle sublanes becomes a loop over k.
//
// The product stays on CUDA cores, summed over k = 0..7 in a fixed order,
// so the kernel equals its plain version (kernels/mtbench.py) bit for bit
// (with -fmad=false). The tensor-core form of the MXU product (mma.sync
// TF32 / 3xTF32, or wgmma) is the instrument's open question on this card
// and a later redesign.
//
// What bounds them on the H100: FP32 instruction rate and dependent
// latency, not bytes. Per visit a thread does ~400 FP32 operations and 8
// divides (MT)
// or 720 for the product plus 8 divides (Woop), on 16-28 bytes of ray
// state it keeps in registers. Every thread reads the same table words at
// the same time, the counterpart of the TPU's scalar (SMEM) reads, so the
// tables are staged once per block in shared memory and read as
// broadcasts: the 4,608 triangle words (18 KB, static) and the 3,072 x 8
// Woop matrix (96 KB). The Woop table goes to shared memory too, rather
// than being read through L1, so that both kernels read their triangle
// data from the same level and their difference is arithmetic; above
// 48 KB that takes dynamic shared memory and the opt-in attribute. With
// R = 1,024 rays there are 8 blocks of 128 threads: a latency measurement
// on 8 SMs, as the TPU tool measured one core.

#include <cuda_runtime.h>

#define RT_MT_SUBS 64
#define RT_MT_TRIS 8
#define RT_MT_SUB_WORDS 72                              // 8 x (a e1 e2)
#define RT_MT_TRI_WORDS (RT_MT_SUBS * RT_MT_SUB_WORDS)  // 4,608
#define RT_WOOP_ROWS 48                                 // 6 outputs x 8
#define RT_WOOP_K 8                                     // ox oy oz 1 dx dy dz 0
#define RT_WOOP_WORDS (RT_MT_SUBS * RT_WOOP_ROWS * RT_WOOP_K)  // 24,576
#define RT_MT_TMIN 1e-3f
#define RT_MT_BIG 1e30f
#define RT_MT_BLOCK 128

__global__ void __launch_bounds__(RT_MT_BLOCK) rt_mt_visits_kernel(
    const float* __restrict__ tri, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ cull, int r, int v,
    float* __restrict__ t_out, int* __restrict__ i_out) {
  __shared__ float s_tri[RT_MT_TRI_WORDS];
  for (int k = threadIdx.x; k < RT_MT_TRI_WORDS; k += blockDim.x)
    s_tri[k] = tri[k];
  __syncthreads();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= r) return;
  const float ox = o[j], oy = o[r + j], oz = o[2 * r + j];
  const float dx = d[j], dy = d[r + j], dz = d[2 * r + j];
  const float c = cull[j];
  float bt = RT_MT_BIG, bu = 0.0f, bv = 0.0f;
  int bi = 0;
  for (int s = 0; s < v; ++s) {
    const float* sub = s_tri + (s % RT_MT_SUBS) * RT_MT_SUB_WORDS;
#pragma unroll
    for (int k = 0; k < RT_MT_TRIS; ++k) {
      const float* w = sub + k * 9;
      const float a0 = w[0], a1 = w[1], a2 = w[2];
      const float e10 = w[3], e11 = w[4], e12 = w[5];
      const float e20 = w[6], e21 = w[7], e22 = w[8];
      const float px = dy * e22 - dz * e21;
      const float py = dz * e20 - dx * e22;
      const float pz = dx * e21 - dy * e20;
      const float det = e10 * px + e11 * py + e12 * pz;
      const bool accept = det * c > 0.0f;
      const float tvx = ox - a0, tvy = oy - a1, tvz = oz - a2;
      const float u_num = tvx * px + tvy * py + tvz * pz;
      const float qx = tvy * e12 - tvz * e11;
      const float qy = tvz * e10 - tvx * e12;
      const float qz = tvx * e11 - tvy * e10;
      const float v_num = dx * qx + dy * qy + dz * qz;
      const float t_num = e20 * qx + e21 * qy + e22 * qz;
      const float inv_det = 1.0f / det;
      const float u = u_num * inv_det;
      const float vv = v_num * inv_det;
      const float t = t_num * inv_det;
      const bool cond = accept && u >= 0.0f && vv >= 0.0f &&
                        u + vv <= 1.0f && t >= RT_MT_TMIN;
      if (cond && t < bt) {
        bt = t;
        bi = s * RT_MT_TRIS + k;
        bu = u;
        bv = vv;
      }
    }
  }
  (void)bu;
  (void)bv;
  t_out[j] = bt;
  i_out[j] = bi;
}

__global__ void __launch_bounds__(RT_MT_BLOCK) rt_woop_visits_kernel(
    const float* __restrict__ wmat, const float* __restrict__ rhs,
    const float* __restrict__ cull, int r, int v, float* __restrict__ t_out,
    int* __restrict__ i_out) {
  extern __shared__ float4 s_w4[];  // RT_WOOP_WORDS floats
  const float4* w4 = reinterpret_cast<const float4*>(wmat);
  for (int k = threadIdx.x; k < RT_WOOP_WORDS / 4; k += blockDim.x)
    s_w4[k] = w4[k];
  __syncthreads();
  const float* s_w = reinterpret_cast<const float*>(s_w4);
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= r) return;
  float x[RT_WOOP_K];
#pragma unroll
  for (int k = 0; k < RT_WOOP_K; ++k) x[k] = rhs[k * r + j];
  const float c = cull[j];
  float bt = RT_MT_BIG, bu = 0.0f, bv = 0.0f;
  int bi = 0;
  for (int s = 0; s < v; ++s) {
    const float* ws = s_w + (s % RT_MT_SUBS) * RT_WOOP_ROWS * RT_WOOP_K;
    float out[RT_WOOP_ROWS];
#pragma unroll
    for (int row = 0; row < RT_WOOP_ROWS; ++row) {
      const float* wr = ws + row * RT_WOOP_K;
      float acc = wr[0] * x[0];
#pragma unroll
      for (int k = 1; k < RT_WOOP_K; ++k) acc = acc + wr[k] * x[k];
      out[row] = acc;
    }
    int best_key = 0x7fffffff;
    float wt = RT_MT_BIG, wu = 0.0f, wv = 0.0f;
#pragma unroll
    for (int k = 0; k < RT_MT_TRIS; ++k) {
      const float oxp = out[k], oyp = out[8 + k], ozp = out[16 + k];
      const float dxp = out[24 + k], dyp = out[32 + k], dzp = out[40 + k];
      const float inv = 1.0f / dzp;
      const float t = -ozp * inv;
      const float u = oxp + t * dxp;
      const float vv = oyp + t * dyp;
      const bool cond = dzp * c > 0.0f && u >= 0.0f && vv >= 0.0f &&
                        u + vv <= 1.0f && t >= RT_MT_TMIN;
      const float tt = cond ? t : RT_MT_BIG;
      const int key = (__float_as_int(tt) & ~7) | k;
      if (key < best_key) {
        best_key = key;
        wt = tt;
        wu = u;
        wv = vv;
      }
    }
    if (wt < bt) {
      bt = wt;
      bi = s * RT_MT_TRIS + (best_key & 7);
      bu = wu;
      bv = wv;
    }
  }
  (void)bu;
  (void)bv;
  t_out[j] = bt;
  i_out[j] = bi;
}

// tri: (4608,) records; o, d: (3, r) SoA; cull: (r,); t_out (r,), i_out
// (r,) int32. Returns a cudaError_t.
extern "C" int rt_mt_visits(const float* tri, const float* o, const float* d,
                            const float* cull, int r, int v, float* t_out,
                            int* i_out, void* stream) {
  if (r <= 0) return 0;
  const int grid = (r + RT_MT_BLOCK - 1) / RT_MT_BLOCK;
  rt_mt_visits_kernel<<<grid, RT_MT_BLOCK, 0, (cudaStream_t)stream>>>(
      tri, o, d, cull, r, v, t_out, i_out);
  return (int)cudaGetLastError();
}

// wmat: (3072, 8) row-major, 16-byte aligned; rhs: (8, r); cull: (r,).
extern "C" int rt_woop_visits(const float* wmat, const float* rhs,
                              const float* cull, int r, int v, float* t_out,
                              int* i_out, void* stream) {
  if (r <= 0) return 0;
  const int smem = RT_WOOP_WORDS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rt_woop_visits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (r + RT_MT_BLOCK - 1) / RT_MT_BLOCK;
  rt_woop_visits_kernel<<<grid, RT_MT_BLOCK, smem, (cudaStream_t)stream>>>(
      wmat, rhs, cull, r, v, t_out, i_out);
  return (int)cudaGetLastError();
}
