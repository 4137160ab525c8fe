// Traversal instrument: the cost of one 8-triangle sub visit, in three
// forms. Every kernel runs V sub visits against R rays with a
// register-carried winner (t, i); visit s reads sub record s % 64 and names
// its triangles s*8 + k. Misses end at t = 1e30, i = 0.
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
//                   winner's untruncated t and a strict t < best. The
//                   product runs on CUDA cores, summed over k = 0..7 in a
//                   fixed order, so the kernel equals its plain version
//                   (kernels/mtbench.py) bit for bit (with -fmad=false):
//                   the exact form the next one is held against.
//   rt_woop_visits_tc  the same function with the (48, 8) x (8, R) product
//                   on the tensor cores, which is what _mxu_kernel's
//                   jnp.dot on the MXU asks: mma.sync m16n8k8 TF32 with
//                   FP32 accumulators, in one pass (operands rounded to
//                   TF32) or three (3xTF32: x = hi + lo with
//                   hi = tf32(x), lo = tf32(x - hi), and
//                   lo*hi + hi*lo + hi*hi accumulated in that order, small
//                   products first). See the kernel for the mapping.
//
// In the first two the TPU kernels' (8, 128) ray planes become one thread
// per ray and the roll-tree over the 8 triangle sublanes a loop over k.
//
// What bounds them on the H100: FP32 instruction rate and dependent
// latency, not bytes. Per visit a thread does ~400 FP32 operations and 8
// divides (MT), or 720 for the product plus 8 divides (Woop), on 16-28
// bytes of ray state it keeps in registers; in the tensor-core form a warp
// runs 12 mma (36 for 3xTF32) in place of its 32 x 720 product
// operations, and each thread keeps the 8 divides and epilogues and adds
// 32 shuffles for the min over a ray's 8 lanes. Every thread reads the same table words at
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

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 does, in integer arithmetic on the bits so that the
// plain version (kernels/mtbench.py tf32_round) rounds identically: add
// half a TF32 ulp to the magnitude, clear the low 13 bits. Finite inputs.
__device__ __forceinline__ float rt_tf32(float x) {
  return __int_as_float((__float_as_int(x) + 0x1000) & 0xffffe000);
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, FP32 accumulate.
__device__ __forceinline__ void rt_mma_tf32(float (&d)[4], const float4& a,
                                            const float2& b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a.x)), "r"(__float_as_uint(a.y)),
        "r"(__float_as_uint(a.z)), "r"(__float_as_uint(a.w)),
        "r"(__float_as_uint(b.x)), "r"(__float_as_uint(b.y)));
}

#define RT_TC_TILES 4                      // N-tiles of 8 rays per warp
#define RT_TC_FRAGS (RT_MT_SUBS * 3 * 32)  // A fragments: sub, M-tile, lane

// The Woop visits with the product on the tensor cores. A warp owns 32
// rays as four N-tiles of 8; the 48 Woop rows of a sub are three M-tiles
// of 16 (rows 0-15 = o'x o'y, 16-31 = o'z d'x, 32-47 = d'y d'z, 8
// triangles each). With g = lane >> 2 and t = lane & 3 the m16n8k8
// fragments are
//   A (16x8): rows g, g + 8, columns t, t + 4
//   B (8x8):  rows (K index) t, t + 4, column (ray) g
//   C (16x8): rows g, g + 8, columns (rays) 2t, 2t + 1
// so after the three M-tiles of an N-tile a thread holds all six outputs
// of triangle g for rays 2t and 2t + 1: the epilogue (t = -o'z / d'z, u,
// v, accept, packed key) runs in registers with no relayout, and the min
// over the 8 triangles is a butterfly over the lanes that differ in g
// (__shfl_xor_sync by 4, 8, 16), the counterpart of the TPU kernel's
// sublane roll-tree; one more shuffle fetches the winner's untruncated t.
// The butterfly runs level by level over the thread's 8 rays at once, so
// that a level's 8 shuffles are in flight together: with one warp per
// scheduler nothing else hides their latency, and ray after ray (4
// dependent shuffles each, 32 in a chain) a visit took 1,132 ns against
// 636 (one TF32 pass, 1,024 rays; NVIDIA H100 80GB HBM3, 700.00 W).
// Every lane of a ray's 8 ends with the same carried winner; lanes with
// g = 0 write it out.
//
// The ray fragments (B) are loaded and split once. The A fragments are
// staged once per block in shared memory, already rounded (and split, for
// 3xTF32) and in fragment order, one float4 per (sub, M-tile, lane), so a
// visit reads them with three (six) conflict-free 16-byte loads: 96 KB, or
// 192 KB for 3xTF32. The K column holding 1 and 0 is exact in TF32.
//
// The order in which mma adds its eight products is not specified, so the
// kernel agrees with its plain version (the same rounded operands, the
// products summed in FP32 in K order) to a tolerance, not bit for bit.
template <int PASSES>
__global__ void __launch_bounds__(RT_MT_BLOCK) rt_woop_visits_tc_kernel(
    const float* __restrict__ wmat, const float* __restrict__ rhs,
    const float* __restrict__ cull, int r, int v, float* __restrict__ t_out,
    int* __restrict__ i_out) {
  extern __shared__ float4 s_frag[];  // hi [RT_TC_FRAGS], then lo for 3 passes
  for (int e = threadIdx.x; e < RT_TC_FRAGS; e += blockDim.x) {
    const int ln = e & 31, m = (e >> 5) % 3, sub = e / 96;
    const float* row_g =  // row g of the M-tile, column t; row g + 8 below
        wmat + ((sub * RT_WOOP_ROWS + 16 * m + (ln >> 2)) * RT_WOOP_K) +
        (ln & 3);
    const float* row_g8 = row_g + 8 * RT_WOOP_K;
    const float4 x = make_float4(row_g[0], row_g8[0], row_g[4], row_g8[4]);
    const float4 h =
        make_float4(rt_tf32(x.x), rt_tf32(x.y), rt_tf32(x.z), rt_tf32(x.w));
    s_frag[e] = h;
    if (PASSES == 3)
      s_frag[RT_TC_FRAGS + e] =
          make_float4(rt_tf32(x.x - h.x), rt_tf32(x.y - h.y),
                      rt_tf32(x.z - h.z), rt_tf32(x.w - h.w));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  if (base >= r) return;  // the whole warp

  float2 b_hi[RT_TC_TILES], b_lo[RT_TC_TILES];
  float c[RT_TC_TILES][2];
  float bt[RT_TC_TILES][2];
  int bi[RT_TC_TILES][2];
#pragma unroll
  for (int n = 0; n < RT_TC_TILES; ++n) {
    const int col = base + 8 * n + g;  // the ray this lane feeds to B
    const float k0 = col < r ? rhs[t * r + col] : 0.0f;
    const float k1 = col < r ? rhs[(t + 4) * r + col] : 0.0f;
    b_hi[n] = make_float2(rt_tf32(k0), rt_tf32(k1));
    b_lo[n] = make_float2(rt_tf32(k0 - b_hi[n].x), rt_tf32(k1 - b_hi[n].y));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ray = base + 8 * n + 2 * t + e;  // the rays of its C columns
      c[n][e] = ray < r ? cull[ray] : 0.0f;
      bt[n][e] = RT_MT_BIG;
      bi[n][e] = 0;
    }
  }

  for (int s = 0; s < v; ++s) {
    const float4* frag = s_frag + (s % RT_MT_SUBS) * 96 + lane;
    float4 a_hi[3], a_lo[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      a_hi[m] = frag[32 * m];
      if (PASSES == 3) a_lo[m] = frag[RT_TC_FRAGS + 32 * m];
    }
    float tt[RT_TC_TILES][2];
    int key[RT_TC_TILES][2];
#pragma unroll
    for (int n = 0; n < RT_TC_TILES; ++n) {
      float acc[3][4];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.0f;
        if (PASSES == 3) {
          rt_mma_tf32(acc[m], a_lo[m], b_hi[n]);
          rt_mma_tf32(acc[m], a_hi[m], b_lo[n]);
        }
        rt_mma_tf32(acc[m], a_hi[m], b_hi[n]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float oxp = acc[0][e], oyp = acc[0][2 + e];
        const float ozp = acc[1][e], dxp = acc[1][2 + e];
        const float dyp = acc[2][e], dzp = acc[2][2 + e];
        const float inv = 1.0f / dzp;
        const float tt0 = -ozp * inv;
        const float u = oxp + tt0 * dxp;
        const float vv = oyp + tt0 * dyp;
        const bool cond = dzp * c[n][e] > 0.0f && u >= 0.0f && vv >= 0.0f &&
                          u + vv <= 1.0f && tt0 >= RT_MT_TMIN;
        tt[n][e] = cond ? tt0 : RT_MT_BIG;
        key[n][e] = (__float_as_int(tt[n][e]) & ~7) | g;
      }
    }
    // The min over a ray's 8 lanes, level by level for the 8 rays at once:
    // the 8 shuffles of a level are independent, so their latencies
    // overlap (a warp has its scheduler to itself here).
#pragma unroll
    for (int x = 4; x <= 16; x <<= 1)
#pragma unroll
      for (int n = 0; n < RT_TC_TILES; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          key[n][e] =
              min(key[n][e], __shfl_xor_sync(0xffffffffu, key[n][e], x));
#pragma unroll
    for (int n = 0; n < RT_TC_TILES; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int win = key[n][e] & 7;
        const float wt = __shfl_sync(0xffffffffu, tt[n][e], (win << 2) | t);
        if (wt < bt[n][e]) {
          bt[n][e] = wt;
          bi[n][e] = s * RT_MT_TRIS + win;
        }
      }
  }
  if (g != 0) return;
#pragma unroll
  for (int n = 0; n < RT_TC_TILES; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ray = base + 8 * n + 2 * t + e;
      if (ray < r) {
        t_out[ray] = bt[n][e];
        i_out[ray] = bi[n][e];
      }
    }
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

// The tensor-core form; passes 1 (TF32) or 3 (3xTF32). Same arguments and
// launch geometry as rt_woop_visits.
extern "C" int rt_woop_visits_tc(const float* wmat, const float* rhs,
                                 const float* cull, int r, int v, int passes,
                                 float* t_out, int* i_out, void* stream) {
  if (passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  if (r <= 0) return 0;
  const int smem = (passes == 3 ? 2 : 1) * RT_TC_FRAGS * (int)sizeof(float4);
  const int grid = (r + RT_MT_BLOCK - 1) / RT_MT_BLOCK;
#define RT_TC_LAUNCH(P)                                                      \
  do {                                                                       \
    cudaError_t err = cudaFuncSetAttribute(                                  \
        rt_woop_visits_tc_kernel<P>,                                         \
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                  \
    if (err != cudaSuccess) return (int)err;                                 \
    rt_woop_visits_tc_kernel<P><<<grid, RT_MT_BLOCK, smem,                   \
                                  (cudaStream_t)stream>>>(                   \
        wmat, rhs, cull, r, v, t_out, i_out);                                \
  } while (0)
  if (passes == 3) RT_TC_LAUNCH(3);
  else RT_TC_LAUNCH(1);
#undef RT_TC_LAUNCH
  return (int)cudaGetLastError();
}
