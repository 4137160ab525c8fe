// Instrument: three other forms of the env kernel (env.cu), each computing
// the same function, out[i] = weight[i] * envmap(dirs[i]) where weight[i]
// > 0, else 0, bit for bit. No render path calls them. They exist so that
// the question "would 16-byte words make the env kernel faster on the
// H100?" can be asked again on another card, map or mix of live lanes:
// `python -m refraction_tpu_torch.env_times --variants` checks each
// against rt_env and times all four in turns.
//
//   1 texel16  one thread per ray as in env.cu, the texel as one 16-byte
//              load from a (H, W, 4) copy of the map (the fourth float
//              unused): a 12-byte texel straddles two 32-byte sectors at
//              2 of every 8 offsets, a 16-byte one never does.
//   2 rays4    a thread takes four consecutive rays: one 16-byte load of
//              their weights, three of their directions (only where a
//              weight is > 0), four texel16 lookups, three 16-byte stores;
//              a scalar tail for the last n % 4 rays.
//   3 staged   one thread per ray, texel as in env.cu; a block stages its
//              256 results in shared memory and writes them as coalesced
//              16-byte stores (scalar stores in the last, partial block).
//
// On the NVIDIA H100 80GB HBM3 (700.00 W) none beat env.cu (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "envmap.cuh"

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float3 texel16(const float4* __restrict__ env4,
                                          int f) {
  const float4 t = __ldg(env4 + f);
  return make_float3(t.x, t.y, t.z);
}

__global__ void env_texel16_kernel(const float4* __restrict__ env4, int env_h,
                                   int env_w, const float* __restrict__ dirs,
                                   const float* __restrict__ weight, int n,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float w = weight[i];
  float3 c = make_float3(0.0f, 0.0f, 0.0f);
  if (w > 0.0f) {
    const float3 t = texel16(env4, rt_env_texel(dirs[3 * i], dirs[3 * i + 1],
                                                dirs[3 * i + 2], env_h, env_w));
    c = make_float3(w * t.x, w * t.y, w * t.z);
  }
  out[3 * i] = c.x;
  out[3 * i + 1] = c.y;
  out[3 * i + 2] = c.z;
}

__global__ void env_rays4_kernel(const float4* __restrict__ env4, int env_h,
                                 int env_w, const float* __restrict__ dirs,
                                 const float* __restrict__ weight, int n,
                                 float* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int i0 = 4 * q;
  if (i0 >= n) return;
  if (i0 + 4 > n) {  // the tail: fewer than four rays left
    for (int i = i0; i < n; ++i) {
      const float w = weight[i];
      float3 c = make_float3(0.0f, 0.0f, 0.0f);
      if (w > 0.0f) {
        const float3 t = texel16(
            env4, rt_env_texel(dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2],
                               env_h, env_w));
        c = make_float3(w * t.x, w * t.y, w * t.z);
      }
      out[3 * i] = c.x;
      out[3 * i + 1] = c.y;
      out[3 * i + 2] = c.z;
    }
    return;
  }
  const float4 wv = reinterpret_cast<const float4*>(weight)[q];
  const float wt[4] = {wv.x, wv.y, wv.z, wv.w};
  float d[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) d[k] = 0.0f;
  if (wv.x > 0.0f || wv.y > 0.0f || wv.z > 0.0f || wv.w > 0.0f) {
    const float4* dp = reinterpret_cast<const float4*>(dirs) + 3 * q;
    const float4 a = dp[0], b = dp[1], c = dp[2];
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
    d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
    d[8] = c.x; d[9] = c.y; d[10] = c.z; d[11] = c.w;
  }
  float o[12];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[3 * k] = o[3 * k + 1] = o[3 * k + 2] = 0.0f;
    if (wt[k] > 0.0f) {
      const float3 t = texel16(env4, rt_env_texel(d[3 * k], d[3 * k + 1],
                                                  d[3 * k + 2], env_h, env_w));
      o[3 * k] = wt[k] * t.x;
      o[3 * k + 1] = wt[k] * t.y;
      o[3 * k + 2] = wt[k] * t.z;
    }
  }
  float4* op = reinterpret_cast<float4*>(out) + 3 * q;
  op[0] = make_float4(o[0], o[1], o[2], o[3]);
  op[1] = make_float4(o[4], o[5], o[6], o[7]);
  op[2] = make_float4(o[8], o[9], o[10], o[11]);
}

__global__ void env_staged_kernel(const float* __restrict__ env, int env_h,
                                  int env_w, const float* __restrict__ dirs,
                                  const float* __restrict__ weight, int n,
                                  float* __restrict__ out) {
  __shared__ float4 stage4[3 * kBlock / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  const int base = blockIdx.x * kBlock;
  const int i = base + threadIdx.x;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (i < n) {
    const float w = weight[i];
    if (w > 0.0f) {
      const int f = rt_env_texel(dirs[3 * i], dirs[3 * i + 1],
                                 dirs[3 * i + 2], env_h, env_w);
      r = w * __ldg(env + 3 * f);
      g = w * __ldg(env + 3 * f + 1);
      b = w * __ldg(env + 3 * f + 2);
    }
  }
  if (base + kBlock > n) {  // the last, partial block
    if (i < n) {
      out[3 * i] = r;
      out[3 * i + 1] = g;
      out[3 * i + 2] = b;
    }
    return;
  }
  stage[3 * threadIdx.x] = r;
  stage[3 * threadIdx.x + 1] = g;
  stage[3 * threadIdx.x + 2] = b;
  __syncthreads();
  if (threadIdx.x < 3 * kBlock / 4)
    reinterpret_cast<float4*>(out + 3 * (size_t)base)[threadIdx.x] =
        stage4[threadIdx.x];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// variant: 1 texel16, 2 rays4, 3 staged (above). env (env_h, env_w, 3) and
// env4 (env_h, env_w, 4) hold the same texels; dirs (n, 3), weight (n,),
// out (n, 3). Returns a cudaError_t: cudaErrorInvalidValue for an unknown
// variant, and cudaErrorMisalignedAddress where a form that moves 16-byte
// words is handed a pointer off a 16-byte boundary.
extern "C" int rt_env_variant(int variant, const float* env,
                              const float* env4, int env_h, int env_w,
                              const float* dirs, const float* weight, int n,
                              float* out, void* stream) {
  if (n <= 0) return 0;
  const auto s = (cudaStream_t)stream;
  const auto* e4 = reinterpret_cast<const float4*>(env4);
  const int grid = (n + kBlock - 1) / kBlock;
  if (variant == 1) {
    if (!aligned16(env4)) return (int)cudaErrorMisalignedAddress;
    env_texel16_kernel<<<grid, kBlock, 0, s>>>(e4, env_h, env_w, dirs, weight,
                                               n, out);
  } else if (variant == 2) {
    if (!aligned16(env4) || !aligned16(dirs) || !aligned16(weight) ||
        !aligned16(out))
      return (int)cudaErrorMisalignedAddress;
    const int groups = (n + 3) / 4;
    env_rays4_kernel<<<(groups + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        e4, env_h, env_w, dirs, weight, n, out);
  } else if (variant == 3) {
    if (!aligned16(out)) return (int)cudaErrorMisalignedAddress;
    env_staged_kernel<<<grid, kBlock, 0, s>>>(env, env_h, env_w, dirs, weight,
                                              n, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
