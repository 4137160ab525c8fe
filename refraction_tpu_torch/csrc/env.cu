// Batch weighted miss radiance: out[i] = weight[i] * envmap(dirs[i]) where
// weight[i] > 0, else 0. One thread per ray around rt_env_texel.
//
// Replaces refraction_tpu/kernels/envmap_pallas.py::_env_call (625-653;
// kernel body _env_kernel at 130) and its entry pallas_env_contribution
// (655-675). It is not on the fused frame path; it lets the lookup be
// checked alone, and serves the eager integrator's "cuda" backend.
//
// Bound on the H100: memory. Per ray it reads 16 bytes of input and one
// 12-byte texel (random for scattered directions, coherent for primaries)
// and writes 12 bytes; the map (24 MB at 1024x2048) fits in the 50 MB L2.
// The TPU version needed the map in VMEM (8 MB cap, XLA fallback beyond);
// here any map size runs the same code.

#include <cuda_runtime.h>

#include "envmap.cuh"

__global__ void rt_env_kernel(const float* __restrict__ env, int env_h,
                              int env_w, const float* __restrict__ dirs,
                              const float* __restrict__ weight, int n,
                              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float w = weight[i];
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (w > 0.0f) {
    const int f = rt_env_texel(dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2],
                               env_h, env_w);
    r = w * __ldg(env + 3 * f);
    g = w * __ldg(env + 3 * f + 1);
    b = w * __ldg(env + 3 * f + 2);
  }
  out[3 * i] = r;
  out[3 * i + 1] = g;
  out[3 * i + 2] = b;
}

extern "C" int rt_env(const float* env, int env_h, int env_w,
                      const float* dirs, const float* weight, int n,
                      float* out, void* stream) {
  const int block = 256;
  const int grid = (n + block - 1) / block;
  rt_env_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      env, env_h, env_w, dirs, weight, n, out);
  return (int)cudaGetLastError();
}
