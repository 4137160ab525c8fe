// Batch weighted miss radiance: out[i] = weight[i] * envmap(dirs[i]) where
// weight[i] > 0, else 0. One thread per ray around rt_env_texel.
//
// Replaces refraction_tpu/kernels/envmap_pallas.py::_env_call (625-653;
// kernel body _env_kernel at 130) and its entry pallas_env_contribution
// (655-675). It is not on the fused frame path; it lets the lookup be
// checked alone, and serves the eager integrator's "cuda" backend, which
// calls it once per bounce round on every lane of the round's static
// width, most of them with weight 0.
//
// On the H100 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): a ray of weight
// > 0 reads 16 bytes of input and one texel (a 32-byte sector of the map)
// and writes 12 bytes; a ray of weight 0 reads its 4-byte weight and
// writes 12 bytes of zeros: 65 MB at 3,145,728 lanes with a tenth alive,
// 0.019 ms of memory time against 0.040 ms measured. Forms that move
// 16-byte words (the texel from a four-float copy of the map; four rays a
// thread with 16-byte loads and stores; stores staged in shared memory)
// were timed against this one and were no faster or slower: they are kept
// as an instrument in env_variants.cu, and `python -m
// refraction_tpu_torch.env_times --variants` times them in turns with
// this kernel. No profiler ran on that card, so what holds the kernel is
// inferred, not measured: moving fewer or wider words changed nothing, and
// a warp runs the index math (atan2f, acosf, IEEE divides) whenever one of
// its 32 lanes is alive, which with scattered live lanes is nearly every
// warp; so instruction issue is the likely limit.
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
