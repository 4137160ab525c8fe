// Equirect environment lookup of one direction: the device function shared
// by the env kernel (env.cu), the frame kernel (frame.cu) and the round
// kernel (round.cu), each of which reads the texel it names as three
// 4-byte loads of the float32 (H, W, 3) map. A 16-byte load from a
// four-float copy of the map was timed in all three and moved none
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md; env_variants.cu keeps that
// form for the env kernel), so there is one map layout.
//
// Replaces refraction_tpu/kernels/envmap_pallas.py::env_window_tile and
// _env_flat (217-267) with env_window_addr/scan/accumulate and the coded
// decoders (_env_decode, 206). On the TPU a per-lane gather was slow, so
// the kernel scanned a row window of a VMEM copy of the map and decoded
// packed texel codes. On the H100 a thread loads its texel directly:
// envmap[iy, ix] from the float32 (H, W, 3) map in global memory. The coded
// layouts decode to the same floats, so they are not needed.
//
// The index math is the reference miss shader's (RayTracing.hlsl:133-134)
// as ops/shade.py::envmap_color writes it: pi = 3.14159, true atan2/acos
// (not the TPU's polynomials), truncation toward zero, then a clamp to the
// edge texel. CUDA's atan2f/acosf are within 2-3 ulp of libm, so a
// direction within float noise of a texel boundary may pick the neighbour.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ int rt_env_texel(float x, float y, float z,
                                            int h, int w) {
  const float pi = 3.14159f;
  const float theta = (float)w * (atan2f(x, z) / pi + 1.0f) / 2.0f;
  const float phi = (float)h * (acosf(fminf(fmaxf(y, -1.0f), 1.0f)) / pi);
  const int ix = min(max((int)theta, 0), w - 1);
  const int iy = min(max((int)phi, 0), h - 1);
  return iy * w + ix;
}
