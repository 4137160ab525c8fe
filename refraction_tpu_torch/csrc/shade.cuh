// ClosestHit shading of one hit: the device functions shared by the frame
// kernel (frame.cu) and the round kernel (round.cu).
//
// The reference's ClosestHit shader (RayTracing.hlsl:79-123) as
// integrator._shade_hits and ops/shade.py write it, in the same float32
// operation order (the library is built with -fmad=false, so each line
// rounds as the plain PyTorch version does):
//
//   n'   = normalize(interpolated normal), negated when the ray is inside
//   cosi = dot(d, n')
//   R    = r0 (1 - r0) (1 - cosi)^5            nonstandard Schlick (hlsl:92)
//   reflection = normalize(d - 2 cosi n')      ReflectRay (hlsl:66-68)
//   refraction = GLSL refract(d, n', eta) normalized, none on TIR
//                                              RefractRay (hlsl:70-76)
//
// Normalization divides by sqrtf (the oracle's), not the TPU kernels'
// rsqrt (megakernel.py:137,163,179; framekernel.py:480,502).
#pragma once

#include <cuda_runtime.h>

#include "traverse_f2b.cuh"

struct RtSurface {
  float hx, hy, hz;  // hit point o + t d
  float nx, ny, nz;  // unit shading normal on the ray's side
  float cosi;        // dot(d, n')
};

// The surface a ray (o, d) sees at its hit h; `outside` is the ray's side.
__device__ __forceinline__ RtSurface rt_surface(const RtHit& h, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz,
                                                bool outside) {
  RtSurface s;
  const float nlen = sqrtf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz);
  s.nx = h.nx / nlen;
  s.ny = h.ny / nlen;
  s.nz = h.nz / nlen;
  if (!outside) { s.nx = -s.nx; s.ny = -s.ny; s.nz = -s.nz; }
  s.hx = ox + h.t * dx;
  s.hy = oy + h.t * dy;
  s.hz = oz + h.t * dz;
  s.cosi = dx * s.nx + dy * s.ny + dz * s.nz;
  return s;
}

// Fresnel weight of the reflection child; fres_scale = r0 * (1 - r0).
__device__ __forceinline__ float rt_fresnel(const RtSurface& s,
                                            float fres_scale) {
  const float base = 1.0f - s.cosi;
  return fres_scale * (base * base) * (base * base) * base;
}

// Unit reflection direction of d about the surface normal.
__device__ __forceinline__ float3 rt_reflect(const RtSurface& s, float dx,
                                             float dy, float dz) {
  float fx = dx - 2.0f * s.cosi * s.nx;
  float fy = dy - 2.0f * s.cosi * s.ny;
  float fz = dz - 2.0f * s.cosi * s.nz;
  const float flen = sqrtf(fx * fx + fy * fy + fz * fz);
  return make_float3(fx / flen, fy / flen, fz / flen);
}

// Unit refraction direction into *out; false on total internal reflection
// (then *out is untouched). eta = 1/ior entering, ior leaving.
__device__ __forceinline__ bool rt_refract(const RtSurface& s, float dx,
                                           float dy, float dz, float eta,
                                           float3* out) {
  const float k = 1.0f - eta * eta * (1.0f - s.cosi * s.cosi);
  if (!(k >= 0.0f)) return false;
  const float coef = eta * s.cosi + sqrtf(k);
  const float tx = eta * dx - coef * s.nx;
  const float ty = eta * dy - coef * s.ny;
  const float tz = eta * dz - coef * s.nz;
  float tlen = sqrtf(tx * tx + ty * ty + tz * tz);
  if (!(tlen > 0.0f)) tlen = 1.0f;
  *out = make_float3(tx / tlen, ty / tlen, tz / tlen);
  return true;
}
