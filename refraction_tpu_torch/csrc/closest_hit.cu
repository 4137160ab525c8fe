// Batch closest hit: one thread per ray around rt_closest_hit
// (traverse_f2b.cuh), in its flat, supers or roots instance as the scene
// has super boxes, root boxes, or neither.
//
// Replaces refraction_tpu/kernels/intersect_pallas.py::_pallas_closest
// (1301-1352; kernel bodies _kernel at 140 and _tile_kernel at 170) and its
// entry pallas_intersect (1355-1406). It is not on the fused frame path; it
// lets the traversal be checked alone, and serves the eager integrator's
// "cuda" backend.
//
// Bound on the H100: the traversal's FP32 operations (refraction_tpu_torch/
// bounds.py counts them for the rays of a call); per ray it reads 28 bytes
// and writes 20. The TPU version
// fell back to a brute force past its 1 MB scalar-memory budget; here the
// tables live in global memory, so there is no size limit and no fallback.
//
// Output on a miss (or a dead ray, cull == 0): t = +inf, idx = -1,
// normal = 0.

#include <cuda_runtime.h>

#include "traverse_f2b.cuh"

template <int WALK>
__global__ void rt_closest_hit_kernel(
    const float* __restrict__ tri, const float* __restrict__ norm,
    const float* __restrict__ roots, const float* __restrict__ supers,
    const float* __restrict__ clusters, const float* __restrict__ subs,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ cull, int n, float tmin, float tmax,
    int n_roots, int n_supers, int n_clusters, int cluster_size,
    int sub_tris, float* __restrict__ t_out, int* __restrict__ idx_out,
    float* __restrict__ n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const RtScene scene{supers, clusters, subs, tri, norm, n_supers,
                      n_clusters, cluster_size / sub_tris, sub_tris, roots,
                      n_roots};
  const RtHit h = rt_closest_hit<WALK>(
      scene, origins[3 * i], origins[3 * i + 1], origins[3 * i + 2],
      dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], cull[i], tmin, tmax,
      false);
  t_out[i] = h.t;
  idx_out[i] = h.idx;
  n_out[3 * i] = h.nx;
  n_out[3 * i + 1] = h.ny;
  n_out[3 * i + 2] = h.nz;
}

extern "C" int rt_closest_hit(
    const float* tri, const float* norm, const float* roots,
    const float* supers, const float* clusters, const float* subs,
    const float* origins, const float* dirs, const float* cull, int n,
    float tmin, float tmax, int n_roots, int n_supers, int n_clusters,
    int cluster_size, int sub_tris, float* t_out, int* idx_out,
    float* n_out, void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
#define RT_CLOSEST_LAUNCH(WALK)                                               \
  rt_closest_hit_kernel<WALK><<<grid, block, 0, (cudaStream_t)stream>>>(      \
      tri, norm, roots, supers, clusters, subs, origins, dirs, cull, n, tmin, \
      tmax, n_roots, n_supers, n_clusters, cluster_size, sub_tris, t_out,     \
      idx_out, n_out)
  if (n_roots > 0) {
    RT_CLOSEST_LAUNCH(RT_WALK_ROOTS);
  } else if (n_supers > 0) {
    RT_CLOSEST_LAUNCH(RT_WALK_SUPERS);
  } else {
    RT_CLOSEST_LAUNCH(RT_WALK_FLAT);
  }
#undef RT_CLOSEST_LAUNCH
  return (int)cudaGetLastError();
}

// The instance walk of a two-level scene (RT_WALK_INSTANCES) on a batch of
// rays: the frame kernel's closest hit, checked alone against its plain
// version (kernels/intersect.instance_hit_plain). idx_out is the winner's
// key (its instance's key base plus its BLAS table index), -1 on a miss.
__global__ void rt_instance_hit_kernel(
    const float* __restrict__ tri, const float* __restrict__ norm,
    const float* __restrict__ supers, const float* __restrict__ clusters,
    const float* __restrict__ subs, const float* __restrict__ inst_boxes,
    const float* __restrict__ inst_roots,
    const float* __restrict__ inst_xform, const int* __restrict__ inst_info,
    int n_inst, int n_inst_roots, int sub_tris,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ cull, int n, float tmin, float tmax,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    float* __restrict__ n_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const RtInstScene scene{
      RtScene{supers, clusters, subs, tri, norm, 0, 0, 0, sub_tris, nullptr,
              0},
      inst_boxes, inst_roots, inst_xform, inst_info, n_inst, n_inst_roots};
  const RtHit h = rt_closest_hit<RT_WALK_INSTANCES>(
      scene, origins[3 * i], origins[3 * i + 1], origins[3 * i + 2],
      dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], cull[i], tmin, tmax,
      false);
  t_out[i] = h.t;
  idx_out[i] = h.idx;
  n_out[3 * i] = h.nx;
  n_out[3 * i + 1] = h.ny;
  n_out[3 * i + 2] = h.nz;
}

extern "C" int rt_instance_hit(
    const float* tri, const float* norm, const float* supers,
    const float* clusters, const float* subs, const float* inst_boxes,
    const float* inst_roots, const float* inst_xform, const int* inst_info,
    int n_inst, int n_inst_roots, int sub_tris, const float* origins,
    const float* dirs, const float* cull, int n, float tmin, float tmax,
    float* t_out, int* idx_out, float* n_out, void* stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  rt_instance_hit_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tri, norm, supers, clusters, subs, inst_boxes, inst_roots, inst_xform,
      inst_info, n_inst, n_inst_roots, sub_tris, origins, dirs, cull, n, tmin,
      tmax, t_out, idx_out, n_out);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
