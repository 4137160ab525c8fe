// Traversal instrument: the per-iteration cost of the traversal's structural
// primitives. Replaces tools/stallbench.py::_kernel (49-103), launched at
// stallbench.py:109, as one kernel templated on the six variants.
//
// One block of 1,024 threads holds the (8, 128) float carry, one element
// per thread: the counterpart of the one TPU core that runs the plane. The
// `sm` table (1,024 floats, the TPU kernel's SMEM operand) is staged once
// in shared memory. Each of n_iter iterations runs one body on the carry
// with the loop index i (fi = (float)i), computing exactly what the TPU
// body computes:
//
//   vecops    64 chained v * 1.0000001f + fi. Measures dependent FP32
//             latency (a multiply and an add each, -fmad=false).
//   tree      bits = int(acc + fi) & 15, OR over all 1,024 elements,
//             acc + float(word) * 1e-9f. The TPU's roll-tree (_roll_or)
//             becomes a block-wide OR: __reduce_or_sync per warp, a
//             32-word shared array, two barriers. Measures the cost of a
//             block-wide reduction with two barriers.
//   extract   the same OR, then a uniform branch on the word (acc + 1e-9f
//             where it is non-zero). Measures the reduction plus a
//             block-uniform branch on its result; on the TPU the scalar
//             extract crossed from the vector to the scalar unit, which a
//             GPU does not have, so this should cost what `tree` costs.
//   while2    a while loop over the word 0x2D | (i & 1), two visits (two
//             lowest-set-bit pops, each a multiply-add on the carry) per
//             trip. Measures loop-trip overhead on a uniform word. The
//             word's base 0x2D is a kernel argument so that the compiler
//             cannot count the trips at build time.
//   loads72   72 uniform shared loads sm[(i & 63) * 9 + k % 9] folded into
//             the carry. Measures uniform (broadcast) shared-memory loads;
//             the reads are volatile so that the 72 loads of 9 distinct
//             words stay 72 loads, as the TPU's 72 SMEM reads.
//   subplane  32 compares of acc * 0.001f + fi against
//             sm[(i & 63) * 6 + b % 6], each OR-ed into bit b % 31, then
//             the block OR and acc + float(word) * 1e-9f. Measures the
//             sub-box gate: 32 volatile shared loads, compares and the
//             reduction.
//
// What bounds it: latency of one dependent chain per thread (the carry
// never leaves registers), plus barrier latency for the three reducing
// variants. One block, so one SM of the 132; the time per iteration is
// the instrument's result.

#include <cuda_runtime.h>

enum RtStallVariant {
  RT_STALL_VECOPS = 0,
  RT_STALL_TREE = 1,
  RT_STALL_EXTRACT = 2,
  RT_STALL_WHILE2 = 3,
  RT_STALL_LOADS72 = 4,
  RT_STALL_SUBPLANE = 5,
};

#define RT_STALL_N 1024  // (8, 128) carry, one element per thread
#define RT_STALL_WARPS (RT_STALL_N / 32)
#define RT_STALL_WHILE_WORD 0x2D

// OR of `bits` over the whole block, returned to every thread: one warp
// reduce, a barrier, warp 0 reduces the 32 partial words, a barrier.
__device__ __forceinline__ int rt_block_or(int bits, int* s_part,
                                           int* s_word) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned w = __reduce_or_sync(0xffffffffu, (unsigned)bits);
  if (lane == 0) s_part[warp] = (int)w;
  __syncthreads();
  if (warp == 0) {
    const unsigned all = __reduce_or_sync(0xffffffffu, (unsigned)s_part[lane]);
    if (lane == 0) *s_word = (int)all;
  }
  __syncthreads();
  return *s_word;
}

template <int V>
__global__ void __launch_bounds__(RT_STALL_N) rt_stall_kernel(
    const float* __restrict__ sm, const float* __restrict__ x,
    float* __restrict__ out, int n_iter, int while_word) {
  __shared__ float s_sm[RT_STALL_N];
  __shared__ int s_part[RT_STALL_WARPS];
  __shared__ int s_word;
  const int tid = threadIdx.x;
  s_sm[tid] = sm[tid];
  __syncthreads();
  const volatile float* vsm = s_sm;
  float acc = x[tid];
  for (int i = 0; i < n_iter; ++i) {
    const float fi = (float)i;
    if (V == RT_STALL_VECOPS) {
#pragma unroll
      for (int k = 0; k < 64; ++k) acc = acc * 1.0000001f + fi;
    } else if (V == RT_STALL_TREE) {
      const int bits = ((int)(acc + fi)) & 15;
      const int word = rt_block_or(bits, s_part, &s_word);
      acc = acc + (float)word * 1e-9f;
    } else if (V == RT_STALL_EXTRACT) {
      const int bits = ((int)(acc + fi)) & 15;
      const int word = rt_block_or(bits, s_part, &s_word);
      if (word != 0) {
        acc = acc + 1e-9f;
      } else {
        acc = acc + 0.0f;
      }
    } else if (V == RT_STALL_WHILE2) {
      int w = while_word | (i & 1);
      while (w != 0) {
        const int iso = w & -w;
        acc = acc * 1.0000001f + (float)iso;
        w ^= iso;
        const int iso2 = w & -w;
        acc = acc * 1.0000001f + (float)iso2;
        w ^= iso2;
      }
    } else if (V == RT_STALL_LOADS72) {
      const int base = (i & 63) * 9;
#pragma unroll
      for (int k = 0; k < 72; ++k) acc = acc + vsm[base + k % 9] * 1e-9f;
    } else {  // RT_STALL_SUBPLANE
      const int base = (i & 63) * 6;
      const float m = acc * 0.001f + fi;
      int bits = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if (m > vsm[base + b % 6]) bits |= 1 << (b % 31);
      const int word = rt_block_or(bits, s_part, &s_word);
      acc = acc + (float)word * 1e-9f;
    }
  }
  out[tid] = acc;
}

// sm: (1024,); x, out: (1024,) = the (8, 128) plane. Returns a cudaError_t.
extern "C" int rt_stall(int variant, int n_iter, const float* sm,
                        const float* x, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RT_STALL_LAUNCH(V)                                            \
  rt_stall_kernel<V><<<1, RT_STALL_N, 0, s>>>(sm, x, out, n_iter,     \
                                              RT_STALL_WHILE_WORD)
  switch (variant) {
    case RT_STALL_VECOPS: RT_STALL_LAUNCH(RT_STALL_VECOPS); break;
    case RT_STALL_TREE: RT_STALL_LAUNCH(RT_STALL_TREE); break;
    case RT_STALL_EXTRACT: RT_STALL_LAUNCH(RT_STALL_EXTRACT); break;
    case RT_STALL_WHILE2: RT_STALL_LAUNCH(RT_STALL_WHILE2); break;
    case RT_STALL_LOADS72: RT_STALL_LAUNCH(RT_STALL_LOADS72); break;
    case RT_STALL_SUBPLANE: RT_STALL_LAUNCH(RT_STALL_SUBPLANE); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_STALL_LAUNCH
  return (int)cudaGetLastError();
}
