// Traversal instrument: the per-iteration cost of the traversal's structural
// primitives. Replaces tools/stallbench.py::_kernel (49-103), launched at
// stallbench.py:109, as one kernel templated on the six variants and on the
// block's shape.
//
// One block holds the (8, 128) float carry: the counterpart of the one TPU
// core that runs the plane. A block of 1024 / EPT threads gives each thread
// EPT elements, element e = tid + k * (1024 / EPT) for k < EPT: EPT
// independent chains per thread. The `sm` table (1,024 floats, the TPU
// kernel's SMEM operand) is staged once in shared memory. Each of n_iter
// iterations runs one body on the carry with the loop index i
// (fi = (float)i), computing exactly what the TPU body computes, element by
// element in the same float32 order:
//
//   vecops    64 chained v * 1.0000001f + fi. Measures dependent FP32
//             latency (a multiply and an add each, -fmad=false).
//   tree      bits = int(acc + fi) & 15, OR over all 1,024 elements,
//             acc + float(word) * 1e-9f. The TPU's roll tree (_roll_or)
//             becomes a block-wide OR with one barrier (rt_block_or).
//   extract   the same OR, then a uniform branch on the word (acc + 1e-9f
//             where it is non-zero). It needs only word != 0, which is
//             what the barrier's own reduction gives: __syncthreads_or
//             (bar.red.or.pred) is the barrier and the OR in one
//             instruction. On the TPU the scalar extract crossed from the
//             vector to the scalar unit, which a GPU does not have.
//   while2    a while loop over the word 0x2D | (i & 1), two visits (two
//             lowest-set-bit pops, each a multiply and an add on the carry)
//             per trip. Measures loop-trip overhead on a uniform word. The
//             word's base 0x2D is a kernel argument so that the compiler
//             cannot count the trips at build time.
//   loads72   72 uniform shared loads sm[(i & 63) * 9 + k % 9] folded into
//             the carry. Measures uniform (broadcast) shared-memory loads;
//             the reads are volatile so that the 72 loads of 9 distinct
//             words stay 72 loads, as the TPU's 72 SMEM reads. A thread's
//             EPT elements share each load, as the TPU's plane shares
//             each scalar read.
//   subplane  32 compares of acc * 0.001f + fi against
//             sm[(i & 63) * 6 + b % 6], each OR-ed into bit b % 31, then
//             the block OR and acc + float(word) * 1e-9f. Measures the
//             sub-box gate: 32 volatile shared loads (shared by a thread's
//             elements), compares and the reduction.
//
// The block OR (tree, subplane) takes one barrier per iteration. Each
// warp's __reduce_or_sync result goes to s_part[i & 1][warp]; one
// __syncthreads(); then every warp reads the partial words (lane = warp
// id, one shared wavefront) and ORs them with a second __reduce_or_sync.
// Why one barrier is enough: iteration i writes buffer i & 1 and reads it
// after barrier i. The next write to that buffer is in iteration i + 2.
// A thread reaches it only after barrier i + 1, which no thread passes
// before every thread has arrived there, and every thread arrives there
// only after its reads of iteration i (they come before barrier i + 1 in
// its program order). So no write can overtake a read of the same buffer,
// and the second barrier of the two-buffer-free form (which guarded that
// write-after-read hazard) is not needed. Iteration i + 1 writes the other
// buffer, which no thread of iteration i reads.
//
// What bounds it: one dependent chain per element (the carry never leaves
// registers), the barrier's latency for the three reducing variants, and
// the one SM's issue rate (one block: one SM of the 132). The time per
// iteration is the instrument's result. bounds.stall_bound takes the
// larger of the card's throughput floor and the chain's latency floor.
//
// rt_stall launches the kept shape (kStallEpt); rt_stall_form launches
// either measured shape, as an instrument (`stallbench --variants` times
// them in turns; PERF.md has the numbers).

#include <cuda_runtime.h>

enum RtStallVariant {
  RT_STALL_VECOPS = 0,
  RT_STALL_TREE = 1,
  RT_STALL_EXTRACT = 2,
  RT_STALL_WHILE2 = 3,
  RT_STALL_LOADS72 = 4,
  RT_STALL_SUBPLANE = 5,
};

#define RT_STALL_N 1024  // (8, 128) carry
#define RT_STALL_WHILE_WORD 0x2D

namespace {

constexpr int kStallEpt = 4;  // the kept shape: 256 threads x 4 elements

// OR of `bits` over the whole block, returned to every thread, with one
// barrier: `part` is this iteration's buffer, s_part[i & 1] (see the
// header for why the parity buffers make the second barrier unneeded).
template <int kWarps>
__device__ __forceinline__ unsigned rt_block_or(unsigned bits,
                                                unsigned* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned w = __reduce_or_sync(0xffffffffu, bits);
  if (lane == 0) part[warp] = w;
  __syncthreads();
  const unsigned mine = lane < kWarps ? part[lane] : 0u;
  return __reduce_or_sync(0xffffffffu, mine);
}

template <int V, int EPT>
__global__ void __launch_bounds__(RT_STALL_N / EPT) rt_stall_kernel(
    const float* __restrict__ sm, const float* __restrict__ x,
    float* __restrict__ out, int n_iter, int while_word) {
  constexpr int kThreads = RT_STALL_N / EPT;
  constexpr int kWarps = kThreads / 32;
  __shared__ float s_sm[RT_STALL_N];
  __shared__ unsigned s_part[2][32];
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < EPT; ++k) s_sm[tid + k * kThreads] = sm[tid + k * kThreads];
  __syncthreads();
  const volatile float* vsm = s_sm;
  float acc[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) acc[k] = x[tid + k * kThreads];
  for (int i = 0; i < n_iter; ++i) {
    const float fi = (float)i;
    if (V == RT_STALL_VECOPS) {
#pragma unroll
      for (int j = 0; j < 64; ++j) {
#pragma unroll
        for (int k = 0; k < EPT; ++k) acc[k] = acc[k] * 1.0000001f + fi;
      }
    } else if (V == RT_STALL_TREE) {
      unsigned bits = 0;
#pragma unroll
      for (int k = 0; k < EPT; ++k) bits |= ((int)(acc[k] + fi)) & 15;
      const int word = (int)rt_block_or<kWarps>(bits, s_part[i & 1]);
      const float add = (float)word * 1e-9f;
#pragma unroll
      for (int k = 0; k < EPT; ++k) acc[k] = acc[k] + add;
    } else if (V == RT_STALL_EXTRACT) {
      unsigned bits = 0;
#pragma unroll
      for (int k = 0; k < EPT; ++k) bits |= ((int)(acc[k] + fi)) & 15;
      const float add = __syncthreads_or(bits != 0) ? 1e-9f : 0.0f;
#pragma unroll
      for (int k = 0; k < EPT; ++k) acc[k] = acc[k] + add;
    } else if (V == RT_STALL_WHILE2) {
      int w = while_word | (i & 1);
      while (w != 0) {
        const int iso = w & -w;
#pragma unroll
        for (int k = 0; k < EPT; ++k) acc[k] = acc[k] * 1.0000001f + (float)iso;
        w ^= iso;
        const int iso2 = w & -w;
#pragma unroll
        for (int k = 0; k < EPT; ++k)
          acc[k] = acc[k] * 1.0000001f + (float)iso2;
        w ^= iso2;
      }
    } else if (V == RT_STALL_LOADS72) {
      const int base = (i & 63) * 9;
#pragma unroll
      for (int j = 0; j < 72; ++j) {
        const float v = vsm[base + j % 9] * 1e-9f;
#pragma unroll
        for (int k = 0; k < EPT; ++k) acc[k] = acc[k] + v;
      }
    } else {  // RT_STALL_SUBPLANE
      const int base = (i & 63) * 6;
      float m[EPT];
#pragma unroll
      for (int k = 0; k < EPT; ++k) m[k] = acc[k] * 0.001f + fi;
      unsigned bits = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const float lo = vsm[base + b % 6];
#pragma unroll
        for (int k = 0; k < EPT; ++k)
          if (m[k] > lo) bits |= 1u << (b % 31);
      }
      const int word = (int)rt_block_or<kWarps>(bits, s_part[i & 1]);
      const float add = (float)word * 1e-9f;
#pragma unroll
      for (int k = 0; k < EPT; ++k) acc[k] = acc[k] + add;
    }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) out[tid + k * kThreads] = acc[k];
}

template <int EPT>
int rt_stall_launch(int variant, int n_iter, const float* sm, const float* x,
                    float* out, cudaStream_t s) {
#define RT_STALL_LAUNCH(V)                                                  \
  rt_stall_kernel<V, EPT><<<1, RT_STALL_N / EPT, 0, s>>>(sm, x, out, n_iter, \
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

}  // namespace

// sm: (1024,); x, out: (1024,) = the (8, 128) plane. Returns a cudaError_t.
extern "C" int rt_stall(int variant, int n_iter, const float* sm,
                        const float* x, float* out, void* stream) {
  return rt_stall_launch<kStallEpt>(variant, n_iter, sm, x, out,
                                    (cudaStream_t)stream);
}

// The instrument: the same function with `ept` elements per thread (1:
// 1,024 threads; 4: 256 threads), whichever shape rt_stall keeps.
extern "C" int rt_stall_form(int ept, int variant, int n_iter,
                             const float* sm, const float* x, float* out,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ept == 1) return rt_stall_launch<1>(variant, n_iter, sm, x, out, s);
  if (ept == 4) return rt_stall_launch<4>(variant, n_iter, sm, x, out, s);
  return (int)cudaErrorInvalidValue;
}
