// The int32 min/max chain of the sort study, for Hopper (sm_90a), bound
// with ctypes.
//
// vpu_chain replaces no TPU kernel.  It is the counterpart of the XLA
// fusion that scripts/bench_sort_study.py times as its case `vpu_chain`
// (the loop body `vpu`): x = k + i, then 48 times x = min(max(x, lo_c),
// hi_c), 96 elementwise int32 operations that XLA fuses into one pass.
// The study reads the chip's int32 operation rate from it, the rate that
// bounds a network of compare-exchanges (csrc/cmpx.cu).  Eager torch would
// run 96 passes over memory and measure bandwidth instead, so the probe
// needs a kernel of its own.
//
// Bound on this card: integer operations.  Each element is read once and
// written once (8 B) and goes through 96 min/max operations: at the
// card's published rates about 2.4 times as long in the integer units as
// in device memory.  Design:
//  * the 96 bounds are a kernel parameter, passed at run time: the
//    compiler cannot fold the chain into one clamp, and every bound is an
//    operand from the constant bank, not a register or a load;
//  * every thread takes four neighbouring elements with one 16-byte load
//    and runs four independent chains, so the integer pipe always has an
//    operation whose input is ready;
//  * a grid of a few blocks an SM walks the array in strides; elements
//    past the last whole group of four (or all of them, when a pointer is
//    not 16-byte aligned) take a scalar loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 48;       // the chain: max then min, 48 times
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Bounds {
  int32_t v[2 * kPairs];         // v[2c]: max's operand, v[2c + 1]: min's
};

__device__ __forceinline__ int32_t chain(int32_t x, int32_t add,
                                         const Bounds& b) {
  x = (int32_t)((uint32_t)x + (uint32_t)add);   // wraps, as torch's add
#pragma unroll
  for (int c = 0; c < kPairs; ++c) {
    x = max(x, b.v[2 * c]);
    x = min(x, b.v[2 * c + 1]);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
vpu_chain_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                 int64_t n, int64_t n4, int32_t add, const Bounds b) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int4* in4 = reinterpret_cast<const int4*>(in);
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int64_t i = first; i < n4; i += stride) {
    int4 v = in4[i];
    v.x = chain(v.x, add, b);
    v.y = chain(v.y, add, b);
    v.z = chain(v.z, add, b);
    v.w = chain(v.w, add, b);
    out4[i] = v;
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride) {
    out[i] = chain(in[i], add, b);
  }
}

}  // namespace

// Entry point: pointers and the stream arrive as void*, the 96 bounds as
// a host array (copied into the kernel's parameter).  Returns
// cudaGetLastError() after the launch.
extern "C" int vpu_chain(const void* in, void* out, int64_t n, int32_t add,
                         const int32_t* bounds, void* stream) {
  if (n <= 0) return 0;
  Bounds b;
  for (int k = 0; k < 2 * kPairs; ++k) b.v[k] = bounds[k];
  const bool aligned = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int64_t n4 = aligned ? n / 4 : 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t work = n4 > 0 ? n4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (int64_t)sms * kBlocksPerSm) blocks = (int64_t)sms * kBlocksPerSm;
  vpu_chain_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, n, n4, add, b);
  return (int)cudaGetLastError();
}
