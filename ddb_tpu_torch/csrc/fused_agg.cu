// Fused TPC-H aggregates for Hopper (sm_90a), bound with ctypes.
//
// q1_fused_aggregate replaces the four TPU layouts of one function in
// ddb_tpu/ops/pallas_agg.py (q1_fused_aggregate / _v3 / _v4 / _v7, kernel
// bodies _kernel, _kernel3, _kernel4).  Those split every value into
// int32 limb streams because the TPU compiler had no int64; here each
// thread accumulates the 6x8 (group, payload) sums in native int64.
// q6_fused_filter_sum replaces _kernel_q6 / q6_fused_filter_sum.
//
// Bound on this card: bytes read.  Q1 reads 6 int32 columns (24 B/row),
// Q6 reads 4 (16 B/row); each row does a few dozen integer operations,
// so the kernels stream their inputs once and keep every partial sum in
// registers.  Design:
//  * grid-stride loop with coalesced 4-byte loads; the ragged edge is
//    masked by the loop bound, so any row count works;
//  * per-thread int64 partials; the group is selected with unrolled
//    `if (g == G)` adds so the accumulators stay in registers (indexing
//    them by a runtime group id would spill them to local memory);
//  * warp shuffle reduction, then one shared-memory pass per block, then
//    one 64-bit atomicAdd per (block, cell) into a zeroed output.
//    Integer atomics commute, so results are exact and deterministic.
//
// Input contract (as the TPU kernels): disc <= 100, tax <= 8,
// qty <= 2^20, 0 <= ext < 2^31; Q1 rows with ship <= cutoff carry a
// gid in [0, 6) (rf*2 + ls).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroups = 6;
constexpr int kPayloads = 8;   // qty, ext, disc, count, dpA, dpB, chA, chB
constexpr int kCells = kGroups * kPayloads;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
q1_kernel(const int32_t* __restrict__ qty, const int32_t* __restrict__ ext,
          const int32_t* __restrict__ disc, const int32_t* __restrict__ tax,
          const int32_t* __restrict__ ship, const int32_t* __restrict__ gid,
          int32_t cutoff, int64_t n, unsigned long long* __restrict__ out) {
  long long acc[kGroups][kPayloads];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int p = 0; p < kPayloads; ++p) acc[g][p] = 0;
  }

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (ship[i] > cutoff) continue;
    const int g = gid[i];
    const long long e = ext[i];
    const long long m = 100 - disc[i];
    const long long t = 100 + tax[i];
    const long long dpA = (e >> 16) * m;      // disc_price = dpA*2^16 + dpB
    const long long dpB = (e & 0xFFFF) * m;
    const long long v[kPayloads] = {qty[i], e, disc[i], 1,
                                    dpA, dpB, dpA * t, dpB * t};
#pragma unroll
    for (int G = 0; G < kGroups; ++G) {
      if (g == G) {
#pragma unroll
        for (int p = 0; p < kPayloads; ++p) acc[G][p] += v[p];
      }
    }
  }

  __shared__ long long part[kWarps][kCells];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int p = 0; p < kPayloads; ++p) {
      const long long s = warp_sum(acc[g][p]);
      if (lane == 0) part[warp][g * kPayloads + p] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x < kCells) {
    long long s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    if (s != 0) atomicAdd(&out[threadIdx.x], (unsigned long long)s);
  }
}

__global__ void __launch_bounds__(kThreads)
q6_kernel(const int32_t* __restrict__ qty, const int32_t* __restrict__ ext,
          const int32_t* __restrict__ disc, const int32_t* __restrict__ ship,
          int32_t cut, int64_t n, unsigned long long* __restrict__ out) {
  long long acc = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t s = ship[i];
    const int32_t d = disc[i];
    if (s >= cut && s < cut + 365 && d >= 5 && d <= 7 && qty[i] < 24) {
      acc += (long long)ext[i] * d;   // up to 2^31 * 7: needs int64
    }
  }
  __shared__ long long part[kWarps];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w];
    if (s != 0) atomicAdd(out, (unsigned long long)s);
  }
}

}  // namespace

// Entry points: pointers and the stream arrive as void*, counts as int64;
// each returns cudaGetLastError() after its launch (0 = launched).

extern "C" int q1_fused_aggregate(const void* qty, const void* ext,
                                  const void* disc, const void* tax,
                                  const void* ship, const void* gid,
                                  int32_t cutoff, int64_t n, void* out,
                                  int32_t blocks, void* stream) {
  q1_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qty, (const int32_t*)ext, (const int32_t*)disc,
      (const int32_t*)tax, (const int32_t*)ship, (const int32_t*)gid, cutoff,
      n, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int q6_fused_filter_sum(const void* qty, const void* ext,
                                   const void* disc, const void* ship,
                                   int32_t cut, int64_t n, void* out,
                                   int32_t blocks, void* stream) {
  q6_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)qty, (const int32_t*)ext, (const int32_t*)disc,
      (const int32_t*)ship, cut, n, (unsigned long long*)out);
  return (int)cudaGetLastError();
}
