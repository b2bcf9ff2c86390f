// Compare-exchange stages of a bitonic network for Hopper (sm_90a), bound
// with ctypes.
//
// cmpx_stages replaces the Pallas kernel of scripts/exp_mosaic_cmpx.py
// (`kernel` inside main(), launched by main.run): on every tile of `rows`
// rows x 128 lanes of (hi, lo) int32 pairs it runs `stages`
// compare-exchange stages, stage t at row distance d = dmin << (t % 5).
// Row i exchanges with row i ^ d of the same lane and tile; the row with
// bit d clear keeps the lexicographic minimum of the two pairs, the other
// the maximum, hi and lo both compared as signed int32.
//
// Bound on this card: integer operations.  Each pair is read once and
// written once (16 B), and between goes through `stages` compare-exchanges,
// each a two-step lexicographic compare and four selects for two rows.  At
// 45 stages that is 135 int32 operations a pair against 16 bytes: about
// 1.7 times as long in the integer units as in device memory at the
// card's published rates.  Design:
//  * the TPU tile (512 x 128 pairs, 512 KiB) does not fit a block's
//    shared memory and need not: lanes never exchange, and the five
//    distances dmin << 0..4 only ever connect rows that differ in five
//    row-index bits.  Such a group of 32 rows of one lane is closed under
//    every stage, so one thread loads it into registers (64 of them),
//    runs all stages there, and stores it.  No shared memory, no
//    synchronisation, one read and one write of device memory;
//  * the 32 threads of a warp hold 32 neighbouring lanes, so every load
//    and store of a row is one coalesced 128-byte line;
//  * the exchange pattern is unrolled at compile time (the distance
//    index is a template parameter), so the group stays in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;    // lanes of a row (the TPU tile's minor axis)
constexpr int kGroup = 32;     // rows closed under distances dmin << 0..4
constexpr int kThreads = 128;  // one group of rows x all lanes per block

// One stage at local distance 1 << J over the thread's 32 pairs.
template <int J>
__device__ __forceinline__ void stage(int32_t (&h)[kGroup],
                                      int32_t (&l)[kGroup]) {
  constexpr int d = 1 << J;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if ((k & d) == 0) {
      const int p = k | d;
      const bool gt = (h[k] > h[p]) | ((h[k] == h[p]) & (l[k] > l[p]));
      const int32_t hk = h[k], lk = l[k];
      h[k] = gt ? h[p] : hk;
      l[k] = gt ? l[p] : lk;
      h[p] = gt ? hk : h[p];
      l[p] = gt ? lk : l[p];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cmpx_kernel(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
            int32_t* __restrict__ out_hi, int32_t* __restrict__ out_lo,
            int64_t total_rows, int32_t stages, int32_t dmin) {
  // block b owns group b: the rows whose index agrees with b outside the
  // five bits the distances touch.  With q = b / dmin and r = b % dmin the
  // group's first row is q * 32 * dmin + r, and its k-th row lies k * dmin
  // further.  Tiles are multiples of 32 * dmin rows, so a group never
  // crosses a tile.
  const int64_t g = blockIdx.x;
  const int64_t first = (g / dmin) * kGroup * dmin + (g % dmin);
  if (first + (int64_t)(kGroup - 1) * dmin >= total_rows) return;
  const int64_t base = first * kLanes + threadIdx.x;
  const int64_t step = (int64_t)dmin * kLanes;

  int32_t h[kGroup], l[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    h[k] = hi[base + k * step];
    l[k] = lo[base + k * step];
  }
  int t = 0;
  for (; t + 5 <= stages; t += 5) {
    stage<0>(h, l);
    stage<1>(h, l);
    stage<2>(h, l);
    stage<3>(h, l);
    stage<4>(h, l);
  }
  if (t + 0 < stages) stage<0>(h, l);
  if (t + 1 < stages) stage<1>(h, l);
  if (t + 2 < stages) stage<2>(h, l);
  if (t + 3 < stages) stage<3>(h, l);
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    out_hi[base + k * step] = h[k];
    out_lo[base + k * step] = l[k];
  }
}

}  // namespace

// Entry point: pointers and the stream arrive as void*.  total_rows is
// tiles * rows; the caller has checked that rows is a power of two above
// 16 * dmin and dmin a power of two, so total_rows / 32 groups cover
// every row once.  Returns cudaGetLastError() after the launch.
extern "C" int cmpx_stages(const void* hi, const void* lo, void* out_hi,
                           void* out_lo, int64_t total_rows, int32_t stages,
                           int32_t dmin, void* stream) {
  const int64_t groups = total_rows / kGroup;
  if (groups == 0) return 0;
  if (groups > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cmpx_kernel<<<(unsigned)groups, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, (int32_t*)out_hi,
      (int32_t*)out_lo, total_rows, stages, dmin);
  return (int)cudaGetLastError();
}
