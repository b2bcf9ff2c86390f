// Fused TPC-H aggregates for Hopper (sm_90a), bound with ctypes.
//
// q1_fused_aggregate replaces the four TPU layouts of one function in
// ddb_tpu/ops/pallas_agg.py (q1_fused_aggregate / _v3 / _v4 / _v7, kernel
// bodies _kernel, _kernel3, _kernel4).  Those split every value into
// int32 limb streams because the TPU compiler had no int64; here the
// sums are native int64.  q6_fused_filter_sum replaces _kernel_q6 /
// q6_fused_filter_sum.
//
// Bound on this card: bytes read.  Q1 reads 6 int32 columns (24 B/row),
// Q6 reads 4 (16 B/row), each once; the function needs a few dozen
// integer operations a row.  Both reduce per thread, then by warp
// shuffle, then through one shared-memory pass per block, then with one
// 64-bit atomicAdd per (block, cell) into a zeroed output.  Integer
// atomics commute, so results are exact and deterministic.
//
// q6_kernel: grid-stride loop with coalesced 4-byte loads, one int64
// partial a thread; the loop bound masks the ragged edge.
//
// q1_kernel is designed around three limits of an H100 SM:
//  * Memory latency.  Each thread reads four consecutive rows of a column
//    with one 16-byte ld.global.nc, neighbouring threads neighbouring
//    words, all six columns before the cutoff is tested, and kQ1Unroll
//    such loads a column are in flight: 192 bytes a thread.  The filter
//    is a predicate on the update, not a branch in front of the loads.
//  * Instruction slots.  48 predicated 64-bit register adds a row (one
//    set per group) cost more time to dispatch than the row's bytes cost
//    memory time.
//    Instead each thread owns a table of partial sums in shared memory,
//    indexed by the row's group at run time: a row is one address, five
//    8-byte loads, five 64-bit adds and five stores.  The table is laid
//    out [group][word][thread], so the 16 threads of a half warp always
//    fall in 16 different bank pairs, whatever groups their rows have:
//    no conflicts, and no atomics since no thread shares a slot.
//  * Registers.  With the partials out of the register file the kernel
//    needs 64 registers a thread (ptxas, CUDA 12.8) where 48 int64
//    register partials needed 128; shared memory (60 KiB of tables a
//    block) then allows three blocks, 24 warps, an SM.
// The grid is one resident wave (q1_launch_info asks the occupancy
// calculator); 1024-row chunks are dealt round robin, so blocks end
// together.
//
// Packing.  The eight payloads of a row all fit in 32 bits under the
// input contract, so a row is computed in 32 bits and added as five
// 64-bit words:
//    word 0   qty   bits 0-31 | disc bits 32-47 | count bits 48-63
//    word 1   dpA   bits 0-31 | dpB  bits 32-63
//    words 2, 3, 4   ext, chA, chB
// The fields are packed from unsigned values: the contract's inputs are
// non-negative, and a negative qty or disc would borrow across fields.
// A field must not overflow into its neighbour.  At the contract's maxima
// disc (100 a row in 16 bits) and dpB (65,535 * 100 a row in 32 bits)
// hold 655 rows, dpA 1,310, qty 4,096.  So after every kFlushRows = 512
// rows of a thread, and at the end, the warp unpacks its tables, sums the
// eight payloads of each group in int64 by shuffle and adds them to its
// row of per-warp int64 partials; the tables start again from zero.  A
// thread adds at most one row (the ragged tail) beyond that, so no field
// ever holds more than 513 rows.
//
// Alignment.  The 16-byte loads need all six pointers 16-byte aligned.
// The wrapper tests data_ptr() % 16 and otherwise launches the kVec =
// false instantiation of the same body: four coalesced 4-byte loads a
// column, guarded by the row count.  In the vector instantiation the
// last n % 4 rows are read with 4-byte loads by block 0.  Nothing reads
// past n.
//
// Input contract (as the TPU kernels): 0 <= disc <= 100, 0 <= tax <= 8,
// 0 <= qty <= 2^20, 0 <= ext < 2^31; Q1 rows with ship <= cutoff carry a
// gid in [0, 6) (rf*2 + ls).  A row whose gid is outside [0, 6) adds
// nothing and indexes nothing, whether or not it passes the cutoff.  The
// inputs are read through the non-coherent path: no other stream may
// write them during the launch.

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

// ---- q1_kernel -------------------------------------------------------------

constexpr int kQ1Threads = 256;
constexpr int kQ1Warps = kQ1Threads / 32;
constexpr int kQ1Unroll = 2;      // 16-byte loads a column in flight
constexpr int kWords = 5;         // packed 64-bit words a group
constexpr int kFlushRows = 512;   // rows a thread packs between flushes
constexpr int kDiscShift = 32;    // word 0: qty | disc << 32 | count << 48
constexpr int kCountShift = 48;
constexpr int kDpBShift = 32;     // word 1: dpA | dpB << 32
constexpr int kQ1TableBytes = kGroups * kWords * kQ1Threads * 8;
typedef unsigned long long u64;

// Four rows of one column for this thread.  kVec: rows 4v .. 4v+3 of
// vector v = chunk * kQ1Threads + thread, one 16-byte load.  Otherwise
// rows chunk * 1024 + j * kQ1Threads + thread, j = 0..3, 4 bytes each.
// Rows at or past n read nothing and get `fill`.
template <bool kVec>
__device__ __forceinline__ void load4(const int32_t* __restrict__ p,
                                      int64_t chunk, int64_t n, int fill,
                                      int (&x)[4]) {
  if (kVec) {
    const int64_t v = chunk * kQ1Threads + threadIdx.x;
    int4 r = make_int4(fill, fill, fill, fill);
    if (v < (n >> 2)) r = __ldg((const int4*)p + v);
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  } else {
    const int64_t r0 = chunk * (kQ1Threads * 4) + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = r0 + j * kQ1Threads;
      x[j] = r < n ? __ldg(p + r) : fill;
    }
  }
}

// One surviving row into this thread's table (tab points at its column).
__device__ __forceinline__ void q1_add_row(u64* tab, int q, int e, int d,
                                           int t, int g) {
  const uint32_t m = 100u - (uint32_t)d, f = 100u + (uint32_t)t;
  const uint32_t dpA = ((uint32_t)e >> 16) * m;   // disc_price = dpA*2^16+dpB
  const uint32_t dpB = ((uint32_t)e & 0xFFFFu) * m;
  const u64 w[kWords] = {
      (u64)(uint32_t)q | ((u64)(uint32_t)d << kDiscShift)
          | (1ull << kCountShift),
      (u64)dpA | ((u64)dpB << kDpBShift),
      (u64)(uint32_t)e, (u64)(dpA * f), (u64)(dpB * f)};
  u64* p = tab + g * (kWords * kQ1Threads);
#pragma unroll
  for (int k = 0; k < kWords; ++k) p[k * kQ1Threads] += w[k];
}

// Unpack this thread's tables, sum each payload over the warp in int64,
// add the sums to the warp's partials and zero the tables.  Every lane of
// the warp must call it together.
__device__ __forceinline__ void q1_flush(u64* tab, long long* warp_part,
                                         int lane) {
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    u64 w[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      w[k] = tab[(g * kWords + k) * kQ1Threads];
      tab[(g * kWords + k) * kQ1Threads] = 0;
    }
    constexpr u64 kDiscMask = (1ull << (kCountShift - kDiscShift)) - 1;
    const long long v[kPayloads] = {
        (long long)(w[0] & ((1ull << kDiscShift) - 1)), (long long)w[2],
        (long long)((w[0] >> kDiscShift) & kDiscMask),
        (long long)(w[0] >> kCountShift),
        (long long)(w[1] & ((1ull << kDpBShift) - 1)),
        (long long)(w[1] >> kDpBShift), (long long)w[3], (long long)w[4]};
#pragma unroll
    for (int p = 0; p < kPayloads; ++p) {
      const long long s = warp_sum(v[p]);
      if (lane == 0) warp_part[g * kPayloads + p] += s;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kQ1Threads)
q1_kernel(const int32_t* __restrict__ qty, const int32_t* __restrict__ ext,
          const int32_t* __restrict__ disc, const int32_t* __restrict__ tax,
          const int32_t* __restrict__ ship, const int32_t* __restrict__ gid,
          int32_t cutoff, int64_t n, unsigned long long* __restrict__ out) {
  extern __shared__ u64 tables[];          // [group][word][thread]
  __shared__ long long part[kQ1Warps][kCells];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  u64* tab = tables + threadIdx.x;
#pragma unroll
  for (int c = 0; c < kGroups * kWords; ++c) tab[c * kQ1Threads] = 0;
  for (int c = lane; c < kCells; c += 32) part[warp][c] = 0;
  __syncwarp();

  auto row = [&](int q, int e, int d, int t, int s, int g) {
    if (s <= cutoff && (unsigned)g < (unsigned)kGroups) {
      q1_add_row(tab, q, e, d, t, g);
    }
  };

  // every block makes the same number of iterations, so a warp's lanes
  // reach each flush together
  const int64_t chunks = kVec ? ((n >> 2) + kQ1Threads - 1) / kQ1Threads
                              : (n + kQ1Threads * 4 - 1) / (kQ1Threads * 4);
  const int64_t per_iter = (int64_t)gridDim.x * kQ1Unroll;
  const int64_t iters = (chunks + per_iter - 1) / per_iter;
  constexpr int kFlushIters = kFlushRows / (4 * kQ1Unroll);
  for (int64_t it = 0; it < iters; ++it) {
    int x[kQ1Unroll][6][4];
#pragma unroll
    for (int u = 0; u < kQ1Unroll; ++u) {
      const int64_t chunk = (it * gridDim.x + blockIdx.x) * kQ1Unroll + u;
      load4<kVec>(qty, chunk, n, 0, x[u][0]);
      load4<kVec>(ext, chunk, n, 0, x[u][1]);
      load4<kVec>(disc, chunk, n, 0, x[u][2]);
      load4<kVec>(tax, chunk, n, 0, x[u][3]);
      load4<kVec>(ship, chunk, n, 0, x[u][4]);
      load4<kVec>(gid, chunk, n, -1, x[u][5]);   // rows past n: no group
    }
#pragma unroll
    for (int u = 0; u < kQ1Unroll; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        row(x[u][0][j], x[u][1][j], x[u][2][j], x[u][3][j], x[u][4][j],
            x[u][5][j]);
      }
    }
    if ((it + 1) % kFlushIters == 0) q1_flush(tab, part[warp], lane);
  }
  if (kVec && blockIdx.x == 0) {           // the last n % 4 rows
    const int64_t r = (n & ~(int64_t)3) + threadIdx.x;
    if (r < n) row(qty[r], ext[r], disc[r], tax[r], ship[r], gid[r]);
  }
  q1_flush(tab, part[warp], lane);
  __syncthreads();
  if (threadIdx.x < kCells) {
    long long s = 0;
#pragma unroll
    for (int w = 0; w < kQ1Warps; ++w) s += part[w][threadIdx.x];
    if (s != 0) atomicAdd(&out[threadIdx.x], (unsigned long long)s);
  }
}

// ---- q6_kernel -------------------------------------------------------------

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

typedef void (*Q1Kernel)(const int32_t*, const int32_t*, const int32_t*,
                         const int32_t*, const int32_t*, const int32_t*,
                         int32_t, int64_t, unsigned long long*);

static Q1Kernel q1_instance(int32_t vec) {
  return vec ? q1_kernel<true> : q1_kernel<false>;
}

// Prepares one q1_kernel instantiation (vec: 16-byte loads, or 4-byte) on
// the current device for its dynamic shared memory and reports its launch
// shape: info = {threads a block, dynamic shared bytes a block, registers
// a thread, resident blocks an SM}.  Call once per device and
// instantiation before q1_fused_aggregate.  Returns the CUDA error (0 = ok).
extern "C" int q1_launch_info(int32_t vec, int32_t* info) {
  const void* fn = (const void*)q1_instance(vec);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kQ1TableBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  }
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int resident = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, fn, kQ1Threads, kQ1TableBytes);
  }
  if (err != cudaSuccess) return (int)err;
  info[0] = kQ1Threads;
  info[1] = kQ1TableBytes;
  info[2] = attr.numRegs;
  info[3] = resident;
  return 0;
}

extern "C" int q1_fused_aggregate(const void* qty, const void* ext,
                                  const void* disc, const void* tax,
                                  const void* ship, const void* gid,
                                  int32_t cutoff, int64_t n, void* out,
                                  int32_t vec, int32_t blocks, void* stream) {
  q1_instance(vec)<<<blocks, kQ1Threads, kQ1TableBytes,
                     (cudaStream_t)stream>>>(
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
