// Dense (perfect-hash) grouped aggregate for Hopper (sm_90a), bound with
// ctypes.
//
// dense_kernel computes, in one pass over the rows, every exact-integer
// aggregate of one ops/aggregate.py:dense_group_aggregate call: the count
// of each group, the non-NULL count of each payload that has NULLs, and
// the int64 sum (one word) or the two int64 limb sums (lo = v &
// 0xffffffff, hi = v >> 32, or a column of high limbs summed as a column
// of its own) of each summed column.  It replaces no TPU kernel: the JAX
// package's dense path is XLA, one masked reduction per (group,
// payload), which on this card is a few hundred passes over the rows for
// TPC-H Q1.  ops/aggregate.py finalises avg, the wide sums and the float
// kinds in torch, as the masked loop does, so the results are
// bit-identical to it (wrapping int64 addition commutes).
//
// Bound on this card: bytes read.  Each column is read once (gid int32,
// sel and the NULL masks one byte, the values at their own width).
//  * Loads.  Each thread reads four consecutive rows of a column with one
//    16-byte ld.global.nc (an int64 column two), kU = 8 such vectors at a
//    time, into registers the same on every path (predicated loads, no
//    moves that would wait for them).  The columns are a list known at
//    run time, so the pipeline runs over the flattened (step, column)
//    sequence with two register buffers used in turn: the next column
//    (or the next step's group ids) is in flight while the current one
//    is added.  Without the table updates below, this reads Q1's
//    columns at 0.91 of the byte bound.
//  * Table updates, the limit.  A row adds to a table of partial sums
//    private to its thread, in shared memory, indexed by the row's group
//    at run time: a word is one 8-byte load, one add and one store.  The
//    table is laid out [group][word][thread], so the 16 threads of a half
//    warp always fall in 16 different bank pairs whatever their groups:
//    no conflicts and no atomics (shared-memory atomics measured slower).
//    In the 16-byte instantiation the per-row code is instantiated for
//    each value width and sum mode (take_col_t): branching on them a row
//    read Q1's columns at 0.55 of the byte bound, the instantiations at
//    0.87.
//  * Shared memory.  A launch holds at most kMaxCells = domain * words
//    cells a thread (113 * 256 * 8 B fits the 227 KB of one SM);
//    ops/aggregate.py splits a call with more words over several
//    launches, each of which reads its own columns once.  The grid is one
//    resident wave (one block of 256 threads an SM: the table's shared
//    memory and the buffers' registers allow no more); steps of
//    kRowsPerStep rows are dealt round robin.  At the end each warp sums a
//    share of the block's cells over the 256 tables and adds it with one
//    64-bit atomicAdd into the zeroed output [words][domain].  Integer
//    atomics commute, so results are exact and deterministic.
//
// Alignment.  The 16-byte loads need every value column 16-byte aligned
// and sel and the NULL masks 4-byte aligned; the wrapper tests the
// pointers and otherwise launches the kVec = false instantiation of the
// same body, which reads each row with its own coalesced load (4 or 8
// bytes, one byte for a mask).  In the vector instantiation block 0
// reads the last n % 4 rows one by one.  Nothing reads past n.
//
// Rows: a row counts when sel is set and 0 <= gid < domain (dead rows may
// hold any gid).  A column with NULLs skips its NULL rows.  The inputs are
// read through the non-coherent path: no other stream may write them
// during the launch.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// vectors of four rows a thread per step: 8 with 16-byte loads, 4 with
// per-row loads (whose masks take a register a row)
template <bool kVec> constexpr int kU = kVec ? 8 : 4;
template <bool kVec> constexpr int kRowsPerStep = 4 * kU<kVec> * kThreads;
constexpr int kMaxCols = 32;      // columns a launch
constexpr int kMaxCells = 113;    // domain * words a launch
typedef unsigned long long u64;

// One column a launch sums or counts (ops/aggregate.py: DenseCol, and
// _DenseColArgs field by field).
struct DenseCol {
  const void* data;         // int32 or int64 values; null: a count alone
  const uint8_t* nulls;     // bool, set = NULL; null: no NULLs
  int32_t width;            // bytes a value: 4 or 8
  int32_t word;             // its first word in the launch's table
  int32_t count;            // 1: a word of its non-NULL rows first
  int32_t sum;              // 0: none; 1: v; 2: v's limbs v & 0xffffffff
                            // and v >> 32 in two words; 3: v & 0xffffffff
                            // alone (a wide sum whose high limbs are a
                            // column of their own, summed by mode 1)
};

// One launch (ops/aggregate.py: _DenseArgs, field by field).
struct DenseArgs {
  const int32_t* gid;
  const uint8_t* sel;
  u64* out;                 // [words][domain] of this launch, zeroed
  int64_t n;
  int32_t domain;
  int32_t words;            // words a group in this launch
  int32_t count_word;       // the group count's word, or -1
  int32_t ncols;
  DenseCol cols[kMaxCols];
};

__device__ __forceinline__ long long warp_sum(long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

// One column's loads for one step: kU vectors of four rows.  A width-4
// column holds row j of vector u in d[u][j], a width-8 one in d[u][2j]
// (low word) and d[u][2j + 1].  The mask: kVec, m[u][0] holds rows 0..3
// in its bytes; else m[u][j] holds row j.
template <bool kVec>
struct Buf {
  int d[kU<kVec>][8];
  unsigned m[kU<kVec>][kVec ? 1 : 4];
};

// Rows of a step: kVec, vector chunk * kU * kThreads + u * kThreads +
// thread holds rows 4v .. 4v + 3; else row chunk * kRowsPerStep +
// u * 4 * kThreads + j * kThreads + thread.
template <bool kVec>
__device__ __forceinline__ void load_col(const void* data, int width,
                                         const uint8_t* mask, int64_t chunk,
                                         int64_t n, Buf<kVec>& b) {
  constexpr int U = kU<kVec>;
  if constexpr (kVec) {
    const int64_t nvec = n >> 2;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = chunk * (U * kThreads) + u * kThreads + threadIdx.x;
      const bool ok = v < nvec;
      const bool wide = width == 8;
      const int4* p = (const int4*)data + (wide ? 2 * v : v);
      int4 x = make_int4(0, 0, 0, 0), y = make_int4(0, 0, 0, 0);
      unsigned m = 0;
      if (ok && mask) m = __ldg((const unsigned*)mask + v);
      if (ok && data) x = __ldg(p);
      if (ok && data && wide) y = __ldg(p + 1);
      b.m[u][0] = m;
      b.d[u][0] = x.x; b.d[u][1] = x.y; b.d[u][2] = x.z; b.d[u][3] = x.w;
      b.d[u][4] = y.x; b.d[u][5] = y.y; b.d[u][6] = y.z; b.d[u][7] = y.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t r = chunk * kRowsPerStep<kVec> + u * (4 * kThreads) +
                          j * kThreads + threadIdx.x;
        const bool ok = r < n;
        b.m[u][j] = 0;
        if (ok && mask) b.m[u][j] = __ldg(mask + r);
        if (ok && data) {
          if (width == 8) {
            const int2 x = __ldg((const int2*)data + r);
            b.d[u][2 * j] = x.x; b.d[u][2 * j + 1] = x.y;
          } else {
            b.d[u][j] = __ldg((const int*)data + r);
          }
        }
      }
    }
  }
}

template <bool kVec>
__device__ __forceinline__ bool mask_at(const Buf<kVec>& b, int u, int j) {
  if constexpr (kVec) {
    return ((b.m[u][0] >> (8 * j)) & 0xffu) != 0;
  } else {
    return b.m[u][j] != 0;
  }
}

__device__ __forceinline__ long long as_i64(int lo, int hi) {
  return (long long)(((u64)(unsigned)hi << 32) | (u64)(unsigned)lo);
}

// One row's words: its count, then its sum's word or limbs (S is the
// column's sum mode).  p points at the row's group and the column's first
// word in this thread's table.
template <int S>
__device__ __forceinline__ void add_row(u64* p, bool count, long long v) {
  if (count) {
    p[0] += 1;
    p += kThreads;
  }
  if (S == 1) {
    p[0] += (u64)v;
  } else if (S >= 2) {
    p[0] += (u64)v & 0xffffffffull;
    if (S == 2) p[kThreads] += (u64)(v >> 32);
  }
}

// The step's group ids: base[u][j] is the row's first word in this
// thread's table, or -1 for a row that does not count.
template <bool kVec>
__device__ __forceinline__ void take_keys(const DenseArgs& a,
                                          const Buf<kVec>& b,
                                          int (&base)[kU<kVec>][4],
                                          u64* tab) {
#pragma unroll
  for (int u = 0; u < kU<kVec>; ++u) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g = b.d[u][j];
      const bool live = mask_at<kVec>(b, u, j) &&
                        (unsigned)g < (unsigned)a.domain;
      base[u][j] = live ? g * a.words * kThreads : -1;
      if (live && a.count_word >= 0) {
        tab[base[u][j] + a.count_word * kThreads] += 1;
      }
    }
  }
}

// One column's rows of a step, for a value width (kW8: 8 bytes, else 4)
// and sum mode S fixed at compile time.
template <bool kVec, bool kW8, int S>
__device__ __forceinline__ void take_col_t(const DenseCol& c,
                                           const Buf<kVec>& b,
                                           const int (&base)[kU<kVec>][4],
                                           u64* tab) {
  u64* col = tab + c.word * kThreads;
  const bool nulls = c.nulls != nullptr, count = c.count != 0;
#pragma unroll
  for (int u = 0; u < kU<kVec>; ++u) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (base[u][j] < 0 || (nulls && mask_at<kVec>(b, u, j))) continue;
      long long v = 0;
      if (S) {
        v = kW8 ? as_i64(b.d[u][2 * j], b.d[u][2 * j + 1])
                : (long long)b.d[u][j];
      }
      add_row<S>(col + base[u][j], count, v);
    }
  }
}

// The row's words for a sum mode known at run time.
__device__ __forceinline__ void add_row_mode(int sum, u64* p, bool count,
                                             long long v) {
  switch (sum) {
    case 0: return add_row<0>(p, count, v);
    case 1: return add_row<1>(p, count, v);
    case 2: return add_row<2>(p, count, v);
    default: return add_row<3>(p, count, v);
  }
}

// The 16-byte instantiation takes each column through take_col_t; the
// per-row one, for unaligned inputs, branches a row (one instantiation
// in place of seven, which keeps the library's build short).
template <bool kVec>
__device__ __forceinline__ void take_col(const DenseCol& c,
                                         const Buf<kVec>& b,
                                         const int (&base)[kU<kVec>][4],
                                         u64* tab) {
  const bool w8 = c.width == 8;
  if constexpr (!kVec) {
    u64* col = tab + c.word * kThreads;
#pragma unroll
    for (int u = 0; u < kU<kVec>; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (base[u][j] < 0 || (c.nulls && mask_at<kVec>(b, u, j))) continue;
        const long long v = w8 ? as_i64(b.d[u][2 * j], b.d[u][2 * j + 1])
                               : (long long)b.d[u][j];
        add_row_mode(c.sum, col + base[u][j], c.count, v);
      }
    }
  } else {
    switch (c.sum) {
      case 0: return take_col_t<kVec, false, 0>(c, b, base, tab);
      case 1: return w8 ? take_col_t<kVec, true, 1>(c, b, base, tab)
                        : take_col_t<kVec, false, 1>(c, b, base, tab);
      case 2: return w8 ? take_col_t<kVec, true, 2>(c, b, base, tab)
                        : take_col_t<kVec, false, 2>(c, b, base, tab);
      default: return w8 ? take_col_t<kVec, true, 3>(c, b, base, tab)
                         : take_col_t<kVec, false, 3>(c, b, base, tab);
    }
  }
}

// The (step, column) cursor of the pipeline: column 0 is the group ids
// and sel, column e > 0 is cols[e - 1].
struct Cursor {
  int64_t chunk;
  int e;
};

__device__ __forceinline__ Cursor following(Cursor c, int ncols) {
  if (++c.e > ncols) {
    c.e = 0;
    c.chunk += gridDim.x;
  }
  return c;
}

template <bool kVec>
__device__ __forceinline__ void load_at(const DenseArgs& a, Cursor c,
                                        Buf<kVec>& b) {
  const void* data = a.gid;
  int width = 4;
  const uint8_t* mask = a.sel;
  if (c.e != 0) {
    const DenseCol& col = a.cols[c.e - 1];
    data = col.sum ? col.data : nullptr;
    width = col.width;
    mask = col.nulls;
  }
  load_col<kVec>(data, width, mask, c.chunk, a.n, b);
}

template <bool kVec>
__device__ __forceinline__ void take_at(const DenseArgs& a, Cursor c,
                                        const Buf<kVec>& b,
                                        int (&base)[kU<kVec>][4], u64* tab) {
  if (c.e == 0) {
    take_keys<kVec>(a, b, base, tab);
  } else {
    take_col<kVec>(a.cols[c.e - 1], b, base, tab);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
dense_kernel(const __grid_constant__ DenseArgs a) {
  extern __shared__ u64 tables[];          // [group][word][thread]
  const int cells = a.domain * a.words;
  u64* tab = tables + threadIdx.x;
  for (int c = 0; c < cells; ++c) tab[c * kThreads] = 0;

  const int64_t chunks =
      (a.n + kRowsPerStep<kVec> - 1) / kRowsPerStep<kVec>;
  int base[kU<kVec>][4];
  Buf<kVec> A, B;
  Cursor ca = {blockIdx.x, 0};
  if (ca.chunk < chunks) {
    load_at<kVec>(a, ca, A);
    for (;;) {
      const Cursor cb = following(ca, a.ncols);
      const bool more_b = cb.chunk < chunks;
      if (more_b) load_at<kVec>(a, cb, B);
      take_at<kVec>(a, ca, A, base, tab);
      if (!more_b) break;
      const Cursor cn = following(cb, a.ncols);
      const bool more_a = cn.chunk < chunks;
      if (more_a) load_at<kVec>(a, cn, A);
      take_at<kVec>(a, cb, B, base, tab);
      if (!more_a) break;
      ca = cn;
    }
  }
  if (kVec && blockIdx.x == 0) {           // the last n % 4 rows
    const int64_t r = (a.n & ~(int64_t)3) + threadIdx.x;
    const int g = r < a.n ? a.gid[r] : -1;
    if (r < a.n && a.sel[r] && (unsigned)g < (unsigned)a.domain) {
      const int row = g * a.words * kThreads;
      if (a.count_word >= 0) tab[row + a.count_word * kThreads] += 1;
      for (int e = 0; e < a.ncols; ++e) {
        const DenseCol& c = a.cols[e];
        if (c.nulls && c.nulls[r]) continue;
        long long v = 0;
        if (c.sum) {
          v = c.width == 8 ? ((const long long*)c.data)[r]
                           : (long long)((const int*)c.data)[r];
        }
        add_row_mode(c.sum, tab + row + c.word * kThreads, c.count, v);
      }
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < cells; c += kWarps) {
    long long s = 0;
    for (int t = lane; t < kThreads; t += 32) s += tables[c * kThreads + t];
    s = warp_sum(s);
    if (lane == 0 && s != 0) {
      const int g = c / a.words;
      atomicAdd(&a.out[(c - g * a.words) * a.domain + g], (u64)s);
    }
  }
}

const void* dense_instance(int32_t vec) {
  return vec ? (const void*)dense_kernel<true>
             : (const void*)dense_kernel<false>;
}

}  // namespace

// Entry points: each returns the CUDA error (0 = ok); a launch returns
// cudaGetLastError() after it.

// The layout both sides must agree on and one instantiation's launch shape
// (vec: 16-byte loads, or per row) for `cells` table cells a thread:
// info = {threads a block, dynamic shared bytes a block, registers a
// thread, resident blocks an SM, sizeof(DenseArgs), offsetof(cols),
// sizeof(DenseCol), kMaxCols, kMaxCells}.
extern "C" int dense_launch_info(int32_t vec, int32_t cells, int32_t* info) {
  const void* fn = dense_instance(vec);
  const int smem = cells * kThreads * (int)sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int resident = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, fn,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  info[0] = kThreads;
  info[1] = smem;
  info[2] = attr.numRegs;
  info[3] = resident;
  info[4] = (int32_t)sizeof(DenseArgs);
  info[5] = (int32_t)offsetof(DenseArgs, cols);
  info[6] = (int32_t)sizeof(DenseCol);
  info[7] = kMaxCols;
  info[8] = kMaxCells;
  return 0;
}

// One launch over `args` (a DenseArgs, copied into the kernel's
// parameters) with `blocks` blocks on `stream`.
extern "C" int dense_aggregate(const void* args, int32_t vec, int32_t blocks,
                               void* stream) {
  const DenseArgs& a = *(const DenseArgs*)args;
  const int smem = a.domain * a.words * kThreads * (int)sizeof(u64);
  cudaError_t err = cudaFuncSetAttribute(
      dense_instance(vec), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (vec) {
    dense_kernel<true><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  } else {
    dense_kernel<false><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
