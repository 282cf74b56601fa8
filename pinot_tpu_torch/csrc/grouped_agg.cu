// Grouped aggregation: per-key count, sums, power sums, min and max over a
// dense group key, written for Hopper (sm_90a).
//
// Replaces the JAX package's GROUP BY regime ladder (pinot_tpu/engine/
// kernels.py `_make_body`), which XLA compiled from jnp ops; no Pallas kernel
// did this work:
//   * the one-hot f32 matmul (:901-911), `_grouped_chunk64` (:605), the
//     `segment_sum` escape (:920-927) and the sort rungs `_grouped_sorted`
//     (:705) and `_grouped_partitioned` (:732): per-key count and sums;
//   * the broadcast-reduce and `segment_min` / `segment_max` (:938-947):
//     per-key min and max;
//   * the grouped `distinct` (:850-884): per-(group, id) row counts over
//     key * size + ids, a count-only call here;
//   * `_presence_2d` (:564, used at :966-975): the scalar per-id counts of
//     the rows the mask keeps, a count-only call with the ids as the key.
// For every row r the mask keeps, with key = sum_g ids_g[r] * strides_g:
//
//   counts[key] += 1
//   cells_o[key] (op_o)= value_o(r)       for each output o
//
// where op is a sum in f64 (of the value, or of the f32 value's square,
// cube or fourth power taken in f64 by multiplications), an exact sum in
// int64, a min or a max. A row the mask drops adds nothing anywhere: no
// overflow cell takes it. A kept row whose key falls outside [0, num_cells)
// is a caller's error; the kernel skips it rather than write out of bounds.
//
// Bound. Bytes: each row reads its int32 group ids, the bool mask and its
// value rows once, and the cells are written once; 9 bytes a row for GROUP
// BY lo_region with one f32 sum. Past shared memory (the global rung) the
// atomics' rate into L2 bounds it instead: one a kept row and output.
//
// Design. One launch per call on the shared rungs, picked by the cells'
// bytes (engine/grouped.py `choose_rung`):
// 1. Several rows a thread. Each thread takes kRows consecutive rows at a
//    time, a whole warp 32 such groups, in a grid-stride loop: the ids and
//    values as 16-byte loads, the mask's 8 bytes as one load, streamed
//    (evict first). The next group's mask is loaded before this group's
//    rows are taken, and a group whose mask keeps no row loads nothing
//    more. The caller finds the head (0-7 rows) after which every column is
//    aligned; the head and the tail are read row by row by one warp, and
//    where no head aligns them all (a slice offset in one column only)
//    every row is read by scalar loads.
// 2. Rungs, from few cells to many:
//    * thread (a few dozen cells, one cell too): each thread owns a copy of
//      the cells in shared memory, laid out [cell][thread], so a warp's
//      lanes hit distinct banks whatever their keys; plain
//      read-modify-writes, no shuffle, no atomic; a warp merges a cell's
//      256 copies with shuffles;
//    * warp (up to a few hundred cells): each warp owns a copy, updated with
//      shared atomics (native for 32-bit cells, compare-and-swap loops for
//      64-bit ones, which 32 warps an SM hide);
//    * block (up to the block's opt-in shared memory): one copy shared by
//      kBlockThreads threads, shared atomics as on the warp rung;
//    * cluster (up to two blocks' opt-in shared memory: lo_suppkey
//      VAR_POP's 20,481 cells): one copy a thread-block cluster of
//      kClusterBlocks blocks of kClusterThreads threads, cell c held by
//      the block of rank c % 2 at index c / 2, updated with atomics
//      through distributed shared memory; each block merges its slice
//      into the accumulators once. Clusters of 4 and 8 ran slower than the
//      global rung; a 64-bit max through distributed shared memory lost
//      updates on the card, so a 64-bit min or max is refused here;
//    * global (past it: lo_custkey's 500,000 keys): atomics straight into
//      the accumulators in device memory (L2), one a kept row and output.
//    Every op and dtype is dispatched once for a thread's rows, not per row.
// 3. Every cell's identity is 0: a min is kept as the max of the
//    complemented order-preserving code, a max as the max of its code (a
//    NaN codes to the top, so it wins as torch's amin / amax propagate it),
//    so a copy or an accumulator starts as zeros, and a cell whose count is
//    0 decodes to its identity.
// 4. One launch on the shared rungs up to kLastBlockCells cells:
//    each block merges its copies into accumulators in device memory with
//    atomics (skipping cells it never saw), then takes a ticket; the block
//    that takes the last one decodes every cell into the outputs (f64 sums
//    rounded to f32, codes back to values), zeroes the accumulators and
//    resets the ticket. An eager launch takes the workspace its stream keeps
//    (zero between launches); a launch captured into a CUDA graph takes a
//    workspace of the graph's own and zeroes it with a captured memset
//    first. A shared rung past kLastBlockCells cells decodes in a second
//    launch over the cells, kFinalBatch cells a thread; so does the global
//    rung, whose accumulators the caller zeroes with a memset of a fresh
//    scratch, so that its atomics find their lines in L2.
// f64 sums are added with __dadd_rn and powers taken with __dmul_rn, which
// the compiler never contracts into an FMA, so each row's power is the plain
// version's bits; only the order of the f64 additions differs. Nothing is
// allocated here.
//
// Not done (later work): fusing the filter mask into the pass that reads it;
// fewer atomics on the global rung, which two a row (count, sum) hold at
// L2's atomic rate, as the first design's were; loads of the next group's ids and values ahead of
// this group's updates (only its mask is); TMA.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxGroups = 16;
constexpr int kMaxOuts = 16;
constexpr int kThreads = 256;         // a block's threads, but the block and cluster rungs'
constexpr int kWarps = kThreads / 32;
constexpr int kBlockThreads = 1024;   // the block rung's: one copy shared by 32 warps
// the cluster rung's threads a block (86 registers a thread: 768 threads'
// share, 80, spilled) and blocks a cluster
constexpr int kClusterThreads = 512;
constexpr int kClusterBlocks = 2;
constexpr int kRows = 8;              // consecutive rows a thread takes at a time
constexpr int kTicketBytes = 16;      // the workspace's head: the ticket
// cells the last block decodes alone; past them a second launch over the
// cells decodes them, as on the global rung
constexpr int kLastBlockCells = 8192;
constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long u64;

// ops (engine/grouped.py OPS)
enum Op { kSumF64 = 0, kSumI64 = 1, kSum2 = 2, kSum3 = 3, kSum4 = 4, kMin = 5, kMax = 6 };
// value dtypes (engine/grouped.py DTYPES)
enum Dtype { kF32 = 0, kF64 = 1, kI32 = 2, kI64 = 3 };
// how a cell combines: f64 add, int64 add, unsigned max of a 32- or 64-bit code
enum Kind { kAddF64 = 0, kAddI64 = 1, kMax32 = 2, kMax64 = 3 };
// rungs (engine/grouped.py RUNGS)
enum Rung { kGlobal = 0, kBlock = 1, kWarp = 2, kThread = 3, kCluster = 4 };

struct Out {
  const void* val;    // value row (n_rows entries of `dtype`)
  void* out;          // result: f32 for an f64 sum, int64 for isum, else the value's dtype
  int op, dtype, kind;
  int width;          // bytes of a cell: 4 or 8
  int vbytes;         // bytes of a value: 4 or 8
  int off;            // byte offset of this output's cells in a copy and in the accumulators
  int soff;           // the cluster rung: byte offset of its cells in a block's slice
};

struct Args {
  const int* gids[kMaxGroups];
  long long strides[kMaxGroups];
  int n_groups;
  int n_outs;
  const unsigned char* mask;
  int n_rows;          // at most INT_MAX: row and group indices are 32-bit
  int head;            // rows before the first whole group of kRows
  int n_vec;           // whole groups of kRows rows from `head`
  int vec;             // the groups' loads are vectors: every column aligned at `head`
  int num_cells;
  int count_off;       // byte offset of the counts in a copy and in the accumulators
  int region;          // bytes of one copy of the cells (warp and block rungs), of a slice
  int s_count_off;     // the cluster rung: byte offset of the counts in a slice
  int* counts;         // the result counts
  unsigned char* acc;  // accumulators in device memory: zero between launches
  unsigned int* ticket;
  int rezero;          // leave the accumulators zero (a captured launch's memset does it)
  Out outs[kMaxOuts];
};

__host__ __device__ inline int kind_of(int op, int dtype) {
  if (op == kSumI64) return kAddI64;
  if (op == kMin || op == kMax) return dtype == kF32 || dtype == kI32 ? kMax32 : kMax64;
  return kAddF64;
}

__device__ __forceinline__ u64 combine(int kind, u64 a, u64 b) {
  switch (kind) {
    case kAddF64:
      return __double_as_longlong(__dadd_rn(__longlong_as_double(a), __longlong_as_double(b)));
    case kAddI64:   // two's complement wraps as the plain version's int64 does
      return a + b;
    default:
      return a > b ? a : b;
  }
}

// the order-preserving integer of a float (a NaN at the end that makes it win)
__device__ __forceinline__ int ordered32(float f, bool is_min) {
  if (f != f) return is_min ? INT_MIN : INT_MAX;
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ long long ordered64(double d, bool is_min) {
  if (d != d) return is_min ? LLONG_MIN : LLONG_MAX;
  const long long b = __double_as_longlong(d);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

__device__ __forceinline__ u64 dbits(double d) { return __double_as_longlong(d); }
__device__ __forceinline__ float f32_of(u64 r) { return __int_as_float(static_cast<int>(r)); }

template <int N, typename F>
__device__ __forceinline__ void each(u64 (&v)[N], F f) {
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = f(v[j]);
}

// Rows' values `v` (their 4 or 8 bytes) as output o's contributions, in
// place: cell codes. One switch on the op and dtype for all the rows.
template <int N>
__device__ __forceinline__ void encode_rows(const Out& o, u64 (&v)[N]) {
  switch (o.op) {
    case kSumF64:
      switch (o.dtype) {
        case kF32: each(v, [](u64 r) { return dbits(f32_of(r)); }); return;
        case kF64: return;
        case kI32: each(v, [](u64 r) { return dbits(static_cast<int>(r)); }); return;
        default:
          each(v, [](u64 r) { return dbits(static_cast<double>(static_cast<long long>(r))); });
          return;
      }
    case kSumI64:
      if (o.dtype == kI32) {
        each(v, [](u64 r) { return static_cast<u64>(static_cast<long long>(static_cast<int>(r))); });
      }
      return;
    case kSum2:
    case kSum3:
    case kSum4:
      // the f32 argument, as the plain version's v.to(float32), then its
      // power in f64 by multiplications
      switch (o.dtype) {
        case kF64:
          each(v, [](u64 r) {
            return static_cast<u64>(__float_as_uint(static_cast<float>(__longlong_as_double(r))));
          });
          break;
        case kI32:
          each(v, [](u64 r) {
            return static_cast<u64>(__float_as_uint(static_cast<float>(static_cast<int>(r))));
          });
          break;
        case kI64:
          each(v, [](u64 r) {
            return static_cast<u64>(__float_as_uint(static_cast<float>(static_cast<long long>(r))));
          });
          break;
        default:
          break;
      }
      if (o.op == kSum2) {
        each(v, [](u64 r) { const double x = f32_of(r); return dbits(__dmul_rn(x, x)); });
      } else if (o.op == kSum3) {
        each(v, [](u64 r) {
          const double x = f32_of(r);
          return dbits(__dmul_rn(__dmul_rn(x, x), x));
        });
      } else {
        each(v, [](u64 r) {
          const double x = f32_of(r), x2 = __dmul_rn(x, x);
          return dbits(__dmul_rn(x2, x2));
        });
      }
      return;
    default: {
      // a min or max: the order-preserving integer, as an unsigned code
      // whose max is the cell's (complemented for a min)
      const bool is_min = o.op == kMin;
      if (o.kind == kMax32) {
        if (o.dtype == kF32) {
          each(v, [is_min](u64 r) {
            return static_cast<u64>(static_cast<unsigned>(ordered32(f32_of(r), is_min)));
          });
        }
        each(v, [is_min](u64 r) {
          const unsigned code = static_cast<unsigned>(r) ^ 0x80000000u;
          return static_cast<u64>(is_min ? ~code : code);
        });
        return;
      }
      if (o.dtype == kF64) {
        each(v, [is_min](u64 r) {
          return static_cast<u64>(ordered64(__longlong_as_double(r), is_min));
        });
      }
      each(v, [is_min](u64 r) {
        const u64 code = r ^ 0x8000000000000000ULL;
        return is_min ? ~code : code;
      });
    }
  }
}

// -- loads of one thread's rows r0 .. r0 + n - 1 (n <= kRows) ------------------
// kVec: a whole group (n == kRows) as 16-byte (ids, values) and 8-byte (mask)
// vectors; the caller guarantees their alignment. Rows past n read as 0.
// Streaming loads (evict first): the rows are read once, the accumulators
// stay in L2.

template <bool kVec>
__device__ __forceinline__ u64 load_mask(const unsigned char* m, int r0, int n) {
  if (kVec && n == kRows) return __ldcs(reinterpret_cast<const unsigned long long*>(m + r0));
  u64 bits = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (j < n) bits |= static_cast<u64>(__ldcs(m + r0 + j)) << (8 * j);
  }
  return bits;
}

template <bool kVec>
__device__ __forceinline__ void load_ids(const int* p, int r0, int n, int (&v)[kRows]) {
  if (kVec && n == kRows) {
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(p + r0) + i);
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) v[j] = j < n ? __ldcs(p + r0 + j) : 0;
}

template <bool kVec>
__device__ __forceinline__ void load_raw(const void* p, int vbytes, int r0, int n,
                                         u64 (&v)[kRows]) {
  if (vbytes == 4) {
    const unsigned* q = static_cast<const unsigned*>(p) + r0;
    if (kVec && n == kRows) {
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const uint4 x = __ldcs(reinterpret_cast<const uint4*>(q) + i);
        v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) v[j] = j < n ? __ldcs(q + j) : 0u;
    return;
  }
  const unsigned long long* q = static_cast<const unsigned long long*>(p) + r0;
  if (kVec && n == kRows) {
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      const ulonglong2 x = __ldcs(reinterpret_cast<const ulonglong2*>(q) + i);
      v[2 * i] = x.x;
      v[2 * i + 1] = x.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) v[j] = j < n ? __ldcs(q + j) : 0ULL;
}

// -- cell updates --------------------------------------------------------------

// an atomic update of a cell in shared or device memory
__device__ __forceinline__ void update_atomic(unsigned char* cell, int kind, u64 x) {
  switch (kind) {
    case kAddF64:
      atomicAdd(reinterpret_cast<double*>(cell), __longlong_as_double(x));
      break;
    case kAddI64:
      atomicAdd(reinterpret_cast<unsigned long long*>(cell), x);
      break;
    case kMax32:
      atomicMax(reinterpret_cast<unsigned*>(cell), static_cast<unsigned>(x));
      break;
    default:
      atomicMax(reinterpret_cast<unsigned long long*>(cell), x);
  }
}

__device__ __forceinline__ u64 load_cell(const unsigned char* cell, int width) {
  return width == 8 ? *reinterpret_cast<const u64*>(cell)
                    : static_cast<u64>(*reinterpret_cast<const unsigned*>(cell));
}

// One output's codes `v` of a thread's rows into their cells (`at(key)`
// the cell's address), plainly or atomically; one switch on the kind for all
// the rows.
template <bool kAtomic, typename At>
__device__ __forceinline__ void update_rows(int kind, const int (&key)[kRows],
                                            const u64 (&v)[kRows], At at) {
  switch (kind) {
    case kAddF64:
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (key[j] < 0) continue;
        double* c = reinterpret_cast<double*>(at(key[j]));
        if (kAtomic) {
          atomicAdd(c, __longlong_as_double(v[j]));
        } else {
          *c = __dadd_rn(*c, __longlong_as_double(v[j]));
        }
      }
      return;
    case kAddI64:
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (key[j] < 0) continue;
        u64* c = reinterpret_cast<u64*>(at(key[j]));
        if (kAtomic) {
          atomicAdd(reinterpret_cast<unsigned long long*>(c), v[j]);
        } else {
          *c += v[j];
        }
      }
      return;
    case kMax32:
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (key[j] < 0) continue;
        unsigned* c = reinterpret_cast<unsigned*>(at(key[j]));
        if (kAtomic) {
          atomicMax(c, static_cast<unsigned>(v[j]));
        } else {
          const unsigned x = static_cast<unsigned>(v[j]);
          if (x > *c) *c = x;
        }
      }
      return;
    default:
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (key[j] < 0) continue;
        unsigned long long* c = reinterpret_cast<unsigned long long*>(at(key[j]));
        if (kAtomic) {
          atomicMax(c, v[j]);
        } else {
          if (v[j] > *c) *c = v[j];
        }
      }
  }
}

__device__ __forceinline__ u64 warp_combine(int kind, u64 x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = combine(kind, x, __shfl_xor_sync(kFull, x, d));
  return x;
}

// One thread's rows r0 .. r0 + n - 1, whose mask bytes are `m`, into its
// rung's cells: keys, then the count, then each output. `copy` is the
// thread's shared copy (warp, block rungs), the block's base (thread and
// cluster rungs) or the accumulators (global).
template <int kRung, bool kVec>
__device__ __forceinline__ void take_rows(const Args& a, int r0, int n, u64 m,
                                          unsigned char* copy) {
  int key[kRows];
  if (a.n_groups == 1) {   // the common key: one column, its products alone
    int v[kRows];
    load_ids<kVec>(a.gids[0], r0, n, v);
    const long long s = a.strides[0];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const long long k = static_cast<long long>(v[j]) * s;
      key[j] = ((m >> (8 * j)) & 0xffu) && k >= 0 && k < a.num_cells ? static_cast<int>(k) : -1;
    }
  } else {
    long long k[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) k[j] = 0;
    for (int g = 0; g < a.n_groups; ++g) {
      int v[kRows];
      load_ids<kVec>(a.gids[g], r0, n, v);
      const long long s = a.strides[g];
#pragma unroll
      for (int j = 0; j < kRows; ++j) k[j] += static_cast<long long>(v[j]) * s;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      key[j] = ((m >> (8 * j)) & 0xffu) && k[j] >= 0 && k[j] < a.num_cells
                   ? static_cast<int>(k[j]) : -1;
    }
  }
  const int tid = threadIdx.x;

  if constexpr (kRung == kThread) {
    // cell c of a field at field_off * kThreads + (c * kThreads + tid) * width
    int* counts = reinterpret_cast<int*>(copy + static_cast<size_t>(a.count_off) * kThreads) + tid;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (key[j] >= 0) counts[key[j] * kThreads] += 1;
    }
    for (int o = 0; o < a.n_outs; ++o) {
      const Out& out = a.outs[o];
      u64 v[kRows];
      load_raw<kVec>(out.val, out.vbytes, r0, n, v);
      encode_rows(out, v);
      unsigned char* cells = copy + static_cast<size_t>(out.off) * kThreads + tid * out.width;
      const size_t stride = static_cast<size_t>(kThreads) * out.width;
      update_rows<false>(out.kind, key, v, [=](int c) { return cells + c * stride; });
    }
  } else if constexpr (kRung == kCluster) {
    // cell c in the slice of the cluster's block c % kClusterBlocks, at
    // index c / kClusterBlocks: atomics through distributed shared memory
    // (this block's own slice too)
    cg::cluster_group cluster = cg::this_cluster();
    int* counts = reinterpret_cast<int*>(copy + a.s_count_off);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (key[j] >= 0) {
        atomicAdd(cluster.map_shared_rank(counts, key[j] % kClusterBlocks) +
                      key[j] / kClusterBlocks, 1);
      }
    }
    for (int o = 0; o < a.n_outs; ++o) {
      const Out& out = a.outs[o];
      u64 v[kRows];
      load_raw<kVec>(out.val, out.vbytes, r0, n, v);
      encode_rows(out, v);
      unsigned char* cells = copy + out.soff;
      const int width = out.width;
      update_rows<true>(out.kind, key, v, [=](int c) {
        return cluster.map_shared_rank(cells, c % kClusterBlocks) +
               static_cast<size_t>(c / kClusterBlocks) * width;
      });
    }
  } else {
    // warp, block, global: atomics on the copy or the accumulators
    int* counts = reinterpret_cast<int*>(copy + a.count_off);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (key[j] >= 0) atomicAdd(counts + key[j], 1);
    }
    for (int o = 0; o < a.n_outs; ++o) {
      const Out& out = a.outs[o];
      u64 v[kRows];
      load_raw<kVec>(out.val, out.vbytes, r0, n, v);
      encode_rows(out, v);
      unsigned char* cells = copy + out.off;
      const int width = out.width;
      update_rows<true>(out.kind, key, v, [=](int c) { return cells + c * width; });
    }
  }
}

// cell c's count n and code x of output o as the output's value
__device__ __forceinline__ void write_result(const Out& o, int c, int n, u64 x) {
  switch (o.kind) {
    case kAddF64:
      static_cast<float*>(o.out)[c] = static_cast<float>(__longlong_as_double(x));
      return;
    case kAddI64:
      static_cast<long long*>(o.out)[c] = static_cast<long long>(x);
      return;
    case kMax32: {
      int v;
      if (n == 0) {   // the identity: +inf / -inf, or the int32 ends
        v = o.dtype == kF32 ? (o.op == kMin ? 0x7f800000 : static_cast<int>(0xff800000u))
                            : (o.op == kMin ? INT_MAX : INT_MIN);
      } else {
        const unsigned code = static_cast<unsigned>(o.op == kMin ? ~x : x);
        const int ord = static_cast<int>(code ^ 0x80000000u);
        v = o.dtype == kF32 && ord < 0 ? ord ^ 0x7fffffff : ord;
      }
      static_cast<int*>(o.out)[c] = v;
      return;
    }
    default: {
      long long v;
      if (n == 0) {
        v = o.dtype == kF64 ? (o.op == kMin ? 0x7ff0000000000000LL
                                            : static_cast<long long>(0xfff0000000000000ULL))
                            : (o.op == kMin ? LLONG_MAX : LLONG_MIN);
      } else {
        const u64 code = o.op == kMin ? ~x : x;
        const long long ord = static_cast<long long>(code ^ 0x8000000000000000ULL);
        v = o.dtype == kF64 && ord < 0 ? ord ^ 0x7fffffffffffffffLL : ord;
      }
      static_cast<long long*>(o.out)[c] = v;
    }
  }
}

// Cells first, first + stride, ... from the accumulators into the outputs,
// the accumulators back to 0 (unless the launch's memset zeroes them):
// kFinalBatch cells a thread at a time, each field's loads of the batch
// issued before its stores.
constexpr int kFinalBatch = 8;

__device__ __forceinline__ void finalize_cells(const Args& a, int first, int stride) {
  int* acc_n = reinterpret_cast<int*>(a.acc + a.count_off);
  for (int c0 = first; c0 < a.num_cells; c0 += kFinalBatch * stride) {
    int n[kFinalBatch];
#pragma unroll
    for (int i = 0; i < kFinalBatch; ++i) {
      const int c = c0 + i * stride;
      n[i] = c < a.num_cells ? __ldcg(acc_n + c) : 0;
    }
    for (int o = 0; o < a.n_outs; ++o) {
      const Out& out = a.outs[o];
      u64 x[kFinalBatch];
#pragma unroll
      for (int i = 0; i < kFinalBatch; ++i) {
        const int c = c0 + i * stride;
        const unsigned char* cell = a.acc + out.off + static_cast<size_t>(c) * out.width;
        x[i] = c >= a.num_cells ? 0
               : out.width == 8 ? __ldcg(reinterpret_cast<const unsigned long long*>(cell))
                                : __ldcg(reinterpret_cast<const unsigned*>(cell));
      }
#pragma unroll
      for (int i = 0; i < kFinalBatch; ++i) {
        const int c = c0 + i * stride;
        if (c >= a.num_cells) continue;
        if (a.rezero) {
          unsigned char* cell = a.acc + out.off + static_cast<size_t>(c) * out.width;
          if (out.width == 8) {
            *reinterpret_cast<u64*>(cell) = 0;
          } else {
            *reinterpret_cast<unsigned*>(cell) = 0;
          }
        }
        write_result(out, c, n[i], x[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFinalBatch; ++i) {
      const int c = c0 + i * stride;
      if (c < a.num_cells) {
        if (a.rezero) acc_n[c] = 0;
        a.counts[c] = n[i];
      }
    }
  }
}

// the previous value of *p, adding 1: a release of this thread's (and, after a
// block barrier, its block's) earlier writes and an acquire of theirs for the
// launch's other blocks, at device scope
__device__ __forceinline__ unsigned int ticket_add(unsigned int* p) {
  unsigned int prev;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(prev) : "l"(p) : "memory");
  return prev;
}

template <int kRung>
__global__ void __launch_bounds__(kRung == kBlock     ? kBlockThreads
                                  : kRung == kCluster ? kClusterThreads
                                                      : kThreads,
                                  kRung == kBlock || kRung == kCluster ? 1
                                  : kRung == kWarp                    ? 4
                                                                      : 3)
    grouped_agg_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kDim = kRung == kBlock ? kBlockThreads : kRung == kCluster ? kClusterThreads
                                                                         : kThreads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if constexpr (kRung != kGlobal) {
    // every copy's cells start at 0, the identity
    const int words = (kRung == kThread ? a.region * kThreads
                       : kRung == kWarp ? a.region * kWarps
                                        : a.region) / 8;
    for (int i = tid; i < words; i += kDim) reinterpret_cast<u64*>(smem)[i] = 0;
    if constexpr (kRung == kCluster) {
      cg::this_cluster().sync();   // every slice zeroed before any block's updates
    } else {
      __syncthreads();
    }
  }
  unsigned char* copy = kRung == kGlobal ? a.acc
                        : kRung == kWarp ? smem + static_cast<size_t>(warp) * a.region
                                         : smem;
  // whole warps walk the groups; a lane past the end takes no rows. The
  // next group's mask is loaded before this group's rows, and a group whose
  // mask keeps no row loads nothing more
  const int step = gridDim.x * kDim;
  int base = (blockIdx.x * (kDim / 32) + warp) * 32;
  u64 m = 0;
  if (base + lane < a.n_vec) {
    m = a.vec ? load_mask<true>(a.mask, a.head + (base + lane) * kRows, kRows)
              : load_mask<false>(a.mask, a.head + (base + lane) * kRows, kRows);
  }
  for (; base < a.n_vec; base += step) {
    const int g = base + lane;
    const bool in = g < a.n_vec;
    const int r0 = a.head + (in ? g : 0) * kRows;
    const int g_next = g + step;
    u64 m_next = 0;
    if (g_next < a.n_vec) {
      m_next = a.vec ? load_mask<true>(a.mask, a.head + g_next * kRows, kRows)
                     : load_mask<false>(a.mask, a.head + g_next * kRows, kRows);
    }
    if (m != 0) {
      if (a.vec) {
        take_rows<kRung, true>(a, r0, in ? kRows : 0, m, copy);
      } else {
        take_rows<kRung, false>(a, r0, in ? kRows : 0, m, copy);
      }
    }
    m = m_next;
  }
  if (blockIdx.x == 0 && warp == 0) {
    // the ragged ends, fewer than kRows rows each, row by row
    const int tail = a.head + a.n_vec * kRows;
    const int r0 = tid == 0 ? 0 : tail;
    const int n = tid == 0 ? a.head : tid == 1 ? a.n_rows - tail : 0;
    take_rows<kRung, false>(a, r0, n, load_mask<false>(a.mask, r0, n), copy);
  }
  if constexpr (kRung == kGlobal) return;

  // the block's cells into the accumulators, once a cell it saw
  if constexpr (kRung == kThread) {
    __syncthreads();
    // a warp a cell: lane l combines the copies of threads l, l + 32, ...
    for (int c = warp; c < a.num_cells; c += kWarps) {
      const int* counts = reinterpret_cast<const int*>(smem + static_cast<size_t>(a.count_off) *
                                                                  kThreads) + c * kThreads + lane;
      int n = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) n += counts[32 * i];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) n += __shfl_xor_sync(kFull, n, d);
      if (n == 0) continue;   // the block never saw this cell
      if (lane == 0) atomicAdd(reinterpret_cast<int*>(a.acc + a.count_off) + c, n);
      for (int o = 0; o < a.n_outs; ++o) {
        const Out& out = a.outs[o];
        const unsigned char* cells = smem + static_cast<size_t>(out.off) * kThreads +
                                     (static_cast<size_t>(c) * kThreads + lane) * out.width;
        u64 x = 0;
#pragma unroll
        for (int i = 0; i < kWarps; ++i) {
          x = combine(out.kind, x, load_cell(cells + 32 * i * out.width, out.width));
        }
        x = warp_combine(out.kind, x);
        if (lane == 0) update_atomic(a.acc + out.off + static_cast<size_t>(c) * out.width,
                                     out.kind, x);
      }
    }
  } else if constexpr (kRung == kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();   // every block's updates into this block's slice are in
    // this slice's cells c = i * kClusterBlocks + rank below num_cells
    const int rank = static_cast<int>(cluster.block_rank());
    const int cells = (a.num_cells - rank + kClusterBlocks - 1) / kClusterBlocks;
    for (int i = tid; i < cells; i += kDim) {
      const int n = reinterpret_cast<const int*>(smem + a.s_count_off)[i];
      if (n == 0) continue;
      const int c = i * kClusterBlocks + rank;
      atomicAdd(reinterpret_cast<int*>(a.acc + a.count_off) + c, n);
      for (int o = 0; o < a.n_outs; ++o) {
        const Out& out = a.outs[o];
        update_atomic(a.acc + out.off + static_cast<size_t>(c) * out.width, out.kind,
                      load_cell(smem + out.soff + static_cast<size_t>(i) * out.width, out.width));
      }
    }
  } else {
    __syncthreads();
    const int copies = kRung == kBlock ? 1 : kWarps;
    for (int c = tid; c < a.num_cells; c += kDim) {
      int n = 0;
      for (int w = 0; w < copies; ++w) {
        n += reinterpret_cast<const int*>(smem + static_cast<size_t>(w) * a.region +
                                          a.count_off)[c];
      }
      if (n == 0) continue;
      atomicAdd(reinterpret_cast<int*>(a.acc + a.count_off) + c, n);
      for (int o = 0; o < a.n_outs; ++o) {
        const Out& out = a.outs[o];
        u64 x = 0;
        for (int w = 0; w < copies; ++w) {
          x = combine(out.kind, x, load_cell(smem + static_cast<size_t>(w) * a.region + out.off +
                                                 static_cast<size_t>(c) * out.width,
                                             out.width));
        }
        update_atomic(a.acc + out.off + static_cast<size_t>(c) * out.width, out.kind, x);
      }
    }
  }

  if (a.num_cells > kLastBlockCells) return;   // the second launch decodes them

  // the last block to arrive decodes every cell (no static shared memory: a
  // shared rung's block may opt into all of it)
  __threadfence();
  __syncthreads();
  const bool last = tid == 0 && ticket_add(a.ticket) == gridDim.x - 1;
  if (!__syncthreads_or(last)) return;
  finalize_cells(a, tid, kDim);
  if (tid == 0) *a.ticket = 0u;   // the next launch on this workspace starts from 0
}

// the global rung's second launch: every cell decoded, the accumulators zeroed
__global__ void __launch_bounds__(kThreads) grouped_finalize_kernel(const Args a) {
  finalize_cells(a, blockIdx.x * kThreads + threadIdx.x, gridDim.x * kThreads);
}

// Byte offsets of one copy of `num_cells` cells for outputs of these ops and
// dtypes: the 8-byte cells first, then the int32 counts and the 4-byte
// cells. Returns the bytes used (the thread rung's copies take that times
// kThreads); a copy of the warp and block rungs, and the accumulators, take
// it rounded up to 8 bytes. engine/grouped.py `region_bytes` computes the
// same; the launch checks that the two agree.
long long cells_of(const int* ops, const int* dtypes, int n_outs, long long num_cells, int* offs,
                   int* count_off) {
  long long off = 0;
  for (int pass = 0; pass < 2; ++pass) {
    const int w = pass == 0 ? 8 : 4;
    if (pass == 1) {
      *count_off = static_cast<int>(off);
      off += 4 * num_cells;
    }
    for (int o = 0; o < n_outs; ++o) {
      if ((kind_of(ops[o], dtypes[o]) == kMax32 ? 4 : 8) != w) continue;
      offs[o] = static_cast<int>(off);
      off += w * num_cells;
    }
  }
  return off;
}

template <int kRung>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(grouped_agg_kernel<kRung>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

bool aligned(const void* p, int head, int bytes, int align) {
  return (reinterpret_cast<uintptr_t>(p) + static_cast<uintptr_t>(head * bytes)) % align == 0;
}

}  // namespace

// out[0..8]: the most group id columns, the most outputs, threads a block,
// warps a block, rows a thread takes at a time, the workspace's ticket
// bytes, the block and the cluster rungs' threads a block, and the cluster
// rung's blocks a cluster.
extern "C" void pinot_grouped_agg_limits(int* out) {
  out[0] = kMaxGroups;
  out[1] = kMaxOuts;
  out[2] = kThreads;
  out[3] = kWarps;
  out[4] = kRows;
  out[5] = kTicketBytes;
  out[6] = kBlockThreads;
  out[7] = kClusterThreads;
  out[8] = kClusterBlocks;
}

// For the current device, once: allows the shared rungs the block's opt-in
// shared memory and writes the SM count, that opt-in maximum and the shared
// memory bytes per SM to out[0..2]. Returns 0 or a CUDA error.
extern "C" int pinot_grouped_agg_setup(int* out) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) err = allow_smem<kBlock>(optin);
  if (err == cudaSuccess) err = allow_smem<kWarp>(optin);
  if (err == cudaSuccess) err = allow_smem<kCluster>(optin);
  if (err == cudaSuccess) err = allow_smem<kThread>(optin);
  out[0] = sms;
  out[1] = optin;
  out[2] = per_sm;
  return static_cast<int>(err);
}

// Aggregate n_rows rows on `stream`. group_ids[g] holds n_rows int32 ids
// (n_groups may be 0: every kept row has key 0), strides[g] their dense-key
// strides; mask holds n_rows bools. Output o reads vals[o] (n_rows values of
// dtypes[o]) under ops[o] into outs[o] (num_cells entries: f32 for an f64
// sum, int64 for an int64 sum, the value's dtype for min / max); counts
// takes num_cells int32. rung is a Rung; grid the blocks (on the cluster
// rung a multiple of kClusterBlocks, cut to the clusters the device holds
// at once); smem_bytes the shared copies' bytes (a block's slice on the
// cluster rung, 0 on the global rung). head / vec: rows
// [head, head + 8k) are read as vectors where vec is 1, which needs every
// column aligned there (checked). workspace: workspace_bytes (at least
// kTicketBytes + the rounded copy) that are zero unless zero_workspace, in
// which case a memset on `stream` zeroes them first; the launch leaves them
// zero. Returns the CUDA error of the launches (0: launched).
extern "C" int pinot_grouped_agg(const void* const* group_ids, const long long* strides,
                                 int n_groups, const void* mask, long long n_rows,
                                 const void* const* vals, const int* dtypes, const int* ops,
                                 void* const* outs, int n_outs, void* counts, long long num_cells,
                                 int rung, int grid, int smem_bytes, long long head, int vec,
                                 void* workspace, long long workspace_bytes, int zero_workspace,
                                 void* stream) {
  if (n_groups < 0 || n_groups > kMaxGroups || n_outs < 0 || n_outs > kMaxOuts ||
      n_rows < 0 || n_rows > INT_MAX || num_cells < 1 || num_cells > INT_MAX || rung < kGlobal ||
      rung > kCluster || grid < 1 || smem_bytes < 0 || head < 0 || head >= kRows ||
      (rung == kCluster && grid % kClusterBlocks != 0)) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  a.n_groups = n_groups;
  for (int g = 0; g < n_groups; ++g) {
    a.gids[g] = static_cast<const int*>(group_ids[g]);
    a.strides[g] = strides[g];
  }
  a.mask = static_cast<const unsigned char*>(mask);
  a.n_rows = static_cast<int>(n_rows);
  a.num_cells = static_cast<int>(num_cells);
  a.counts = static_cast<int*>(counts);
  a.n_outs = n_outs;
  int offs[kMaxOuts] = {};
  for (int o = 0; o < n_outs; ++o) {
    const int op = ops[o], dt = dtypes[o];
    if (op < kSumF64 || op > kMax || dt < kF32 || dt > kI64 ||
        (op == kSumI64 && dt != kI32 && dt != kI64) ||
        (rung == kCluster && kind_of(op, dt) == kMax64)) {
      return cudaErrorInvalidValue;
    }
  }
  const long long used = cells_of(ops, dtypes, n_outs, num_cells, offs, &a.count_off);
  const long long region = (used + 7) / 8 * 8;
  if (workspace_bytes < kTicketBytes + region || region > INT_MAX) return cudaErrorInvalidValue;
  a.region = static_cast<int>(region);
  // the cluster rung: a block's slice of ceil(num_cells / kClusterBlocks) cells
  int soffs[kMaxOuts] = {};
  const long long slice = (cells_of(ops, dtypes, n_outs,
                                    (num_cells + kClusterBlocks - 1) / kClusterBlocks, soffs,
                                    &a.s_count_off) + 7) / 8 * 8;
  const long long want = rung == kThread ? used * kThreads
                         : rung == kWarp ? region * kWarps
                         : rung == kBlock ? region
                         : rung == kCluster ? slice : 0;
  if (want != smem_bytes) return cudaErrorInvalidValue;
  if (rung == kThread) a.region = static_cast<int>(used);   // the copies' words: used * kThreads / 8
  if (rung == kCluster) a.region = static_cast<int>(slice);
  for (int o = 0; o < n_outs; ++o) {
    Out& out = a.outs[o];
    out.val = vals[o];
    out.out = outs[o];
    out.op = ops[o];
    out.dtype = dtypes[o];
    out.kind = kind_of(ops[o], dtypes[o]);
    out.width = out.kind == kMax32 ? 4 : 8;
    out.vbytes = dtypes[o] == kF32 || dtypes[o] == kI32 ? 4 : 8;
    out.off = offs[o];
    out.soff = soffs[o];
  }
  // the rows: a head row by row, whole groups of kRows, a tail row by row
  a.head = static_cast<int>(head < n_rows ? head : n_rows);
  a.n_vec = (n_rows - a.head) / kRows;
  a.vec = vec;
  if (vec) {
    bool ok = aligned(mask, a.head, 1, 8);
    for (int g = 0; g < n_groups; ++g) ok = ok && aligned(group_ids[g], a.head, 4, 16);
    for (int o = 0; o < n_outs; ++o) ok = ok && aligned(vals[o], a.head, a.outs[o].vbytes, 16);
    if (!ok) return cudaErrorMisalignedAddress;
  }
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  a.ticket = reinterpret_cast<unsigned int*>(ws);
  a.acc = ws + kTicketBytes;
  a.rezero = !zero_workspace;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (zero_workspace) {
    err = cudaMemsetAsync(ws, 0, static_cast<size_t>(kTicketBytes + region), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (rung) {
    case kGlobal: grouped_agg_kernel<kGlobal><<<grid, kThreads, 0, s>>>(a); break;
    case kBlock: grouped_agg_kernel<kBlock><<<grid, kBlockThreads, smem_bytes, s>>>(a); break;
    case kWarp: grouped_agg_kernel<kWarp><<<grid, kThreads, smem_bytes, s>>>(a); break;
    case kCluster: {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = kClusterBlocks;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(grid);
      cfg.blockDim = dim3(kClusterThreads);
      cfg.dynamicSmemBytes = smem_bytes;
      cfg.stream = s;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      // no more clusters than the device holds at once: a second wave would
      // zero and merge every slice again
      int most = 0;
      err = cudaOccupancyMaxActiveClusters(&most, grouped_agg_kernel<kCluster>, &cfg);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (most < 1) return cudaErrorInvalidConfiguration;
      if (grid > most * kClusterBlocks) cfg.gridDim = dim3(most * kClusterBlocks);
      err = cudaLaunchKernelEx(&cfg, grouped_agg_kernel<kCluster>, a);
      if (err != cudaSuccess) return static_cast<int>(err);
      break;
    }
    default: grouped_agg_kernel<kThread><<<grid, kThreads, smem_bytes, s>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || (rung != kGlobal && num_cells <= kLastBlockCells)) {
    return static_cast<int>(err);
  }
  const long long per_block = static_cast<long long>(kThreads) * kFinalBatch;
  const long long blocks = (num_cells + per_block - 1) / per_block;
  grouped_finalize_kernel<<<static_cast<int>(blocks < 1024 ? blocks : 1024), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
