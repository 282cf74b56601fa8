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
// Bound. Bytes for the shared rungs: each row reads its int32 group ids, the
// bool mask and its value rows once, and the cells are written once; at a
// few dozen keys that is 9 bytes a row for GROUP BY lo_region with one f32
// sum. Atomics' throughput for the global rung: one atomic per distinct key
// of a warp's 32 rows and output, into cells in device memory (L2).
//
// Design. The TPU's rungs exist because its scatter is slow and its matrix
// unit fast; on the H100 one kernel with two rungs gives the same answers,
// picked by whether a block's copy of the cells fits in shared memory:
// 1. Updates are warp-aggregated. Each warp takes 32 consecutive rows;
//    __match_any_sync on the key groups the lanes with equal keys, a
//    shuffle tree within each group combines their values, and the group's
//    lowest lane alone updates the cell. At a few keys that turns 32
//    updates of a handful of addresses into one per key.
// 2. Shared rung, one copy per warp (kSharedWarp, a few dozen keys): each
//    warp owns a private copy of the cells in shared memory, which only its
//    group leaders touch, one per key at a time, so it updates them with
//    plain read-modify-writes: no atomic, no f64 compare-and-swap loop.
// 3. Shared rung, one copy per block (kSharedBlock, up to the block's opt-in
//    shared memory): the warps share one copy through shared-memory atomics.
// 4. In both shared rungs each block walks a grid-stride share of the rows
//    and then merges its copies once into the cells in device memory,
//    skipping keys it never saw (count 0).
// 5. Global rung (kGlobal, past shared memory: lo_custkey's 500,000 keys):
//    the group leaders' atomics go straight to the cells in device memory.
//    The TPU's sort rungs bought exact int32 counts and no scatter; here the
//    counts are exact integers on every rung and the scatter is atomics, so
//    they map onto this rung.
// f64 sums are added with __dadd_rn and powers taken with __dmul_rn, which
// the compiler never contracts into an FMA, so each row's power is the
// plain version's bits; only the order of the f64 additions differs. Min and
// max of f32 / f64 values run on order-preserving integers (a NaN maps to
// the end that makes it win, as torch's amin / amax propagate it), decoded
// back in place by the finalize pass. One call is an init pass (counts 0,
// cells the identity), the accumulate pass and, where an output needs it, a
// finalize pass (f64 cells rounded to f32, ordered integers decoded), all on
// the caller's stream; nothing is allocated here.
//
// Not done (later work): several rows a thread with 16-byte loads, TMA, and
// fusing the filter mask into the pass that reads it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 16;
constexpr int kMaxOuts = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ops (engine/grouped.py OPS)
enum Op { kSumF64 = 0, kSumI64 = 1, kSum2 = 2, kSum3 = 3, kSum4 = 4, kMin = 5, kMax = 6 };
// value dtypes (engine/grouped.py DTYPES)
enum Dtype { kF32 = 0, kF64 = 1, kI32 = 2, kI64 = 3 };
// how a cell combines: f64 add, int64 add, min, max (of int32 / int64, or of
// the ordered integers of f32 / f64)
enum Kind { kAddF64 = 0, kAddI64 = 1, kKindMin = 2, kKindMax = 3 };
// rungs (engine/grouped.py RUNGS)
enum Rung { kGlobal = 0, kSharedBlock = 1, kSharedWarp = 2 };

struct Out {
  const void* val;    // value row (n_rows entries of `dtype`)
  void* cell;         // accumulator cells in device memory, `width` bytes each
  void* out;          // f32 result of an f64 sum (finalize), else == cell
  long long ident;    // the cell's identity (as its payload)
  int op, dtype, kind, width;
  int smem_off;       // byte offset of this output's cells in a shared copy
};

struct Args {
  const int* gids[kMaxGroups];
  long long strides[kMaxGroups];
  int n_groups;
  const unsigned char* mask;
  long long n_rows;
  int num_cells;
  int* counts;
  int n_outs;
  int count_off;      // byte offset of the counts in a shared copy
  int region;         // bytes of one shared copy
  int copies;         // shared copies a block keeps (1, or one per warp)
  Out outs[kMaxOuts];
};

__host__ __device__ inline int kind_of(int op) {
  return op == kSumI64 ? kAddI64 : op == kMin ? kKindMin : op == kMax ? kKindMax : kAddF64;
}

__device__ __forceinline__ long long combine(int kind, long long a, long long b) {
  switch (kind) {
    case kAddF64:
      return __double_as_longlong(__dadd_rn(__longlong_as_double(a), __longlong_as_double(b)));
    case kAddI64:   // two's complement wraps as the plain version's int64 does
      return static_cast<long long>(static_cast<unsigned long long>(a) +
                                    static_cast<unsigned long long>(b));
    case kKindMin:
      return a < b ? a : b;
    default:
      return a > b ? a : b;
  }
}

__device__ __forceinline__ int ordered32(float f, bool is_min) {
  if (f != f) return is_min ? INT_MIN : INT_MAX;   // a NaN wins
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ long long ordered64(double d, bool is_min) {
  if (d != d) return is_min ? LLONG_MIN : LLONG_MAX;
  const long long b = __double_as_longlong(d);
  return b >= 0 ? b : b ^ 0x7fffffffffffffffLL;
}

// row r's contribution to output o, as a 64-bit payload
__device__ __forceinline__ long long payload(const Out& o, long long r) {
  switch (o.op) {
    case kSumF64: {
      double d;
      switch (o.dtype) {
        case kF32: d = __ldg(static_cast<const float*>(o.val) + r); break;
        case kF64: d = __ldg(static_cast<const double*>(o.val) + r); break;
        case kI32: d = __ldg(static_cast<const int*>(o.val) + r); break;
        default: d = static_cast<double>(__ldg(static_cast<const long long*>(o.val) + r));
      }
      return __double_as_longlong(d);
    }
    case kSumI64:
      return o.dtype == kI32 ? static_cast<long long>(__ldg(static_cast<const int*>(o.val) + r))
                             : __ldg(static_cast<const long long*>(o.val) + r);
    case kSum2:
    case kSum3:
    case kSum4: {
      float f;   // the f32 argument, as the plain version's v.to(float32)
      switch (o.dtype) {
        case kF32: f = __ldg(static_cast<const float*>(o.val) + r); break;
        case kF64: f = static_cast<float>(__ldg(static_cast<const double*>(o.val) + r)); break;
        case kI32: f = static_cast<float>(__ldg(static_cast<const int*>(o.val) + r)); break;
        default: f = static_cast<float>(__ldg(static_cast<const long long*>(o.val) + r));
      }
      const double x = f;
      const double x2 = __dmul_rn(x, x);
      const double p = o.op == kSum2 ? x2 : o.op == kSum3 ? __dmul_rn(x2, x) : __dmul_rn(x2, x2);
      return __double_as_longlong(p);
    }
    default: {
      const bool is_min = o.op == kMin;
      switch (o.dtype) {
        case kF32: return ordered32(__ldg(static_cast<const float*>(o.val) + r), is_min);
        case kF64: return ordered64(__ldg(static_cast<const double*>(o.val) + r), is_min);
        case kI32: return __ldg(static_cast<const int*>(o.val) + r);
        default: return __ldg(static_cast<const long long*>(o.val) + r);
      }
    }
  }
}

// Combine x over each group of lanes with equal keys (`peers`, this lane's
// group); the group's lowest lane ends with the group's total. A tree over
// the group's lanes in lane order: every lane of the warp takes part.
__device__ __forceinline__ long long reduce_peers(unsigned peers, int lane, int kind,
                                                  long long x) {
  unsigned rel = __popc(peers & ((1u << lane) - 1u));   // rank within the group
  unsigned above = peers & ~((2u << lane) - 1u);         // the group's higher lanes
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);                        // 1 + next higher lane, or 0
    const long long t = __shfl_sync(kFull, x, next ? next - 1 : lane);
    if (next) x = combine(kind, x, t);
    above &= ~__ballot_sync(kFull, rel & 1u);             // lanes that handed theirs on
    rel >>= 1;
  }
  return x;
}

__device__ __forceinline__ void store_plain(unsigned char* cells, int width, int kind, int key,
                                            long long x) {
  if (width == 8) {
    long long* c = reinterpret_cast<long long*>(cells) + key;
    *c = combine(kind, *c, x);
  } else {
    int* c = reinterpret_cast<int*>(cells) + key;
    *c = static_cast<int>(combine(kind, *c, x));
  }
}

// an atomic update of cell `key` (shared or device memory)
__device__ __forceinline__ void store_atomic(void* cells, int width, int kind, long long key,
                                             long long x) {
  switch (kind) {
    case kAddF64:
      atomicAdd(static_cast<double*>(cells) + key, __longlong_as_double(x));
      break;
    case kAddI64:
      atomicAdd(static_cast<unsigned long long*>(cells) + key,
                static_cast<unsigned long long>(x));
      break;
    case kKindMin:
      if (width == 4) {
        atomicMin(static_cast<int*>(cells) + key, static_cast<int>(x));
      } else {
        atomicMin(static_cast<long long*>(cells) + key, x);
      }
      break;
    default:
      if (width == 4) {
        atomicMax(static_cast<int*>(cells) + key, static_cast<int>(x));
      } else {
        atomicMax(static_cast<long long*>(cells) + key, x);
      }
  }
}

__device__ __forceinline__ long long load_cell(const unsigned char* cells, int width, long long key) {
  return width == 8 ? reinterpret_cast<const long long*>(cells)[key]
                    : static_cast<long long>(reinterpret_cast<const int*>(cells)[key]);
}

__device__ __forceinline__ void set_cell(unsigned char* cells, int width, long long key,
                                         long long x) {
  if (width == 8) {
    reinterpret_cast<long long*>(cells)[key] = x;
  } else {
    reinterpret_cast<int*>(cells)[key] = static_cast<int>(x);
  }
}

// counts 0 and every cell its identity
__global__ void grouped_init_kernel(const Args a) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       c < a.num_cells; c += step) {
    a.counts[c] = 0;
    for (int o = 0; o < a.n_outs; ++o) {
      set_cell(static_cast<unsigned char*>(a.outs[o].cell), a.outs[o].width, c, a.outs[o].ident);
    }
  }
}

template <int kRung>
__global__ void __launch_bounds__(kThreads) grouped_agg_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;

  if (kRung != kGlobal) {
    // every shared copy: counts 0, cells the identity
    const int cells = a.copies * a.num_cells;
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      const int copy = i / a.num_cells, c = i - copy * a.num_cells;
      unsigned char* base = smem + static_cast<size_t>(copy) * a.region;
      reinterpret_cast<int*>(base + a.count_off)[c] = 0;
      for (int o = 0; o < a.n_outs; ++o) {
        set_cell(base + a.outs[o].smem_off, a.outs[o].width, c, a.outs[o].ident);
      }
    }
    __syncthreads();
  }
  unsigned char* mine =
      smem + (kRung == kSharedWarp ? static_cast<size_t>(warp) * a.region : 0);

  // whole warps walk the rows, 32 consecutive rows a step, so that every
  // lane takes part in the warp's collectives; rows past the end are dropped
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
       base < a.n_rows; base += step) {
    const long long r = base + lane;
    int key = -1;
    if (r < a.n_rows && a.mask[r]) {
      long long k = 0;
      for (int g = 0; g < a.n_groups; ++g) {
        k += static_cast<long long>(__ldg(a.gids[g] + r)) * a.strides[g];
      }
      if (k >= 0 && k < a.num_cells) key = static_cast<int>(k);
    }
    const unsigned peers = __match_any_sync(kFull, key);
    const bool leader = key >= 0 && (peers & lt) == 0u;
    if (leader) {
      const int n = __popc(peers);
      if (kRung == kGlobal) {
        atomicAdd(a.counts + key, n);
      } else if (kRung == kSharedBlock) {
        atomicAdd(reinterpret_cast<int*>(mine + a.count_off) + key, n);
      } else {
        reinterpret_cast<int*>(mine + a.count_off)[key] += n;
      }
    }
    for (int o = 0; o < a.n_outs; ++o) {
      const Out& out = a.outs[o];
      long long x = key >= 0 ? payload(out, r) : out.ident;
      x = reduce_peers(peers, lane, out.kind, x);
      if (leader) {
        if (kRung == kGlobal) {
          store_atomic(out.cell, out.width, out.kind, key, x);
        } else if (kRung == kSharedBlock) {
          store_atomic(mine + out.smem_off, out.width, out.kind, key, x);
        } else {
          store_plain(mine + out.smem_off, out.width, out.kind, key, x);
        }
      }
    }
    if (kRung == kSharedWarp) __syncwarp();   // this step's updates before the next's
  }

  if (kRung != kGlobal) {
    // merge the block's copies into the cells in device memory, once a key
    __syncthreads();
    for (int c = threadIdx.x; c < a.num_cells; c += kThreads) {
      int n = 0;
      for (int copy = 0; copy < a.copies; ++copy) {
        n += reinterpret_cast<const int*>(smem + static_cast<size_t>(copy) * a.region +
                                          a.count_off)[c];
      }
      if (n == 0) continue;   // the block never saw this key
      atomicAdd(a.counts + c, n);
      for (int o = 0; o < a.n_outs; ++o) {
        const Out& out = a.outs[o];
        long long x = out.ident;
        for (int copy = 0; copy < a.copies; ++copy) {
          x = combine(out.kind, x,
                      load_cell(smem + static_cast<size_t>(copy) * a.region + out.smem_off,
                                out.width, c));
        }
        store_atomic(out.cell, out.width, out.kind, c, x);
      }
    }
  }
}

// f64 sums rounded to their f32 outputs; ordered integers of f32 / f64 min
// and max decoded to their values, in place
__global__ void grouped_finalize_kernel(const Args a) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       c < a.num_cells; c += step) {
    for (int o = 0; o < a.n_outs; ++o) {
      const Out& out = a.outs[o];
      if (out.kind == kAddF64 && out.out != out.cell) {
        static_cast<float*>(out.out)[c] = static_cast<float>(static_cast<const double*>(out.cell)[c]);
      } else if ((out.kind == kKindMin || out.kind == kKindMax) && out.dtype == kF32) {
        int* cell = static_cast<int*>(out.cell) + c;
        *cell = *cell >= 0 ? *cell : *cell ^ 0x7fffffff;
      } else if ((out.kind == kKindMin || out.kind == kKindMax) && out.dtype == kF64) {
        long long* cell = static_cast<long long*>(out.cell) + c;
        *cell = *cell >= 0 ? *cell : *cell ^ 0x7fffffffffffffffLL;
      }
    }
  }
}

long long identity_of(int kind, int dtype) {
  if (kind == kAddF64 || kind == kAddI64) return 0;   // 0.0's bits are 0
  const bool is_min = kind == kKindMin;
  switch (dtype) {
    case kF32:   // ordered +inf / -inf (bits 0x7f800000 / 0xff800000)
      return is_min ? 0x7f800000LL : static_cast<long long>(static_cast<int>(0xff800000u ^ 0x7fffffffu));
    case kF64:
      return is_min ? 0x7ff0000000000000LL
                    : static_cast<long long>(0xfff0000000000000ULL ^ 0x7fffffffffffffffULL);
    case kI32:
      return is_min ? INT_MAX : INT_MIN;
    default:
      return is_min ? LLONG_MAX : LLONG_MIN;
  }
}

int width_of(int kind, int dtype) {
  return (kind == kKindMin || kind == kKindMax) && (dtype == kF32 || dtype == kI32) ? 4 : 8;
}

}  // namespace

// out[0..3]: the most group id columns, the most outputs, threads a block,
// warps a block (one shared copy each on the warp rung).
extern "C" void pinot_grouped_agg_limits(int* out) {
  out[0] = kMaxGroups;
  out[1] = kMaxOuts;
  out[2] = kThreads;
  out[3] = kWarps;
}

// Bytes of one shared copy of `num_cells` cells for outputs of these ops and
// dtypes: the 8-byte cells first, then the int32 counts and the 4-byte
// cells, rounded up to 8 bytes. engine/grouped.py `region_bytes` computes
// the same; the launch checks that the two agree.
static long long region_of(const int* ops, const int* dtypes, int n_outs, long long num_cells,
                           int* offs, int* count_off) {
  long long off = 0;
  for (int pass = 0; pass < 2; ++pass) {
    const int w = pass == 0 ? 8 : 4;
    if (pass == 1) {
      if (count_off) *count_off = static_cast<int>(off);
      off += 4 * num_cells;
    }
    for (int o = 0; o < n_outs; ++o) {
      if (width_of(kind_of(ops[o]), dtypes[o]) != w) continue;
      if (offs) offs[o] = static_cast<int>(off);
      off += w * num_cells;
    }
  }
  return (off + 7) / 8 * 8;
}

// For the current device, once: allows both shared rungs the block's opt-in
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
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(grouped_agg_kernel<kSharedBlock>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(grouped_agg_kernel<kSharedWarp>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  }
  out[0] = sms;
  out[1] = optin;
  out[2] = per_sm;
  return static_cast<int>(err);
}

// Aggregate n_rows rows on `stream`. group_ids[g] holds n_rows int32 ids
// (n_groups may be 0: every kept row has key 0), strides[g] their dense-key
// strides; mask holds n_rows bools. Output o reads vals[o] (n_rows values of
// dtypes[o]) under ops[o] into cells[o] (num_cells cells: double for an f64
// sum, int64 for an int64 sum, the value's dtype for min / max) and, for an
// f64 sum whose outs[o] differs from cells[o], writes the f32 rounding to
// outs[o]. counts takes num_cells int32. rung is kGlobal, kSharedBlock or
// kSharedWarp; grid the blocks of the accumulate pass; smem_bytes the
// shared copies' bytes (region_of times the copies: 1, or one per warp), 0
// on the global rung. Returns the CUDA error of the launches (0: launched).
extern "C" int pinot_grouped_agg(const void* const* group_ids, const long long* strides,
                                 int n_groups, const void* mask, long long n_rows,
                                 const void* const* vals, const int* dtypes, const int* ops,
                                 void* const* cells, void* const* outs, int n_outs, void* counts,
                                 long long num_cells, int rung, int grid, int smem_bytes,
                                 void* stream) {
  if (n_groups < 0 || n_groups > kMaxGroups || n_outs < 0 || n_outs > kMaxOuts ||
      n_rows < 0 || num_cells < 1 || num_cells > INT_MAX || rung < kGlobal ||
      rung > kSharedWarp || grid < 1 || smem_bytes < 0) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  a.n_groups = n_groups;
  for (int g = 0; g < n_groups; ++g) {
    a.gids[g] = static_cast<const int*>(group_ids[g]);
    a.strides[g] = strides[g];
  }
  a.mask = static_cast<const unsigned char*>(mask);
  a.n_rows = n_rows;
  a.num_cells = static_cast<int>(num_cells);
  a.counts = static_cast<int*>(counts);
  a.n_outs = n_outs;
  bool finalize = false;
  for (int o = 0; o < n_outs; ++o) {
    const int op = ops[o], dt = dtypes[o];
    if (op < kSumF64 || op > kMax || dt < kF32 || dt > kI64 ||
        (op == kSumI64 && dt != kI32 && dt != kI64)) {
      return cudaErrorInvalidValue;
    }
    Out& out = a.outs[o];
    out.val = vals[o];
    out.cell = cells[o];
    out.out = outs[o];
    out.op = op;
    out.dtype = dt;
    out.kind = kind_of(op);
    out.width = width_of(out.kind, dt);
    out.ident = identity_of(out.kind, dt);
    finalize = finalize || (out.kind == kAddF64 && out.out != out.cell) ||
               ((out.kind == kKindMin || out.kind == kKindMax) && (dt == kF32 || dt == kF64));
  }
  int offs[kMaxOuts] = {};
  const long long region = region_of(ops, dtypes, n_outs, num_cells, offs, &a.count_off);
  a.copies = rung == kSharedWarp ? kWarps : 1;
  if (rung != kGlobal) {
    if (region * a.copies != smem_bytes) return cudaErrorInvalidValue;
    a.region = static_cast<int>(region);
    for (int o = 0; o < n_outs; ++o) a.outs[o].smem_off = offs[o];
  } else if (smem_bytes != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pass_blocks = (num_cells + kThreads - 1) / kThreads;
  const int cell_grid = static_cast<int>(pass_blocks < 1024 ? pass_blocks : 1024);
  grouped_init_kernel<<<cell_grid, kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0) {
    if (rung == kGlobal) {
      grouped_agg_kernel<kGlobal><<<grid, kThreads, 0, s>>>(a);
    } else if (rung == kSharedBlock) {
      grouped_agg_kernel<kSharedBlock><<<grid, kThreads, smem_bytes, s>>>(a);
    } else {
      grouped_agg_kernel<kSharedWarp><<<grid, kThreads, smem_bytes, s>>>(a);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (finalize) {
    grouped_finalize_kernel<<<cell_grid, kThreads, 0, s>>>(a);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
