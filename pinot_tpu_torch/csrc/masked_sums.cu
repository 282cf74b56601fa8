// Masked multi-sum scan: the filter + SUM/COUNT hot loop of a scalar
// aggregation, written for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of pinot_tpu/engine/pallas_scan.py:
//   masked_sums_pallas        (float operands)       -> pinot_masked_sums_f32
//   masked_sums_pallas_fused  (FOR-encoded operands) -> pinot_masked_sums_u8 / _u16
// Both compute
//   m      = AND_c (col_c >= lo_c && col_c <= hi_c)      over int32 dict-id columns
//   sum_j  = sum over rows of operand_j * m               (f32 accumulation)
//   count  = sum over rows of m                           (exact integer)
// where operand_j is an f32 row, or float(delta) + base for a frame-of-reference
// column of uint8/uint16 deltas decoded in registers.
//
// Bound: bytes. The scan reads every input once and does a few compares and
// adds per row, far below the card's arithmetic rate. SSB Q1.1 reads 16 B/row
// (three int32 id columns and one f32 operand row), the fused FOR query 9 B/row
// (two int32 id columns and one uint8 delta column); the bound is those bytes
// over the card's memory rate. Reaching it takes enough loads in flight to
// cover HBM latency on every SM, and no work on the card after the scan.
//
// Design:
// * Loads in flight: a persistent grid (as many blocks as fit on the card at
//   once, see pinot_masked_sums_setup), each block walking one contiguous range
//   of rows in tiles through a kStages-deep ring in dynamic shared memory.
//   Thread 0 copies each column's tile into a stage with one 1-D bulk
//   asynchronous copy (cp.async.bulk, global -> shared) whose completion lands
//   on the stage's `full` mbarrier (arrive.expect_tx with the stage's byte
//   count). All threads wait on `full`, evaluate the tile, and meet at one
//   block barrier, after which thread 0 refills the stage with the tile
//   kStages ahead, so up to kStages tiles (128 KB per SM) are in flight. Rows
//   per stage come from the caller, set from the bytes per row so the ring
//   fits kRingBytes; they and every block's range are multiples of 16 rows, so
//   each column's tile is a whole number of 16-byte units and starts 16-byte
//   aligned (the caller checks the columns' alignment). The host splits the
//   rows over the blocks (Split), so the card does no 64-bit division.
// * Shared-memory reads: each thread takes 4 rows at a time, reading each
//   4-byte column (ids, f32 operands) as one 16-byte vector and a 1- or 2-byte
//   operand as one 4- or 8-byte vector for the same rows; neighbouring threads
//   read neighbouring addresses, so a warp's reads are free of bank conflicts.
// * Ragged edge: the n % 16 rows after the last whole group are read with
//   plain loads by the last block. Any n is taken, 0 included.
// * One launch per call, deterministic: each block reduces its threads'
//   partials (warp shuffles of all kMaxSums values, unguarded, since a
//   shuffle under a branch costs a convergence barrier each; then thread 0
//   over the warps) into f32 sums and an int32 count in a workspace and takes
//   a ticket with an acquire-release atomic (which publishes the partials: no
//   separate fence). The block that draws the last ticket sums all blocks'
//   partials in f64 (count in int64) in a fixed order, writes the answer
//   (int64 count, then f32 sums) and resets the ticket to 0. An eager launch
//   takes its ticket from static device memory, one slot per stream, chosen by
//   the caller: launches sharing a slot run one after another, so no
//   allocation or memset joins the launch. A launch captured into a CUDA graph
//   takes a ticket word in the caller's workspace, which the graph owns, and
//   zeroes it with a captured memset first: graphs hold no static slot, and
//   two graphs replayed at once never share a ticket. No torch op runs after
//   the kernel, and every run of the same inputs gives the same bits.
// * Column pointers, bands and FOR bases are kernel parameters (structs passed
//   by value), so a new literal or a new table rebuilds nothing.
// * Operands are loaded for every row and multiplied by the 0/1 mask, as the
//   Pallas kernel does, so NaN and Inf propagate the same way in both.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxMask = 8;
constexpr int kMaxSums = 8;
constexpr int kThreads = 256;            // per block: 4 rows each per step
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kRingBytes = 128 * 1024;   // dynamic shared memory of the ring, at most
constexpr int kGroupRows = 16;           // rows per stage and block ranges are multiples
constexpr int kTicketSlots = 1024;
// a barrier wait that has not completed after this many cycles (~2 s) traps,
// so a fault in the pipeline fails the launch instead of hanging the card
constexpr long long kWaitLimitCycles = 1LL << 32;

__device__ unsigned int g_tickets[kTicketSlots];   // eager launches' tickets: zero at load

struct MaskArgs {
  const int32_t* cols[kMaxMask];
  int32_t lo[kMaxMask];
  int32_t hi[kMaxMask];
};

template <typename T>
struct SumArgs {
  const T* cols[kMaxSums];
  float base[kMaxSums];
};

// the rows' split over the grid: n / 16 whole groups, groups_per_block to each
// block and one more to the first `extra` blocks; the rows from whole_rows to n
// are the ragged edge
struct Split {
  int64_t n;
  int64_t whole_rows;
  int groups_per_block;
  int extra;
};

// -- PTX wrappers: mbarrier and bulk copies ----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool bar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!bar_try_wait(bar, parity)) {
    if (clock64() - start > kWaitLimitCycles) __trap();
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

// global -> shared bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned); completion is counted against the barrier's expected bytes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// -- operand decode -----------------------------------------------------------

template <typename T>
__device__ __forceinline__ float decode(T v, float base) {
  return static_cast<float>(v) + base;   // frame-of-reference delta
}

template <>
__device__ __forceinline__ float decode<float>(float v, float) {
  return v;
}

// the 4 operands of rows 4q..4q+3 of one column's tile, decoded
template <typename T>
__device__ __forceinline__ void load4(const unsigned char* tile, int q, float base,
                                      float (&x)[4]);

template <>
__device__ __forceinline__ void load4<float>(const unsigned char* tile, int q, float,
                                             float (&x)[4]) {
  const float4 v = reinterpret_cast<const float4*>(tile)[q];
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <>
__device__ __forceinline__ void load4<uint8_t>(const unsigned char* tile, int q,
                                               float base, float (&x)[4]) {
  const uchar4 v = reinterpret_cast<const uchar4*>(tile)[q];
  x[0] = decode<uint8_t>(v.x, base); x[1] = decode<uint8_t>(v.y, base);
  x[2] = decode<uint8_t>(v.z, base); x[3] = decode<uint8_t>(v.w, base);
}

template <>
__device__ __forceinline__ void load4<uint16_t>(const unsigned char* tile, int q,
                                                float base, float (&x)[4]) {
  const ushort4 v = reinterpret_cast<const ushort4*>(tile)[q];
  x[0] = decode<uint16_t>(v.x, base); x[1] = decode<uint16_t>(v.y, base);
  x[2] = decode<uint16_t>(v.z, base); x[3] = decode<uint16_t>(v.w, base);
}

__device__ __forceinline__ int rows_at(int64_t r, int64_t row1, int R) {
  return row1 - r < R ? static_cast<int>(row1 - r) : R;   // rows of the tile at r
}

__device__ __forceinline__ int in_band(int32_t v, int32_t lo, int32_t hi) {
  return (v >= lo) & (v <= hi);
}

// -- the kernel ---------------------------------------------------------------

// part: f32[gridDim.x * n_sums] block sums, then int32[gridDim.x] block counts.
// ticket: the launch's ticket word, or null for g_tickets[slot].
// out: int64 count, then f32[n_sums] sums.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
masked_sums_kernel(MaskArgs mask, int n_mask, SumArgs<T> sums, int n_sums, Split split,
                   int rows_per_stage, int slot, unsigned int* ticket,
                   float* __restrict__ part_sums, int32_t* __restrict__ part_counts,
                   int64_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];    // a stage's tile has landed
  __shared__ float s_sums[kWarps][kMaxSums];
  __shared__ int32_t s_counts[kWarps];
  __shared__ double s_dsums[kWarps][kMaxSums];
  __shared__ long long s_dcounts[kWarps];
  __shared__ int s_last;

  unsigned int* const tk = ticket != nullptr ? ticket : g_tickets + slot;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int R = rows_per_stage;
  const int stage_bytes = R * (4 * n_mask + static_cast<int>(sizeof(T)) * n_sums);
  const int ops_offset = R * 4 * n_mask;   // operand tiles follow the id tiles

  // this block's rows: a contiguous range of whole 16-row groups
  const int b = blockIdx.x;
  const int64_t row0 =
      (static_cast<int64_t>(b) * split.groups_per_block + min(b, split.extra)) * kGroupRows;
  const int block_rows = (split.groups_per_block + (b < split.extra)) * kGroupRows;
  const int64_t row1 = row0 + block_rows;
  const int ntiles = static_cast<int>((static_cast<unsigned>(block_rows) + R - 1) / R);

  // copy tile `t` of this block's range into its stage (thread 0)
  auto issue = [&](int t) {
    const int s = t % kStages;
    const int64_t r = row0 + static_cast<int64_t>(t) * R;
    const int rows = rows_at(r, row1, R);
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t dst = smem_addr(ring + s * stage_bytes);
    bar_arrive_expect_tx(bar, static_cast<uint32_t>(rows) *
                                  (4 * n_mask + static_cast<uint32_t>(sizeof(T)) * n_sums));
#pragma unroll
    for (int c = 0; c < kMaxMask; ++c) {
      if (c < n_mask) bulk_copy(dst + c * R * 4, mask.cols[c] + r, rows * 4, bar);
    }
#pragma unroll
    for (int j = 0; j < kMaxSums; ++j) {
      if (j < n_sums) {
        bulk_copy(dst + ops_offset + j * R * static_cast<int>(sizeof(T)), sums.cols[j] + r,
                  rows * static_cast<int>(sizeof(T)), bar);
      }
    }
  };

  // thread 0 (warp 0 starts first) sets up the barriers and fills the ring
  // before the block barrier, so the first loads overlap the other warps' start
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) bar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < kStages && t < ntiles; ++t) issue(t);
  }
  __syncthreads();

  float acc[kMaxSums];
#pragma unroll
  for (int j = 0; j < kMaxSums; ++j) acc[j] = 0.f;
  int32_t count = 0;

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    bar_wait(smem_addr(&full[s]), (t / kStages) & 1);
    const int64_t r = row0 + static_cast<int64_t>(t) * R;
    const int quads = rows_at(r, row1, R) / 4;
    const unsigned char* stage = ring + s * stage_bytes;
    for (int q = tid; q < quads; q += kThreads) {
      int m0 = 1, m1 = 1, m2 = 1, m3 = 1;
#pragma unroll
      for (int c = 0; c < kMaxMask; ++c) {
        if (c < n_mask) {
          const int4 v = reinterpret_cast<const int4*>(stage + c * R * 4)[q];
          const int32_t lo = mask.lo[c], hi = mask.hi[c];
          m0 &= in_band(v.x, lo, hi);
          m1 &= in_band(v.y, lo, hi);
          m2 &= in_band(v.z, lo, hi);
          m3 &= in_band(v.w, lo, hi);
        }
      }
      count += m0 + m1 + m2 + m3;
      const float f0 = static_cast<float>(m0), f1 = static_cast<float>(m1);
      const float f2 = static_cast<float>(m2), f3 = static_cast<float>(m3);
#pragma unroll
      for (int j = 0; j < kMaxSums; ++j) {
        if (j < n_sums) {
          float x[4];
          load4<T>(stage + ops_offset + j * R * static_cast<int>(sizeof(T)), q,
                   sums.base[j], x);
          acc[j] += x[0] * f0;
          acc[j] += x[1] * f1;
          acc[j] += x[2] * f2;
          acc[j] += x[3] * f3;
        }
      }
    }
    __syncthreads();   // every thread is done with stage s: refill it
    if (tid == 0 && t + kStages < ntiles) issue(t + kStages);
  }

  // the ragged edge: rows past the last whole group, read directly
  if (blockIdx.x == gridDim.x - 1 && warp == 0 && lane < kGroupRows) {
    const int64_t i = split.whole_rows + lane;
    if (i < split.n) {
      int m = 1;
#pragma unroll
      for (int c = 0; c < kMaxMask; ++c) {
        if (c < n_mask) m &= in_band(__ldg(mask.cols[c] + i), mask.lo[c], mask.hi[c]);
      }
      count += m;
      const float fm = static_cast<float>(m);
#pragma unroll
      for (int j = 0; j < kMaxSums; ++j) {
        if (j < n_sums) acc[j] += decode<T>(__ldg(sums.cols[j] + i), sums.base[j]) * fm;
      }
    }
  }

  // block reduction: warp shuffles, then thread 0 adds the warps' values
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, off);
#pragma unroll
    for (int j = 0; j < kMaxSums; ++j) acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
  }
  if (lane == 0) {
    s_counts[warp] = count;
#pragma unroll
    for (int j = 0; j < kMaxSums; ++j) s_sums[warp][j] = acc[j];
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      count += s_counts[w];
#pragma unroll
      for (int j = 0; j < kMaxSums; ++j) acc[j] += s_sums[w][j];
    }
#pragma unroll
    for (int j = 0; j < kMaxSums; ++j) {
      if (j < n_sums) part_sums[static_cast<int64_t>(blockIdx.x) * n_sums + j] = acc[j];
    }
    part_counts[blockIdx.x] = count;
    s_last = ticket_add(tk) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // the last block: every block's partials in f64 / int64, in a fixed order
  // (its thread 0 acquired them with the ticket; the block barrier passed that on)
  double dsum[kMaxSums];
#pragma unroll
  for (int j = 0; j < kMaxSums; ++j) dsum[j] = 0.0;
  long long dcount = 0;
  for (int b = tid; b < static_cast<int>(gridDim.x); b += kThreads) {
    dcount += __ldcg(part_counts + b);
#pragma unroll
    for (int j = 0; j < kMaxSums; ++j) {
      if (j < n_sums) {
        dsum[j] += static_cast<double>(__ldcg(part_sums + static_cast<int64_t>(b) * n_sums + j));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dcount += __shfl_down_sync(0xffffffffu, dcount, off);
#pragma unroll
    for (int j = 0; j < kMaxSums; ++j) dsum[j] += __shfl_down_sync(0xffffffffu, dsum[j], off);
  }
  if (lane == 0) {
    s_dcounts[warp] = dcount;
#pragma unroll
    for (int j = 0; j < kMaxSums; ++j) s_dsums[warp][j] = dsum[j];
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      dcount += s_dcounts[w];
#pragma unroll
      for (int j = 0; j < kMaxSums; ++j) {
        if (j < n_sums) dsum[j] += s_dsums[w][j];
      }
    }
    out[0] = dcount;
    float* out_sums = reinterpret_cast<float*>(out + 1);
#pragma unroll
    for (int j = 0; j < kMaxSums; ++j) {
      if (j < n_sums) out_sums[j] = static_cast<float>(dsum[j]);
    }
    *tk = 0u;   // the next launch on this ticket starts from 0
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int setup() {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(masked_sums_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, masked_sums_kernel<T>,
                                                        kThreads, kRingBytes);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks * sms > 0 ? blocks * sms : -static_cast<int>(cudaErrorInvalidConfiguration);
}

template <typename T>
int launch(const void* const* mask_cols, const int32_t* bands, int n_mask,
           const void* const* sum_cols, const float* bases, int n_sums, int64_t n,
           int rows_per_stage, int grid, int slot, void* ticket, void* part, void* out,
           void* stream) {
  const int64_t stage_bytes =
      static_cast<int64_t>(rows_per_stage) * (4 * n_mask + sizeof(T) * n_sums);
  if (n_mask < 0 || n_mask > kMaxMask || n_sums < 0 || n_sums > kMaxSums ||
      n_mask + n_sums == 0 || n < 0 || grid <= 0 || rows_per_stage <= 0 ||
      n > INT32_MAX || rows_per_stage % kGroupRows != 0 || kStages * stage_bytes > kRingBytes ||
      (ticket == nullptr && (slot < 0 || slot >= kTicketSlots))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MaskArgs mask{};
  for (int c = 0; c < n_mask; ++c) {
    if (!aligned16(mask_cols[c])) return static_cast<int>(cudaErrorMisalignedAddress);
    mask.cols[c] = static_cast<const int32_t*>(mask_cols[c]);
    mask.lo[c] = bands[2 * c];
    mask.hi[c] = bands[2 * c + 1];
  }
  SumArgs<T> sums{};
  for (int j = 0; j < n_sums; ++j) {
    if (!aligned16(sum_cols[j])) return static_cast<int>(cudaErrorMisalignedAddress);
    sums.cols[j] = static_cast<const T*>(sum_cols[j]);
    sums.base[j] = bases[j];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ticket != nullptr) {
    const cudaError_t err = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t groups = n / kGroupRows;
  const Split split{n, groups * kGroupRows, static_cast<int>(groups / grid),
                    static_cast<int>(groups % grid)};
  float* part_sums = static_cast<float*>(part);
  int32_t* part_counts = reinterpret_cast<int32_t*>(part_sums + static_cast<int64_t>(grid) * n_sums);
  masked_sums_kernel<T><<<grid, kThreads, static_cast<size_t>(kStages * stage_bytes), s>>>(
      mask, n_mask, sums, n_sums, split, rows_per_stage, slot,
      static_cast<unsigned int*>(ticket), part_sums, part_counts, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers,
// 16-byte aligned; `stream` is the caller's cudaStream_t. `bands` is
// int32[2 * n_mask] as (lo, hi) pairs and `bases` float[n_sums], both in host
// memory. The caller allocates `part` (4-byte words: grid * (n_sums + 1)) and
// `out` (8-byte words: 1 + ceil(n_sums / 2)); it picks rows_per_stage (a
// multiple of 16 whose ring fits kRingBytes) and the grid (at most what
// pinot_masked_sums_setup returns). `ticket` null takes the static ticket
// `slot` (one per stream); otherwise `ticket` is a 4-byte word of the caller's
// that a memset zeroes before the kernel (for a launch captured into a CUDA
// graph). Each returns cudaGetLastError() after the launch: 0 means launched.
extern "C" {

// ring stages, ring bytes, rows per group, static ticket slots
void pinot_masked_sums_config(int32_t* out) {
  out[0] = kStages;
  out[1] = kRingBytes;
  out[2] = kGroupRows;
  out[3] = kTicketSlots;
}

// For the current device and an operand size (4: f32, 1: uint8, 2: uint16):
// allows the ring's dynamic shared memory and returns the persistent grid
// (resident blocks per SM x SMs), or minus a CUDA error.
int pinot_masked_sums_setup(int itemsize) {
  switch (itemsize) {
    case 4: return setup<float>();
    case 1: return setup<uint8_t>();
    case 2: return setup<uint16_t>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

#define PINOT_MASKED_SUMS_ENTRY(name, T)                                                  \
  int name(const void* const* mask_cols, const int32_t* bands, int n_mask,                \
           const void* const* sum_cols, const float* bases, int n_sums, int64_t n,        \
           int rows_per_stage, int grid, int slot, void* ticket, void* part, void* out,   \
           void* stream) {                                                                \
    return launch<T>(mask_cols, bands, n_mask, sum_cols, bases, n_sums, n,                \
                     rows_per_stage, grid, slot, ticket, part, out, stream);              \
  }

PINOT_MASKED_SUMS_ENTRY(pinot_masked_sums_f32, float)
PINOT_MASKED_SUMS_ENTRY(pinot_masked_sums_u8, uint8_t)
PINOT_MASKED_SUMS_ENTRY(pinot_masked_sums_u16, uint16_t)

}  // extern "C"
