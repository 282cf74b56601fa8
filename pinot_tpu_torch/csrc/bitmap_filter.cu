// Word-domain bitmap filter: a filter tree evaluated over packed row bitmaps,
// written for Hopper (sm_90a).
//
// Replaces the JAX package's jit programs for the word-domain filter
// (pinot_tpu/engine/kernels.py: _bitmap_leaf_words, _make_word_fn,
// _unpack_words, _pack_valid and the popcount of compute_filter_count), which
// XLA compiled from jnp ops; no Pallas kernel did this work. It computes, for every packed
// word g of a segment (or of a stacked set of S segments, word g = s * W + w):
//
//   leaf_l[g] = OR over the leaf's selected dict ids r of words_l[s, r, w]
//   tree[g]   = the filter tree (AND / OR / NOT) over the leaves, in postfix
//   result[g] = tree[g] & valid[g]
//
// and writes one of three outputs: the result words (uint32[S * W]), the row
// mask they pack (bool[32 * S * W], row 32 g + b = bit b of word g), or the
// count of set bits (one int64). Word rows are the bitmap index of a
// dictionary column (engine/datablock.py `bitmap_words`): row r packs the rows
// whose dict id is r, 32 rows a word, and the star id of a star-tree record
// (id == cardinality) is in no row. ANDing `valid` clears the padding rows'
// bits that a NOT sets.
//
// Bound: bytes. Each output word reads one word of each selected row of each
// leaf and one valid word, and does a few bitwise ops: k + 1 loads for k
// selected rows, far below the card's integer rate. The bound is
// (k + 1) * 4 bytes a word read and 4 (words), 32 (mask) or nothing (count)
// written, over the card's memory rate.
//
// Design. The first version (one thread per 4 words in a grid-stride loop)
// ran at 3-25% of that bound. What held it back, and what this design does:
// 1. A thread's row loads ran one after another, each ORed into the sum
//    before the next. Here a block owns a tile of kTileWords words of one
//    segment and has all of the tile's rows in flight at once. Where every
//    block takes one tile (a segment) and the tile has at most kDirectRows
//    rows, valid included, each thread issues its 16-byte loads of every row
//    into registers before it uses any (bitmap_filter_kernel<false>); else
//    one thread copies the tile's span of every selected row and of `valid`
//    into a shared-memory stage with 1-D bulk copies (cp.async.bulk, global
//    -> shared) that complete on the stage's mbarrier
//    (bitmap_filter_kernel<true>). Either way a tile's k + 1 rows cost one
//    round trip to device memory, not k + 1; for a few rows the loads'
//    round trip is the shorter.
// 2. Half the card idled at segment size (64 blocks for 65,536 words). Tiles
//    of 256 words give 256 tiles a segment, and a persistent grid (the blocks
//    the card holds at once) walks a stacked set's tiles through a
//    kStages-deep ring, loading the next tiles while it evaluates one. A tile
//    whose rows pass one stage (kMaxStageRows) streams through the ring in
//    groups of rows, ORed into per-leaf accumulators in shared memory.
// 3. The postfix stack lived in local memory. Here the top of the stack is a
//    register and the entries below it are shared-memory slots of a tile,
//    where each thread reads and writes only its own 16 bytes, so the tree
//    needs no barrier and no local memory (ptxas: no stack frame).
// 4. Mask stores were strided (a lane's 128 bytes beside its neighbour's).
//    Here each warp stages its result words in shared memory and lane i
//    expands half-word i (16 rows -> 16 bytes), so each warp store writes 512
//    contiguous bytes. Result words go out as 16-byte stores, neighbouring
//    lanes on neighbouring words.
// 5. Count mode needed the caller to zero the output (a fill kernel). Here
//    each block adds its count and one arrival to a 64-bit ticket in static
//    device memory with one atomic (arrivals in the high 24 bits, the count
//    in the low 40); the block whose add completes the arrivals writes the
//    int64 and resets the ticket to 0. The caller picks the ticket: an eager
//    launch takes its stream's (launches on a stream run in order), a launch
//    captured into a CUDA graph one of its own (a graph's replays run in
//    order). So no launch needs a zeroed buffer, a memset or a fill.
// 6. Every call queried the device. Here the caller reads the SM count and
//    the shared memory per SM once per device (pinot_bitmap_filter_setup) and
//    passes them in; the launch computes its grid from them.
// Shapes the bulk copy cannot take (W % 4 != 0, or a pointer not 16-byte
// aligned) take the register path with 4-byte loads, chosen from the shape,
// never on a failure. Real segments pad to a power of two of at least 1,024
// rows, so their W is a multiple of 4.
//
// Not done (later work): fusing the row mask into the aggregation that reads it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kMaxRows = 1024;      // selected rows of all leaves together
constexpr int kMaxProgram = 64;
constexpr int kMaxStack = 16;
constexpr int kThreads = 64;                   // per block: 4 consecutive words each
constexpr int kWarps = kThreads / 32;
constexpr int kTileWords = 4 * kThreads;       // a tile: 256 words, 1 KB of each row
constexpr int kStages = 4;
constexpr int kMaxStageRows = 16;              // tile rows one ring stage holds
// tile rows (valid included) the register path holds: more rows there cost
// registers and slowed tiles of a few rows
constexpr int kDirectRows = 8;
// blocks a launch keeps on an SM at most, so that a stacked set's blocks
// walk a few tiles each through their rings
constexpr int kMaxBlocksPerSm = 8;
constexpr int kBlockReserveBytes = 2048;       // per block: the SM's reserve + static smem
constexpr int kStreamSlots = 1024;             // count tickets: one per stream,
constexpr int kTicketSlots = 65536;            // then one per launch captured into a graph
constexpr int kCountBits = 40;                 // a ticket's count; arrivals above it
// a tile row's 16-byte units: one per thread
constexpr int kUnitBytes = 16;
// dynamic shared memory at most: a full ring, every leaf's accumulator, the
// deepest stack and the result row
constexpr int kMaxSmemBytes =
    kUnitBytes * kThreads * (kStages * kMaxStageRows + kMaxLeaves + (kMaxStack - 1) + 1);
// a barrier wait that has not completed after this many cycles (~2 s) traps,
// so a fault in the pipeline fails the launch instead of hanging the card
constexpr long long kWaitLimitCycles = 1LL << 32;

constexpr int kAnd = -1;
constexpr int kOr = -2;
constexpr int kNot = -3;

enum Mode : int { kWords = 0, kMask = 1, kCount = 2 };

__device__ unsigned long long g_tickets[kTicketSlots];   // count tickets: zero at load

struct Args {
  const uint32_t* leaf_words[kMaxLeaves];   // [S, card_l, W] each
  unsigned long long leaf_seg_stride[kMaxLeaves];   // card_l * W words
  int row_off[kMaxLeaves + 1];               // leaf l's rows: rows[row_off[l]..row_off[l+1])
  unsigned char rows[kMaxRows];              // selected dict ids (cardinality <= 255)
  signed char program[kMaxProgram];          // >= 0: LEAF l; kAnd, kOr, kNot
  int n_leaves;
  int n_program;
};

// One launch's tiling. A tile's rows, in order: every selected row of leaf 0,
// of leaf 1, ..., then the valid row (n_rows in all); a ring stage holds
// stage_rows of them, so a tile is `groups` stages.
struct Tiling {
  uint32_t W;               // words per segment
  uint32_t tiles_per_seg;   // ceil(W / kTileWords)
  uint32_t n_tiles;
  int n_rows;
  int stage_rows;
  int groups;
  int stack_slots;          // the program's depth - 1 (the top is a register)
  int vec;                  // 1: rows start 16-byte aligned and W % 4 == 0
};

struct Tile {
  uint32_t seg;
  uint32_t w0;      // first word in the segment
  uint32_t words;   // kTileWords, or fewer for a segment's last tile
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

// global -> shared bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned); completion is counted against the barrier's expected bytes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// -- four words at a time -------------------------------------------------------

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 not4(uint4 a) { return make_uint4(~a.x, ~a.y, ~a.z, ~a.w); }

// the first n (0..4) of 4 words at p, the rest 0: one 16-byte load where
// vec (n is then 0 or 4), else 4-byte loads
__device__ __forceinline__ uint4 load_direct(const uint32_t* p, uint32_t n, int vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vec) return n == 4 ? __ldg(reinterpret_cast<const uint4*>(p)) : v;
  if (n > 0) v.x = __ldg(p);
  if (n > 1) v.y = __ldg(p + 1);
  if (n > 2) v.z = __ldg(p + 2);
  if (n > 3) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ Tile tile_at(const Tiling& t, uint32_t tile) {
  const uint32_t seg = tile / t.tiles_per_seg;
  const uint32_t w0 = (tile - seg * t.tiles_per_seg) * kTileWords;
  const uint32_t left = t.W - w0;
  return {seg, w0, left < kTileWords ? left : static_cast<uint32_t>(kTileWords)};
}

// row f of tile x (leaf l's row, or the valid row when f == n_rows - 1)
__device__ __forceinline__ const uint32_t* row_ptr(const Args& a, const Tiling& t,
                                                   const uint32_t* valid, int f, int l,
                                                   const Tile& x) {
  if (f == t.n_rows - 1) return valid + static_cast<size_t>(x.seg) * t.W + x.w0;
  return a.leaf_words[l] + x.seg * a.leaf_seg_stride[l] +
         static_cast<size_t>(a.rows[f]) * t.W + x.w0;
}

// OR of rows [f0, f1) of a tile held row by row in shared memory
__device__ __forceinline__ uint4 fold_shared(const uint4* rows, int f0, int f1, int tid) {
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
  for (int f = f0; f < f1; ++f) acc = or4(acc, rows[f * kThreads + tid]);
  return acc;
}

// The postfix program over this thread's 4 words: the top of the stack in
// registers, the entries below it in shared-memory slots (each thread's own
// 16 bytes of a slot). leaf(l) gives leaf l's words.
template <typename Leaf>
__device__ __forceinline__ uint4 run_program(const Args& a, uint4* stack, int tid, Leaf leaf) {
  uint4 top = make_uint4(0u, 0u, 0u, 0u);
  int sp = 0;
  for (int pc = 0; pc < a.n_program; ++pc) {
    const int op = a.program[pc];
    if (op >= 0) {
      if (sp > 0) stack[(sp - 1) * kThreads + tid] = top;
      top = leaf(op);
      ++sp;
    } else if (op == kNot) {
      top = not4(top);
    } else {
      --sp;
      const uint4 below = stack[(sp - 1) * kThreads + tid];
      top = op == kAnd ? and4(below, top) : or4(below, top);
    }
  }
  return top;
}

// bits b15..b0 of a half-word -> bytes 15..0 of a uint4, each 0 or 1: a nibble
// spreads to 4 bytes by one multiply (the shifted copies 0, 7, 14, 21 do not
// overlap, so it never carries)
__device__ __forceinline__ uint32_t spread_nibble(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint4 expand_half(uint32_t h) {
  return make_uint4(spread_nibble(h & 15u), spread_nibble((h >> 4) & 15u),
                    spread_nibble((h >> 8) & 15u), spread_nibble((h >> 12) & 15u));
}

// Writes this thread's 4 result words r of tile x (its words past the tile's
// end already 0). Every thread of the block calls it (mask mode meets at warp
// barriers).
__device__ __forceinline__ void emit(int mode, uint4 r, const Tile& x, const Tiling& t, int tid,
                                     uint4* res, void* out, unsigned int& count) {
  const uint32_t g0 = x.seg * t.W + x.w0;   // the tile's first word
  const uint32_t mine = 4u * tid;
  const uint32_t n = x.words > mine ? min(4u, x.words - mine) : 0u;
  if (mode == kWords) {
    uint32_t* o = static_cast<uint32_t*>(out) + g0 + mine;
    if (t.vec) {
      if (n == 4) *reinterpret_cast<uint4*>(o) = r;
    } else {
      if (n > 0) o[0] = r.x;
      if (n > 1) o[1] = r.y;
      if (n > 2) o[2] = r.z;
      if (n > 3) o[3] = r.w;
    }
  } else if (mode == kMask) {
    // the warp's 128 words through shared memory: lane i expands half-word
    // 32 j + i, so store j of the warp writes 512 contiguous bytes
    const int lane = tid & 31, warp = tid >> 5;
    res[tid] = r;
    __syncwarp();
    const unsigned short* halves = reinterpret_cast<const unsigned short*>(res + 32 * warp);
    uint4* o = reinterpret_cast<uint4*>(static_cast<unsigned char*>(out) + 32ull * g0) +
               256 * warp;
    const uint32_t warp_word0 = 128u * warp;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int h = 32 * j + lane;
      if (warp_word0 + h / 2 < x.words) o[h] = expand_half(halves[h]);
    }
    __syncwarp();
  } else {
    count += __popc(r.x) + __popc(r.y) + __popc(r.z) + __popc(r.w);
  }
}

// out: uint32[S * W] (words), bool[32 * S * W] (mask) or one int64 (count,
// through the ticket g_tickets[slot]).
template <bool kBulk>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
bitmap_filter_kernel(const __grid_constant__ Args a, const Tiling t,
                     const uint32_t* __restrict__ valid, int mode, int slot, void* out) {
  extern __shared__ __align__(128) uint4 smem[];
  __shared__ __align__(8) uint64_t full[kStages];    // a stage's rows have landed
  __shared__ unsigned int s_counts[kWarps];

  const int tid = threadIdx.x;
  const int R = t.stage_rows, G = t.groups;
  uint4* const ring = smem;                                      // [kStages][R][kThreads]
  uint4* const leafbuf = ring + (kBulk ? kStages * R * kThreads : 0);   // [n_leaves][kThreads]
  uint4* const stack = leafbuf + (G > 1 ? a.n_leaves * kThreads : 0);   // [slots][kThreads]
  uint4* const res = stack + t.stack_slots * kThreads;                   // [kThreads]
  const uint32_t mine = 4u * tid;
  unsigned int count = 0;

  if constexpr (kBulk) {
    // this block's tiles are blockIdx.x + i * gridDim.x; item j is group
    // j % G of its tile j / G, in ring stage j % kStages
    const uint32_t my_tiles =
        blockIdx.x < t.n_tiles ? (t.n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const uint32_t items = my_tiles * G;

    // copy item j's rows into its stage (thread 0)
    auto issue = [&](uint32_t j) {
      const int s = j % kStages;
      const int g = j % G;
      const Tile x = tile_at(t, blockIdx.x + (j / G) * gridDim.x);
      const int f0 = g * R;
      const int f1 = min(f0 + R, t.n_rows);
      const uint32_t bytes = 4u * x.words;
      const uint32_t bar = smem_addr(&full[s]);
      const uint32_t dst = smem_addr(ring + s * R * kThreads);
      bar_arrive_expect_tx(bar, bytes * static_cast<uint32_t>(f1 - f0));
      int l = 0;
      for (int f = f0; f < f1; ++f) {
        while (l < a.n_leaves && a.row_off[l + 1] <= f) ++l;
        bulk_copy(dst + (f - f0) * kUnitBytes * kThreads, row_ptr(a, t, valid, f, l, x),
                  bytes, bar);
      }
    };

    // thread 0 (warp 0 starts first) sets up the barriers and fills the ring
    // before the block barrier, so the first loads overlap the other warp's start
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) bar_init(smem_addr(&full[s]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (uint32_t j = 0; j < kStages && j < items; ++j) issue(j);
    }
    __syncthreads();

    for (uint32_t j = 0; j < items; ++j) {
      const int s = j % kStages;
      const int g = j % G;
      bar_wait(smem_addr(&full[s]), (j / kStages) & 1);
      const uint4* stage = ring + s * R * kThreads;
      const int f0 = g * R;
      if (G > 1) {
        // this group's selected rows, ORed into their leaves' accumulators
        const int f1 = min(f0 + R, t.n_rows - 1);
        for (int l = 0; l < a.n_leaves; ++l) {
          const int lo = max(a.row_off[l], f0), hi = min(a.row_off[l + 1], f1);
          if (lo >= hi) continue;
          const uint4 acc = fold_shared(stage, lo - f0, hi - f0, tid);
          uint4& buf = leafbuf[l * kThreads + tid];
          buf = a.row_off[l] >= f0 ? acc : or4(buf, acc);
        }
      }
      if (g == G - 1) {
        const Tile x = tile_at(t, blockIdx.x + (j / G) * gridDim.x);
        uint4 r;
        if (G == 1) {
          r = run_program(a, stack, tid, [&](int l) {
            return fold_shared(stage, a.row_off[l], a.row_off[l + 1], tid);
          });
        } else {
          r = run_program(a, stack, tid, [&](int l) {
            return a.row_off[l] == a.row_off[l + 1] ? make_uint4(0u, 0u, 0u, 0u)
                                                    : leafbuf[l * kThreads + tid];
          });
        }
        r = and4(r, stage[(t.n_rows - 1 - f0) * kThreads + tid]);
        if (mine >= x.words) r = make_uint4(0u, 0u, 0u, 0u);   // past a short tile
        emit(mode, r, x, t, tid, res, out, count);
      }
      __syncthreads();   // every thread is done with stage s: refill it
      if (tid == 0 && j + kStages < items) issue(j + kStages);
    }
  } else {
    // loads straight from device memory into registers, the same tiles: the
    // valid row first, then (up to kDirectRows rows in all) every selected
    // row, so that all of them are in flight before any is used
    for (uint32_t tile = blockIdx.x; tile < t.n_tiles; tile += gridDim.x) {
      const Tile x = tile_at(t, tile);
      const uint32_t n = x.words > mine ? min(4u, x.words - mine) : 0u;
      const uint4 v = load_direct(row_ptr(a, t, valid, t.n_rows - 1, 0, x) + mine, n, t.vec);
      uint4 r;
      if (t.n_rows <= kDirectRows) {
        uint4 row[kDirectRows - 1];
        int l = 0;
#pragma unroll
        for (int f = 0; f < kDirectRows - 1; ++f) {
          row[f] = make_uint4(0u, 0u, 0u, 0u);
          if (f < t.n_rows - 1) {
            while (a.row_off[l + 1] <= f) ++l;
            row[f] = load_direct(row_ptr(a, t, valid, f, l, x) + mine, n, t.vec);
          }
        }
        r = run_program(a, stack, tid, [&](int leaf) {
          uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int f = 0; f < kDirectRows - 1; ++f) {
            if (f >= a.row_off[leaf] && f < a.row_off[leaf + 1]) acc = or4(acc, row[f]);
          }
          return acc;
        });
      } else {
        r = run_program(a, stack, tid, [&](int leaf) {
          uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
          for (int f = a.row_off[leaf]; f < a.row_off[leaf + 1]; ++f) {
            acc = or4(acc, load_direct(row_ptr(a, t, valid, f, leaf, x) + mine, n, t.vec));
          }
          return acc;
        });
      }
      emit(mode, and4(r, v), x, t, tid, res, out, count);
    }
  }
  if (mode != kCount) return;

  // the block's count and one arrival in one atomic on the ticket; the
  // arrival that completes the grid holds every other block's count in the
  // value it replaced, so it writes the answer and resets the ticket
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned int warp_count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) s_counts[warp] = warp_count;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_counts[w];
    unsigned long long* const tk = g_tickets + slot;
    const unsigned long long prev = atomicAdd(tk, (1ull << kCountBits) | total);
    if ((prev >> kCountBits) == gridDim.x - 1) {
      *static_cast<long long*>(out) =
          static_cast<long long>((prev & ((1ull << kCountBits) - 1)) + total);
      atomicExch(tk, 0ull);   // the next launch on this ticket starts from 0
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

size_t smem_bytes(const Tiling& t, int n_leaves, bool bulk) {
  return static_cast<size_t>(kUnitBytes) * kThreads *
         ((bulk ? kStages * t.stage_rows : 0) + (t.groups > 1 ? n_leaves : 0) +
          t.stack_slots + 1);
}

}  // namespace

// Limits the caller checks against (pinot_tpu_torch/engine/bitmap.py):
// leaves, selected rows, program codes, stack depth.
extern "C" void pinot_bitmap_filter_limits(int* out) {
  out[0] = kMaxLeaves;
  out[1] = kMaxRows;
  out[2] = kMaxProgram;
  out[3] = kMaxStack;
}

// Count mode's tickets: slots [0, out[0]) for streams, [out[0], out[1]) for
// launches captured into graphs.
extern "C" void pinot_bitmap_filter_config(int* out) {
  out[0] = kStreamSlots;
  out[1] = kTicketSlots;
}

// For the current device, once: allows both kernels their largest dynamic
// shared memory and writes the SM count and the shared memory bytes per SM
// to out[0..1]. Returns 0 or a CUDA error.
extern "C" int pinot_bitmap_filter_setup(int* out) {
  int dev = 0, sms = 0, smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bitmap_filter_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bitmap_filter_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  }
  out[0] = sms;
  out[1] = smem;
  return static_cast<int>(err);
}

// Launch the filter on `stream`. leaf_words[l] points at leaf l's word matrix
// [S, card_l, W] (uint32, C order), leaf_seg_stride[l] = card_l * W; leaf l's
// selected rows are rows[row_off[l] .. row_off[l + 1]) (each < 256); program
// holds n_program codes (>= 0: LEAF l; -1 AND; -2 OR; -3 NOT), a tree whose
// stack never passes kMaxStack. valid holds n_words = S * W words. vec is 1
// (every word row, valid and out 16-byte aligned, W % 4 == 0: 16-byte bulk
// copies or loads) or 0 (4-byte loads). mode 0 writes uint32[n_words], 1 bool[32 * n_words], 2 the
// int64 bit count at out. sms and smem_per_sm are the device's, from
// pinot_bitmap_filter_setup. Count mode only: `slot` is the launch's ticket
// (pinot_bitmap_filter_config): its stream's, or, for a launch captured into a
// graph, one no other launch takes. Returns the CUDA error of the launch (0:
// launched), or cudaErrorInvalidValue for arguments past the limits.
extern "C" int pinot_bitmap_filter(const void* const* leaf_words,
                                   const unsigned long long* leaf_seg_stride, int n_leaves,
                                   const int* row_off, const int* rows, const int* program,
                                   int n_program, const void* valid, unsigned int words_per_seg,
                                   unsigned int n_words, int vec, int mode, int sms,
                                   int smem_per_sm, int slot, void* out, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_program < 1 || n_program > kMaxProgram ||
      row_off[0] != 0 || row_off[n_leaves] > kMaxRows || words_per_seg == 0 ||
      n_words % words_per_seg != 0 || (vec != 0 && vec != 1) ||
      (vec && words_per_seg % 4 != 0) || mode < kWords || mode > kCount || sms < 1 ||
      smem_per_sm < 1 ||
      (mode == kCount && (slot < 0 || slot >= kTicketSlots))) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  for (int l = 0; l < n_leaves; ++l) {
    if (row_off[l + 1] < row_off[l]) return cudaErrorInvalidValue;
    a.leaf_words[l] = static_cast<const uint32_t*>(leaf_words[l]);
    a.leaf_seg_stride[l] = leaf_seg_stride[l];
    if (vec && !aligned16(leaf_words[l])) return cudaErrorMisalignedAddress;
  }
  if (vec && (!aligned16(valid) || !aligned16(out))) return cudaErrorMisalignedAddress;
  for (int l = 0; l <= n_leaves; ++l) a.row_off[l] = row_off[l];
  for (int i = 0; i < row_off[n_leaves]; ++i) {
    if (rows[i] < 0 || rows[i] > 255) return cudaErrorInvalidValue;
    a.rows[i] = static_cast<unsigned char>(rows[i]);
  }
  int depth = 0, peak = 0;
  for (int pc = 0; pc < n_program; ++pc) {
    const int op = program[pc];
    if (op >= n_leaves || (op < 0 && op != kAnd && op != kOr && op != kNot)) {
      return cudaErrorInvalidValue;
    }
    depth += op >= 0 ? 1 : (op == kNot ? 0 : -1);
    if (depth < 1 || depth > kMaxStack) return cudaErrorInvalidValue;
    peak = depth > peak ? depth : peak;
    a.program[pc] = static_cast<signed char>(op);
  }
  if (depth != 1) return cudaErrorInvalidValue;
  a.n_leaves = n_leaves;
  a.n_program = n_program;
  if (n_words == 0) return 0;

  Tiling t{};
  t.W = words_per_seg;
  t.tiles_per_seg = (words_per_seg + kTileWords - 1) / kTileWords;
  t.n_tiles = (n_words / words_per_seg) * t.tiles_per_seg;
  t.n_rows = row_off[n_leaves] + 1;
  t.vec = vec;
  // bulk copies through the ring, unless the rows fit registers and every
  // block takes one tile (nothing to prefetch), or the rows are not aligned
  const unsigned int n_tiles_at_once = static_cast<unsigned int>(sms) * kMaxBlocksPerSm;
  const bool bulk = vec && (t.n_rows > kDirectRows || t.n_tiles > n_tiles_at_once);
  t.stage_rows = bulk ? (t.n_rows < kMaxStageRows ? t.n_rows : kMaxStageRows) : t.n_rows;
  t.groups = (t.n_rows + t.stage_rows - 1) / t.stage_rows;
  t.stack_slots = peak - 1;
  const size_t smem = smem_bytes(t, n_leaves, bulk);
  // a persistent grid: the blocks the card holds at once, at most one a tile
  int per_sm = static_cast<int>(static_cast<size_t>(smem_per_sm) / (smem + kBlockReserveBytes));
  per_sm = per_sm < 1 ? 1 : (per_sm > kMaxBlocksPerSm ? kMaxBlocksPerSm : per_sm);
  const unsigned int cap = static_cast<unsigned int>(sms) * per_sm;
  const unsigned int grid = t.n_tiles < cap ? t.n_tiles : cap;

  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const uint32_t*>(valid);
  if (bulk) {
    bitmap_filter_kernel<true><<<grid, kThreads, smem, s>>>(a, t, v, mode, slot, out);
  } else {
    bitmap_filter_kernel<false><<<grid, kThreads, smem, s>>>(a, t, v, mode, slot, out);
  }
  return static_cast<int>(cudaGetLastError());
}
