// Word-domain bitmap filter: a filter tree evaluated over packed row bitmaps,
// written for Hopper (sm_90a).
//
// Replaces the JAX package's jit programs for the word-domain filter
// (pinot_tpu/engine/kernels.py: _bitmap_leaf_words, _make_word_fn,
// _unpack_words and the popcount of compute_filter_count), which XLA compiled
// from jnp ops; no Pallas kernel did this work. It computes, for every packed
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
// Design (a simple kernel that is right first):
// * One pass over the words: a grid-stride loop, each thread taking 4
//   consecutive words with 16-byte loads (uint4) where every word row starts
//   16-byte aligned and W % 4 == 0, else one word with 4-byte loads.
//   Neighbouring threads read neighbouring words of the same row, so every
//   load is coalesced; each input word is read once.
// * The tree, the leaves' word-matrix pointers and their selected rows are a
//   kernel parameter (__grid_constant__, read in place from the constant
//   bank: every thread of a warp reads the same entry, a broadcast). A new
//   literal or a new tree rebuilds nothing and copies nothing to the card.
// * The postfix program runs on a small per-thread stack (local memory,
//   cached in L1): a LEAF code ORs the leaf's selected rows into a new entry,
//   AND and OR pop two, NOT flips the top.
// * mask: each word becomes 32 bytes of 0/1, written as two 16-byte stores
//   (a nibble spreads to 4 bytes by one multiply); count: __popc per word,
//   a warp and block reduction, one 64-bit atomic per block into the output,
//   which the caller zeroes.
//
// Not done yet (later work): TMA or cp.async staging of the word rows, and
// fusing the row mask into the aggregation that reads it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kMaxRows = 1024;      // selected rows of all leaves together
constexpr int kMaxProgram = 64;
constexpr int kMaxStack = 16;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

constexpr int kAnd = -1;
constexpr int kOr = -2;
constexpr int kNot = -3;

enum Mode : int { kWords = 0, kMask = 1, kCount = 2 };

struct Args {
  const uint32_t* leaf_words[kMaxLeaves];   // [S, card_l, W] each
  unsigned long long leaf_seg_stride[kMaxLeaves];   // card_l * W words
  int row_off[kMaxLeaves + 1];               // leaf l's rows: rows[row_off[l]..row_off[l+1])
  unsigned char rows[kMaxRows];              // selected dict ids (cardinality <= 255)
  signed char program[kMaxProgram];          // >= 0: LEAF l; kAnd, kOr, kNot
  int n_program;
};

template <int N>
struct Words {
  uint32_t v[N];
};

template <int N>
__device__ __forceinline__ Words<N> load_words(const uint32_t* p);

template <>
__device__ __forceinline__ Words<4> load_words<4>(const uint32_t* p) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  return {{x.x, x.y, x.z, x.w}};
}

template <>
__device__ __forceinline__ Words<1> load_words<1>(const uint32_t* p) {
  return {{__ldg(p)}};
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* p, const Words<N>& w);

template <>
__device__ __forceinline__ void store_words<4>(uint32_t* p, const Words<4>& w) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w.v[0], w.v[1], w.v[2], w.v[3]);
}

template <>
__device__ __forceinline__ void store_words<1>(uint32_t* p, const Words<1>& w) {
  *p = w.v[0];
}

// bits b3..b0 of a nibble -> bytes 3..0 of a word, each 0 or 1: the four
// shifted copies (0, 7, 14, 21) do not overlap, so the multiply never carries
__device__ __forceinline__ uint32_t spread_nibble(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

// one word -> the 32 mask bytes of its rows, as two 16-byte stores
__device__ __forceinline__ void store_mask(unsigned char* out, uint32_t w) {
  uint4 lo, hi;
  lo.x = spread_nibble(w & 15u);
  lo.y = spread_nibble((w >> 4) & 15u);
  lo.z = spread_nibble((w >> 8) & 15u);
  lo.w = spread_nibble((w >> 12) & 15u);
  hi.x = spread_nibble((w >> 16) & 15u);
  hi.y = spread_nibble((w >> 20) & 15u);
  hi.z = spread_nibble((w >> 24) & 15u);
  hi.w = spread_nibble(w >> 28);
  reinterpret_cast<uint4*>(out)[0] = lo;
  reinterpret_cast<uint4*>(out)[1] = hi;
}

template <int N>
__device__ __forceinline__ Words<N> fold_leaf(const Args& a, int l, uint32_t s, uint32_t w,
                                              uint32_t W) {
  Words<N> acc;
#pragma unroll
  for (int j = 0; j < N; ++j) acc.v[j] = 0u;
  const uint32_t* base = a.leaf_words[l] + (size_t)s * a.leaf_seg_stride[l] + w;
  for (int i = a.row_off[l]; i < a.row_off[l + 1]; ++i) {
    const Words<N> x = load_words<N>(base + (size_t)a.rows[i] * W);
#pragma unroll
    for (int j = 0; j < N; ++j) acc.v[j] |= x.v[j];
  }
  return acc;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
bitmap_filter_kernel(const __grid_constant__ Args a, const uint32_t* __restrict__ valid,
                     uint32_t W, uint32_t n_words, int mode, void* out) {
  const uint32_t n_units = n_words / N;
  unsigned long long count = 0;
  for (uint32_t u = blockIdx.x * blockDim.x + threadIdx.x; u < n_units;
       u += gridDim.x * blockDim.x) {
    const uint32_t g = u * N;
    const uint32_t s = g / W;
    const uint32_t w = g - s * W;
    Words<N> stack[kMaxStack];
    int sp = 0;
    for (int pc = 0; pc < a.n_program; ++pc) {
      const int op = a.program[pc];
      if (op >= 0) {
        stack[sp++] = fold_leaf<N>(a, op, s, w, W);
      } else if (op == kNot) {
#pragma unroll
        for (int j = 0; j < N; ++j) stack[sp - 1].v[j] = ~stack[sp - 1].v[j];
      } else {
        --sp;
        const bool is_and = op == kAnd;   // else kOr
#pragma unroll
        for (int j = 0; j < N; ++j) {
          stack[sp - 1].v[j] = is_and ? (stack[sp - 1].v[j] & stack[sp].v[j])
                                      : (stack[sp - 1].v[j] | stack[sp].v[j]);
        }
      }
    }
    Words<N> r = stack[0];
    const Words<N> v = load_words<N>(valid + g);
#pragma unroll
    for (int j = 0; j < N; ++j) r.v[j] &= v.v[j];
    if (mode == kWords) {
      store_words<N>(static_cast<uint32_t*>(out) + g, r);
    } else if (mode == kMask) {
#pragma unroll
      for (int j = 0; j < N; ++j) store_mask(static_cast<unsigned char*>(out) + 32ull * (g + j), r.v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) count += __popc(r.v[j]);
    }
  }
  if (mode != kCount) return;
  // block reduction of the counts, then one atomic per block
  __shared__ unsigned long long warp_sums[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    if (total) atomicAdd(static_cast<unsigned long long*>(out), total);
  }
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

// Launch the filter on `stream`. leaf_words[l] points at leaf l's word matrix
// [S, card_l, W] (uint32, C order), leaf_seg_stride[l] = card_l * W; leaf l's
// selected rows are rows[row_off[l] .. row_off[l + 1]) (each < 256); program
// holds n_program codes (>= 0: LEAF l; -1 AND; -2 OR; -3 NOT), a tree whose
// stack never passes kMaxStack. valid holds n_words = S * W words. vec is 4
// (every word row and the outputs 16-byte aligned, W % 4 == 0) or 1. mode 0
// writes uint32[n_words], 1 bool[32 * n_words], 2 adds the bit count to the
// int64 at out (zeroed by the caller). Returns the CUDA error of the launch
// (0: launched), or cudaErrorInvalidValue for arguments past the limits.
extern "C" int pinot_bitmap_filter(const void* const* leaf_words,
                                   const unsigned long long* leaf_seg_stride, int n_leaves,
                                   const int* row_off, const int* rows, const int* program,
                                   int n_program, const void* valid, unsigned int words_per_seg,
                                   unsigned int n_words, int vec, int mode, void* out,
                                   void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || n_program < 1 || n_program > kMaxProgram ||
      row_off[0] != 0 || row_off[n_leaves] > kMaxRows || words_per_seg == 0 ||
      n_words % words_per_seg != 0 || (vec != 1 && vec != 4) ||
      (vec == 4 && words_per_seg % 4 != 0) || mode < kWords || mode > kCount) {
    return cudaErrorInvalidValue;
  }
  Args a = {};
  for (int l = 0; l < n_leaves; ++l) {
    a.leaf_words[l] = static_cast<const uint32_t*>(leaf_words[l]);
    a.leaf_seg_stride[l] = leaf_seg_stride[l];
  }
  for (int l = 0; l <= n_leaves; ++l) a.row_off[l] = row_off[l];
  for (int i = 0; i < row_off[n_leaves]; ++i) {
    if (rows[i] < 0 || rows[i] > 255) return cudaErrorInvalidValue;
    a.rows[i] = static_cast<unsigned char>(rows[i]);
  }
  int depth = 0;
  for (int pc = 0; pc < n_program; ++pc) {
    const int op = program[pc];
    if (op >= n_leaves || (op < 0 && op != kAnd && op != kOr && op != kNot)) {
      return cudaErrorInvalidValue;
    }
    depth += op >= 0 ? 1 : (op == kNot ? 0 : -1);
    if (depth < 1 || depth > kMaxStack) return cudaErrorInvalidValue;
    a.program[pc] = static_cast<signed char>(op);
  }
  if (depth != 1) return cudaErrorInvalidValue;
  a.n_program = n_program;
  if (n_words == 0) return 0;

  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const unsigned int units = n_words / vec;
  const unsigned int want = (units + kThreads - 1) / kThreads;
  const unsigned int cap = static_cast<unsigned int>(sms) * kBlocksPerSm;
  const unsigned int grid = want < cap ? want : cap;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const uint32_t*>(valid);
  if (vec == 4) {
    bitmap_filter_kernel<4><<<grid, kThreads, 0, s>>>(a, v, words_per_seg, n_words, mode, out);
  } else {
    bitmap_filter_kernel<1><<<grid, kThreads, 0, s>>>(a, v, words_per_seg, n_words, mode, out);
  }
  return cudaGetLastError();
}
