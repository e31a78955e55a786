// Kernels A (pack_blocks) and B (pack_bytes_blocks): variable-width token
// bit packing into per-block MSB-first u32 arenas.
//
// Replaces tudocomp_tpu/ops/bitpack_pallas.py:_pack_kernel (A) and
// _pack_bytes_kernel / _pack_bytes_packed_kernel (B). Flat bit p of a block
// lives in word p >> 5 at u32 bit 31 - (p & 31); bits that land at or past
// n_words are dropped, the word of a token's high part and the word of its
// low part checked separately (tudocomp_tpu/ops/bitpack.py:pack_tokens).
//
// Design. Tokens are (value, width <= 32). Kernel A reads them from two
// [B, nt] arrays; kernel B makes them on the fly as table[byte] from the
// block's 256-entry (codeword, length) tables staged in shared memory, for
// the live bytes pos < n_valid[b], after a header already in the arena.
// Both run the same two passes over a grid of (token tile, block):
//   1. tile_sums: each CTA sums the widths of its TILE tokens.
//   2. scatter: each CTA sums the tile totals before it (a few hundred
//      L2-resident ints at most) for its start bit, scans its tokens' widths
//      across the block, and ORs every token's bits into the arena with
//      atomicOr. Parts of different tokens are bit-disjoint, so the result
//      does not depend on the order the atomics land in. A thread merges the
//      parts of its own ITEMS consecutive tokens per word before issuing an
//      atomic.
// Bound on the H100: kernel B reads each input byte twice (once per pass)
// and writes ~len/8 bytes of arena per byte; the atomics on shared words are
// the expected limit, which the per-thread merge divides by ITEMS / (bits
// per word). The TPU kernel's roll scans, one-hot MXU scatters and the
// `pack` byte folding were workarounds for a machine without scatters or
// atomics and have no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                 // consecutive tokens per thread
constexpr int TILE = THREADS * ITEMS;    // tokens per CTA

struct PackArgs {
  // kernel A: token arrays [B, nt]
  const uint32_t* values;
  const int32_t* nbits;
  // kernel B: bytes [B, nt], tables [B, 256], per-block header bits and
  // live byte counts [B]
  const uint8_t* bytes;
  const uint32_t* table_vals;
  const int32_t* table_bits;
  const int32_t* start_bits;
  const int32_t* n_valid;
  int64_t nt;
  int n_words;
  int n_tiles;
  int32_t* tile_bits;   // [B, n_tiles] scratch
  uint32_t* words;      // [B, n_words] arena, zeroed or pre-filled
  int32_t* total_bits;  // [B]
  int32_t* err;         // mapped host word (csrc/launch.cu): 1 when a width lies outside [0, 32]
};

__device__ __forceinline__ int checked_width(int nb, int32_t* err) {
  if (nb < 0 || nb > 32) {
    *reinterpret_cast<volatile int32_t*>(err) = 1;  // a plain store: every writer stores 1
    return 0;
  }
  return nb;
}

// Stage block b's tables in shared memory (kernel B only).
template <bool BYTES>
__device__ void stage_tables(const PackArgs& a, int b, uint32_t* s_val, int32_t* s_bits) {
  if (BYTES) {
    const int s = threadIdx.x;  // THREADS == 256
    s_val[s] = a.table_vals[(int64_t)b * 256 + s];
    s_bits[s] = checked_width(a.table_bits[(int64_t)b * 256 + s], a.err);
    __syncthreads();
  }
}

// The ITEMS tokens of this thread, starting at token index i0.
template <bool BYTES>
__device__ void load_tokens(const PackArgs& a, int b, int64_t i0, const uint32_t* s_val,
                            const int32_t* s_bits, uint32_t* v, int* nb) {
  if (BYTES) {
    const int64_t live = a.n_valid[b];
    const uint8_t* row = a.bytes + (int64_t)b * a.nt;
    uint8_t c[ITEMS];
    if (i0 + ITEMS <= a.nt && (reinterpret_cast<uintptr_t>(row + i0) & 7) == 0) {
      const uint2 q = *reinterpret_cast<const uint2*>(row + i0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[k] = (q.x >> (8 * k)) & 0xFF;
        c[k + 4] = (q.y >> (8 * k)) & 0xFF;
      }
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) c[k] = i0 + k < a.nt ? row[i0 + k] : 0;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const bool on = i0 + k < live && i0 + k < a.nt;
      v[k] = s_val[c[k]];
      nb[k] = on ? s_bits[c[k]] : 0;
    }
  } else {
    const int64_t base = (int64_t)b * a.nt;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int64_t i = i0 + k;
      if (i < a.nt) {
        v[k] = a.values[base + i];
        nb[k] = checked_width(a.nbits[base + i], a.err);
      } else {
        v[k] = 0;
        nb[k] = 0;
      }
    }
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive scan of one int per thread across the CTA; *total gets the sum.
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[THREADS / 32];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_inclusive_scan(x);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int ws = lane < THREADS / 32 ? warp_sums[lane] : 0;
    const int wincl = warp_inclusive_scan(ws);
    if (lane < THREADS / 32) warp_sums[lane] = wincl - ws;
    if (lane == THREADS / 32 - 1) s_total = wincl;
  }
  __syncthreads();
  const int excl = warp_sums[warp] + incl - x;
  *total = s_total;
  __syncthreads();
  return excl;
}

__device__ long long block_sum64(long long x) {
  __shared__ long long warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w];
  __syncthreads();
  return s;
}

template <bool BYTES>
__global__ void __launch_bounds__(THREADS) tile_sums_kernel(PackArgs a) {
  __shared__ uint32_t s_val[256];
  __shared__ int32_t s_bits[256];
  const int t = blockIdx.x, b = blockIdx.y;
  stage_tables<BYTES>(a, b, s_val, s_bits);
  uint32_t v[ITEMS];
  int nb[ITEMS];
  load_tokens<BYTES>(a, b, (int64_t)t * TILE + (int64_t)threadIdx.x * ITEMS, s_val, s_bits, v, nb);
  int sum = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) sum += nb[k];
  int total;
  block_exclusive_scan(sum, &total);
  if (threadIdx.x == 0) a.tile_bits[(int64_t)b * a.n_tiles + t] = total;
}

__device__ __forceinline__ void flush_word(uint32_t* row, int n_words, int64_t w, uint32_t bits) {
  if (bits && w < n_words) atomicOr(row + w, bits);
}

template <bool BYTES>
__global__ void __launch_bounds__(THREADS) scatter_kernel(PackArgs a) {
  __shared__ uint32_t s_val[256];
  __shared__ int32_t s_bits[256];
  const int t = blockIdx.x, b = blockIdx.y;
  stage_tables<BYTES>(a, b, s_val, s_bits);

  // start bit of this tile: the header plus every earlier tile of the block
  long long before = 0;
  for (int j = threadIdx.x; j < t; j += THREADS) before += a.tile_bits[(int64_t)b * a.n_tiles + j];
  const int64_t start = block_sum64(before) + (a.start_bits ? a.start_bits[b] : 0);

  uint32_t v[ITEMS];
  int nb[ITEMS];
  load_tokens<BYTES>(a, b, (int64_t)t * TILE + (int64_t)threadIdx.x * ITEMS, s_val, s_bits, v, nb);
  int sum = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) sum += nb[k];
  int tile_total;
  const int excl = block_exclusive_scan(sum, &tile_total);

  uint32_t* row = a.words + (int64_t)b * a.n_words;
  int64_t off = start + excl;
  int64_t cur_w = -1;
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int n = nb[k];
    if (n == 0) continue;
    const uint32_t val = n == 32 ? v[k] : v[k] & ((1u << n) - 1u);
    const int64_t w0 = off >> 5;
    const int sh_end = (int)(off & 31) + n;  // in [1, 63]
    if (w0 != cur_w) {
      flush_word(row, a.n_words, cur_w, acc);
      cur_w = w0;
      acc = 0;
    }
    if (sh_end <= 32) {
      acc |= val << (32 - sh_end);
    } else {
      acc |= val >> (sh_end - 32);
      flush_word(row, a.n_words, cur_w, acc);
      cur_w = w0 + 1;
      acc = val << (64 - sh_end);
    }
    off += n;
  }
  flush_word(row, a.n_words, cur_w, acc);

  if (t == a.n_tiles - 1 && threadIdx.x == 0) a.total_bits[b] = (int32_t)(start + tile_total);
}

template <bool BYTES>
int launch(const PackArgs& a, int B, cudaStream_t stream) {
  const dim3 grid(a.n_tiles, B);
  tile_sums_kernel<BYTES><<<grid, THREADS, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scatter_kernel<BYTES><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int n_tiles_for(int64_t nt) { return (int)((nt + TILE - 1) / TILE); }

}  // namespace

// Kernel A. values/nbits [B, nt] (u32 / i32), words [B, n_words] zeroed by the
// caller, tile_bits [B, ceil(nt / 2048)] scratch, total_bits [B], err the
// mapped flag word.
extern "C" int tdc_pack_blocks(const void* values, const void* nbits, int B, long long nt,
                               int n_words, void* tile_bits, void* words, void* total_bits,
                               void* err, void* stream) {
  PackArgs a{};
  a.values = static_cast<const uint32_t*>(values);
  a.nbits = static_cast<const int32_t*>(nbits);
  a.nt = nt;
  a.n_words = n_words;
  a.n_tiles = n_tiles_for(nt);
  a.tile_bits = static_cast<int32_t*>(tile_bits);
  a.words = static_cast<uint32_t*>(words);
  a.total_bits = static_cast<int32_t*>(total_bits);
  a.err = static_cast<int32_t*>(err);
  return launch<false>(a, B, static_cast<cudaStream_t>(stream));
}

// Kernel B. bytes [B, bs] u8, n_valid [B], table_vals/table_bits [B, 256],
// start_bits [B] header bits, words [B, n_words] pre-filled with the header
// words by the caller, tile_bits [B, ceil(bs / 2048)] scratch, total_bits [B],
// err the mapped flag word.
extern "C" int tdc_pack_bytes_blocks(const void* bytes, const void* n_valid, const void* table_vals,
                                     const void* table_bits, const void* start_bits, int B,
                                     long long bs, int n_words, void* tile_bits, void* words,
                                     void* total_bits, void* err, void* stream) {
  PackArgs a{};
  a.bytes = static_cast<const uint8_t*>(bytes);
  a.n_valid = static_cast<const int32_t*>(n_valid);
  a.table_vals = static_cast<const uint32_t*>(table_vals);
  a.table_bits = static_cast<const int32_t*>(table_bits);
  a.start_bits = static_cast<const int32_t*>(start_bits);
  a.nt = bs;
  a.n_words = n_words;
  a.n_tiles = n_tiles_for(bs);
  a.tile_bits = static_cast<int32_t*>(tile_bits);
  a.words = static_cast<uint32_t*>(words);
  a.total_bits = static_cast<int32_t*>(total_bits);
  a.err = static_cast<int32_t*>(err);
  return launch<true>(a, B, static_cast<cudaStream_t>(stream));
}
