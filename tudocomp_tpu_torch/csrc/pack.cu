// Kernels A (pack_blocks) and B (pack_bytes_blocks): variable-width token
// bit packing into per-block MSB-first u32 arenas.
//
// Replaces tudocomp_tpu/ops/bitpack_pallas.py:_pack_kernel (:217, A) and
// _pack_bytes_kernel / _pack_bytes_packed_kernel (:243, :289, B). Flat bit p
// of a block lives in word p >> 5 at u32 bit 31 - (p & 31); bits that land
// at or past n_words are dropped (tudocomp_tpu/ops/bitpack.py:pack_tokens),
// and the row's bit count still counts them.
//
// Tokens are (value, width <= 32). Kernel A reads them from two [B, nt]
// arrays; kernel B makes them on the fly as table[byte] from the block's
// 256-entry (codeword, length) tables staged in shared memory, for the live
// bytes pos < n_valid[b], after the block's header (hdr_bits[b] bits of
// hdr_words[b]). A's tokens start at bit 0. The TPU kernels walked a row's
// tiles in order with the bit offset carried in SMEM, used one-hot selects
// for the lookup and roll scans for the prefix sums, and read-modify-wrote
// a zeroed arena; here every tile of every row runs at once, the lookup is
// a shared-memory read and the scans are warp shuffles.
//
// Design. A CTA of 256 threads takes a tile of one row: kernel B 8192
// bytes, 32 consecutive ones a thread (two 16-byte loads), kernel A 1024
// tokens, 4 a thread. Each arena word is stored once, with a plain store,
// and nothing zeroes the arena:
//   - Where a tile starts. Kernel A's rows of one tile (its 393 header
//     tokens) need no other tile: one launch, one pass, no scratch. Kernel
//     B, and A's longer rows, take two launches: tile_widths_kernel reads
//     the tokens once (B: stages only the length table) and writes each
//     tile's widths and, for B, each thread's; then each CTA of
//     pack_tiles_kernel sums its row's tile totals (<= 32 ints at 256 KiB,
//     from L2; A's rows of 65536 tokens have 64) for its start bit and the
//     row's total, and B's threads take their own widths from the first
//     pass, so B looks each byte up once in the second pass, inside the
//     merge, with no token arrays in registers.
//     The other way, one pass with a decoupled look-back over tile status
//     words, needs an atomic tile counter, since CTAs start in no fixed
//     order, and status words zeroed before every launch: a memset, whose
//     host cost is the size of this kernel's device time. The second pass
//     reads the bytes again, from L2 (16 MiB a batch).
//   - The tile's words. One CTA round (warp shuffles, then the 8 warp
//     totals) scans the widths and sums the tile totals; each thread
//     appends its tokens to a 64-bit buffer and moves every full word into
//     a window of the tile's words in shared memory (at most a word a token
//     and one more: no token is wider than 32 bits): a plain store for a
//     word of its bits alone, atomicOr for its first and last words, which
//     it may share with the thread before or after it. The CTA writes the words it owns from
//     the window, in 16-byte stores where the row's alignment allows.
//   - Owners. A word belongs to the tile that holds its last bit, or the
//     row's last bit for the row's last word; tile 0 holds the header's
//     bits as well. So a word cut by a tile boundary belongs to the last
//     tile that starts inside it and reaches its end (probes.cu's P7 rule),
//     a tile without bits owns nothing (B's dead tail, A's zero runs), and
//     the header's words are tile 0's. Every owned word below
//     min(hdr_cols, n_words) gets the header word ORed in, as the TPU
//     kernel's arena starts as the header (bitpack_pallas.py:259).
//   - The walk-back. Warp 0 of the owner of a cut word gets the earlier
//     tokens' bits of it, walking back over the tokens before the tile, 32
//     at a time (the first 32 fetched at the start), until it has covered
//     the word's bits below the tile, skipping whole tiles whose total is
//     0, and stores that word itself. It is bounded by bits, not tokens: B's
//     live bytes are at least 1 bit wide (8 in a degenerate block), so one
//     step covers the <= 31 bits; A's zero runs cost a step a 32 tokens
//     inside a tile that has bits.
//   - The tail. The words from the row's last bit to n_words are split into
//     one share a tile (every CTA knows the row's total), so no CTA writes
//     alone the ~45% of kernel B's arena (sized for 9 bits a byte) that lies
//     past the bits.
// No global atomics. A width outside [0, 32] sets the mapped flag word (a
// plain store; csrc/launch.cu) and counts as 0 everywhere.
// The tile sizes. Kernel B's per-CTA work (the table staging, the scan
// round, three barriers, the walk-back) is spread over 8192 bytes, and its
// pack kernel is held to 48 registers, 5 CTAs of 256 threads an SM (34 KiB
// of shared memory each): on the H100 it was slower at 4096 bytes a CTA and
// with its registers unbounded. Kernel A's main-path rows are 393 tokens:
// at 4 a thread one CTA takes a row with 99 threads busy, where 32 a
// thread left 13 of them to merge their tokens in turn (PERF.md section 6).
// Bound on the H100: the bytes (B: the valid bytes read, the filled words
// written). Here B reads its bytes twice (the second time from L2), writes
// the whole arena (the tail's zeros too) and stages its tables a CTA; the
// per-token merge, the CTA's scan and barriers and the walk-back hold it,
// not the bytes (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// THREADS, ITEMS_A and ITEMS_B are also in ops/bitpack_cuda.py (TILE_A,
// TILE_B size the first pass's scratch); tests/test_torch_pack_tiles.py
// holds the two files to the same values.
constexpr int THREADS = 256;
constexpr int ITEMS_A = 4;               // kernel A: consecutive tokens a thread
constexpr int ITEMS_B = 32;              // kernel B: consecutive bytes a thread
constexpr int MIN_CTAS = 5;              // CTAs an SM that kernel B's pack_tiles_kernel registers allow
constexpr unsigned FULL = 0xffffffffu;
static_assert(ITEMS_A % 4 == 0 && ITEMS_B % 16 == 0 && THREADS == 256,
              "16-byte loads; a thread a table entry");

template <bool BYTES>
struct Tile {
  static constexpr int ITEMS = BYTES ? ITEMS_B : ITEMS_A;
  static constexpr int TOKENS = THREADS * ITEMS;  // tokens a CTA
  static constexpr int WIN = TOKENS + 4;          // window words: a tile's bits touch at most TOKENS + 1
};

struct PackArgs {
  // kernel A: token arrays [B, nt]
  const uint32_t* values;
  const int32_t* nbits;
  // kernel B: bytes [B, nt], live byte counts [B]; tables, header words and
  // header bits of row b at b times their row stride (0: one for every row)
  const uint8_t* bytes;
  const int32_t* n_valid;
  const uint32_t* table_vals;
  const int32_t* table_bits;
  int64_t table_stride;
  const uint32_t* hdr_words;
  int64_t hdr_stride;
  int hdr_cols;
  const int32_t* hdr_bits;
  int64_t hdr_bits_stride;
  int64_t nt;
  int n_words;
  int n_tiles;
  int32_t* tile_bits;    // [B, n_tiles] tile totals (first pass); null when A's rows are one tile
  int32_t* thread_bits;  // kernel B: [B, n_tiles, THREADS] each thread's widths (first pass)
  uint32_t* words;      // [B, n_words] arena, every word stored here
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

__device__ __forceinline__ uint32_t masked(uint32_t v, int nb) { return nb >= 32 ? v : v & ((1u << nb) - 1u); }

// Bytes live in row b: kernel B's n_valid within the row, kernel A's whole row.
template <bool BYTES>
__device__ __forceinline__ int64_t live_tokens(const PackArgs& a, int64_t b) {
  if (!BYTES) return a.nt;
  const int64_t n = a.n_valid[b];
  return n < 0 ? 0 : (n < a.nt ? n : a.nt);
}

// Kernel B: the ITEMS_B bytes from byte i0 of row b, four a word (0 past the row).
__device__ __forceinline__ void load_bytes(const PackArgs& a, int64_t b, int64_t i0, uint32_t (&q)[ITEMS_B / 4]) {
  const uint8_t* row = a.bytes + b * a.nt;
  if (i0 + ITEMS_B <= a.nt && (reinterpret_cast<uintptr_t>(row + i0) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < ITEMS_B / 16; ++j) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + i0) + j);
      q[4 * j] = x.x, q[4 * j + 1] = x.y, q[4 * j + 2] = x.z, q[4 * j + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS_B / 4; ++j) {
      q[j] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t i = i0 + 4 * j + k;
        if (i < a.nt) q[j] |= (uint32_t)row[i] << (8 * k);
      }
    }
  }
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t (&q)[ITEMS_B / 4], int k) {
  return (q[k >> 2] >> (8 * (k & 3))) & 0xFF;
}

// Kernel A: the ITEMS_A tokens from token i0 of row b, values masked to
// their widths (checked; width 0 past the row).
__device__ __forceinline__ void load_tokens(const PackArgs& a, int64_t b, int64_t i0, uint32_t (&v)[ITEMS_A],
                                            int (&nb)[ITEMS_A]) {
  const int64_t base = b * a.nt + i0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(a.nbits + base) | reinterpret_cast<uintptr_t>(a.values + base);
  if (i0 + ITEMS_A <= a.nt && (align & 15) == 0) {
#pragma unroll
    for (int j = 0; j < ITEMS_A / 4; ++j) {
      const int4 n4 = __ldg(reinterpret_cast<const int4*>(a.nbits + base) + j);
      const uint4 v4 = __ldg(reinterpret_cast<const uint4*>(a.values + base) + j);
      nb[4 * j] = n4.x, nb[4 * j + 1] = n4.y, nb[4 * j + 2] = n4.z, nb[4 * j + 3] = n4.w;
      v[4 * j] = v4.x, v[4 * j + 1] = v4.y, v[4 * j + 2] = v4.z, v[4 * j + 3] = v4.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS_A; ++k) {
      const bool in = i0 + k < a.nt;
      nb[k] = in ? __ldg(a.nbits + base + k) : 0;
      v[k] = in ? __ldg(a.values + base + k) : 0u;
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS_A; ++k) {
    nb[k] = checked_width(nb[k], a.err);
    v[k] = masked(v[k], nb[k]);
  }
}

// Kernel B's table entry: (width << 32) | value masked to its width.
__device__ __forceinline__ unsigned long long table_entry(const PackArgs& a, int64_t b, int c) {
  const int64_t i = b * a.table_stride + c;
  const int nb = checked_width(a.table_bits[i], a.err);
  return ((unsigned long long)nb << 32) | masked(a.table_vals[i], nb);
}

// Token i of row b (width 0 outside [0, live)); kernel B looks it up in s_tab.
template <bool BYTES>
__device__ __forceinline__ void token_at(const PackArgs& a, int64_t b, int64_t i, int64_t live,
                                         const unsigned long long* s_tab, uint32_t* v, int* nb) {
  *v = 0;
  *nb = 0;
  if (i < 0 || i >= live) return;
  if (BYTES) {
    const unsigned long long e = s_tab[a.bytes[b * a.nt + i]];
    *v = (uint32_t)e;
    *nb = (int)(e >> 32);
  } else {
    *nb = checked_width(a.nbits[b * a.nt + i], a.err);
    *v = masked(a.values[b * a.nt + i], *nb);
  }
}

// The parts of a token of width nb (0-32, value masked) at bit offset off:
// hi for word off >> 5, lo for the word after.
__device__ __forceinline__ void token_parts(uint32_t vm, int nb, int off, uint32_t* hi, uint32_t* lo) {
  const int sh_end = (off & 31) + nb;
  *hi = *lo = 0;
  if (nb > 0) {
    if (sh_end <= 32) {
      *hi = vm << (32 - sh_end);
    } else {
      *hi = vm >> (sh_end - 32);
      *lo = vm << (64 - sh_end);
    }
  }
}

// row[w] = word(w) for w in [w0, w1], each word by one thread of the CTA:
// 16-byte stores from the first 16-byte aligned word on, scalar at the ends.
template <class F>
__device__ __forceinline__ void store_words(uint32_t* row, int w0, int w1, F word) {
  if (w0 > w1) return;
  const int mis = (int)((reinterpret_cast<uintptr_t>(row + w0) >> 2) & 3);
  const int head = min(w1 + 1, w0 + ((4 - mis) & 3));
  const int body = head + ((w1 + 1 - head) & ~3);
  for (int w = w0 + (int)threadIdx.x; w < head; w += THREADS) row[w] = word(w);
  for (int w = head + 4 * (int)threadIdx.x; w < body; w += 4 * THREADS)
    *reinterpret_cast<uint4*>(row + w) = make_uint4(word(w), word(w + 1), word(w + 2), word(w + 3));
  for (int w = body + (int)threadIdx.x; w <= w1; w += THREADS) row[w] = word(w);
}

// First pass (kernel B, and A's rows of several tiles): tile_bits[b, t] = the
// widths of tile t of row b; for B also thread_bits[b, t, i], those of its
// thread i.
template <bool BYTES>
__global__ void __launch_bounds__(THREADS) tile_widths_kernel(PackArgs a) {
  constexpr int ITEMS = Tile<BYTES>::ITEMS, TILE = Tile<BYTES>::TOKENS;
  __shared__ int32_t s_bits[BYTES ? 256 : 1];
  __shared__ int s_warp[THREADS / 32];
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.y;
  const int64_t i0 = (int64_t)t * TILE + (int64_t)tid * ITEMS;
  int sum = 0;
  if constexpr (BYTES) {
    uint32_t q[ITEMS / 4];
    load_bytes(a, b, i0, q);
    const int64_t live = live_tokens<true>(a, b);
    s_bits[tid] = checked_width(a.table_bits[b * a.table_stride + tid], a.err);
    __syncthreads();
    if (i0 + ITEMS <= live) {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) sum += s_bits[byte_of(q, k)];
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) sum += i0 + k < live ? s_bits[byte_of(q, k)] : 0;
    }
    a.thread_bits[((int64_t)b * a.n_tiles + t) * THREADS + tid] = sum;
  } else {
    const int32_t* nbits = a.nbits + b * a.nt + i0;
    if (i0 + ITEMS <= a.nt && (reinterpret_cast<uintptr_t>(nbits) & 15) == 0) {
#pragma unroll
      for (int j = 0; j < ITEMS / 4; ++j) {
        const int4 n4 = __ldg(reinterpret_cast<const int4*>(nbits) + j);
        sum += checked_width(n4.x, a.err) + checked_width(n4.y, a.err) + checked_width(n4.z, a.err) +
               checked_width(n4.w, a.err);
      }
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) sum += i0 + k < a.nt ? checked_width(__ldg(nbits + k), a.err) : 0;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(FULL, sum, d);
  if (lane == 0) s_warp[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += s_warp[w];
    a.tile_bits[b * a.n_tiles + t] = total;
  }
}

// Tile t of row b: its tokens into the window, then the words it owns.
template <bool BYTES>
__global__ void __launch_bounds__(THREADS, BYTES ? MIN_CTAS : 1) pack_tiles_kernel(PackArgs a) {
  constexpr int ITEMS = Tile<BYTES>::ITEMS, TILE = Tile<BYTES>::TOKENS;
  __shared__ unsigned long long s_tab[BYTES ? 256 : 1];
  __shared__ __align__(16) uint32_t win[Tile<BYTES>::WIN];
  __shared__ int s_warp[THREADS / 32];
  __shared__ long long s_rows[THREADS / 32];
  __shared__ int s_prev;  // the widths of the tile before this one
  const int t = blockIdx.x, T = a.n_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.y;
  const int64_t i0 = (int64_t)t * TILE + (int64_t)tid * ITEMS;
  const int64_t live = live_tokens<BYTES>(a, b);

  // 1. the reads that depend on nothing, all in flight at once: the tokens
  // (B: bytes), the row's tile totals, the 32 tokens before the tile (warp 0,
  // for the walk-back), the header's bits, B's tables; the window zeroed
  uint32_t v[ITEMS_A];
  int nb[ITEMS_A];
  uint32_t q[ITEMS_B / 4];
  if constexpr (BYTES) load_bytes(a, b, i0, q); else load_tokens(a, b, i0, v, nb);
  long long rows = 0;  // (widths of the tiles before this one << 32) + widths of the row's tiles
  if (T > 1)
    for (int j = tid; j < T; j += THREADS) {
      const long long w = a.tile_bits[b * T + j];
      rows += (j < t ? w << 32 : 0) + w;
      if (j == t - 1) s_prev = (int)w;
    }
  const int64_t back = (int64_t)t * TILE - 32 + lane;  // warp 0's token in the chunk before the tile
  uint32_t back_v = 0;
  int back_nb = 0, back_c = 0;
  if (t > 0 && warp == 0) {
    if (BYTES) {
      back_c = a.bytes[b * a.nt + back];  // in the row: the tiles before t are whole
    } else {
      token_at<false>(a, b, back, live, nullptr, &back_v, &back_nb);
    }
  }
  const int S = BYTES ? a.hdr_bits[b * a.hdr_bits_stride] : 0;  // bits before the first token
  if (BYTES) s_tab[tid] = table_entry(a, b, tid);
  // the window: at most one word a live token and one more
  const int64_t toks = (live < (int64_t)(t + 1) * TILE ? live : (int64_t)(t + 1) * TILE) - (int64_t)t * TILE;
  const int zero4 = toks > 0 ? (int)(toks + 4) / 4 : 1;
  for (int j = tid; j < zero4; j += THREADS) reinterpret_cast<uint4*>(win)[j] = make_uint4(0, 0, 0, 0);
  int sum = 0;  // this thread's widths: B's from the first pass
  if constexpr (BYTES) {
    sum = a.thread_bits[((int64_t)b * T + t) * THREADS + tid];
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) sum += nb[k];
  }

  // 2. one CTA round for the scan of the widths and the sums of the tile
  // totals; B's tables are staged by then
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) rows += __shfl_xor_sync(FULL, rows, d);
  if (lane == 31) {
    s_warp[warp] = incl;
    s_rows[warp] = rows;
  }
  __syncthreads();
  if (BYTES && t > 0 && warp == 0 && back < live) {
    back_v = (uint32_t)s_tab[back_c];
    back_nb = (int)(s_tab[back_c] >> 32);
  }
  int excl = incl - sum, tile_total = 0;
  rows = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int x = s_warp[w];
    excl += w < warp ? x : 0;
    tile_total += x;
    rows += s_rows[w];
  }

  const int s = S + (int)(rows >> 32);                                 // the tile's first token bit
  const int e = s + tile_total;                                        // one past its last
  const int total = S + (T > 1 ? (int)(rows & 0xffffffffLL) : tile_total);  // the row's bits
  const int a0 = t == 0 ? 0 : s;     // tile 0 holds the header's bits too
  const bool owns_end = e == total && (e > a0 || t == 0);
  const int lo = a0 >> 5;            // the words this tile owns: lo .. hi
  const int hi = e > a0 ? (owns_end ? ((total + 31) >> 5) - 1 : (e >> 5) - 1) : lo - 1;
  const int base = s >> 5;           // win[j] is word base + j

  // 3. this thread's tokens (B: looked up now) into the window through a
  // 64-bit buffer: a word that only this thread's bits fill is stored, one
  // it may share with the thread before or after it ORed in
  {
    const int off = s + excl;
    int w = (off >> 5) - base, have = off & 31;  // have: the buffer's bits, from the word's first
    bool first = have != 0;
    unsigned long long buf = 0;
    const bool all_live = i0 + ITEMS <= live;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      uint32_t vk;
      int nk;
      if constexpr (BYTES) {
        const unsigned long long e = all_live || i0 + k < live ? s_tab[byte_of(q, k)] : 0ull;
        vk = (uint32_t)e;
        nk = (int)(e >> 32);
      } else {
        vk = v[k];
        nk = nb[k];
      }
      buf = (buf << nk) | vk;
      have += nk;
      if (have >= 32) {
        have -= 32;
        const uint32_t word = (uint32_t)(buf >> have);
        if (first) atomicOr(&win[w], word); else win[w] = word;
        first = false;
        ++w;
      }
    }
    if (have > 0) {
      const uint32_t word = (uint32_t)(buf << (32 - have));
      if (word) atomicOr(&win[w], word);
    }
  }
  __syncthreads();

  // 4. the words this tile owns, and its share of the tail past the row's bits
  uint32_t* row = a.words + b * a.n_words;
  const uint32_t* hdr = BYTES ? a.hdr_words + b * a.hdr_stride : nullptr;
  const int k_hdr = BYTES ? min(a.hdr_cols, a.n_words) : 0;  // words that take the header's word
  auto owned = [&](int w) {
    uint32_t x = w >= base ? win[w - base] : 0u;
    if (w < k_hdr) x |= __ldg(hdr + w);
    return x;
  };
  const bool walk = t > 0 && (s & 31) && lo <= hi;  // word lo is cut: earlier tokens hold bits of it
  if (walk && warp == 0) {
    // warp 0 walks back over the tokens before the tile, 32 at a time, for
    // those bits, and stores word lo
    const int need = s & 31;  // bits of word lo below s
    int covered = 0;          // bits of the tokens walked so far
    uint32_t earlier = 0;
    int64_t k = (int64_t)t * TILE;  // the chunk is tokens [k - 32, k)
    bool fetched = true;            // back_v, back_nb hold it
    while (covered < need && k > 0) {
      if (k % TILE == 0 && (k == (int64_t)t * TILE ? s_prev : a.tile_bits[b * T + k / TILE - 1]) == 0) {
        // a tile without bits
        k -= TILE;
        fetched = false;
        continue;
      }
      if (!fetched) token_at<BYTES>(a, b, k - 32 + lane, live, s_tab, &back_v, &back_nb);
      fetched = false;
      int suffix = back_nb;  // widths of this lane's token and those after it in the chunk
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_down_sync(FULL, suffix, d);
        if (lane + d < 32) suffix += y;
      }
      const int tok_end = s - covered - (suffix - back_nb);
      uint32_t part = 0;
      if (back_nb > 0 && tok_end > 32 * lo) {
        uint32_t phi, plo;
        token_parts(back_v, back_nb, tok_end - back_nb, &phi, &plo);
        const int tw = (tok_end - back_nb) >> 5;
        part = (tw == lo ? phi : 0u) | (tw + 1 == lo ? plo : 0u);
      }
      earlier |= __reduce_or_sync(FULL, part);
      covered += __shfl_sync(FULL, suffix, 0);
      k -= 32;
    }
    if (lane == 0 && lo < a.n_words) row[lo] = owned(lo) | earlier;
  }
  store_words(row, walk ? lo + 1 : lo, min(hi, a.n_words - 1), owned);
  const int tail = (total + 31) >> 5;
  if (tail < a.n_words) {
    const int64_t n = a.n_words - tail;
    store_words(row, tail + (int)(n * t / T), tail + (int)(n * (t + 1) / T) - 1,
                [&](int w) { return w < k_hdr ? __ldg(hdr + w) : 0u; });
  }
  if (t == 0 && tid == 0) a.total_bits[b] = total;
}

template <bool BYTES>
int launch(PackArgs a, int B, cudaStream_t stream) {
  const dim3 grid(a.n_tiles, B);
  if (BYTES || a.n_tiles > 1) {
    tile_widths_kernel<BYTES><<<grid, THREADS, 0, stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else {
    a.tile_bits = nullptr;
  }
  pack_tiles_kernel<BYTES><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool BYTES>
int n_tiles_for(int64_t nt) {
  constexpr int TILE = Tile<BYTES>::TOKENS;
  return nt <= TILE ? 1 : (int)((nt + TILE - 1) / TILE);
}

}  // namespace

// Kernel A. values/nbits [B, nt] (u32 / i32), words [B, n_words] (written
// whole, nothing needs zeroing), tile_bits [B, ceil(nt / TOKENS)] scratch
// (TOKENS = Tile<false>::TOKENS, 1024; null when nt <= TOKENS: one tile a
// row, one launch), total_bits [B], err the mapped flag word.
extern "C" int tdc_pack_blocks(const void* values, const void* nbits, int B, long long nt,
                               int n_words, void* tile_bits, void* words, void* total_bits,
                               void* err, void* stream) {
  PackArgs a{};
  a.values = static_cast<const uint32_t*>(values);
  a.nbits = static_cast<const int32_t*>(nbits);
  a.nt = nt;
  a.n_words = n_words;
  a.n_tiles = n_tiles_for<false>(nt);
  a.tile_bits = static_cast<int32_t*>(tile_bits);
  a.words = static_cast<uint32_t*>(words);
  a.total_bits = static_cast<int32_t*>(total_bits);
  a.err = static_cast<int32_t*>(err);
  return launch<false>(a, B, static_cast<cudaStream_t>(stream));
}

// Kernel B. bytes [B, bs] u8, n_valid [B]; table_vals/table_bits rows of 256
// at a row stride of table_stride; the header: hdr_cols words a row at
// hdr_stride, hdr_bits at hdr_bits_stride (strides 0: one shared table and
// header for every row); words [B, n_words] (written whole, header
// included), scratch of B * T * 257 ints for the first pass (T = ceil(bs /
// TOKENS) tiles a row, TOKENS = Tile<true>::TOKENS, 8192: the tile totals
// [B, T], then each thread's widths [B, T, 256]), total_bits [B], err the
// mapped flag word.
extern "C" int tdc_pack_bytes_blocks(const void* bytes, const void* n_valid, const void* table_vals,
                                     const void* table_bits, long long table_stride, const void* hdr_words,
                                     long long hdr_stride, int hdr_cols, const void* hdr_bits,
                                     long long hdr_bits_stride, int B, long long bs, int n_words,
                                     void* scratch, void* words, void* total_bits, void* err,
                                     void* stream) {
  PackArgs a{};
  a.bytes = static_cast<const uint8_t*>(bytes);
  a.n_valid = static_cast<const int32_t*>(n_valid);
  a.table_vals = static_cast<const uint32_t*>(table_vals);
  a.table_bits = static_cast<const int32_t*>(table_bits);
  a.table_stride = table_stride;
  a.hdr_words = static_cast<const uint32_t*>(hdr_words);
  a.hdr_stride = hdr_stride;
  a.hdr_cols = hdr_cols;
  a.hdr_bits = static_cast<const int32_t*>(hdr_bits);
  a.hdr_bits_stride = hdr_bits_stride;
  a.nt = bs;
  a.n_words = n_words;
  a.n_tiles = n_tiles_for<true>(bs);
  a.tile_bits = static_cast<int32_t*>(scratch);
  a.thread_bits = a.tile_bits + (int64_t)B * a.n_tiles;
  a.words = static_cast<uint32_t*>(words);
  a.total_bits = static_cast<int32_t*>(total_bits);
  a.err = static_cast<int32_t*>(err);
  return launch<true>(a, B, static_cast<cudaStream_t>(stream));
}
