// Kernels E (lz78_parse) and F (lzw_parse): the LZ78 and LZW trie parses of
// many independent blocks.
//
// Kernel E replaces tudocomp_tpu/ops/lz78_pallas.py:_lz78_kernel (128 blocks
// of at most 8 KiB in lockstep) and tudocomp_tpu/ops/lz78_bucket_pallas.py:
// _lz78_bucket_kernel (one block of at most 256 KiB per program). Both compute
// one function, the factors (parent node, char) of the host tdc_lz78_parse,
// the trailing partial factor included (LZ78Compressor.hpp:124-131): factor i
// creates node i + 1, so a block that ends inside node k > 0 re-emits factor
// k - 1. Kernel F replaces lz78_pallas.py:_lzw_kernel, the codes of the host
// tdc_lzw_parse: 256 implicit roots, a miss emits the current node, creates
// node 256 + nf and restarts at the missed byte; a non-empty block always
// emits its final node. Positions at or past n_valid[b] are never read.
//
// One design for both (parse_warp<LZW>): one warp parses one block, and its
// lanes probe the prefixes of the current phrase at once. The block's
// dictionary is an open-addressing table (linear probing) whose slots are
// keyed by a hash of the phrase's bytes, not of (parent, byte): the phrase
// starts at s, and lane k hashes its prefix of base + k + 1 bytes (E) or of
// base + k + 2 bytes (F, whose phrase starts at the root t[s], node id
// t[s]), base 0, 32, 64, ... while a phrase outgrows the warp, from the text
// alone, so the 32 probes of a round depend on no load of that round and
// are in flight together. The hash is polynomial: G(i) = G(i - 1) * P +
// t[i - 1] + 1 over the block's prefixes, kept in a ring in shared memory
// that the warp fills 128 bytes at a time with a shuffle scan (the next 128
// bytes' loads in flight meanwhile), so that hash(t[s .. s + L)) = G(s + L)
// - G(s) * P^L costs a lane one ring read. A slot is one 64-bit word,
// (parent id << 32) | (byte << 24) | child id, all ones when empty, so
// every hit is verified exactly: lane k holds its node when its slot's
// parent is lane k - 1's child (the phrase's node so far for lane 0) and
// its byte is the prefix's last. The warp resolves a round in registers
// with ballots and shuffles: the first lane f that fails either sees an
// empty slot, so its prefix is absent (its entry would lie before the first
// empty slot from its home) and it inserts the next node there, or sees
// another key and probes on; lanes whose slot is surely not theirs (another
// byte, or another parent where the lane before is verified) probe on with
// it. A __syncwarp orders each insert before the next round's loads. At an
// absent prefix E's factor ends at lane f's byte (its parent, the byte) and
// the next phrase starts after it; F emits lane f's parent, the node of the
// prefix before the byte, and the next phrase starts at the byte. No
// matched prefix is longer than the longest entry inserted so far, so lanes
// past that length plus one load nothing. The tables live in device memory,
// four blocks a CTA, sized by what a block's trie can hold, a power of two
// at most 55% full (ops/lz78_cuda.py): E's at z_max(bs) + 1 nodes (the most
// distinct non-empty phrases whose lengths sum to bs), 2^13 slots (64 KiB)
// a block of 8 KiB and 2^18 (2 MiB) one of 256 KiB; F's at lzw_z_max(bs) +
// 1 entries (distinct strings of 2 bytes or more whose lengths less one sum
// to bs - 1), 2^14 slots (128 KiB) a block of 8 KiB and 2^22 one of 4 MiB.
// A table of at most 2^BITMAP_LOG2 slots keeps an occupancy bit a slot in
// shared memory (2 KiB a warp at 2^14): a probe of an empty slot, which
// every lane past the phrase's end makes, reads the bit and not device
// memory, and the table is never filled (its empty words are never read).
// On English text in blocks of 8 KiB that halves the table loads a round
// (5.6 against 12.1 in the CPU emulation, tests/test_torch_lzw.py) and
// drops the wrapper's fill of 800 MiB (F) or 400 MiB (E) at [6400, 8192]:
// E 3.89-4.08 ms against 5.09-5.23 with no bitmap (chip_smoke.py --turns,
// same card; at [200, 262144], whose tables take no bitmap, 27.6-27.7
// against 27.9-28.0), F 4.08-4.50. Larger
// tables, whose batches hold few blocks, are filled with ones and every
// probe loads. (Tables in shared memory for blocks of at most 8 KiB, 64 KiB
// a warp and so three warps an SM, took 10.19 ms at [6400, 8192] against
// 4.70 ms in device memory on an NVIDIA H100 80GB HBM3 at 700 W, and were
// dropped.)
//
// Bound on the H100: a chain of dependent rounds per block, one a phrase
// and one more per probe collision on the verified path, each about one
// load's latency from device memory (the tables of a batch outgrow the 50
// MB L2), against one dependent load per input byte for a walk of the trie
// by (node, byte): 27,686 factors against 262,144 bytes in E's longest
// chain of 50 MiB of English text in blocks of 256 KiB. With many blocks the random
// 32-byte table reads of all warps together bound it as well: at [6400,
// 8192] E and F take 64 and 62 registers a thread, so an SM holds 8 CTAs
// and the 6400 warps run in two waves. Builds with __launch_bounds__ for
// 10, 12 and 16 CTAs an SM (48, 40, 32 registers) spill; on that card E
// got 10, 12 and 16 CTAs an SM and took 7.59, 8.29 and 11.03 ms against
// 3.70, the last in one wave, so for E one wave is not the lever. F got
// 10, 12 and 12 (its 9 KiB of rings and 8 KiB bitmap a CTA cap it at 12,
// 6336 blocks at once) and took 4.83, 7.42 and 9.44 against 4.03, never
// in one wave. So the bitmap cut the loads instead of the waves.
// tdc_parse_occupancy reports the registers and CTAs an SM; chip_smoke.py
// phase 6 prints them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;     // blocks per CTA, tables in device memory
constexpr int RING = 256;    // entries of a warp's hash and byte rings
constexpr int RMASK = RING - 1;
constexpr int CHUNK = 128;   // bytes a refill hashes: four a lane
constexpr unsigned long long SLOT_EMPTY = ~0ull;
constexpr unsigned long long P = 0x9E3779B97F4A7C15ull;    // odd: the hash's base
constexpr unsigned long long P4 = P * P * P * P;
constexpr unsigned long long MIX = 0xBF58476D1CE4E5B9ull;  // spreads a hash over the top bits

__device__ __forceinline__ unsigned long long ipow(unsigned long long b, unsigned e) {
  unsigned long long r = 1;
  for (; e; e >>= 1, b *= b)
    if (e & 1) r *= b;
  return r;
}

// Tables of at most 2^BITMAP_LOG2 slots (blocks of up to 16 KiB for F, 32
// KiB for E) keep an occupancy bit a slot in shared memory (4 KiB a warp at
// most): an empty slot is known from the bit, its word in device memory is
// neither read nor filled (ops/lz78_cuda.py leaves such tables unfilled).
constexpr int BITMAP_LOG2 = 15;

// 32-bit words of a warp's bitmap; 0: the table keeps none.
__host__ __device__ inline int bitmap_words(int log2_slots) {
  return log2_slots > BITMAP_LOG2 ? 0 : 1 << (log2_slots > 5 ? log2_slots - 5 : 0);
}

__host__ __device__ inline size_t bitmap_bytes(int log2_slots) {
  return (size_t)WARPS * bitmap_words(log2_slots) * sizeof(uint32_t);
}

// Warp `warp`'s bitmap, or null where the table keeps none.
__device__ __forceinline__ uint32_t* warp_bitmap(uint32_t* bitmaps, int warp, int log2_slots) {
  const int words = bitmap_words(log2_slots);
  return words ? bitmaps + warp * words : nullptr;
}

// Slot h, all ones where the bitmap (if any) says it is empty.
__device__ __forceinline__ unsigned long long load_slot(const unsigned long long* tab, const uint32_t* bits,
                                                        uint32_t h) {
  if (bits != nullptr && !((bits[h >> 5] >> (h & 31)) & 1u)) return SLOT_EMPTY;
  return tab[h];
}

// A warp's view of its block: G(i) at g[i & RMASK] for hi - RING < i <= hi,
// t[i] at c[i & RMASK] for hi - RING <= i < hi, and the bytes of the next
// chunk, t[hi + 4 lane + m] (0 past n), already requested.
struct Window {
  unsigned long long* g;
  uint8_t* c;
  int hi;
  unsigned long long g_hi;  // G(hi)
  uint32_t q[4];

  __device__ void fetch(const uint8_t* t, int n, int lane) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = hi + 4 * lane + m;
      q[m] = i < n ? __ldg(t + i) : 0u;
    }
  }

  // G and the bytes of [hi, hi + CHUNK) into the rings; p4l = P^(4 lane + 4).
  __device__ void refill(const uint8_t* t, int n, int lane, unsigned long long p4l) {
    unsigned long long x = 0;  // this lane's four bytes, as the hash of a string
#pragma unroll
    for (int m = 0; m < 4; ++m) x = x * P + (q[m] + 1);
    unsigned long long a = P4;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1, a *= a) {  // x = sum over lanes j <= lane of x_j P^(4 (lane - j))
      const unsigned long long y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y * a;
    }
    const unsigned long long end = g_hi * p4l + x;  // G(hi + 4 lane + 4)
    unsigned long long gi = __shfl_up_sync(FULL, end, 1);
    if (lane == 0) gi = g_hi;
    const int i0 = hi + 4 * lane;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      c[(i0 + m) & RMASK] = (uint8_t)q[m];
      gi = gi * P + (q[m] + 1);
      g[(i0 + m + 1) & RMASK] = gi;
    }
    g_hi = __shfl_sync(FULL, end, 31);
    hi += CHUNK;
    __syncwarp();
    fetch(t, n, lane);
  }
};

// One warp parses block b. LZW false (E): out [bs + 1] takes the factors'
// parents, chr their bytes. LZW true (F): out [bs] takes the codes, chr is
// null. tab: the block's 2^log2_slots slots, all ones.
template <bool LZW>
__device__ __forceinline__ void parse_warp(const uint8_t* t, int n, unsigned long long* tab, int log2_slots,
                                           int32_t* out, uint8_t* chr, int32_t* nf_out,
                                           unsigned long long* g_ring, uint8_t* c_ring, uint32_t* bits,
                                           int lane) {
  constexpr int OFF = LZW ? 1 : 0;                // lane k's byte: t[s + base + OFF + k]
  constexpr uint32_t FIRST_ID = LZW ? 256u : 1u;  // the first inserted node's id
  const uint32_t mask = (1u << log2_slots) - 1;
  const unsigned long long pk1 = ipow(P, lane + 1 + OFF), p4l = ipow(P, 4 * lane + 4), p32 = ipow(P, 32);

  Window w{g_ring, c_ring, 0, 0};
  if (bits != nullptr)  // the occupancy bitmap starts empty
    for (int j = lane; j < bitmap_words(log2_slots); j += 32) bits[j] = 0;
  if (lane == 0) w.g[0] = 0;  // G(0): the empty prefix
  w.fetch(t, n, lane);
  __syncwarp();

  uint32_t nf = 0;
  int maxlen = OFF;  // the longest entry in the table (F: entries have 2 bytes or more)
  int s = 0;         // the current phrase's start
  while (s < n) {
    uint32_t node = 0;  // the node of the phrase's first base + OFF bytes
    int base = 0;
    unsigned long long pw = pk1, gs = 0;  // P^(base + OFF + lane + 1), G(s)
    for (;;) {
      const int need = min(n, s + base + OFF + 32);
      while (w.hi < need) w.refill(t, n, lane, p4l);
      if (base == 0) {
        gs = w.g[s & RMASK];
        if (LZW) node = w.c[s & RMASK];  // the root t[s]
      }
      const int pos = s + base + OFF + lane;
      const bool valid = pos < n;
      const uint32_t c = valid ? w.c[pos & RMASK] : 0u;
      uint32_t h = 0;
      unsigned long long e = SLOT_EMPTY;
      if (valid && base + OFF + lane <= maxlen) {  // longer prefixes cannot be in the table
        unsigned long long x = w.g[(pos + 1) & RMASK] - gs * pw;
        x = (x ^ (x >> 29)) * MIX;
        h = (uint32_t)(x >> (64 - log2_slots));
        e = load_slot(tab, bits, h);
      }
      int f;  // the first lane whose prefix is not verified; 32: none
      uint32_t child, prev;
      for (;;) {
        child = (uint32_t)e & 0xFFFFFFu;
        prev = __shfl_up_sync(FULL, child, 1);
        if (lane == 0) prev = node;
        const bool full = e != SLOT_EMPTY;
        const bool byte_ok = ((uint32_t)(e >> 24) & 0xFFu) == c;
        const bool parent_ok = (uint32_t)(e >> 32) == prev;
        const uint32_t fail = __ballot_sync(FULL, valid && !(full && byte_ok && parent_ok));
        f = fail ? __ffs(fail) - 1 : 32;
        if (f == 32 || !__shfl_sync(FULL, (int)full, f)) break;
        // lane f sees another key: it and every lane before the first empty
        // slot whose key is surely not its own probe the next slot
        const uint32_t empty = __ballot_sync(FULL, valid && !full);
        const int g = empty ? __ffs(empty) - 1 : 32;
        if (lane < g && full && (!byte_ok || (lane <= f && !parent_ok))) {
          h = (h + 1) & mask;
          e = load_slot(tab, bits, h);
        }
      }
      if (f < 32) {  // prefix f is absent: E's factor ends at its byte, F's phrase before it
        if (lane == f) {
          tab[h] = ((unsigned long long)prev << 32) | ((unsigned long long)c << 24) | (FIRST_ID + nf);
          if (bits != nullptr) bits[h >> 5] |= 1u << (h & 31);
          out[nf] = (int32_t)prev;
          if (!LZW) chr[nf] = (uint8_t)c;
        }
        ++nf;
        maxlen = max(maxlen, base + OFF + f + 1);
        s += base + f + 1;
        __syncwarp();
        break;
      }
      const int nv = n - (s + base + OFF);  // lanes in the block, all verified
      const uint32_t last = __shfl_sync(FULL, child, min(max(nv - 1, 0), 31));
      if (nv >= 32) {  // the phrase goes on past this warp's 32 prefixes
        node = last;
        base += 32;
        pw *= p32;
        continue;
      }
      if (nv > 0) node = last;
      if (lane == 0) {
        if (LZW) {  // the final phrase
          out[nf] = (int32_t)node;
        } else {  // the block ends inside node: the trailing partial factor
          out[nf] = out[node - 1];
          chr[nf] = chr[node - 1];
        }
      }
      ++nf;
      s = n;
      break;
    }
  }
  if (lane == 0) *nf_out = (int32_t)nf;
}

// table + b * 2^log2_slots: block b's table (all ones).
__global__ void __launch_bounds__(WARPS * 32)
lz78_kernel(const uint8_t* text, long long bs, const int32_t* n_valid, int B,
            unsigned long long* table, int log2_slots, int32_t* parents, uint8_t* chars,
            int32_t* nf_out) {
  __shared__ unsigned long long g_ring[WARPS][RING];
  __shared__ uint8_t c_ring[WARPS][RING];
  extern __shared__ uint32_t bitmaps[];  // WARPS x 2^log2_slots bits where log2_slots <= BITMAP_LOG2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  parse_warp<false>(text + (long long)b * bs, n_valid[b], table + ((long long)b << log2_slots), log2_slots,
                    parents + (long long)b * (bs + 1), chars + (long long)b * (bs + 1), nf_out + b,
                    g_ring[warp], c_ring[warp], warp_bitmap(bitmaps, warp, log2_slots), lane);
}

__global__ void __launch_bounds__(WARPS * 32)
lzw_kernel(const uint8_t* text, long long bs, const int32_t* n_valid, int B,
           unsigned long long* table, int log2_slots, int32_t* codes, int32_t* nf_out) {
  __shared__ unsigned long long g_ring[WARPS][RING];
  __shared__ uint8_t c_ring[WARPS][RING];
  extern __shared__ uint32_t bitmaps[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  parse_warp<true>(text + (long long)b * bs, n_valid[b], table + ((long long)b << log2_slots), log2_slots,
                   codes + (long long)b * bs, nullptr, nf_out + b, g_ring[warp], c_ring[warp],
                   warp_bitmap(bitmaps, warp, log2_slots), lane);
}

}  // namespace

// text [B, bs] u8, n_valid [B] i32, table [B, 2^log2_slots] u64 (all ones) ->
// parents [B, bs + 1] i32, chars [B, bs + 1] u8 (factors from slot 0), nf [B] i32.
extern "C" int tdc_lz78_parse(const void* text, long long bs, const void* n_valid, int B,
                              void* table, int log2_slots, void* parents, void* chars, void* nf,
                              void* stream) {
  const int grid = (B + WARPS - 1) / WARPS;
  lz78_kernel<<<grid, WARPS * 32, bitmap_bytes(log2_slots), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), bs, static_cast<const int32_t*>(n_valid), B,
      static_cast<unsigned long long*>(table), log2_slots, static_cast<int32_t*>(parents),
      static_cast<uint8_t*>(chars), static_cast<int32_t*>(nf));
  return (int)cudaGetLastError();
}

// text [B, bs] u8, n_valid [B] i32, table [B, 2^log2_slots] u64 (all ones) ->
// codes [B, bs] i32 (from slot 0), nf [B] i32.
extern "C" int tdc_lzw_parse(const void* text, long long bs, const void* n_valid, int B,
                             void* table, int log2_slots, void* codes, void* nf, void* stream) {
  const int grid = (B + WARPS - 1) / WARPS;
  lzw_kernel<<<grid, WARPS * 32, bitmap_bytes(log2_slots), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), bs, static_cast<const int32_t*>(n_valid), B,
      static_cast<unsigned long long*>(table), log2_slots, static_cast<int32_t*>(codes),
      static_cast<int32_t*>(nf));
  return (int)cudaGetLastError();
}

// A host helper (launches nothing): the registers a thread of kernel E (lzw
// 0) or F (lzw 1) and the CTAs of WARPS blocks one SM holds at once; returns
// a CUDA error code.
template <typename K>
int occupancy(K kernel, size_t smem, int* regs, int* ctas_per_sm) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  if (rc != cudaSuccess) return (int)rc;
  *regs = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, WARPS * 32, smem);
}

extern "C" int tdc_parse_occupancy(int lzw, int log2_slots, int* regs, int* ctas_per_sm) {
  const size_t smem = bitmap_bytes(log2_slots);
  return lzw ? occupancy(lzw_kernel, smem, regs, ctas_per_sm) : occupancy(lz78_kernel, smem, regs, ctas_per_sm);
}
