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
// node 256 + nf and restarts at the byte; a non-empty block always emits its
// final node. Positions at or past n_valid[b] are never read.
//
// E's design: one warp parses one block, and its lanes probe the prefixes of
// the current phrase at once. The block's dictionary is an open-addressing
// table (linear probing) whose slots are keyed by a hash of the phrase's
// bytes, not of (parent, byte): lane k hashes t[s .. s + base + k] (s the
// phrase's start, base 0, 32, 64, ... while a phrase outgrows the warp)
// from the text alone, so the 32 probes of a round depend on no load of
// that round and are in flight together. The hash is polynomial:
// G(i) = G(i - 1) * P + t[i - 1] + 1 over the block's prefixes, kept in a
// ring in shared memory that the warp fills 128 bytes at a time with a
// shuffle scan (the next 128 bytes' loads in flight meanwhile), so that
// hash(t[s .. s + L)) = G(s + L) - G(s) * P^L costs a lane one ring read.
// A slot is one 64-bit word, (parent id << 32) | (byte << 24) | child id,
// all ones when empty, so every hit is verified exactly: lane k holds its
// node when its slot's parent is lane k - 1's child (the phrase's node so
// far for lane 0) and its byte is t[s + base + k]. The warp resolves a round
// in registers with ballots and shuffles: the first lane that fails either
// sees an empty slot, so its prefix is absent (its entry would lie before
// the first empty slot from its home) and it inserts node nf + 1 there and
// the phrase ends at its byte, or sees another key and probes on; lanes
// whose slot is surely not theirs (another byte, or another parent where
// the lane before is verified) probe on with it. A __syncwarp orders each
// insert before the next round's loads. No phrase is longer than the
// longest phrase inserted so far plus one, so lanes past that length load
// nothing. The table holds at most z_max(bs) nodes (the most distinct
// non-empty phrases whose lengths sum to bs: all 256 of one byte, then all
// of two bytes, and so on), and the wrapper sizes it to a power of two at
// most 55% full at z_max + 1 entries (ops/lz78_cuda.py:table_log2):
// 2^18 slots (2 MiB) a block of 256 KiB, 2^13 (64 KiB) a block of 8 KiB.
// The tables live in device memory, four blocks a CTA. (Tables in shared
// memory for blocks of at most 8 KiB, 64 KiB a warp and so three warps an
// SM, took 10.19 ms at [6400, 8192] against 4.70 ms in device memory on an
// NVIDIA H100 80GB HBM3 at 700 W, and were dropped.)
//
// Bound on the H100: a chain of dependent rounds per block, one a factor
// and one more per probe collision on the verified path, each about one
// load's latency from device memory (the tables of a batch outgrow the
// 50 MB L2), against the old design's one load per input byte: 27,686
// factors against 262,144 bytes in the longest chain of 50 MiB of English
// text in blocks of 256 KiB. Blocks of 8 KiB are 6400 warps, more than the
// card holds at once at 64 registers a thread.
//
// Kernel F keeps the first design: one thread parses one block, a chain of
// dependent probes of a table keyed by (node << 8) | byte in device memory
// (a slot: the key in its low half, the child in its high half; 0xFFFFFFFF
// the empty key), at least half empty, one load per input byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;  // F: blocks per CTA, a thread each
constexpr uint32_t EMPTY = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xffffffffu;

struct Dict {
  unsigned long long* slots;
  int shift;      // 32 - log2(slot count)
  uint32_t mask;  // slot count - 1

  // The child stored under `key`; where there is none, inserts `new_id`
  // under it and sets *miss.
  __device__ uint32_t find_or_insert(uint32_t key, uint32_t new_id, bool* miss) const {
    uint32_t h = (key * 0x9E3779B1u) >> shift;
    for (;;) {
      const unsigned long long e = slots[h];
      const uint32_t k = (uint32_t)e;
      if (k == key) {
        *miss = false;
        return (uint32_t)(e >> 32);
      }
      if (k == EMPTY) {
        slots[h] = ((unsigned long long)new_id << 32) | key;
        *miss = true;
        return new_id;
      }
      h = (h + 1) & mask;
    }
  }
};

__device__ Dict block_dict(unsigned long long* table, int b, int log2_slots) {
  const long long slots = 1LL << log2_slots;
  return Dict{table + (long long)b * slots, 32 - log2_slots, (uint32_t)(slots - 1)};
}

__global__ void __launch_bounds__(THREADS)
lzw_kernel(const uint8_t* text, long long bs, const int32_t* n_valid, int B,
           unsigned long long* table, int log2_slots, int32_t* codes, int32_t* nf_out) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  const Dict d = block_dict(table, b, log2_slots);
  const uint8_t* t = text + (long long)b * bs;
  int32_t* out = codes + (long long)b * bs;
  const int n = n_valid[b];
  uint32_t nf = 0;
  if (n > 0) {
    uint32_t node = t[0];
    for (int i = 1; i < n; ++i) {
      const uint32_t c = t[i];
      bool miss;
      const uint32_t child = d.find_or_insert((node << 8) | c, 256 + nf, &miss);
      if (miss) {
        out[nf++] = (int32_t)node;
        node = c;
      } else {
        node = child;
      }
    }
    out[nf++] = (int32_t)node;  // the final phrase
  }
  nf_out[b] = (int32_t)nf;
}

// ---- kernel E --------------------------------------------------------------

constexpr int E_WARPS = 4;   // blocks per CTA, tables in device memory
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

// table + b * 2^log2_slots: block b's table (all ones).
__global__ void __launch_bounds__(E_WARPS * 32)
lz78_kernel(const uint8_t* text, long long bs, const int32_t* n_valid, int B,
            unsigned long long* table, int log2_slots, int32_t* parents, uint8_t* chars,
            int32_t* nf_out) {
  __shared__ unsigned long long g_ring[E_WARPS][RING];
  __shared__ uint8_t c_ring[E_WARPS][RING];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * E_WARPS + warp;
  if (b >= B) return;
  const uint32_t mask = (1u << log2_slots) - 1;
  unsigned long long* tab = table + (long long)b * (mask + 1);
  const uint8_t* t = text + (long long)b * bs;
  int32_t* par = parents + (long long)b * (bs + 1);
  uint8_t* chr = chars + (long long)b * (bs + 1);
  const int n = n_valid[b];
  const unsigned long long pk1 = ipow(P, lane + 1), p4l = ipow(P, 4 * lane + 4), p32 = ipow(P, 32);

  Window w{g_ring[warp], c_ring[warp], 0, 0};
  if (lane == 0) w.g[0] = 0;  // G(0): the empty prefix
  w.fetch(t, n, lane);
  __syncwarp();

  uint32_t nf = 0;
  int maxlen = 0;  // the longest phrase in the table
  int s = 0;       // the current phrase's start
  while (s < n) {
    uint32_t node = 0;  // the node of t[s .. s + base)
    int base = 0;
    unsigned long long pw = pk1, gs = 0;  // P^(base + lane + 1), G(s)
    for (;;) {
      const int need = min(n, s + base + 32);
      while (w.hi < need) w.refill(t, n, lane, p4l);
      if (base == 0) gs = w.g[s & RMASK];
      const int pos = s + base + lane;
      const bool valid = pos < n;
      const uint32_t c = valid ? w.c[pos & RMASK] : 0u;
      uint32_t h = 0;
      unsigned long long e = SLOT_EMPTY;
      if (valid && base + lane <= maxlen) {  // longer prefixes cannot be in the table
        unsigned long long x = w.g[(pos + 1) & RMASK] - gs * pw;
        x = (x ^ (x >> 29)) * MIX;
        h = (uint32_t)(x >> (64 - log2_slots));
        e = tab[h];
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
          e = tab[h];
        }
      }
      if (f < 32) {  // prefix f is absent: the factor ends at its byte
        if (lane == f) {
          tab[h] = ((unsigned long long)prev << 32) | ((unsigned long long)c << 24) | (nf + 1);
          par[nf] = (int32_t)prev;
          chr[nf] = (uint8_t)c;
        }
        ++nf;
        maxlen = max(maxlen, base + f + 1);
        s += base + f + 1;
        __syncwarp();
        break;
      }
      const int nv = n - (s + base);  // lanes in the block, all verified
      const uint32_t last = __shfl_sync(FULL, child, min(max(nv - 1, 0), 31));
      if (nv >= 32) {  // the phrase goes on past this warp's 32 prefixes
        node = last;
        base += 32;
        pw *= p32;
        continue;
      }
      if (nv > 0) node = last;
      if (lane == 0) {  // the block ends inside node: the trailing partial factor
        par[nf] = par[node - 1];
        chr[nf] = chr[node - 1];
      }
      ++nf;
      s = n;
      break;
    }
  }
  if (lane == 0) nf_out[b] = (int32_t)nf;
}

}  // namespace

// text [B, bs] u8, n_valid [B] i32, table [B, 2^log2_slots] u64 (all ones) ->
// parents [B, bs + 1] i32, chars [B, bs + 1] u8 (factors from slot 0), nf [B] i32.
extern "C" int tdc_lz78_parse(const void* text, long long bs, const void* n_valid, int B,
                              void* table, int log2_slots, void* parents, void* chars, void* nf,
                              void* stream) {
  const int grid = (B + E_WARPS - 1) / E_WARPS;
  lz78_kernel<<<grid, E_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), bs, static_cast<const int32_t*>(n_valid), B,
      static_cast<unsigned long long*>(table), log2_slots, static_cast<int32_t*>(parents),
      static_cast<uint8_t*>(chars), static_cast<int32_t*>(nf));
  return (int)cudaGetLastError();
}

// text [B, bs] u8, n_valid [B] i32, table [B, 2^log2_slots] u64 (all ones) ->
// codes [B, bs] i32 (from slot 0), nf [B] i32.
extern "C" int tdc_lzw_parse(const void* text, long long bs, const void* n_valid, int B,
                             void* table, int log2_slots, void* codes, void* nf, void* stream) {
  const int grid = (B + THREADS - 1) / THREADS;
  lzw_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), bs, static_cast<const int32_t*>(n_valid), B,
      static_cast<unsigned long long*>(table), log2_slots, static_cast<int32_t*>(codes),
      static_cast<int32_t*>(nf));
  return (int)cudaGetLastError();
}
