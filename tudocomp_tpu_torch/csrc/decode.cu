// Kernel D (decode_payloads): canonical Huffman decode of many independent
// encode(huff) streams.
//
// Replaces tudocomp_tpu/ops/huffman_decode_pallas.py:_bitserial_kernel and
// the _pack_kernel compaction that followed it. The rule is the bit-serial
// one of huffman_decode_pallas.py:143-166: a code of length l is complete
// when its value acc >= fc[l]; its symbol is syms[clamp(acc + adj[l], 0,
// 255)]. Bits at or past a stream's total_bits are not live: a code they
// would finish is dropped, as in the lockstep kernel. Degenerate streams
// arrive as the length-8 identity code (fc[8] = 0). A stream needing more
// than 32 bits for a code is rejected: its count comes back as -1.
//
// Design: one CTA per stream, one thread per chunk of its bits, after
// Weissenberger & Schmidt, "Massively Parallel Huffman Decoding on GPUs"
// (ICPP 2018). The CTA first builds a 2^K-entry table in shared memory
// that maps the next K bits to (length, symbol); codes longer than K bits
// finish with the fc walk from length K + 1. A thread keeps a 64-bit bit
// buffer in registers, refilled a 32-bit word at a time. Then:
//   1. every thread decodes its chunk from the chunk's first bit,
//      speculatively, and records the first code boundary at or past the
//      chunk's end (its exit) and its code count;
//   2. in rounds, thread t restarts from thread t - 1's exit when that
//      moved. It walks the new start and its previous start side by side
//      (whichever cursor is behind steps); once both stand on one bit the
//      rest of the chunk decodes as before, so the count is corrected and
//      the exit kept. Only a moved exit makes the next chunk move in the
//      next round; the rounds end when nothing moved (at most the chunk
//      count: after round r chunks 0..r are exact);
//   3. a block-wide exclusive scan of the counts gives each chunk's offset;
//   4. every thread decodes its chunk again and writes its bytes, 16 at a
//      time where they are aligned (a warp's byte stores would each touch 32
//      sectors).
// Traps. Codes whose lengths share a factor g (all 8 bits: the degenerate
// identity code, a uniform histogram) never synchronise from a start off
// that grid, so speculative starts are rounded up to a multiple of g; a
// fixed-length code then starts every chunk on a true boundary and needs
// no round. A speculative decode may meet a false "invalid" code or run
// into the stream's tail: it publishes the next chunk's speculative start
// as its exit (so the next chunk does not move), and only the first chunk
// flagged invalid after synchronisation decides count -1 (its successors
// write nothing).
// Bound on the H100: the chain of table lookups a thread walks (about
// (codes a chunk) x (phases) shared-memory round trips), the word loads of
// its refills and its stores; the card is filled by n CTAs of up to 1024
// threads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 11;            // table index bits: 2^K entries of (length << 8 | symbol)
constexpr int MAX_T = 1024;      // threads (chunks) a stream at most
constexpr int CHUNK_BITS = 512;  // bits a chunk at least, when the launch picks the thread count
constexpr int NL = 33;           // table slots for code lengths 0..32

struct Cursor {
  uint64_t buf;  // the next nb bits of the stream from the MSB down
  int nb;
  long long wi;  // the next word to load
};

struct Stream {
  const uint32_t* w;
  long long W;
  int tb;
  const uint16_t* tab;
  const int32_t* fc;
  const int32_t* adj;
  const uint8_t* sy;
};

__device__ __forceinline__ uint32_t word(const Stream& s, long long i) { return i < s.W ? s.w[i] : 0u; }

__device__ __forceinline__ void seek(const Stream& s, Cursor& c, int p) {
  const long long wi = p >> 5;
  const uint64_t two = ((uint64_t)word(s, wi) << 32) | word(s, wi + 1);
  c.buf = two << (p & 31);
  c.nb = 64 - (p & 31);
  c.wi = wi + 2;
}

// The code at bit p: its length (> 0) and symbol; 0 where it is not live
// (the stream's dropped tail); -1 where no code of 32 bits or fewer
// completes and 32 live bits remain.
__device__ __forceinline__ int next_code(const Stream& s, Cursor& c, int p, int& sym) {
  if (c.nb < 32) {
    c.buf |= (uint64_t)word(s, c.wi++) << (32 - c.nb);
    c.nb += 32;
  }
  const int avail = s.tb - p;
  const uint16_t e = s.tab[c.buf >> (64 - K)];
  int l = e >> 8;
  if (l) {
    sym = e & 0xff;
  } else {
    long long code = 0;
    for (l = K + 1; l <= 32; ++l) {
      code = (long long)(c.buf >> (64 - l));
      if (code >= s.fc[l]) break;
    }
    if (l > 32) return avail >= 32 ? -1 : 0;
    long long r = code + s.adj[l];
    r = r < 0 ? 0 : (r > 255 ? 255 : r);
    sym = s.sy[r];
  }
  if (l > avail) return 0;
  c.buf <<= l;
  c.nb -= l;
  return l;
}

// A chunk's record: the exit its successor starts from, its codes, and
// whether its decode stopped at an invalid code.
struct Record {
  int exit, n;
  bool bad;
};

// Decode the chunk [start, end) from `start`; when `old_live`, the previous
// decode from `old_start` gave `old` and the two walks are merged where they
// meet. `next` is the successor's speculative start.
__device__ Record decode_chunk(const Stream& s, int start, int end, int next, bool old_live,
                               int old_start, Record old) {
  Cursor a, b;
  int pn = start, po = old_start, cn = 0, co = 0, sym;
  seek(s, b, pn);
  old_live = old_live && po < end;
  if (old_live) seek(s, a, po);
  for (;;) {
    if (pn >= end) return {pn, cn, false};
    if (old_live && po == pn) return {old.exit, old.n - co + cn, old.bad};
    if (old_live && po < pn) {
      const int l = next_code(s, a, po, sym);
      po += l > 0 ? l : 0;
      co += 1;
      old_live = l > 0 && po < end;
    } else {
      const int l = next_code(s, b, pn, sym);
      if (l == 0) return {s.tb, cn, false};  // the tail is dropped: the stream ends here
      if (l < 0) return {next, cn, true};
      pn += l;
      cn += 1;
    }
  }
}

__global__ void __launch_bounds__(MAX_T)
decode_kernel(const uint32_t* words, long long W, const int32_t* total_bits, const int32_t* fc,
              const int32_t* adj, const uint8_t* syms, uint8_t* out, long long max_out,
              long long* counts, int32_t* rounds_out) {
  __shared__ uint16_t s_tab[1 << K];
  __shared__ int32_t s_fc[NL];
  __shared__ int32_t s_adj[NL];
  __shared__ uint8_t s_sym[256];
  __shared__ int s_exit[MAX_T];
  __shared__ int s_warp[MAX_T / 32];
  __shared__ int s_first_bad;

  const int i = blockIdx.x;
  const int c = threadIdx.x;
  const int T = blockDim.x;
  for (int j = c; j < NL; j += T) {
    s_fc[j] = fc[(int64_t)i * NL + j];
    s_adj[j] = adj[(int64_t)i * NL + j];
  }
  for (int j = c; j < 256; j += T) s_sym[j] = syms[(int64_t)i * 256 + j];
  if (c == 0) s_first_bad = T;
  __syncthreads();
  for (int v = c; v < (1 << K); v += T) {
    uint16_t e = 0;
    for (int l = 1; l <= K; ++l) {
      const long long code = v >> (K - l);
      if (code >= s_fc[l]) {
        long long r = code + s_adj[l];
        r = r < 0 ? 0 : (r > 255 ? 255 : r);
        e = (uint16_t)((l << 8) | s_sym[r]);
        break;
      }
    }
    s_tab[v] = e;
  }
  // g: the gcd of the code lengths in use. The l-bit prefixes still open
  // after length l - 1 are [0, open); those >= fc[l] complete at l.
  int g = 0;
  long long open = 1;
  for (int l = 1; l <= 32 && open > 0; ++l) {
    const long long f = s_fc[l];
    if (f < 2 * open) {
      int a = g, b = l;
      while (b) {
        const int t = a % b;
        a = b;
        b = t;
      }
      g = a;
    }
    open = f < 2 * open ? f : 2 * open;
  }
  g = g ? g : 1;
  __syncthreads();

  const Stream s{words + (int64_t)i * W, W, total_bits[i], s_tab, s_fc, s_adj, s_sym};
  const int tb = s.tb;
  int L = (int)(((long long)tb + T - 1) / T);
  L = L < 32 ? 32 : (L + 31) & ~31;
  auto spec = [&](int k) -> int {  // chunk k's speculative start
    const long long lo = (long long)k * L, a = (lo + g - 1) / g * g;
    return (int)(a < tb ? a : tb);
  };
  const int end = (int)((long long)(c + 1) * L < tb ? (long long)(c + 1) * L : tb);
  const int next = spec(c + 1);

  // 1. speculative decode from the chunk's own start
  int start = c == 0 ? 0 : spec(c);
  Record rec = decode_chunk(s, start, end, next, false, 0, Record{0, 0, false});
  s_exit[c] = rec.exit;
  __syncthreads();

  // 2. synchronisation rounds
  int rounds = 0;
  for (;;) {
    const int want = c == 0 ? 0 : s_exit[c - 1];
    const bool moved = want != start;
    __syncthreads();  // every read of s_exit before any write
    if (moved) {
      rec = decode_chunk(s, want, end, next, true, start, rec);
      start = want;
      s_exit[c] = rec.exit;
    }
    if (!__syncthreads_or(moved)) break;
    if (++rounds >= T) break;
  }

  // 3. offsets: an exclusive scan of the counts up to the first invalid chunk
  if (rec.bad) atomicMin(&s_first_bad, c);
  __syncthreads();
  const int first_bad = s_first_bad;
  const int n = c <= first_bad ? rec.n : 0;
  const int lane = c & 31, warp = c >> 5;
  int incl = n;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < T / 32 ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    if (lane < T / 32) s_warp[lane] = v;  // inclusive over warps
  }
  __syncthreads();
  const long long off = (long long)(warp ? s_warp[warp - 1] : 0) + incl - n;
  if (c == T - 1) {
    counts[i] = first_bad < T ? -1 : (long long)s_warp[T / 32 - 1];
    if (rounds_out) rounds_out[i] = rounds;
  }

  // 4. decode again and write bytes [off, stop) of the row: single bytes up
  // to a 16-byte bound, then 16 bytes a store, then the tail
  uint8_t* o = out + (int64_t)i * max_out;
  const long long stop = off + n < max_out ? off + n : max_out;
  Cursor cur;
  seek(s, cur, start);
  int p = start, sym;
  long long q = off;
  for (; q < stop && (reinterpret_cast<uintptr_t>(o + q) & 15); ++q) {
    p += next_code(s, cur, p, sym);
    o[q] = (uint8_t)sym;
  }
  for (; q + 16 <= stop; q += 16) {
    uint64_t lo = 0, hi = 0;
    for (int k = 0; k < 16; ++k) {
      p += next_code(s, cur, p, sym);
      const uint64_t b = (uint64_t)sym << (8 * (k & 7));
      if (k < 8)
        lo |= b;
      else
        hi |= b;
    }
    *reinterpret_cast<uint4*>(o + q) = make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
  }
  for (; q < stop; ++q) {
    p += next_code(s, cur, p, sym);
    o[q] = (uint8_t)sym;
  }
}

}  // namespace

// words [n, W] u32 (each stream's symbol bits from bit 0, MSB-first),
// total_bits [n] i32, fc / adj [n, 33] i32, syms [n, 256] u8 ->
// out [n, max_out] u8 (zeroed by the caller), counts [n] i64 (-1: invalid
// stream), rounds [n] i32 (the synchronisation rounds each stream took;
// may be null).
extern "C" int tdc_decode_payloads(const void* words, long long W, const void* total_bits,
                                   const void* fc, const void* adj, const void* syms, int n,
                                   void* out, long long max_out, void* counts, void* rounds,
                                   void* stream) {
  if (n <= 0) return 0;
  int threads = 32;
  while (threads < MAX_T && (long long)threads * 2 * CHUNK_BITS <= W * 32) threads *= 2;
  decode_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), W, static_cast<const int32_t*>(total_bits),
      static_cast<const int32_t*>(fc), static_cast<const int32_t*>(adj),
      static_cast<const uint8_t*>(syms), static_cast<uint8_t*>(out), max_out,
      static_cast<long long*>(counts), static_cast<int32_t*>(rounds));
  return (int)cudaGetLastError();
}
