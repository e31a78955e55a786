// Kernel H (plcp_segments): the permuted LCP array by Kärkkäinen's
// phi-algorithm, from the suffix array, one chain of positions per lane, in
// levels.
//
// The port's own kernel: it replaces no Pallas kernel. The JAX package's
// tudocomp_tpu/ops/plcp_jax.py:plcp_device walks S segments in lockstep under
// one XLA while_loop, a word compare per lane and step; in PyTorch that loop
// is thousands of steps of a dozen small launches each
// (ops/plcp_torch.py:plcp_device_plain).
//
// One entry point runs the whole function: phi_kernel writes phi[sa[i]] =
// sa[i - 1] (phi[sa[0]] = sa[n - 1]) from the int32 SA and plcp[n - 1] = 0,
// then the levels run, coarsest first. The sequential algorithm (reference
// ds/PLCPFromPhi.hpp:38-44) starts plcp[i] from plcp[i - 1] - 1, so a walk's
// compares telescope to its length plus the LCP of its first position; more
// generally plcp[i + s] >= plcp[i] - s for any stride s. Level k takes the
// positions that are multiples of its stride s_k in chains of F_k of them,
// each chain starting from the value the level above (stride s_k * F_k) left
// at its first position. The top level's few positions (at most TOP) start
// from 0. That is what keeps one letter or a period of 1000,
// where LCPs are of the text's order, from quadratic work.
//
// One chain per lane: a warp runs 32 independent chains, so a latency-bound
// walk has 32 chains in flight a warp. F_k is chosen from the positions of
// the level: the chains of every level fill the card's 132 x 2048 thread
// slots where the level has that many positions over 4, and no chain is
// longer than 32 dependent positions, so no level is a long tail of a few
// warps. A warp stages phi and plcp through shared memory, so that at
// stride 1 both move as coalesced rows. A lane compares 8, 16 and 8 bytes,
// 32 in all: aligned 8-byte loads joined by shifts, the first differing
// byte from the XOR's lowest set bit (little-endian words). A lane whose
// position needs more asks its warp for help: the warp then
// compares 2 KiB a step for that one position, each lane a coalesced word
// of each of 8 rows.
//
// Two kernels follow phi. Level 0 (stride 1, most of the work) runs
// across the card in plcp_level_kernel. Everything above it is one launch,
// plcp_upper_kernel: a block of 8 warps a top position, which computes that
// position from 0 (16 KiB a step) and then, level by level with a barrier
// between, the chains of its subtree [b * top, (b + 1) * top) down to level
// 1; no block waits on another. So a small text (a 256 KiB block) pays
// three launches, not one a level.
//
// phi is a random scatter, 4 bytes to a random place of an array of 4n
// bytes; past the L2 cache's 50 MB each write costs a DRAM sector. So
// phi_kernel runs in passes over the SA, each writing only the entries of
// one region of phi of at most 16 MiB, which the L2 holds.
//
// Bound on the H100: the SA, phi and plcp cross the memory bus once or twice
// (4 bytes a position each) and the text once; what limits it is the random
// scatter of phi and the random reads of the text at phi, one or two 32-byte
// sectors a position, and on few positions the chain of dependent loads
// each lane walks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int64_t TOP = 256;                // positions of the top level, at most
constexpr int64_t SLOTS = 132 * 2048;       // thread slots of an H100 SXM
constexpr int MIN_CHAIN = 4, MAX_CHAIN = 32;
constexpr int64_t PHI_REGION = 1 << 22;     // phi entries a pass of phi_kernel writes, at most (16 MiB)
constexpr int WARPS = 4;                    // warps a block of level 0's kernel
constexpr int UPPER_WARPS = 8;              // warps a block of the upper levels' kernel: a top position each
constexpr int MAX_LEVELS = 40;

struct Text {
  const uint64_t* w;  // the text as little-endian 8-byte words (8-byte aligned)
  int64_t n;
  int64_t last;       // index of the last word holding a text byte
};

__device__ __forceinline__ uint64_t word(const Text& t, int64_t q) { return q <= t.last ? __ldg(t.w + q) : 0; }

// Bytes equal from a and from b, at most 8 * W, none at or past n: W + 1
// aligned 8-byte loads a suffix, all issued before any compare, each window
// of 8 bytes joined by a shift, the first differing byte from the XOR's
// lowest set bit (little-endian words).
template <int W>
__device__ __forceinline__ int match(const Text& t, int64_t a, int64_t b) {
  const int64_t lim = t.n - (a > b ? a : b);
  if (lim <= 0) return 0;
  const int sa = (int)(a & 7) * 8, sb = (int)(b & 7) * 8;
  uint64_t wa[W + 1], wb[W + 1];
#pragma unroll
  for (int q = 0; q <= W; ++q) {
    wa[q] = q < W || sa ? word(t, (a >> 3) + q) : 0;
    wb[q] = q < W || sb ? word(t, (b >> 3) + q) : 0;
  }
  int m = 8 * W;
#pragma unroll
  for (int q = W - 1; q >= 0; --q) {
    const uint64_t x = (sa ? (wa[q] >> sa) | (wa[q + 1] << (64 - sa)) : wa[q]) ^
                       (sb ? (wb[q] >> sb) | (wb[q + 1] << (64 - sb)) : wb[q]);
    if (x) m = 8 * q + ((__ffsll((long long)x) - 1) >> 3);
  }
  return lim < m ? (int)lim : m;
}

// Bytes equal from a and from b among the next SPAN (SPAN: all of them),
// none at or past n, the warp comparing them at once: in row q lane j holds
// the aligned words 32q + j past a's and b's first, so each load is one
// coalesced 256-byte row, and a lane's window is its word joined with lane
// j + 1's (lane 31's with the next row's first). All 16 loads are issued
// before any compare. Every lane returns the count.
constexpr int SPAN = 8 * 256;

__device__ int64_t warp_match_span(const Text& t, int64_t a, int64_t b, int lane) {
  const int sa = (int)(a & 7) * 8, sb = (int)(b & 7) * 8;
  const int64_t qa = a >> 3, qb = b >> 3;
  const int64_t lim = t.n - (a > b ? a : b);  // bytes that can match
  uint64_t wa[9], wb[9];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    wa[q] = word(t, qa + 32 * q + lane);
    wb[q] = word(t, qb + 32 * q + lane);
  }
  wa[8] = lane == 31 ? word(t, qa + 256) : 0;
  wb[8] = lane == 31 ? word(t, qb + 256) : 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint64_t da = __shfl_down_sync(FULL, wa[q], 1), db = __shfl_down_sync(FULL, wb[q], 1);
    const uint64_t ra = q < 7 ? __shfl_sync(FULL, wa[q + 1], 0) : wa[8];
    const uint64_t rb = q < 7 ? __shfl_sync(FULL, wb[q + 1], 0) : wb[8];
    const uint64_t ha = lane == 31 ? ra : da, hb = lane == 31 ? rb : db;
    const uint64_t x = (sa ? (wa[q] >> sa) | (ha << (64 - sa)) : wa[q]) ^
                       (sb ? (wb[q] >> sb) | (hb << (64 - sb)) : wb[q]);
    const int at = (32 * q + lane) * 8;  // this lane's window starts `at` bytes past a
    const unsigned miss = __ballot_sync(FULL, x != 0 || at + 8 > lim);
    if (miss) {
      const int first = __ffs(miss) - 1;
      const uint64_t fx = __shfl_sync(FULL, x, first);
      const int64_t m = (32 * q + first) * 8 + (fx ? (__ffsll((long long)fx) - 1) >> 3 : 8);
      return m < lim ? m : (lim > 0 ? lim : 0);
    }
  }
  return SPAN;
}

// The LCP of the suffixes at a and b, by the warp; every lane returns it.
__device__ int64_t warp_match(const Text& t, int64_t a, int64_t b, int lane) {
  for (int64_t off = 0;; off += SPAN) {
    const int64_t m = warp_match_span(t, a + off, b + off, lane);
    if (m < SPAN) return off + m;
  }
}

// phi[sa[i]] = sa[i - 1] (phi[sa[0]] = sa[n - 1]) for the entries in [lo, hi)
// of phi: a pass writes a region that the L2 cache holds, so its random
// 4-byte writes merge there instead of each costing a sector in DRAM.
__global__ void phi_kernel(const int32_t* __restrict__ sa, int64_t n, int64_t lo, int64_t hi,
                           int32_t* __restrict__ phi, int32_t* __restrict__ plcp) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t d = sa[i];
  if (d >= lo && d < hi) phi[d] = sa[i ? i - 1 : n - 1];
  if (i == n - 1 && lo == 0) plcp[i] = 0;
}

// Chains c0 .. c0 + 31 of a level, the warp's, lane j walking chain c0 + j
// (chains at or past c_end are another warp's): the positions k * stride
// < n - 1 (k < count) with k in [c * chain, (c + 1) * chain). The first of
// them holds its value already. The warp stages phi and plcp through shared
// memory 32 positions of each of its chains at a time, so that at stride 1
// both move as coalesced rows.
__device__ void walk_chains(const Text& t, const int32_t* __restrict__ phi, int64_t stride, int64_t count,
                            int chain, int64_t c0, int64_t c_end, int32_t (*tile)[33], int lane,
                            int32_t* __restrict__ plcp) {
  const int64_t first = c0 * chain;  // the warp's first position
  if (first >= count || c0 >= c_end) return;
  const int chains = c_end - c0 < 32 ? (int)(c_end - c0) : 32;
  const int64_t k0 = (c0 + lane) * chain;
  const bool mine = lane < chains && k0 < count;
  int64_t l = mine ? plcp[k0 * stride] : 0;
  for (int j0 = 1; j0 < chain; j0 += 32) {
    const int rows = chain - j0 < 32 ? chain - j0 : 32;
    for (int r = 0; r < chains; ++r) {  // chain r's positions j0 .. j0 + rows - 1, a lane each
      const int64_t k = first + (int64_t)r * chain + j0 + lane;
      tile[r][lane] = lane < rows && k < count ? phi[k * stride] : 0;
    }
    __syncwarp();
    for (int jj = 0; jj < rows; ++jj) {
      const int64_t k = k0 + j0 + jj;
      const bool on = mine && k < count;
      const int64_t i = k * stride;
      const int64_t p = tile[lane][jj];
      l = l > stride ? l - stride : 0;
      // 32 bytes in three steps of 8, 16 and 8: most positions end in the
      // first; one needing 9-24 bytes waits on two round trips
      bool done = !on;
      if (!done) {
        const int m = match<1>(t, i + l, p + l);
        l += m;
        done = m < 8;
      }
      if (!done) {
        const int m = match<2>(t, i + l, p + l);
        l += m;
        done = m < 16;
      }
      if (!done) {
        const int m = match<1>(t, i + l, p + l);
        l += m;
        done = m < 8;
      }
      for (unsigned need = __ballot_sync(FULL, !done); need; need &= need - 1) {
        const int src = __ffs(need) - 1;
        const int64_t a = __shfl_sync(FULL, i + l, src), b = __shfl_sync(FULL, p + l, src);
        const int64_t ext = warp_match(t, a, b, lane);
        if (lane == src) l += ext;
      }
      tile[lane][jj] = (int32_t)l;
    }
    __syncwarp();
    for (int r = 0; r < chains; ++r) {
      const int64_t k = first + (int64_t)r * chain + j0 + lane;
      if (lane < rows && k < count) plcp[k * stride] = tile[r][lane];
    }
    __syncwarp();
  }
}

__host__ __device__ int64_t positions(int64_t n, int64_t stride) { return (n - 1 + stride - 1) / stride; }

struct Levels {
  int64_t stride[MAX_LEVELS];
  int chain[MAX_LEVELS];
  int count;
};

// Block b: the top level's position b * top, from l = 0, its warps comparing
// UPPER_WARPS spans side by side a step; then, level by level down to level
// 1, the chains of [b * top, (b + 1) * top), the top position's subtree, a
// barrier between levels. No block waits on another.
__global__ void __launch_bounds__(UPPER_WARPS * 32)
plcp_upper_kernel(Text t, const int32_t* __restrict__ phi, Levels lv, int64_t top, int32_t* __restrict__ plcp) {
  __shared__ int32_t tiles[UPPER_WARPS][32][33];
  __shared__ int64_t s_m[UPPER_WARPS];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t i = blockIdx.x * top, p = phi[i];
  for (int64_t off = 0;; off += UPPER_WARPS * SPAN) {
    const int64_t m = warp_match_span(t, i + off + w * SPAN, p + off + w * SPAN, lane);
    if (lane == 0) s_m[w] = m;
    __syncthreads();
    int64_t l = -1;
    for (int v = 0; v < UPPER_WARPS && l < 0; ++v)
      if (s_m[v] < SPAN) l = off + v * SPAN + s_m[v];
    __syncthreads();
    if (l >= 0) {
      if (threadIdx.x == 0) plcp[i] = (int32_t)l;
      break;
    }
  }
  __syncthreads();
  for (int k = lv.count - 1; k >= 1; --k) {
    const int64_t stride = lv.stride[k], per = top / (stride * lv.chain[k]);  // chains a subtree
    const int64_t c_lo = blockIdx.x * per, c_hi = c_lo + per;
    for (int64_t c0 = c_lo + 32 * w; c0 < c_hi; c0 += 32 * UPPER_WARPS)
      walk_chains(t, phi, stride, positions(t.n, stride), lv.chain[k], c0, c_hi, tiles[w], lane, plcp);
    __syncthreads();
  }
}

// Level 0 (stride 1) over the whole text: lane c of the grid walks chain c.
__global__ void __launch_bounds__(WARPS * 32)
plcp_level_kernel(Text t, const int32_t* __restrict__ phi, int64_t count, int chain, int32_t* __restrict__ plcp) {
  __shared__ int32_t tiles[WARPS][32][33];
  const int lane = threadIdx.x & 31;
  const int64_t c0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x - lane;
  walk_chains(t, phi, 1, count, chain, c0, INT64_MAX, tiles[threadIdx.x >> 5], lane, plcp);
}

}  // namespace

// text [n] u8 (8-byte aligned), sa [n] i32 -> phi [n] i32 (scratch), plcp
// [n] i32 (every entry written). seg > 1: chains of seg positions at every
// level; 0: chosen per level from its positions (the main path's choice).
extern "C" int tdc_plcp_segments(const void* text, const void* sa, long long n, int seg,
                                 void* phi, void* plcp, void* stream) {
  if (n <= 0) return 0;
  if (seg == 1 || seg < 0 || (reinterpret_cast<uintptr_t>(text) & 7)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* phi_c = static_cast<const int32_t*>(phi);
  int32_t* out = static_cast<int32_t*>(plcp);
  const int64_t passes = (n + PHI_REGION - 1) / PHI_REGION, region = (n + passes - 1) / passes;
  for (int64_t lo = 0; lo < n; lo += region)
    phi_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(static_cast<const int32_t*>(sa), n, lo, lo + region,
                                                            static_cast<int32_t*>(phi), out);
  if (n > 1) {
    Levels lv;
    lv.count = 0;
    int64_t s = 1;
    while (positions(n, s) > TOP && lv.count < MAX_LEVELS) {
      int f = seg;
      if (!f) {
        const int64_t want = positions(n, s) / SLOTS;
        f = (int)(want < MIN_CHAIN ? MIN_CHAIN : (want > MAX_CHAIN ? MAX_CHAIN : want));
      }
      lv.stride[lv.count] = s;
      lv.chain[lv.count++] = f;
      s *= f;
    }
    const Text t{static_cast<const uint64_t*>(text), n, (n - 1) >> 3};
    plcp_upper_kernel<<<(unsigned)positions(n, s), UPPER_WARPS * 32, 0, st>>>(t, phi_c, lv, s, out);
    if (lv.count) {
      const int64_t lanes = (positions(n, 1) + lv.chain[0] - 1) / lv.chain[0];
      const int threads = WARPS * 32;
      plcp_level_kernel<<<(unsigned)((lanes + threads - 1) / threads), threads, 0, st>>>(
          t, phi_c, positions(n, 1), lv.chain[0], out);
    }
  }
  return (int)cudaGetLastError();
}
