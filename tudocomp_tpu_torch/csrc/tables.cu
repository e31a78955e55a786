// Kernel C (huffman_tables): canonical Huffman tables from [B, 256] byte
// histograms, in two instances over the weight type: int32 for the
// per-block tables, int64 for the one table of the shared-table path; and
// kernel G (moffat_phase12): Moffat phases 1 and 2 on sorted int64 weights.
//
// Kernel C replaces tudocomp_tpu/ops/pallas_kernels.py:_huffman_tables_kernel
// and reproduces tudocomp_tpu/ops/huffman_jax.py _sort_hist, _phase12_xla,
// _phase3 and canonical_codes_batch exactly:
//   - symbols rank by the key (count << 9) | symbol, absent symbols last
//     (int32: the reference's wrapping i32 key; int64: the same order
//     without the wrap, for counts below 2^53);
//   - Moffat-Katajainen code lengths, phases 1 and 2 (ties prefer the
//     leaf), then leaf depths from the internal-depth histogram;
//   - blocks with sigma <= 1 get all-zero lengths, and sigma / longest are
//     re-derived from the masked lengths;
//   - canonical codes in (length, symbol) order (HuffmanCoder.hpp:192-218).
// The int64 instance also reports a code longer than MAX_LEN bits through
// the launch path's mapped flag word, with the true longest length in
// longest_out.
//
// Kernel G replaces tudocomp_tpu/ops/pallas_kernels.py:_moffat_lockstep_kernel
// (entry point moffat_phase12): phases 1 and 2 alone on [B, 256] sorted
// int64 weights; slots 0..sigma-2 come back holding internal-node depths,
// the others their weights; rows with sigma <= 1 come back unchanged.
//
// Design. One CTA of 256 threads per row, everything in shared memory. The
// bytes are nothing (a row reads 1-2 KiB and writes ~4 KiB), and so is the
// arithmetic; what bounds both kernels is phase 1, the two-queue merge:
// m - 2 steps of two picks, each step depending on the one before, on one
// thread. The TPU kernels stepped all rows in lockstep through one-hot
// lane selects; a port that walked Moffat's array in shared memory paid
// two or three dependent loads a pick (~120 cycles a step) and a serial
// phase 2 (~40 cycles a node). Here:
//   - phase 1 (moffat_chain) keeps the two heads of each queue in
//     registers and decides a step's two picks at once from them; the
//     pairs that may become heads next are loaded at the step's start, the
//     node just formed is forwarded into the heads, and the step is a few
//     dozen instructions that record only the node's weight, with no
//     predicated shared-memory access. What bounds it now is the step's
//     instructions and their chain of compares and selects (~55 cycles a
//     step for int32, ~100 for int64 on the H100), not memory;
//   - the merge takes the values in sorted order whatever the ties, so the
//     tie rule lives in phase 2: each internal node's parent is the step
//     that takes it, found from its weight by a binary search over the
//     leaves (a leaf before a node of equal weight), and the depths come
//     from pointer jumping over the parents across the CTA;
//   - kernel C ranks by a warp sort and binary searches, computes its
//     prefix sums (phase 3's leaf counts, the canonical num_shorter and
//     firstcode) as warp scans, and orders the codewords by (length,
//     symbol) with a warp match and per-warp counts, in place of two
//     256-step ranks and serial loops on one thread.
// Kernels C and G walk the phases through one template, so they agree by
// construction.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEN = 32;
constexpr int32_t BIG = 0x3FFFFFFF;
constexpr int SLOTS = 256 + 8;  // a queue's pairs, past its last entry the loads' reach

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

template <typename W>
struct Lim;
template <>
struct Lim<int32_t> {
  static constexpr int32_t INF = INT32_MAX;  // above every sum of a block's counts (< 2^31)
  using Pair = int2;
};
template <>
struct Lim<int64_t> {
  static constexpr int64_t INF = INT64_MAX;  // above every sum of counts below 2^53
  using Pair = longlong2;
};

// The shared memory of phases 1 and 2. A pair holds two neighbouring
// entries of a queue, so that one 8- or 16-byte access moves both.
template <typename W>
struct Chain {
  typename Lim<W>::Pair lq[SLOTS];  // (leaf j, leaf j + 1): the sorted weights, INF from sigma on
  typename Lim<W>::Pair iq[SLOTS];  // (node j, node j + 1): internal weights, INF until formed
  int32_t dp[2][256];
  int32_t pq[2][256];
};

template <typename W>
__device__ __forceinline__ W lesser(W a, W b) {
  return b < a ? b : a;
}

// Moffat phase 1 on one thread, m >= 2, from ch.lq (iq all INF): the
// internal nodes' weights, into ch.iq. Each step forms node t from two
// picks (ties prefer the leaf; a queue slot with no entry holds INF), both
// decided at once from the heads R0, R1 (internal nodes root, root + 1)
// and L0, L1 (leaves leaf, leaf + 1): the first takes the internal node if
// R0 < L0, the second compares R1 with L0 after an internal first pick and
// R0 with L1 after a leaf. The heads that may come next, the pairs (root +
// 2, root + 3) and (leaf + 2, leaf + 3), are loaded at the step's start,
// before the picks are known, so their latency overlaps the decision.
// Node t goes straight into the heads when it is one of them
// (forwarding), and into ch.iq as the pairs (t - 1, t) and (t, none yet)
// for a later load. One thread issues every instruction of the chain, so
// a step is kept to a few dozen and records nothing but node t's weight
// (internal_depth finds the parents from the weights); its shared-memory
// accesses are unconditional (a predicated one makes the compiler rebuild
// the shared window's address inside the loop).
template <typename W>
__device__ __forceinline__ void moffat_chain(Chain<W>& ch, int m) {
  using P = typename Lim<W>::Pair;
  constexpr W INF = Lim<W>::INF;
  const P l01 = ch.lq[0], l23 = ch.lq[2];
  W prev = l01.x + l01.y;    // node t - 1's weight
  W R0 = prev, R1 = INF;     // internal nodes root, root + 1
  W L0 = l23.x, L1 = l23.y;  // leaves leaf, leaf + 1
  int root = 0;              // leaf = 2 t - root
#pragma unroll 4  // the compiler interleaves the steps' independent work
  for (int t = 1; t < m - 1; ++t) {
    const P x = ch.iq[root + 2], y = ch.lq[2 * t - root + 2];
    const bool a = R0 < L0, b = R1 < L0, c = R0 < L1;
    const bool two = a && b;     // two internal nodes
    const bool none = !a && !c;  // two leaves
    const W w = two ? R0 + R1 : none ? L0 + L1 : R0 + L0;
    const W r0 = two ? x.x : none ? R0 : R1, r1 = two ? x.y : none ? R1 : x.x;
    L0 = none ? y.x : two ? L0 : L1;
    L1 = none ? y.y : two ? L1 : y.x;
    // forwarding: a formed node weighs at most w (internal weights never
    // fall), an unformed one is INF, and the new root is at most node t
    R0 = lesser(r0, w);
    R1 = r0 == INF ? INF : lesser(r1, w);
    root += two ? 2 : none ? 0 : 1;
    ch.iq[t - 1] = P{prev, w};
    ch.iq[t] = P{w, INF};
    prev = w;
  }
}

// Moffat phases 1 and 2, called by all 256 threads with a block-uniform
// m >= 2 and ch.lq, ch.iq as moffat_chain takes them; returns thread s's
// internal-node depth (s < m - 1; 0 for the others): each node's parent
// by a binary search over the leaves, then pointer jumping over the
// parents, ceil(log2(m - 1)) rounds of d += d[p], p = p[p], exact since
// every node's parent has a higher index.
template <typename W>
__device__ int internal_depth(Chain<W>& ch, int m) {
  const int s = threadIdx.x;
  if (s == 0) moffat_chain<W>(ch, m);
  __syncthreads();
  // the merge takes the items in weight order, a leaf before an internal
  // node of equal weight, two a step: node s is the (s + #{leaves <= its
  // weight})-th item taken, in step (that count) / 2, the step that forms
  // its parent
  int p = s, d = 0;
  if (s < m - 2) {
    const W ws = ch.iq[s].x;
    int lo = 0;  // leaves of weight <= ws, by halving over the 256 slots (INF past m)
#pragma unroll
    for (int half = 128; half > 0; half >>= 1) lo += ch.lq[lo + half - 1].x <= ws ? half : 0;
    p = (s + lo + (ch.lq[lo].x <= ws)) >> 1;
    d = 1;
  }
  int cur = 0;
  for (int span = 1; span < m - 1; span <<= 1) {  // depths < m - 1 <= 2^rounds
    ch.dp[cur][s] = d;
    ch.pq[cur][s] = p;
    __syncthreads();
    d += ch.dp[cur][p];
    p = ch.pq[cur][p];
    cur ^= 1;
  }
  return d;
}

__device__ __forceinline__ int32_t sort_key(int32_t h, int s) {  // wraps like the reference's i32
  return h > 0 ? (int32_t)(((uint32_t)h << 9) | (uint32_t)s) : (BIG | s);
}
__device__ __forceinline__ int64_t sort_key(int64_t h, int s) {
  return h > 0 ? ((h << 9) | s) : ((int64_t(1) << 62) | s);
}

// #{j : key[j] < k} over the CTA's 256 keys, called by all 256
// threads: each warp sorts its 32 keys (a bitonic network of shuffles)
// into sorted[], then every thread counts the keys below its own in each
// warp's run by eight independent binary searches.
template <typename W>
__device__ __forceinline__ int rank_of(W k, W* sorted, int lane, int warp) {
  W v = k;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const W o = __shfl_xor_sync(0xffffffffu, v, j);
      const bool keep_smaller = ((lane & j) == 0) == ((lane & size) == 0);
      v = keep_smaller == (o < v) ? o : v;
    }
  }
  sorted[warp * 32 + lane] = v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const W* run = sorted + 32 * w;
    int lo = 0;  // the run's keys below k, counted by halving: 16 + 8 + 4 + 2 + 1, then the last
#pragma unroll
    for (int half = 16; half > 0; half >>= 1) lo += run[lo + half - 1] < k ? half : 0;
    r += lo + (run[lo] < k);
  }
  return r;
}

template <typename W>
__global__ void __launch_bounds__(256)
huffman_tables_kernel(const W* hists, int32_t* lengths, int32_t* cw, int32_t* numl, int32_t* ordered_sym,
                      int32_t* sigma_out, int32_t* longest_out, int32_t* flag) {
  __shared__ W key[256];  // each warp's keys, sorted
  __shared__ Chain<W> ch;
  __shared__ int32_t depth[256];
  __shared__ int32_t osym[256];
  __shared__ int32_t nd[MAX_LEN + 1];
  __shared__ int32_t cum[MAX_LEN + 1];
  __shared__ int32_t s_numl[MAX_LEN];
  __shared__ int32_t firstcode[MAX_LEN];
  __shared__ int32_t num_shorter[MAX_LEN + 1];
  __shared__ int32_t wcnt[8 * (MAX_LEN + 2)];  // symbols of each length (1..33) in each warp
  __shared__ int32_t s_longest, s_deepest;

  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int lane = s & 31, warp = s >> 5;
  const W h = hists[(int64_t)b * 256 + s];
  const bool present = h > 0;
  const W k = sort_key(h, s);
  for (int i = s; i < SLOTS; i += 256) ch.lq[i] = ch.iq[i] = {Lim<W>::INF, Lim<W>::INF};
  if (s <= MAX_LEN) nd[s] = 0;
  if (s < MAX_LEN) s_numl[s] = 0;
  for (int i = s; i < 8 * (MAX_LEN + 2); i += 256) wcnt[i] = 0;
  if (s == 0) s_longest = s_deepest = 0;
  const int m = __syncthreads_count(present);
  const int rank = rank_of(k, key, lane, warp);
  if (present) {
    ch.lq[rank].x = h;
    if (rank > 0) ch.lq[rank - 1].y = h;
  }
  __syncthreads();

  // Moffat phases 1 and 2
  int idepth = MAX_LEN + 1;
  if (m >= 2) {
    const int d = internal_depth<W>(ch, m);
    if (s < m - 1) {
      idepth = min(d, MAX_LEN + 1);
      if (flag) atomicMax(&s_deepest, d + 1);
    }
  }

  // phase 3: internal nodes per depth -> leaves per depth -> depth per sorted position
  if (idepth <= MAX_LEN) atomicAdd(&nd[idepth], 1);
  __syncthreads();
  if (warp == 0) {  // cum[d] = sum over 1..d of 2 nd[e - 1] - nd[e]
    const int c = warp_inclusive_sum(2 * nd[lane] - nd[lane + 1], lane);
    cum[lane + 1] = c;
    if (lane == 0) cum[0] = 0;
  }
  __syncthreads();
  {
    const int rf = m - 1 - s;  // rank counted from the most frequent symbol
    int dpth = 0;
#pragma unroll
    for (int d = 0; d <= MAX_LEN; ++d) dpth += cum[d] <= rf;
    depth[s] = s < m ? dpth : 0;
  }
  __syncthreads();
  const int len = m >= 2 ? depth[rank] : 0;

  // canonical codes: sigma / longest from the masked lengths
  const int sigma_c = __syncthreads_count(len > 0);
  const int wmax = __reduce_max_sync(0xffffffffu, len);
  if (lane == 0 && wmax > 0) atomicMax(&s_longest, wmax);
  if (len >= 1 && len <= MAX_LEN) atomicAdd(&s_numl[len - 1], 1);
  // (length, symbol) order inside the warp: the lanes below with the same length
  const unsigned peers = __match_any_sync(0xffffffffu, len);
  const int within = __popc(peers & ((1u << lane) - 1));
  if (len > 0 && within == 0) wcnt[warp * (MAX_LEN + 2) + min(len, MAX_LEN + 1)] = __popc(peers);
  __syncthreads();
  const int longest = s_longest;
  if (warp == 0) {  // num_shorter[l] = numl[0] + ... + numl[l - 1]
    const int c = warp_inclusive_sum(s_numl[lane], lane);
    num_shorter[lane + 1] = c;
    if (lane == 0) num_shorter[0] = 0;
  } else if (warp == 1) {
    // firstcode[L - 1] = 0, firstcode[i - 1] = (firstcode[i] + numl[i]) >> 1 (L = longest, at most
    // MAX_LEN): firstcode[k] = (sum over j in k+1..L-1 of numl[j] << (L - 1 - j)) >> (L - 1 - k)
    const int L = min(longest, MAX_LEN);
    const int64_t u = lane < L ? (int64_t)s_numl[lane] << (L - 1 - lane) : 0;
    int64_t suffix = u;  // sum over j >= lane
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_down_sync(0xffffffffu, suffix, o);
      if (lane + o < 32) suffix += y;
    }
    const int64_t above = __shfl_down_sync(0xffffffffu, suffix, 1);  // sum over j > lane
    firstcode[lane] = lane < L - 1 ? (int32_t)(above >> (L - 1 - lane)) : 0;
  }
  __syncthreads();
  uint32_t code = 0;
  if (len > 0) {
    const int slot = min(len - 1, MAX_LEN);
    int before = within;
    for (int w = 0; w < warp; ++w) before += wcnt[w * (MAX_LEN + 2) + slot + 1];
    osym[num_shorter[slot] + before] = s;
    code = (uint32_t)((slot < MAX_LEN ? firstcode[slot] : 0) + before);
  }
  __syncthreads();

  const int64_t row = (int64_t)b * 256 + s;
  lengths[row] = len;
  cw[row] = (int32_t)code;
  ordered_sym[row] = s < sigma_c ? osym[s] : 0;
  if (s < MAX_LEN) numl[(int64_t)b * MAX_LEN + s] = s_numl[s];
  if (s == 0) {
    sigma_out[b] = sigma_c;
    const bool deep = flag && s_deepest > MAX_LEN;
    longest_out[b] = deep ? s_deepest : longest;
    if (deep) *flag = 1;
  }
}

__global__ void __launch_bounds__(256)
moffat_phase12_kernel(const int64_t* weights, const int32_t* sigma, int64_t* out) {
  constexpr int64_t INF = Lim<int64_t>::INF;
  __shared__ Chain<int64_t> ch;
  const int64_t row = (int64_t)blockIdx.x * 256;
  const int s = threadIdx.x;
  const int m = min(max(sigma[blockIdx.x], 0), 256);
  const int64_t w = weights[row + s];
  const int64_t leaf = s < m ? w : INF;
  ch.lq[s].x = leaf;
  ch.lq[s == 0 ? 255 : s - 1].y = s == 0 ? INF : leaf;
  ch.iq[s] = {INF, INF};
  if (s < SLOTS - 256) ch.lq[256 + s] = ch.iq[256 + s] = {INF, INF};
  __syncthreads();
  int64_t v = w;
  if (m >= 2) {
    const int d = internal_depth<int64_t>(ch, m);
    if (s < m - 1) v = d;
  }
  out[row + s] = v;
}

}  // namespace

// weights [B, 256] i64 (ascending over each row's first sigma slots),
// sigma [B] i32 (clamped to [0, 256]) -> out [B, 256] i64.
extern "C" int tdc_moffat_phase12(const void* weights, const void* sigma, int B, void* out,
                                  void* stream) {
  moffat_phase12_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(weights), static_cast<const int32_t*>(sigma),
      static_cast<int64_t*>(out));
  return (int)cudaGetLastError();
}

// hists [B, 256] i32 -> lengths, cw (u32 bit patterns), ordered_sym [B, 256],
// numl [B, 32], sigma [B], longest [B], all i32.
extern "C" int tdc_huffman_tables(const void* hists, int B, void* lengths, void* cw, void* numl,
                                  void* ordered_sym, void* sigma, void* longest, void* stream) {
  huffman_tables_kernel<int32_t><<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hists), static_cast<int32_t*>(lengths),
      static_cast<int32_t*>(cw), static_cast<int32_t*>(numl), static_cast<int32_t*>(ordered_sym),
      static_cast<int32_t*>(sigma), static_cast<int32_t*>(longest), nullptr);
  return (int)cudaGetLastError();
}

// hists [B, 256] i64 (counts below 2^53) -> the same i32 outputs; a row
// whose code needs more than 32 bits sets *flag (the mapped word) to 1 and
// its longest to that length.
extern "C" int tdc_huffman_tables64(const void* hists, int B, void* lengths, void* cw, void* numl,
                                    void* ordered_sym, void* sigma, void* longest, void* flag,
                                    void* stream) {
  huffman_tables_kernel<int64_t><<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(hists), static_cast<int32_t*>(lengths),
      static_cast<int32_t*>(cw), static_cast<int32_t*>(numl), static_cast<int32_t*>(ordered_sym),
      static_cast<int32_t*>(sigma), static_cast<int32_t*>(longest), static_cast<int32_t*>(flag));
  return (int)cudaGetLastError();
}
