// Kernel C (huffman_tables): per-block canonical Huffman tables from
// [B, 256] byte histograms; and kernel G (moffat_phase12): Moffat phases 1
// and 2 on sorted int64 weights, for the shared table.
//
// Replaces tudocomp_tpu/ops/pallas_kernels.py:_huffman_tables_kernel and
// reproduces tudocomp_tpu/ops/huffman_jax.py _sort_hist, _phase12_xla,
// _phase3 and canonical_codes_batch exactly:
//   - symbols rank by the key (count << 9) | symbol, absent symbols last;
//   - Moffat-Katajainen in-place code lengths, phases 1 and 2 (ties prefer
//     the leaf), then leaf depths from the internal-depth histogram;
//   - blocks with sigma <= 1 get all-zero lengths, and sigma / longest are
//     re-derived from the masked lengths;
//   - canonical codes in (length, symbol) order (HuffmanCoder.hpp:192-218).
//
// Design. One CTA of 256 threads per block, everything in shared memory.
// Ranks, depths and codewords are 256-wide and one thread per symbol
// computes them; the Moffat phases are a chain of ~2 * 254 dependent steps
// and run on one thread. Bound on the H100: latency of that chain (a few
// microseconds a block), not bandwidth: a block reads 1 KiB and writes
// ~4 KiB. The TPU kernel's lane rotations and one-hot selects stood in for
// gathers and scatters that shared memory gives directly.
//
// Kernel G replaces tudocomp_tpu/ops/pallas_kernels.py:_moffat_lockstep_kernel
// (entry point moffat_phase12): the same phases 1 and 2 on [B, 256] sorted
// weights, here int64, since the shared table sums the histograms of all
// blocks and its weights pass 2^31 once the input passes 2 GiB. Slots
// 0..sigma-2 come back holding internal-node depths; rows with sigma <= 1
// come back unchanged, as the TPU kernel leaves them. Design: one CTA per
// row, the row in shared memory (257 x 8 bytes), one thread walking the
// phases. Bound on the H100: the latency of the dependent chain of
// ~2 * 254 shared-memory steps (a few microseconds a row), not bytes
// (a row reads and writes 2 KiB); the shared path runs it on one row. The
// TPU kernel advanced all rows in lockstep through one-hot lane selects;
// here each row is its own CTA. Kernels C and G walk the phases through
// one function, moffat_phase12_row, instantiated per weight type, so
// kernel C's arithmetic is what it was.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEN = 32;
constexpr int32_t BIG = 0x3FFFFFFF;

// Moffat-Katajainen phases 1 and 2 (ties prefer the leaf) on A[0..m-1],
// sorted ascending, in place; A[m..256] must be readable (A[256] reads as
// an out-of-range one-hot read: 0). On return A[0..m-2] hold the internal
// nodes' depths. One thread: each step depends on the one before.
template <typename W>
__device__ void moffat_phase12_row(W* A, int m) {
  if (m < 2) return;
  A[0] = A[0] + A[1];
  int root = 0, leaf = 2;
  for (int t = 1; t < m - 1; ++t) {
    W a_root = A[root], a_leaf = A[leaf];
    W v1;
    if (leaf >= m || a_root < a_leaf) {
      v1 = a_root;
      A[root++] = t;
    } else {
      v1 = a_leaf;
      ++leaf;
    }
    A[t] = v1;
    a_root = A[root];
    a_leaf = A[leaf];
    W v2;
    if (leaf >= m || (root < t && a_root < a_leaf)) {
      v2 = a_root;
      A[root++] = t;
    } else {
      v2 = a_leaf;
      ++leaf;
    }
    A[t] = v1 + v2;
  }
  A[m - 2] = 0;
  for (int nxt = m - 3; nxt >= 0; --nxt) A[nxt] = A[(int)A[nxt]] + 1;
}

__global__ void __launch_bounds__(256)
huffman_tables_kernel(const int32_t* hists, int32_t* lengths, int32_t* cw, int32_t* numl,
                      int32_t* ordered_sym, int32_t* sigma_out, int32_t* longest_out) {
  __shared__ int32_t key[256];
  __shared__ int32_t A[257];  // Moffat's array; A[256] reads as 0 like an out-of-range one-hot read
  __shared__ int32_t depth[256];
  __shared__ int32_t nd[MAX_LEN + 1];
  __shared__ int32_t cum[MAX_LEN + 1];
  __shared__ int32_t s_numl[MAX_LEN];
  __shared__ int32_t firstcode[MAX_LEN];
  __shared__ int32_t num_shorter[MAX_LEN + 1];
  __shared__ int32_t osym[256];
  __shared__ int32_t s_longest;

  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int h = hists[(int64_t)b * 256 + s];
  const bool present = h > 0;

  // sort by (count, symbol); the key arithmetic wraps like the reference's i32
  const int32_t k = present ? (int32_t)(((uint32_t)h << 9) | (uint32_t)s) : (BIG | s);
  key[s] = k;
  A[s] = 0;
  if (s == 0) A[256] = 0;
  if (s <= MAX_LEN) nd[s] = 0;
  if (s < MAX_LEN) s_numl[s] = 0;
  osym[s] = 0;
  if (s == 0) s_longest = 0;
  const int m = __syncthreads_count(present);
  int rank = 0;
  for (int j = 0; j < 256; ++j) rank += key[j] < k;
  if (present) A[rank] = h;
  __syncthreads();

  // Moffat phases 1 and 2 (one thread: a dependent chain)
  if (s == 0) moffat_phase12_row<int32_t>(A, m);
  __syncthreads();

  // phase 3: internal nodes per depth -> leaves per depth -> depth per sorted position
  const int idepth = s < m - 1 ? min(A[s], MAX_LEN + 1) : MAX_LEN + 1;
  if (idepth <= MAX_LEN) atomicAdd(&nd[idepth], 1);
  __syncthreads();
  if (s == 0) {
    int run = 0;
    for (int d = 0; d <= MAX_LEN; ++d) {
      if (d > 0) run += 2 * nd[d - 1] - nd[d];
      cum[d] = run;
    }
  }
  __syncthreads();
  {
    const int rf = m - 1 - s;  // rank counted from the most frequent symbol
    int dp = 0;
    for (int d = 0; d <= MAX_LEN; ++d) dp += cum[d] <= rf;
    depth[s] = s < m ? dp : 0;
  }
  __syncthreads();
  const int len = m >= 2 ? depth[rank] : 0;

  // canonical codes: sigma / longest from the masked lengths
  const int sigma_c = __syncthreads_count(len > 0);
  if (len > 0) atomicMax(&s_longest, len);
  if (len >= 1 && len <= MAX_LEN) atomicAdd(&s_numl[len - 1], 1);
  __syncthreads();
  const int longest = s_longest;
  if (s == 0) {
    int fc = 0;
    firstcode[MAX_LEN - 1] = 0;
    for (int i = MAX_LEN - 1; i >= 1; --i) {
      fc = i < longest ? (fc + s_numl[i]) >> 1 : 0;
      firstcode[i - 1] = fc;
    }
    int acc = 0;
    for (int l = 0; l < MAX_LEN; ++l) {
      num_shorter[l] = acc;
      acc += s_numl[l];
    }
    num_shorter[MAX_LEN] = acc;
  }
  // order by (length, symbol), absent last
  const int32_t k2 = len > 0 ? (int32_t)(((uint32_t)len << 9) | (uint32_t)s) : 0x7FFF0000 + s;
  __syncthreads();
  key[s] = k2;
  __syncthreads();
  int rank2 = 0;
  for (int j = 0; j < 256; ++j) rank2 += key[j] < k2;
  uint32_t code = 0;
  if (len > 0) {
    osym[rank2] = s;
    const int slot = min(len - 1, MAX_LEN);
    const int fc = slot < MAX_LEN ? firstcode[slot] : 0;
    code = (uint32_t)(fc + (rank2 - num_shorter[slot]));
  }
  __syncthreads();

  const int64_t row = (int64_t)b * 256 + s;
  lengths[row] = len;
  cw[row] = (int32_t)code;
  ordered_sym[row] = s < sigma_c ? osym[s] : 0;
  if (s < MAX_LEN) numl[(int64_t)b * MAX_LEN + s] = s_numl[s];
  if (s == 0) {
    sigma_out[b] = sigma_c;
    longest_out[b] = longest;
  }
}

__global__ void __launch_bounds__(256)
moffat_phase12_kernel(const int64_t* weights, const int32_t* sigma, int64_t* out) {
  __shared__ int64_t A[257];
  const int64_t row = (int64_t)blockIdx.x * 256;
  const int s = threadIdx.x;
  A[s] = weights[row + s];
  if (s == 0) A[256] = 0;
  __syncthreads();
  if (s == 0) moffat_phase12_row<int64_t>(A, min(max(sigma[blockIdx.x], 0), 256));
  __syncthreads();
  out[row + s] = A[s];
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
  huffman_tables_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hists), static_cast<int32_t*>(lengths),
      static_cast<int32_t*>(cw), static_cast<int32_t*>(numl), static_cast<int32_t*>(ordered_sym),
      static_cast<int32_t*>(sigma), static_cast<int32_t*>(longest));
  return (int)cudaGetLastError();
}
