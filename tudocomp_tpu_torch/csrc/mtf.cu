// Kernel J (mtf_encode): the move-to-front encode, [n] u8 -> [n] u8 ranks,
// every chunk of the input walked at once, a warp a chunk.
//
// The port's own kernel: it replaces no Pallas kernel. The JAX package's
// tudocomp_tpu/ops/transforms.py:23 (mtf_encode_device) is plain JAX, a
// lax.scan over chunks of 4096 bytes carrying the [256] recency state, with
// O(n * 256) work; in PyTorch that is ~15 launches a chunk, and the host's
// table walk (tdc_mtf_encode: a search and a memmove a byte) is the
// function to beat. The plain version is ops/transforms_torch.py:
// mtf_encode_plain.
//
// It rests on MTF's closed form (tudocomp_tpu/ops/mtf.py:1-14): the table
// at any position is fixed by the last occurrence of each symbol before it,
// the seen symbols first, the most recent first, then the unseen symbols in
// byte order. So each chunk starts from its own entry table, and all chunks
// run at once, in three launches on one stream:
//   J1 mtf_last_kernel   a CTA a chunk: each symbol's last position in the
//                        chunk, [C, 256] int32 (-1: absent), by a shared
//                        atomicMax that one lane of each group of equal
//                        bytes in a warp issues (__match_any_sync);
//   J2 mtf_entry_kernel  J1's rows made their exclusive running max over
//                        the chunks, in place: each symbol's last position
//                        before each chunk. A CTA per 32 symbols, a warp per
//                        segment of chunks: the segments' maxima, then each
//                        segment's scan from the maxima before it;
//   J3 mtf_walk_kernel   a warp a chunk. Its entry table: each symbol's
//                        rank from sort keys in shared memory (seen
//                        symbols by their last position, latest first,
//                        then the unseen by value), counted by each lane
//                        for its 8 symbols. The table lives in registers,
//                        8 bytes a lane (position 8 * lane + j in byte j).
//                        A step: every lane compares its 8 bytes with the
//                        byte (__vcmpeq4), one warp reduction
//                        (__reduce_min_sync, redux.sync) gives the rank
//                        to every lane at once, where a ballot and an
//                        __ffs would name the lane and a shuffle would
//                        still have to broadcast the byte's place in it;
//                        then a __shfl_up_sync brings each lane its left
//                        neighbour's last byte and the entries up to the
//                        rank shift one place, the byte going to the
//                        front. The chunk is staged in shared memory and
//                        its ranks written back over it, then stored.
//
// Bound on the H100: n bytes read and n written (0.010 ms at 16 MiB over
// 3.35 TB/s), beside the [C, 256] int32 scratch that J1 writes and J2
// rewrites (1 KiB a chunk: 4 MiB at 16 MiB in chunks of 4096). What limits
// the kernel is the chain of `chunk` dependent steps a warp, each a shared
// load, the compares, a warp reduction and a shuffle: the input's size
// over the chunk sets how many chains run side by side.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SIGMA = 256;
constexpr int WALK_WARPS = 4;   // chunks a CTA of J3
constexpr int SCAN_SEGS = 32;   // J2: segments of chunks a CTA, a warp each
constexpr int KEY_BYTES = SIGMA * 4;
constexpr int TAB_BYTES = SIGMA;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int chunk_len(int64_t n, int64_t base, int chunk) {
  const int64_t rem = n - base;
  return rem < chunk ? (int)rem : chunk;
}

// J1: grid C, SIGMA threads.
__global__ void mtf_last_kernel(const uint8_t* __restrict__ in, int64_t n, int chunk,
                                int32_t* __restrict__ last) {
  __shared__ int32_t s_last[SIGMA];
  const int64_t base = (int64_t)blockIdx.x * chunk;
  const int len = chunk_len(n, base, chunk);
  const int lane = threadIdx.x & 31;
  s_last[threadIdx.x] = -1;
  __syncthreads();
  for (int i0 = 0; i0 < len; i0 += SIGMA) {
    const int i = i0 + (int)threadIdx.x;
    const unsigned live = __ballot_sync(FULL, i < len);
    if (i < len) {
      const int c = in[base + i];
      // the lanes holding c: the highest holds its latest position
      const unsigned peers = __match_any_sync(live, c);
      if (lane == 31 - __clz(peers)) atomicMax(&s_last[c], (int32_t)(base + i));
    }
  }
  __syncthreads();
  last[(int64_t)blockIdx.x * SIGMA + threadIdx.x] = s_last[threadIdx.x];
}

// J2: grid SIGMA / 32, 32 * SCAN_SEGS threads; in place.
__global__ void mtf_entry_kernel(int32_t* __restrict__ last, int n_chunks) {
  __shared__ int32_t seg_max[SCAN_SEGS][32];
  const int lane = threadIdx.x & 31, seg = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + lane;
  const int per = (n_chunks + SCAN_SEGS - 1) / SCAN_SEGS;
  const int c0 = seg * per;
  const int c1 = min(n_chunks, c0 + per);
  int32_t m = -1;
#pragma unroll 8
  for (int c = c0; c < c1; ++c) m = max(m, last[(int64_t)c * SIGMA + s]);
  seg_max[seg][lane] = m;
  __syncthreads();
  int32_t run = -1;
  for (int k = 0; k < seg; ++k) run = max(run, seg_max[k][lane]);
  for (int c = c0; c < c1; ++c) {
    const int64_t at = (int64_t)c * SIGMA + s;
    const int32_t v = last[at];
    last[at] = run;
    run = max(run, v);
  }
}

// J3: grid ceil(C / WALK_WARPS), 32 * WALK_WARPS threads,
// WALK_WARPS * (KEY_BYTES + TAB_BYTES + chunk) bytes of dynamic shared memory.
__global__ void mtf_walk_kernel(const uint8_t* __restrict__ in, int64_t n, int chunk, int n_chunks,
                                const int32_t* __restrict__ entry, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WALK_WARPS + warp;
  if (c >= n_chunks) return;  // the warp's chunk: no CTA-wide barrier below
  unsigned char* mine = smem + (size_t)warp * (KEY_BYTES + TAB_BYTES + chunk);
  uint32_t* keys = reinterpret_cast<uint32_t*>(mine);
  uint8_t* tab = mine + KEY_BYTES;
  uint8_t* buf = tab + TAB_BYTES;
  const int64_t base = (int64_t)c * chunk;
  const int len = chunk_len(n, base, chunk);

  for (int s = lane; s < SIGMA; s += 32) {
    const int32_t e = entry[(int64_t)c * SIGMA + s];
    keys[s] = e >= 0 ? 0x7FFFFFFFu - (uint32_t)e : 0x80000000u + (uint32_t)s;
  }
  for (int i = lane; i < len; i += 32) buf[i] = in[base + i];
  __syncwarp();
  // the entry table: a symbol's rank is the count of smaller keys
  const int lane8 = lane * 8;
  uint32_t k[8];
  int r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    k[j] = keys[lane8 + j];
    r[j] = 0;
  }
  for (int t = 0; t < SIGMA; ++t) {
    const uint32_t kt = keys[t];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] += kt < k[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) tab[r[j]] = (uint8_t)(lane8 + j);
  __syncwarp();
  uint32_t lo = reinterpret_cast<const uint32_t*>(tab)[2 * lane];
  uint32_t hi = reinterpret_cast<const uint32_t*>(tab)[2 * lane + 1];

  for (int i = 0; i < len; ++i) {
    const uint32_t ch = buf[i];
    const uint32_t c4 = ch * 0x01010101u;
    const uint32_t mlo = __vcmpeq4(lo, c4), mhi = __vcmpeq4(hi, c4);
    uint32_t cand = SIGMA;
    if (mlo) {
      cand = lane8 + ((__ffs(mlo) - 1) >> 3);
    } else if (mhi) {
      cand = lane8 + 4 + ((__ffs(mhi) - 1) >> 3);
    }
    const uint32_t rank = __reduce_min_sync(FULL, cand);
    uint32_t cin = __shfl_up_sync(FULL, hi >> 24, 1);
    if (lane == 0) cin = ch;
    // positions lane8 .. lane8 + take - 1 are <= rank: they take the entry
    // one place below (the byte itself at position 0)
    const int take = min(max((int)rank - lane8 + 1, 0), 8);
    const uint32_t take_lo = take >= 4 ? FULL : (1u << (8 * take)) - 1u;
    const uint32_t take_hi = take >= 8 ? FULL : take <= 4 ? 0u : (1u << (8 * (take - 4))) - 1u;
    const uint32_t slo = (lo << 8) | cin, shi = (hi << 8) | (lo >> 24);
    lo = (slo & take_lo) | (lo & ~take_lo);
    hi = (shi & take_hi) | (hi & ~take_hi);
    if (lane == 0) buf[i] = (uint8_t)rank;  // every lane has read buf[i]: the reduction waited for them
  }
  __syncwarp();
  for (int i = lane; i < len; i += 32) out[base + i] = buf[i];
}

}  // namespace

// in: u8 [n]; out: u8 [n]; last: int32 [ceil(n / chunk), 256], scratch;
// chunk: a multiple of 128 in [128, 8192]; n < 2^31.
extern "C" int tdc_mtf_encode_chunks(const void* in, long long n, void* out, void* last, int chunk,
                                     void* stream) {
  if (n < 0 || n >= (1LL << 31) || chunk < 128 || chunk > 8192 || chunk % 128 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int n_chunks = (int)((n + chunk - 1) / chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* src = static_cast<const uint8_t*>(in);
  int32_t* scratch = static_cast<int32_t*>(last);
  mtf_last_kernel<<<n_chunks, SIGMA, 0, s>>>(src, n, chunk, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mtf_entry_kernel<<<SIGMA / 32, 32 * SCAN_SEGS, 0, s>>>(scratch, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned walk_blocks = (unsigned)((n_chunks + WALK_WARPS - 1) / WALK_WARPS);
  const size_t smem = (size_t)WALK_WARPS * (KEY_BYTES + TAB_BYTES + chunk);
  mtf_walk_kernel<<<walk_blocks, 32 * WALK_WARPS, smem, s>>>(src, n, chunk, n_chunks, scratch,
                                                              static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
