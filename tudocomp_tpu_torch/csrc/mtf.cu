// Kernel J (mtf_encode): the move-to-front encode, [n] u8 -> [n] u8 ranks,
// every chunk of the input walked at once, a warp a chunk and a thread a
// sub-chunk of it.
//
// What it replaces: tudocomp_tpu/ops/transforms.py:23 (mtf_encode_device)
// is plain JAX, no Pallas kernel: a lax.scan over chunks of 4096 bytes
// carrying the [256] recency state, O(n * 256) work. In PyTorch that is ~15
// launches a chunk, and the host's table walk (tdc_mtf_encode: a search and
// a memmove a byte) is the function to beat. The plain version is
// ops/transforms_torch.py:mtf_encode_plain.
//
// It rests on MTF's closed form (tudocomp_tpu/ops/mtf.py:1-14): the table
// at any position is fixed by the last occurrence of each symbol before it,
// the seen symbols first, the most recent first, then the unseen symbols in
// byte order. So every chunk starts from its own entry table, and all
// chunks run at once, in three launches on one stream:
//   J1 mtf_last_kernel     a CTA a chunk: each symbol's last position in the
//                          chunk, [C, 256] int32 (-1: absent), by a shared
//                          atomicMax that one lane of each group of equal
//                          bytes in a warp issues (__match_any_sync);
//   J2 mtf_entry_kernel    J1's rows made their exclusive running max over
//                          the chunks, in place: each symbol's last position
//                          before each chunk. A CTA per 32 symbols, a warp
//                          per segment of chunks: the segments' maxima, then
//                          each segment's scan from the maxima before it;
//   J3 mtf_walkers_kernel  a CTA of one warp a chunk, its 32 lanes 32
//                          walkers, each walking a sub-chunk of chunk / 32
//                          bytes from its own entry table (below).
//
// What bounds it on the H100: the function moves n bytes in and n out
// (0.010 ms at 16 MiB over 3.35 TB/s); the [C, 256] int32 scratch that J1
// writes and J2 rewrites is 1 KiB a chunk beside it. The walk is a chain of
// dependent steps a byte, so what bounds the kernel is the instructions the
// warps issue for every byte: a table spread over a warp's lanes would
// advance one byte a warp step, ~30 instructions of table upkeep on 31
// lanes for each byte whatever its rank. Here a warp step advances 32
// bytes, one a walker, and costs what the warp's largest rank of the step
// needs (~14 instructions a word of 4 table bytes, a group of 4 words for
// every 16 ranks), so a byte costs a few instructions on text and all 16
// groups on uniform bytes; building the 32 walkers' tables costs a warp
// pass each, which the sub-chunk of chunk / 32 bytes amortises.
//
// J3, a warp a chunk of `chunk` bytes (sub = chunk / 32 a walker):
//   1. stage the chunk in shared memory, walker t's sub-chunk at word
//      t * stride (stride = sub / 4, made odd: the 32 walkers' words lie in
//      32 banks);
//   2. each walker lists its sub-chunk's distinct symbols by their last
//      occurrence, latest first (D_t), walking its sub-chunk backwards with
//      a 256-bit seen set of its own in shared memory;
//   3. the chunk's entry table E: its 256 sort keys (seen symbols by their
//      entry position from J2, latest first, then the unseen by value)
//      sorted by a bitonic network across the warp, 8 keys a lane, which
//      leaves lane l holding table positions 8l .. 8l + 7;
//   4. walker 0 starts from E; walker t + 1 from MTF's table after sub-chunk
//      t, which the closed form gives as D_t followed by walker t's table
//      without D_t's symbols: one warp pass a walker (D_t to the front, the
//      rest placed in order behind it by the counts of the lanes below,
//      four ballots), the table staged in shared memory for walker t + 1 to
//      load into its registers;
//   5. each walker walks its sub-chunk with its table in 64 registers
//      (mtf_step): the byte's word found from the front by a SWAR zero-byte
//      test, the words in front of it shifted one byte by funnel shifts, the
//      byte put at the front, 4 words a group without a branch, the warp
//      stopping after the group in which its last walker found its byte;
//      the ranks written over the staged bytes, 4 a word;
//   6. the chunk stored, coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SIGMA = 256;
constexpr int SCAN_SEGS = 32;  // J2: segments of chunks a CTA, a warp each
constexpr int TAB_WORDS = SIGMA / 4;
constexpr int WALKERS = 32;    // J3: sub-chunks a chunk, a lane each
constexpr int STAGE_BATCH = 4; // J3: words a lane loads at once when it stages its chunk
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int chunk_len(int64_t n, int64_t base, int chunk) {
  const int64_t rem = n - base;
  return rem < chunk ? (int)rem : chunk;
}

// J3's dynamic shared memory, in 32-bit words: the staged chunk, two
// tables, the walkers' seen sets, their lists D_t (one byte a symbol, word
// w of walker t at w * 32 + t), the flags of D_t's symbols, the list lengths
__host__ __device__ constexpr int walk_stride(int chunk) { return (chunk / 128) | 1; }
__host__ __device__ constexpr int walk_smem_words(int chunk) {
  return WALKERS * walk_stride(chunk) + 2 * TAB_WORDS + 8 * WALKERS + chunk / 4 + SIGMA / 4 + WALKERS;
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

// One MTF step of every walker of the warp: ch's rank in the walker's table
// w (byte p of the table in byte p % 4 of word p / 4) and the table
// updated: each word searched for ch by a SWAR zero-byte test on
// word ^ (ch * 0x01010101), shifted one byte by a funnel shift from the
// word before it while ch is not yet found, ch put at the front. The words
// go 4 at a time, a template a group so that every index into w is a
// constant and the table stays in registers; no lane branches inside a
// group, and the warp stops after the group in which its last lane found
// its byte. In a group, `move` marks the bits that shift (all of a word
// before ch's, ch's byte and those below it in ch's word, none after), and
// its popcount over the step is 8 (rank + 1).
template <int G>
__device__ __forceinline__ void mtf_group(uint32_t (&w)[TAB_WORDS], uint32_t c4, uint32_t& prev, uint32_t& alive,
                                          uint32_t& moved) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t cur = w[4 * G + i];
    const uint32_t x = cur ^ c4;
    const uint32_t z = (x - 0x01010101u) & ~x & 0x80808080u;
    const uint32_t low = z & (0u - z);            // the top bit of ch's byte, 0 where ch is not
    const uint32_t move = (2 * low - 1) & alive;  // 2 * low wraps to 0 for the top byte: all bits
    w[4 * G + i] = (__funnelshift_l(prev, cur, 8) & move) | (cur & ~move);
    moved += __popc(move);
    alive &= (uint32_t)((int32_t)(low - 1) >> 31);  // all ones until ch is found
    prev = cur;
  }
}

template <int G>
__device__ __forceinline__ void mtf_groups(uint32_t (&w)[TAB_WORDS], uint32_t c4, uint32_t& prev, uint32_t& alive,
                                           uint32_t& moved) {
  mtf_group<G>(w, c4, prev, alive, moved);
  if constexpr (G + 1 < TAB_WORDS / 4) {
    if (__any_sync(FULL, alive)) mtf_groups<G + 1>(w, c4, prev, alive, moved);
  }
}

__device__ __forceinline__ uint32_t mtf_step(uint32_t (&w)[TAB_WORDS], uint32_t ch) {
  uint32_t prev = ch << 24, alive = FULL, moved = 0;  // ch enters at byte 0
  mtf_groups<0>(w, ch * 0x01010101u, prev, alive, moved);
  return moved / 8 - 1;
}

// J3: grid C, 32 threads, walk_smem_words(chunk) * 4 bytes of dynamic
// shared memory. entry: J2's rows.
__global__ void __launch_bounds__(32, 16)
mtf_walkers_kernel(const uint8_t* __restrict__ in, int64_t n, int chunk, const int32_t* __restrict__ entry,
                   uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x;
  const int sub = chunk / WALKERS;
  const int sw = walk_stride(chunk);
  uint32_t* buf = smem;                                   // WALKERS * sw
  uint32_t* tabs = buf + WALKERS * sw;                    // 2 * TAB_WORDS
  uint32_t* seen = tabs + 2 * TAB_WORDS;                  // 8 * WALKERS
  uint8_t* dlist = reinterpret_cast<uint8_t*>(seen + 8 * WALKERS);  // chunk bytes
  uint8_t* flag = dlist + chunk;                          // SIGMA
  int* dcount = reinterpret_cast<int*>(flag + SIGMA);     // WALKERS
  uint8_t* buf8 = reinterpret_cast<uint8_t*>(buf);

  const int c = blockIdx.x;
  const int64_t base = (int64_t)c * chunk;
  const int len = chunk_len(n, base, chunk);
  const int words = sub / 4;  // a sub-chunk's words

  // 1. stage: chunk word q lies in sub-chunk q / words
  const bool in_aligned = ((reinterpret_cast<uintptr_t>(in) | base) & 3) == 0;
  for (int q0 = lane; q0 < chunk / 4; q0 += 32 * STAGE_BATCH) {  // the batch's loads issued together
    uint32_t v[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = 4 * (q0 + 32 * u);
      v[u] = 0;
      if (in_aligned && i + 4 <= len) {
        v[u] = reinterpret_cast<const uint32_t*>(in + base)[q0 + 32 * u];
      } else {
        for (int b = 0; b < 4 && i + b < len; ++b) v[u] |= (uint32_t)in[base + i + b] << (8 * b);
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int q = q0 + 32 * u;
      const int t = q / words;
      if (q < chunk / 4) buf[t * sw + (q - t * words)] = v[u];
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) seen[k * WALKERS + lane] = 0;
  for (int s = lane; s < SIGMA; s += 32) flag[s] = 0;
  __syncwarp();

  // 2. D_t: walker `lane`'s distinct symbols, latest first
  const int mylen = min(max(len - lane * sub, 0), sub);
  {
    const uint8_t* mine = buf8 + 4 * lane * sw;
    int nd = 0;
    for (int i = mylen - 1; i >= 0; --i) {
      const uint32_t ch = mine[i];
      uint32_t* word = seen + (ch >> 5) * WALKERS + lane;
      const uint32_t bit = 1u << (ch & 31);
      const uint32_t v = *word;
      if (!(v & bit)) {
        *word = v | bit;
        dlist[4 * ((nd >> 2) * WALKERS + lane) + (nd & 3)] = (uint8_t)ch;
        ++nd;
      }
    }
    dcount[lane] = nd;
  }

  // 3. E: sort keys 8 a lane (symbols 8 * lane + j), a bitonic network over
  // i = 8 * lane + j; keys are distinct
  uint32_t key[8], sym[8];
  {
    const int4* row = reinterpret_cast<const int4*>(entry + (int64_t)c * SIGMA + 8 * lane);
    const int4 e0 = row[0], e1 = row[1];
    const int32_t e[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sym[j] = 8 * lane + j;
      key[j] = e[j] >= 0 ? 0x7FFFFFFFu - (uint32_t)e[j] : 0x80000000u + sym[j];
    }
  }
#pragma unroll
  for (int ls = 1; ls <= 8; ++ls) {  // runs of size 2^ls, 256 = 2^8
    const int size = 1 << ls;
#pragma unroll
    for (int st = ls - 1; st >= 0; --st) {
      const int stride = 1 << st;
      if (stride >= 8) {  // partners in lane ^ (stride / 8), the same j
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 8 * lane + j;
          const uint32_t ok = __shfl_xor_sync(FULL, key[j], stride >> 3);
          const uint32_t os = __shfl_xor_sync(FULL, sym[j], stride >> 3);
          // the lower index of a pair keeps the smaller key in an ascending
          // run of the network, the larger in a descending one
          const bool want_min = ((i & size) == 0) == ((i & stride) == 0);
          if (want_min ? ok < key[j] : ok > key[j]) {
            key[j] = ok;
            sym[j] = os;
          }
        }
      } else {  // partners in the lane: j and j | stride
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j & stride) continue;
          const int jj = j | stride;
          const bool up = ((8 * lane + j) & size) == 0;
          if (up ? key[j] > key[jj] : key[j] < key[jj]) {
            const uint32_t tk = key[j], ts = sym[j];
            key[j] = key[jj];
            sym[j] = sym[jj];
            key[jj] = tk;
            sym[jj] = ts;
          }
        }
      }
    }
  }
  // the lane's table positions 8 * lane .. 8 * lane + 7
  uint32_t lo = sym[0] | sym[1] << 8 | sym[2] << 16 | sym[3] << 24;
  uint32_t hi = sym[4] | sym[5] << 8 | sym[6] << 16 | sym[7] << 24;

  // 4. the walkers' entry tables, walker 0's first
  uint32_t w[TAB_WORDS];
  reinterpret_cast<uint2*>(tabs)[lane] = make_uint2(lo, hi);
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < TAB_WORDS / 4; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(tabs)[k];
      w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
    }
  }
  for (int t = 0; t + 1 < WALKERS; ++t) {
    uint8_t* next = reinterpret_cast<uint8_t*>(tabs + ((t + 1) & 1) * TAB_WORDS);
    const int nd = dcount[t];
    const uint8_t mark = (uint8_t)(t + 1);
    for (int k = lane; k < nd; k += 32) {  // D_t to the front, in order
      const uint8_t d = dlist[4 * ((k >> 2) * WALKERS + t) + (k & 3)];
      next[k] = d;
      flag[d] = mark;
    }
    __syncwarp();
    // the lane's other symbols keep their order behind D_t
    unsigned stay = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t s = ((j < 4 ? lo : hi) >> (8 * (j & 3))) & 0xFF;
      stay |= (unsigned)(flag[s] != mark) << j;
    }
    // the count of staying symbols in the lanes below, from the bits of
    // each lane's count (at most 8: 4 bits), a ballot a bit
    const unsigned cnt = __popc(stay), below = (1u << lane) - 1;
    int pos = nd;
#pragma unroll
    for (int bit = 0; bit < 4; ++bit) pos += __popc(__ballot_sync(FULL, cnt >> bit & 1) & below) << bit;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (stay >> j & 1) next[pos++] = (uint8_t)(((j < 4 ? lo : hi) >> (8 * (j & 3))) & 0xFF);
    }
    __syncwarp();
    const uint2 mine = reinterpret_cast<const uint2*>(next)[lane];
    lo = mine.x;
    hi = mine.y;
    if (lane == t + 1) {
#pragma unroll
      for (int k = 0; k < TAB_WORDS / 4; ++k) {
        const uint4 v = reinterpret_cast<const uint4*>(next)[k];
        w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
      }
    }
  }

  // 5. the walk: 4 bytes a staged word, their ranks written over it. Every
  // lane steps as far as walker 0 (the votes need the whole warp); a walker
  // past its sub-chunk's end walks the zeros staged there, whose ranks are
  // never stored.
  {
    uint32_t* mine = buf + lane * sw;
    const int nwords = (min(len, sub) + 3) / 4;
    for (int q = 0; q < nwords; ++q) {
      const uint32_t v = mine[q];
      uint32_t r = 0;
#pragma unroll 1
      for (int b = 0; b < 4; ++b) r |= mtf_step(w, (v >> (8 * b)) & 0xFF) << (8 * b);
      mine[q] = r;
    }
  }
  __syncwarp();

  // 6. store
  const bool out_aligned = ((reinterpret_cast<uintptr_t>(out) | base) & 3) == 0;
  for (int q = lane; q < chunk / 4; q += 32) {
    const int i = 4 * q;
    if (i >= len) break;
    const int t = q / words;
    const uint32_t v = buf[t * sw + (q - t * words)];
    if (out_aligned && i + 4 <= len) {
      reinterpret_cast<uint32_t*>(out + base)[q] = v;
    } else {
      for (int b = 0; b < 4 && i + b < len; ++b) out[base + i + b] = (uint8_t)(v >> (8 * b));
    }
  }
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
  const size_t smem = (size_t)walk_smem_words(chunk) * 4;
  mtf_walkers_kernel<<<n_chunks, WALKERS, smem, s>>>(src, n, chunk, scratch, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
